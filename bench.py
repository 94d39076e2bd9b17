"""Headline benchmark: 1080p FAST frames/sec on one GPU.

Mirrors the reference's criterion benchmark (benches/benchmark.rs:18-50):
three configs — nonmax Off / MaxThreshold / SumAbsolute — at t=16, n=9 on a
1920x1080 grayscale frame.  The reference's published numbers (README.md:
54-65, BASELINE.md) on an i7-4770TE are:

    Off           5.3381 ms  -> 187.33 f/s   (23184 keypoints)
    MaxThreshold  8.7080 ms  -> 114.84 f/s   ( 7646 keypoints)
    SumAbsolute   7.2343 ms  -> 138.23 f/s   ( 8307 keypoints)

Two figures per config:
  * device: the reference's criterion loop reuses one in-memory image
    (benches/benchmark.rs:24-27); here a device-resident batch of
    DEVICE_BATCH frames runs the full detector contract — detect + score +
    nonmax + hierarchical compaction — timed to `block_until_ready`;
  * end to end: BATCH frames from host memory to keypoint lists on the
    host (transfer, detection, packed readback, decode), ROUNDS batches
    in flight through the serving path's packed layout.

The frame is media/golden_1080p.png (INPUT_FILE substitutes another, as
in the reference bench).  Fails without a GPU.  Diagnostics go to stderr,
each with the card's name and power limit; the last line of stdout is
one JSON record.
"""

from __future__ import annotations

import json
import os
import statistics
import sys
import time

import numpy as np

BASELINES = {
    "off": 1000.0 / 5.3381,  # README.md:59
    "max_threshold": 1000.0 / 8.7080,  # README.md:62
    "sum_absolute": 1000.0 / 7.2343,  # README.md:65
}

BATCH = 16          # end-to-end batch
ROUNDS = 10         # end-to-end batches per timing
DEVICE_BATCH = 64   # device-resident batch
DEVICE_REPS = 10    # timed device calls; the median is the headline


def build_1080p_frame() -> np.ndarray:
    """Benchmark frame.  Like the reference bench (benchmark.rs:6-7), the
    INPUT_FILE env var substitutes a real frame; the default is the
    committed natural-statistics 1080p golden frame (media/golden_1080p.png
    — single seamless render, 24130 OFF keypoints vs the reference frame's
    23184; tests/test_golden.py pins its hash and counts)."""
    from feature_detector_fast_tpu.utils.image import load_luma8

    override = os.environ.get("INPUT_FILE")
    if override:
        return load_luma8(override)
    return load_luma8(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                   "media", "golden_1080p.png"))


def settle_cap(dev_batch, config) -> int:
    """The cap production serving lands on for this frame: the initial
    cap, grown by api._grow_cap until nothing overflows."""
    from feature_detector_fast_tpu import api

    cap = api._DEFAULT_SUPER_CAP
    max_cap = api._max_super_cap(*dev_batch.shape[-2:])
    while True:
        packed = np.asarray(api._detect_compact_batch_packed(
            dev_batch, int(config.threshold), int(config.count),
            config.nonmax, cap))
        n_supers = int(packed[:, 1].max())
        if n_supers <= cap:
            return cap
        cap = api._grow_cap(cap, n_supers, max_cap)


def bench_config(img, config):
    """Returns (device sec/frame samples, e2e sec/frame, keypoints)."""
    import jax

    from feature_detector_fast_tpu import api

    batch_np = np.broadcast_to(img, (BATCH,) + img.shape).copy()
    cap = settle_cap(jax.device_put(batch_np), config)
    args = (int(config.threshold), int(config.count), config.nonmax, cap)
    width = api.effective_width(img.shape[-1])

    # End to end: host frames in, host keypoint lists out.
    kps = api.unpack_batch_packed(np.asarray(
        api._detect_compact_batch_packed(jax.device_put(batch_np), *args)),
        cap, width)
    n_kp = len(kps[0])
    t0 = time.perf_counter()
    outs = [api._detect_compact_batch_packed(jax.device_put(batch_np), *args)
            for _ in range(ROUNDS)]
    for o in outs:
        o.copy_to_host_async()
    host = [api.unpack_batch_packed(np.asarray(o), cap, width) for o in outs]
    e2e = (time.perf_counter() - t0) / (ROUNDS * BATCH)
    assert all(len(h[0]) == n_kp for h in host)

    # Device: resident batch, full detection contract per call.
    dev_batch = jax.device_put(
        np.broadcast_to(img, (DEVICE_BATCH,) + img.shape).copy())
    jax.block_until_ready(api._detect_compact_batch(dev_batch, *args))
    samples = []
    for _ in range(DEVICE_REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(api._detect_compact_batch(dev_batch, *args))
        samples.append((time.perf_counter() - t0) / DEVICE_BATCH)
    return samples, e2e, n_kp


def main() -> int:
    from feature_detector_fast_tpu import Config, NonmaxMode
    from feature_detector_fast_tpu.utils import cache, device

    dev = device.require_gpu()
    card = device.card_info()
    cache.enable()
    img = build_1080p_frame()
    print(f"device: {dev.platform} {dev.device_kind} | card: {card}",
          file=sys.stderr)

    results = {}
    for name, config in (
        ("off", Config(16, 9, NonmaxMode.OFF)),
        ("max_threshold", Config(16, 9, NonmaxMode.MAX_THRESHOLD)),
        ("sum_absolute", Config(16, 9, NonmaxMode.SUM_ABSOLUTE)),
    ):
        samples, e2e, n_kp = bench_config(img, config)
        sec = statistics.median(samples)
        results[name] = 1.0 / sec
        print(
            f"{name}: device {sec * 1e3:.4f} ms/frame = {1.0 / sec:.1f} f/s "
            f"({1.0 / sec / BASELINES[name]:.2f}x reference) [min/max over "
            f"{len(samples)} calls of {DEVICE_BATCH}: {min(samples) * 1e3:.4f}"
            f"/{max(samples) * 1e3:.4f} ms] | end to end {e2e * 1e3:.4f} "
            f"ms/frame = {1.0 / e2e:.1f} f/s ({n_kp} keypoints) | {card}",
            file=sys.stderr,
        )

    fps_off = results["off"]
    print(json.dumps({
        "metric": "1080p FAST frames/sec on one GPU (t=16 n=9, nonmax off; "
                  "detect+compact, device-resident batch)",
        "value": round(fps_off, 2),
        "unit": "frames/s",
        "vs_baseline": round(fps_off / BASELINES["off"], 3),
        "card": card,
        "device": device.describe(dev),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
