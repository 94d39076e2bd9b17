"""GPU benchmark of the pipelined detection serving path.

`serving.DetectorPipeline` keeps depth-N batches in flight with async
readback; the production-relevant figure is pipelined end-to-end
throughput — frames stream in, keypoint lists stream out, host<->device
transfers overlapped across in-flight batches.

Measures, per config (off / max_threshold / sum_absolute):
  * single-shot e2e (submit -> drain each batch; depth effectively 0) —
    the same regime as bench.py's end-to-end loop,
  * pipelined e2e at depths 1 / 2 / 4 over a longer stream,
and checks every streamed frame against `api.detect_arrays`.

Output: one JSON object per line on stdout, each with the card's name and
power limit; diagnostics on stderr.  Fails without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

BATCH = 16
N_BATCHES = 12  # frames per measurement = BATCH * N_BATCHES


def run_stream(batch_np, config, cap: int, depth: int, n_batches: int,
               expect_xy=None):
    """Stream n_batches through a DetectorPipeline; returns (sec/frame,
    keypoints/frame, submit seconds, ready/drain seconds).

    The submit/ready wall-time split diagnoses pipeline-depth behavior:
    submit pays the h2d copy + dispatch, ready/drain pays the (async-
    overlapped) d2h readback + decode — if deeper pipelines queue h2d
    copies BEHIND in-flight d2h copies, it shows up as growing submit
    time.

    ``expect_xy`` (the single-device api.detect_arrays result on this
    frame) turns on the HARDWARE correctness cross-check: every frame's
    decoded keypoints must be bit-identical, at every depth."""
    from feature_detector_fast_tpu.serving import DetectorPipeline

    pipe = DetectorPipeline(config, depth=depth, max_supers=cap)
    n_frames = 0
    n_kp = 0
    got = []  # one decoded batch kept per drain for the post-timing check
    t_submit = 0.0
    t_ready = 0.0
    t0 = time.perf_counter()
    for _ in range(n_batches):
        t = time.perf_counter()
        pipe.submit(batch_np)
        t_submit += time.perf_counter() - t
        t = time.perf_counter()
        for kps in pipe.ready():
            n_frames += len(kps)
            n_kp = len(kps[0])
            got.append(kps)
        t_ready += time.perf_counter() - t
    t = time.perf_counter()
    for kps in pipe.drain():
        n_frames += len(kps)
        n_kp = len(kps[0])
        got.append(kps)
    t_ready += time.perf_counter() - t
    dt = time.perf_counter() - t0
    assert n_frames == n_batches * batch_np.shape[0]
    if expect_xy is not None:
        # bit-exactness of the PIPELINED path vs the single-device API,
        # on hardware, for every streamed frame
        for kps in got:
            for xy in kps:
                if not np.array_equal(xy, expect_xy):
                    raise AssertionError(
                        f"pipelined keypoints diverge at depth {depth}: "
                        f"{len(xy)} vs {len(expect_xy)} expected")
    return dt / n_frames, n_kp, t_submit, t_ready


def main() -> int:
    import jax

    from bench import build_1080p_frame, settle_cap
    from feature_detector_fast_tpu import Config, NonmaxMode
    from feature_detector_fast_tpu.utils import cache, device

    dev = device.require_gpu()
    card = device.card_info()
    cache.enable()
    print(f"device: {dev.platform} {dev.device_kind} | card: {card}",
          file=sys.stderr)

    img = build_1080p_frame()
    batch_np = np.broadcast_to(img, (BATCH,) + img.shape).copy()

    from feature_detector_fast_tpu import api

    for name, config in (
        ("off", Config(16, 9, NonmaxMode.OFF)),
        ("max_threshold", Config(16, 9, NonmaxMode.MAX_THRESHOLD)),
        ("sum_absolute", Config(16, 9, NonmaxMode.SUM_ABSOLUTE)),
    ):
        cap = settle_cap(jax.device_put(batch_np), config)
        # single-device API reference for the hardware bit-exactness
        # cross-check: every pipelined frame, every depth
        expect = api.detect_arrays(img, config)
        # single-shot reference: depth 0 == drain after every submit
        sec0, n_kp, sub0, rdy0 = run_stream(batch_np, config, cap, 0, 4,
                                            expect_xy=expect)
        rec = {"stage": "serving", "config": name, "card": card,
               "keypoints": n_kp,
               "cap": cap, "bit_exact": True,
               "single_shot_ms_per_frame": round(sec0 * 1e3, 3),
               "single_shot_fps": round(1.0 / sec0, 1),
               "single_shot_submit_s": round(sub0, 2),
               "single_shot_ready_s": round(rdy0, 2)}
        for depth in (1, 2, 4):
            sec, _, sub, rdy = run_stream(batch_np, config, cap, depth,
                                          N_BATCHES, expect_xy=expect)
            rec[f"depth{depth}_ms_per_frame"] = round(sec * 1e3, 3)
            rec[f"depth{depth}_fps"] = round(1.0 / sec, 1)
            rec[f"depth{depth}_submit_s"] = round(sub, 2)
            rec[f"depth{depth}_ready_s"] = round(rdy, 2)
        rec["pipeline_speedup"] = round(
            rec["single_shot_ms_per_frame"] / rec["depth2_ms_per_frame"], 2)
        print(json.dumps(rec), flush=True)
        print(f"{name}: single {rec['single_shot_fps']} f/s -> depth2 "
              f"{rec['depth2_fps']} f/s (x{rec['pipeline_speedup']})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
