"""Detector kernel A/B on the GPU: the Pallas kernels of ops/fast_triton.py
against the XLA reference (ops/fast.py + ops/compact.py), end to end
through the batched detect + compaction program, plus the XLA BRIEF time.

For each nonmax mode at t=16 n=9 on media/golden_1080p.png:
  * checks that both routes emit the same keypoints (bit-exact words);
  * times a device-resident B=64 batch through each route, in turns
    (xla, triton, triton, xla, ...), and reports the median ms/frame.
Then times `brief.describe` / `describe_oriented` at K=1000 on a B=16
batch of 1080p frames.

Usage:  python tools/kernel_bench.py [--reps N]
Every line names the card and its power limit.  Fails without a GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402

BATCH = 64
BRIEF_BATCH = 16
CALLS = 10  # batched calls per timed sample


def _time_call(fn, *args) -> float:
    """Median seconds of one call over CALLS calls (after a warm call)."""
    import jax

    jax.block_until_ready(fn(*args))
    dts = []
    for _ in range(CALLS):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        dts.append(time.perf_counter() - t0)
    return statistics.median(dts)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3,
                    help="alternating (xla, triton, triton, xla) rounds")
    args = ap.parse_args()

    from feature_detector_fast_tpu.utils import cache, device

    cache.enable()
    import jax
    import jax.numpy as jnp

    from feature_detector_fast_tpu import api
    from feature_detector_fast_tpu.config import NonmaxMode
    from feature_detector_fast_tpu.models import brief
    from feature_detector_fast_tpu.ops import compact, fast, fast_triton
    from feature_detector_fast_tpu.utils.image import load_luma8

    dev = device.require_gpu()
    card = device.card_info()
    print(f"card: {card}", flush=True)
    root = os.path.join(os.path.dirname(__file__), "..")
    img = load_luma8(os.path.join(root, "media", "golden_1080p.png"))
    h, w = img.shape
    batch = jax.device_put(np.broadcast_to(img, (BATCH, h, w)).copy())
    cap = api._max_super_cap(h, w)  # identity layout: the cap dense frames reach
    results = {}
    for mode in NonmaxMode:
        words = np.asarray(jax.jit(fast_triton.detect_words,
                                   static_argnums=(1, 2, 3))(
            jnp.asarray(img), 16, 9, mode))
        mask = np.asarray(fast.detect_dense_jit(jnp.asarray(img), 16, 9,
                                                mode)[0])
        wp = fast_triton.padded_width(w)
        padded = np.zeros((h, wp), bool)
        padded[:, :w] = mask
        ref = np.asarray(compact.pack_mask_words(jnp.asarray(padded))[0])
        exact = bool(np.array_equal(words.reshape(-1), ref))
        routes = {
            name: jax.jit(jax.vmap(functools.partial(
                f, threshold=16, count=9, nonmax=mode, max_supers=cap)))
            for name, f in (("xla", api._compact_xla),
                            ("triton", api._compact_triton))
        }
        outs = {k: [np.asarray(o) for o in f(batch)] for k, f in
                routes.items()}
        same = all(np.array_equal(a, b) for a, b in
                   zip(outs["xla"], outs["triton"]))
        samples = {"xla": [], "triton": []}
        for _ in range(args.reps):
            for name in ("xla", "triton", "triton", "xla"):
                samples[name].append(_time_call(routes[name], batch) / BATCH)
        rec = {
            "mode": mode.value, "exact_words": exact, "same_compaction": same,
            "keypoints": int(mask.sum()),
            **{f"{k}_ms_per_frame": [round(v * 1e3, 5) for v in vs]
               for k, vs in samples.items()},
            **{f"{k}_median_ms": round(statistics.median(vs) * 1e3, 5)
               for k, vs in samples.items()},
            "card": card,
        }
        results[mode.value] = rec
        print(json.dumps(rec), flush=True)

    # XLA BRIEF on its own (keypoints given), K=1000 at 1080p.
    bimgs = batch[:BRIEF_BATCH]
    select = jax.jit(jax.vmap(lambda im: brief.select_topk(
        *fast.detect_dense(im, 16, 9, NonmaxMode.SUM_ABSOLUTE), 1000)))
    kps = select(bimgs)
    for name, fn in (("describe", brief.describe),
                     ("describe_oriented", brief.describe_oriented)):
        f = jax.jit(jax.vmap(fn))
        dt = _time_call(f, bimgs, kps) / BRIEF_BATCH
        print(json.dumps({"brief": name, "k": 1000,
                          "ms_per_frame": round(dt * 1e3, 5), "card": card}),
              flush=True)
    fe = functools.partial(brief.detect_and_describe_batch, threshold=16,
                           count=9, k=1000)
    for oriented in (False, True):
        dt = _time_call(functools.partial(fe, oriented=oriented), bimgs)
        print(json.dumps({"frontend": "detect_and_describe_batch",
                          "oriented": oriented, "k": 1000,
                          "ms_per_frame": round(dt / BRIEF_BATCH * 1e3, 5),
                          "card": card}), flush=True)
    ok = all(r["exact_words"] and r["same_compaction"]
             for r in results.values())
    print(json.dumps({"ok": ok, "device": device.describe(dev)}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
