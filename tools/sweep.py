"""Arc/threshold sweep benchmark (BASELINE.json config[2]).

Runs the detector over the full configurable surface the reference
supports — consecutive count 9..=16 (lib.rs:45-48, including the n>=12
regime that enables the reference's 3-of-4 cardinal fast path) and a
threshold sweep — on the benchmark frame, reporting keypoint counts and
per-frame device time for each point.

Usage: python tools/sweep.py [image.png]   (default: tiled 1080p frame)
Output: one JSON object per line on stdout.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def main() -> int:
    import jax
    import jax.numpy as jnp

    from feature_detector_fast_tpu.utils import cache as _cache

    _cache.enable()

    from bench import build_1080p_frame
    from feature_detector_fast_tpu import NonmaxMode
    from feature_detector_fast_tpu.api import _detect_compact
    from feature_detector_fast_tpu.utils.image import load_luma8

    if len(sys.argv) > 1:
        img_np = load_luma8(sys.argv[1])
    else:
        img_np = build_1080p_frame()
    img = jax.device_put(jnp.asarray(img_np))
    jax.block_until_ready(img)
    addall = jax.jit(lambda xs: jnp.stack([x[2] for x in xs]).sum())

    for count in range(9, 17):
        for threshold in (16, 32):
            args = (threshold, count, NonmaxMode.SUM_ABSOLUTE, 1 << 12)
            out = _detect_compact(img, *args)
            n = int(out[2])
            rounds = 10
            int(addall([_detect_compact(img, *args) for _ in range(2)]))
            t0 = time.perf_counter()
            int(addall([_detect_compact(img, *args) for _ in range(rounds)]))
            dt = (time.perf_counter() - t0) / rounds
            print(json.dumps({
                "threshold": threshold,
                "count": count,
                "nonmax": "sum_absolute",
                "keypoints": n,
                "ms_per_frame": round(dt * 1e3, 3),
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
