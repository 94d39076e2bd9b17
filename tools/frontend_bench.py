"""Full SLAM front-end benchmark: detect + top-K + BRIEF (+ matching).

The detector headline (`bench.py`) covers the reference's scope; a SLAM
deployment runs the whole front-end per frame.  This measures, on the
device (an on-device lax.scan over rounds, one dispatch per timing):

  1. detect_and_describe: FAST (SumAbsolute) -> top-K -> BRIEF-256
     (optionally steered/oriented) per frame, and
  2. the same plus mutual-NN Hamming matching of consecutive frame pairs
     (one +-1 matmul per pair).

Usage: python tools/frontend_bench.py [k]   (default k=1000)
Output: one JSON object per line on stdout; diagnostics on stderr.
"""

from __future__ import annotations

import functools
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))

RESOLUTIONS = [("vga", 640, 480), ("720p", 1280, 720), ("1080p", 1920, 1080)]


def main() -> int:
    import jax
    import jax.numpy as jnp

    from feature_detector_fast_tpu.utils import cache as _cache

    _cache.enable()

    from bench import build_1080p_frame
    from feature_detector_fast_tpu.models import brief, match

    k = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    base = build_1080p_frame()

    for name, w, h in RESOLUTIONS:
        frame = np.tile(base, (-(-h // base.shape[0]), -(-w // base.shape[1])))
        frame = frame[:h, :w].copy()
        batch = max(4, int(round(32 * (1920 * 1080) / (h * w))))
        if k > 1024:
            # Large-k paths hold O(k) per-frame descriptor state (dense
            # word planes / extracted windows); scale the in-flight batch
            # down so the sweep fits HBM instead of OOMing.
            batch = max(4, batch * 1024 // k)
        rounds = 10
        imgs = jax.device_put(np.broadcast_to(frame, (batch, h, w)).copy())
        zeros = jax.device_put(np.zeros(rounds, np.uint8))
        jax.block_until_ready((imgs, zeros))

        for oriented in (False, True):
            for with_match in (False, True):

                @functools.partial(jax.jit, static_argnums=(2,))
                def loop(ims, zs, r):
                    def body(c, z):
                        kps, desc, dv = brief.detect_and_describe_batch(
                            ims ^ z, 16, 9, k, oriented)
                        acc = (kps.xy.sum(dtype=jnp.int32)
                               + desc.sum(dtype=jnp.uint32).astype(jnp.int32)
                               + dv.sum(dtype=jnp.int32))
                        if with_match:
                            m = jax.vmap(
                                lambda da, va, db, vb:
                                match.match.__wrapped__(da, va, db, vb).idx_b
                            )(desc[:-1], dv[:-1], desc[1:], dv[1:])
                            acc = acc + m.sum(dtype=jnp.int32)
                        return c + acc, None
                    c, _ = jax.lax.scan(body, jnp.int32(0), zs[:r])
                    return c

                int(loop(imgs, zeros, rounds))
                t0 = time.perf_counter()
                int(loop(imgs, zeros, rounds))
                dt = (time.perf_counter() - t0) / rounds / batch
                tag = ("oriented-" if oriented else "") + (
                    "detect+describe+match" if with_match else "detect+describe")
                print(f"{name} {tag}: {dt * 1e3:.3f} ms/frame = "
                      f"{1.0 / dt:.0f} f/s (batch {batch}, k {k})",
                      file=sys.stderr, flush=True)
                print(json.dumps({
                    "stage": tag, "resolution": name, "k": k,
                    "ms_per_frame": round(dt * 1e3, 3),
                    "frames_per_sec": round(1.0 / dt, 1),
                }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
