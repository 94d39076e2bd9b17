"""Full visual-odometry throughput on one GPU.

The front-end kernels have device numbers (bench.py, frontend_bench.py);
this measures the COMPOSED system — rendered frames
-> batched detect+describe -> vmapped pair matching -> batched essential
RANSAC + fused per-pair GN refinement -> scale chaining -> pose graph
(optionally + signature-gated loop closure + rotation averaging + global
robust BA) — as frames/sec wall-clock with warm compiles, the number a
SLAM deployment sees.

Host stages (scale chaining, union-find tracks, graph assembly) run
interleaved with the batched device dispatches, so this is NOT a pure
device number; per-stage timings are printed to attribute the split.

Usage: python tools/vo_bench.py [n_frames] [--loops] [--resident]
Output: one JSON object per line on stdout (with the card's name and
power limit); diagnostics on stderr.  Fails without a GPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir))


def main() -> int:
    from feature_detector_fast_tpu.utils import cache, device

    dev = device.require_gpu()
    card = device.card_info()
    cache.enable()

    import jax

    from feature_detector_fast_tpu.io import render
    from feature_detector_fast_tpu.models import slam

    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 64
    with_loops = "--loops" in sys.argv
    # --resident: stage the frame stack on the device BEFORE the timed
    # region (the serving pattern — uploads overlap the previous batch's
    # compute in a streaming deployment).
    resident = "--resident" in sys.argv

    print(f"device: {dev.platform} {dev.device_kind} | card: {card}",
          file=sys.stderr)

    cfg = render.RenderConfig(width=640, height=480, fx=520.0, fy=520.0,
                              z_back=12.0, cell=0.3, n_boxes=10,
                              noise_sigma=4.0, blur=True, vignette=0.25,
                              seed=3)
    gt = render.loop_trajectory(n, radius=2.0, laps=max(1, n // 64))
    t0 = time.perf_counter()
    frames = render.render_sequence(gt, cfg)
    print(f"render {n}x{cfg.height}x{cfg.width}: "
          f"{time.perf_counter() - t0:.1f}s (host, not counted)",
          file=sys.stderr)
    traj = np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum()
    vocfg = slam.VOConfig(max_keypoints=512, camera=cfg.camera(),
                          loop_ratio_mad_max=0.15, loop_edge_weight=0.3,
                          loop_edge_min_gap=(3 * n) // 4)

    import jax as _jax
    import numpy as _np
    frames_in = frames
    if resident:
        import jax.numpy as _jnp
        frames_in = _jax.device_put(_jnp.asarray(_np.stack(frames)))
        _jax.block_until_ready(frames_in)

    def run_once():
        stages = {}
        t = time.perf_counter()
        feats = slam.frontend_features(frames_in, vocfg)
        jax.block_until_ready(feats)
        stages["features_s"] = time.perf_counter() - t
        t = time.perf_counter()
        pd = slam.frontend_matches(frames, vocfg, features=feats)
        stages["frontend_s"] = time.perf_counter() - t
        loops = None
        if with_loops:
            t = time.perf_counter()
            loops = slam.propose_loop_closures(frames, vocfg, gap=10,
                                               top_k=8, features=feats)
            stages["loop_propose_s"] = time.perf_counter() - t
        t = time.perf_counter()
        st = {}
        est = slam.run_vo_matches(list(pd), vocfg, loop_pairs=loops,
                                  ba_refine=with_loops, stage_times=st)
        stages["geometry_s"] = time.perf_counter() - t
        stages.update({f"geo.{k}_s": v for k, v in st.items()})
        return est, stages

    # Warmup compiles every program involved; the second run is the
    # steady-state timing.
    t0 = time.perf_counter()
    run_once()
    print(f"warmup (incl. compiles): {time.perf_counter() - t0:.1f}s",
          file=sys.stderr)
    t0 = time.perf_counter()
    est, stages = run_once()
    total = time.perf_counter() - t0
    ate = slam.evaluate_ate(est, gt)
    rec = {
        "metric": "full-VO frames/sec (640x480, K=512, warm compiles)"
                  + (" with loop closure + BA" if with_loops else "")
                  + (" [frames device-resident]" if resident else ""),
        "frames": n,
        "card": card,
        "frames_per_sec": round(n / total, 2),
        "total_s": round(total, 2),
        "ate_pct_of_trajectory": round(100 * ate / traj, 3),
        **{k: round(v, 2) for k, v in stages.items()},
    }
    print(json.dumps(rec), flush=True)
    print(f"{n} frames in {total:.2f}s = {n/total:.1f} f/s "
          f"(ate {100*ate/traj:.2f}%)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
