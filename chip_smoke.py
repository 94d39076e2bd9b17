"""Smoke run of the main path on one GPU, in one process.

    python chip_smoke.py                # one card: phases 1-5
    python chip_smoke.py --four-cards   # four cards: the multi-device paths

Phases (any failure ends the run with a non-zero exit):
  1. device: JAX's first device must be a GPU; the card's name and power
     limit (nvidia-smi) go on the first line and beside every result;
  2. detector parity at 1080p (media/golden_1080p.png, t=16): all 24
     (nonmax mode x count 9..16) configurations through the GPU detector —
     the dense (mask, score) path and the keypoint path of
     `api.detect_arrays` — bit-exact against ops/fast.py on this process's
     CPU device, the C++ oracle on the three n=9 configurations, and the
     golden counts (24130 / 4457 / 6469 here, 309 / 131 / 135 on the
     300x200 frame through `cli.main`);
  3. serving: 1080p batches of 16 through `serving.DetectorPipeline`,
     equal per frame to `api.detect_arrays`;
  4. front-end: `brief.detect_and_describe_batch` at 1080p, K=1000, plain
     and steered, then `match.match` between two frames — bit-exact
     against the CPU device (integer and exact math throughout: the +-1
     bf16 Hamming product sums at most 256 terms);
  5. VO: the staged 32-frame rendered circuit (odometry -> loops -> BA)
     under its own gates; the three ATEs print beside the CPU run's.

With ``--four-cards`` only the multi-device paths run, each against its
single-device result: data-parallel detection (bit-exact), the 3-stage
pipelined front-end (bit-exact), sharded BA on a 4x1 and a 2x2 mesh (f32
tolerance), and `slam.run_vo_matches` on the mesh (ATE bound).

The last line of standard output is one JSON object:
    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN_1080P = os.path.join(ROOT, "media", "golden_1080p.png")
SMALL = os.path.join(ROOT, "media", "Screenshot315_torch_grey.png")

#: t=16 n=9 keypoint counts (tests/test_golden.py).
GOLDEN_1080P_COUNTS = {"off": 24130, "max_threshold": 4457,
                       "sum_absolute": 6469}
SMALL_COUNTS = {"off": 309, "max_threshold": 131, "sum_absolute": 135}

#: Staged ATE of the 32-frame circuit on the CPU, in % of trajectory
#: length (odometry, +loops, +BA); see CHANGES.md.
CPU_STAGED_ATE_PCT = (1.4613, 1.4134, 0.6892)

#: Four-card BA: f32 psum reduction order differs from the single-device
#: sum, and CG amplifies it, so pose entries are not compared.  Both steps
#: must cut the starting cost at least in half, and their post-step costs
#: must agree to this fraction of the starting cost (the residual left
#: after a step is ~1e-3 of it, so a tolerance relative to that residual
#: would measure f32 rounding, not the collectives; the 8-device CPU mesh
#: agrees to ~2e-6).
BA_COST_TOL = 1e-4


def _eq(name: str, got, want) -> None:
    """Bit-exact comparison of two arrays (or pytrees of arrays)."""
    import jax
    import numpy as np

    g_leaves, g_tree = jax.tree.flatten(got)
    w_leaves, w_tree = jax.tree.flatten(want)
    if g_tree != w_tree:
        raise AssertionError(f"{name}: structure {g_tree} != {w_tree}")
    for i, (g, w) in enumerate(zip(g_leaves, w_leaves)):
        g, w = np.asarray(g), np.asarray(w)
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(
                f"{name}[{i}]: {g.dtype}{g.shape} != {w.dtype}{w.shape}")
        if not np.array_equal(g, w):
            bad = int(np.sum(g != w))
            raise AssertionError(f"{name}[{i}]: {bad} of {g.size} differ")


def _mask_to_xy(mask):
    """Row-major (x, y) uint32 keypoints of a dense boolean mask."""
    import numpy as np

    yx = np.argwhere(np.asarray(mask))
    return yx[:, ::-1].astype(np.uint32)


def _batch_of_variants(img, n: int):
    """(n, H, W) frames: ``img`` rolled by distinct offsets (distinct
    content per frame, same statistics)."""
    import numpy as np

    return np.stack([np.roll(img, (7 * i, 13 * i), axis=(0, 1))
                     for i in range(n)])


def phase_detector(ctx) -> str:
    import jax

    from feature_detector_fast_tpu import api, cli
    from feature_detector_fast_tpu.config import Config, NonmaxMode
    from feature_detector_fast_tpu.oracle import native as oracle
    from feature_detector_fast_tpu.ops import fast

    img = ctx["img"]
    on_gpu = jax.device_put(img, ctx["gpu"])
    on_cpu = jax.device_put(img, ctx["cpu"])
    counts = {}
    for mode in NonmaxMode:
        for count in range(9, 17):
            tag = f"{mode.value} n={count}"
            dense_gpu = fast.detect_dense_jit(on_gpu, 16, count, mode)
            dense_cpu = fast.detect_dense_jit(on_cpu, 16, count, mode)
            _eq(f"dense {tag}", dense_gpu, dense_cpu)
            want = _mask_to_xy(dense_cpu[0])
            got = api.detect_arrays(on_gpu, Config(16, count, mode))
            _eq(f"keypoints {tag}", got, want)
            if count == 9:
                _eq(f"oracle {tag}",
                    oracle.detect_arrays(img, Config(16, count, mode)), want)
                counts[mode.value] = len(got)
    if counts != GOLDEN_1080P_COUNTS:
        raise AssertionError(f"1080p counts {counts} != {GOLDEN_1080P_COUNTS}")

    small = {}
    with tempfile.TemporaryDirectory() as tmp:
        for mode in NonmaxMode:
            out_png = os.path.join(tmp, f"{mode.value}.png")
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([SMALL, out_png, "16", "9", mode.value])
            if rc != 0:
                raise AssertionError(f"cli.main returned {rc}")
            with open(out_png.replace(".png", ".txt")) as f:
                small[mode.value] = sum(1 for _ in f)
            if f"found {small[mode.value]} keypoints" not in buf.getvalue():
                raise AssertionError(f"cli output: {buf.getvalue()!r}")
    if small != SMALL_COUNTS:
        raise AssertionError(f"300x200 counts {small} != {SMALL_COUNTS}")
    return (f"24 configs bit-exact (dense + keypoints, route "
            f"{api.detector_route()}); oracle n=9 ok; 1080p {counts}; "
            f"cli 300x200 {small}")


def phase_serving(ctx) -> str:
    from feature_detector_fast_tpu import api, serving
    from feature_detector_fast_tpu.config import Config, NonmaxMode
    from feature_detector_fast_tpu.runtime import native as host_native

    img = ctx["img"]
    h, w = img.shape
    batches = [_batch_of_variants(img, 16),
               _batch_of_variants(img[::-1].copy(), 16)]
    n_frames = 0
    for mode in NonmaxMode:
        cfg = Config(16, 9, mode)
        pipe = serving.DetectorPipeline(cfg, max_supers=api._max_super_cap(h, w))
        results = []
        for b in batches:
            pipe.submit(b)
            results.extend(pipe.ready())
        results.extend(pipe.drain())
        for b, kps in zip(batches, results):
            for i, kp in enumerate(kps):
                _eq(f"serving {mode.value} frame {i}", kp,
                    api.detect_arrays(b[i], cfg))
                n_frames += 1
    decode = "native" if host_native.available() else "numpy"
    return f"{n_frames} frames equal to detect_arrays; host decode: {decode}"


def phase_frontend(ctx) -> str:
    import jax
    import numpy as np

    from feature_detector_fast_tpu.models import brief, match

    img = ctx["img"]
    frames = np.stack([img, np.roll(img, (5, 9), axis=(0, 1))])
    notes = []
    for oriented in (False, True):
        outs = {}
        for name in ("gpu", "cpu"):
            x = jax.device_put(frames, ctx[name])
            kps, desc, dvalid = brief.detect_and_describe_batch(
                x, 16, 9, 1000, oriented)
            m = match.match(desc[0], dvalid[0], desc[1], dvalid[1])
            outs[name] = (kps, desc, dvalid, m)
        _eq(f"front-end oriented={oriented}", outs["gpu"], outs["cpu"])
        n_match = int(np.sum(np.asarray(outs["gpu"][3].idx_b) >= 0))
        if n_match < 100:
            raise AssertionError(f"only {n_match} matches (oriented={oriented})")
        notes.append(f"oriented={oriented}: {n_match} matches")
    return "bit-exact vs CPU; " + ", ".join(notes)


def staged_vo():
    """The composed 32-frame staged evaluation (tests/test_render_vo.py):
    returns (a0, a1, a2, trajectory length, loop-closure accepted)."""
    import numpy as np

    from feature_detector_fast_tpu.io import render
    from feature_detector_fast_tpu.models import slam

    cfg = render.RenderConfig(z_back=12.0, cell=0.3, n_boxes=10,
                              noise_sigma=4.0, blur=True, vignette=0.25,
                              seed=3)
    gt = render.loop_trajectory(32, radius=2.0)
    frames = render.render_sequence(gt, cfg)
    vocfg = slam.VOConfig(max_keypoints=512, camera=cfg.camera(),
                          loop_ratio_mad_max=0.15, loop_edge_weight=0.3,
                          loop_edge_min_gap=24)
    traj = float(np.linalg.norm(np.diff(gt[:, :3, 3], axis=0), axis=1).sum())
    pd = slam.frontend_matches(frames, vocfg)
    loops = slam.propose_loop_closures(frames, vocfg, gap=10)
    est0 = slam.run_vo_matches(list(pd), vocfg)
    mets = []
    est1 = slam.run_vo_matches(list(pd), vocfg, loop_pairs=loops,
                               metrics=mets)
    est2 = slam.run_vo_matches(list(pd), vocfg, loop_pairs=loops,
                               ba_refine=True)
    ates = [slam.evaluate_ate(e, gt) for e in (est0, est1, est2)]
    closed = any(m.get("loop_closure") for m in mets)
    return (*ates, traj, closed, len(loops))


def phase_vo(ctx) -> str:
    # The geometry runs in f32 under utils/precision.matmul_highest, which
    # rules out TF32 on the card; reduction order still differs from the
    # CPU, so the ATEs are held to the test's own gates, not to the CPU's
    # digits.
    a0, a1, a2, traj, closed, n_loops = staged_vo()
    pct = [100 * a / traj for a in (a0, a1, a2)]
    cpu = "/".join(f"{v:.4f}" for v in CPU_STAGED_ATE_PCT)
    line = (f"ATE % of trajectory {pct[0]:.4f}/{pct[1]:.4f}/{pct[2]:.4f} "
            f"(CPU {cpu}); {n_loops} loop pairs")
    if not closed or n_loops <= 20:
        raise AssertionError(f"loops not closed: {line}")
    if not (a1 < a0 and a2 < a1 and a2 < 0.8 * a1 and a2 < 0.015 * traj):
        raise AssertionError(f"staged ATE gates failed: {line}")
    return line


def _ba_problem(n_cams: int = 8, n_pts: int = 200, seed: int = 0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from feature_detector_fast_tpu.models import ba, lie

    rng = np.random.default_rng(seed)
    xi = np.zeros((n_cams, 6), np.float32)
    xi[:, 0] = -0.5 * np.arange(n_cams)
    xi[:, 4] = 0.05 * np.sin(np.arange(n_cams))
    gt = lie.se3_exp(jnp.asarray(xi))
    pts = np.stack([rng.uniform(-1, 0.5 * n_cams + 1, n_pts),
                    rng.uniform(-2, 2, n_pts), rng.uniform(4, 8, n_pts)],
                   axis=-1).astype(np.float32)
    cams = np.repeat(np.arange(n_cams), n_pts).astype(np.int32)
    lms = np.tile(np.arange(n_pts), n_cams).astype(np.int32)
    uv = jax.vmap(lambda c, l: ba.project(gt[c], jnp.asarray(pts)[l]))(
        jnp.asarray(cams), jnp.asarray(lms))
    noise = jnp.asarray(rng.normal(0, 0.05, (n_cams, 6)), jnp.float32)
    noise = noise.at[:2].set(0.0)  # the fixed gauge cameras stay exact
    return ba.BAProblem(
        poses=lie.se3_exp(noise) @ gt,
        points=jnp.asarray(pts + rng.normal(0, 0.05, pts.shape), jnp.float32),
        obs_cam=jnp.asarray(cams), obs_lm=jnp.asarray(lms), obs_uv=uv,
        obs_valid=jnp.ones(cams.shape[0], bool), n_fixed_cams=2)


def phase_four_cards(ctx) -> str:
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from feature_detector_fast_tpu.config import NonmaxMode
    from feature_detector_fast_tpu.models import ba, brief, match
    from feature_detector_fast_tpu.parallel import (
        ba_sharded, frontend, mesh as meshlib, pipeline)

    devices = jax.devices()
    if len(devices) != 4:
        raise AssertionError(f"--four-cards needs 4 devices, have {len(devices)}")
    notes = []
    img = ctx["img"]

    # data-parallel detection, 8 frames over 4 cards
    frames = _batch_of_variants(img, 8)
    mesh = meshlib.make_mesh(devices=devices)
    sharded = jax.device_put(frames, NamedSharding(mesh, P(meshlib.DATA_AXIS)))
    for mode in NonmaxMode:
        got = frontend.detect_batch_sharded(sharded, 16, 9, mode, mesh=mesh)
        want = jax.jit(frontend.detect_batch, static_argnums=(1, 2, 3))(
            jax.device_put(frames, devices[0]), 16, 9, mode)
        _eq(f"data-parallel {mode.value}", got, want)
    notes.append("data-parallel detection bit-exact")

    # 3-stage pipelined front-end vs the sequential batch front-end
    stream_frames = frames[:6]
    pipe_mesh = pipeline.make_pipe_mesh(devices[:pipeline.N_STAGES])
    stream = pipeline.frontend_pipelined(stream_frames, 16, 9, 1000,
                                         mesh=pipe_mesh)
    kps, desc, dvalid = brief.detect_and_describe_batch(
        jax.device_put(stream_frames, devices[0]), 16, 9, 1000)
    _eq("pipeline keypoints", (stream.kp_xy, stream.kp_score, stream.kp_valid),
        tuple(kps))
    _eq("pipeline descriptors", (stream.desc, stream.dvalid), (desc, dvalid))
    for i in range(1, len(stream_frames)):
        m = match.match(desc[i], dvalid[i], desc[i - 1], dvalid[i - 1])
        _eq(f"pipeline matches {i}", (stream.match_idx[i], stream.match_dist[i]),
            (m.idx_b, m.dist))
    notes.append("pipelined front-end bit-exact")

    # sharded BA: one step on 4x1 and 2x2 meshes vs the single device
    p = _ba_problem()
    c0 = float(ba.total_cost(p))
    poses1, points1, _ = ba.ba_step(p, 1e-6, 30)
    c1 = float(ba.total_cost(p._replace(poses=poses1, points=points1)))
    for name, m, step in (
        ("4x1", meshlib.make_mesh(n_data=4, devices=devices),
         ba_sharded.ba_step_sharded),
        ("2x2", meshlib.make_mesh(n_data=2, n_model=2, devices=devices),
         ba_sharded.ba_step_sharded2d),
    ):
        poses_s, points_s, _ = step(p, m, 1e-6, 30)
        cs = float(ba.total_cost(p._replace(poses=poses_s, points=points_s)))
        if not (c1 < 0.5 * c0 and cs < 0.5 * c0
                and abs(cs - c1) <= BA_COST_TOL * c0):
            raise AssertionError(f"BA {name}: cost {c0} -> single {c1}, "
                                 f"sharded {cs}")
        notes.append(f"BA {name} cost {cs:.6g} vs single {c1:.6g}")

    # loop-closing VO on the mesh, as __graft_entry__.dryrun_multichip
    from __graft_entry__ import vo_on_mesh

    a_mesh, a_single = vo_on_mesh(meshlib.make_mesh(n_data=2, n_model=2,
                                                    devices=devices))
    if not a_mesh < max(2.0 * a_single, 0.05):
        raise AssertionError(f"VO on mesh: ATE {a_mesh} vs single {a_single}")
    notes.append(f"VO on mesh ATE {a_mesh:.5f} vs single {a_single:.5f}")
    return "; ".join(notes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the multi-device paths on four cards")
    args = ap.parse_args(argv)

    # The CPU device is the reference in the same process; keep it
    # available where the platform list is pinned.
    pinned = os.environ.get("JAX_PLATFORMS", "")
    if pinned and "cpu" not in pinned.split(","):
        os.environ["JAX_PLATFORMS"] = pinned + ",cpu"

    import jax

    from feature_detector_fast_tpu.utils import cache, device
    from feature_detector_fast_tpu.utils.image import load_luma8

    gpu = device.require_gpu()
    card = device.card_info()
    print(card, flush=True)  # as nvidia-smi gives it: name, power limit
    cache.enable()
    ctx = {"gpu": gpu, "cpu": jax.devices("cpu")[0],
           "img": load_luma8(GOLDEN_1080P)}
    if args.four_cards:
        phases = [("four-cards", phase_four_cards)]
    else:
        phases = [("detector", phase_detector), ("serving", phase_serving),
                  ("front-end", phase_frontend), ("vo", phase_vo)]
    for name, fn in phases:
        t0 = time.perf_counter()
        note = fn(ctx)
        print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s | {note} | "
              f"{card}", flush=True)
    print(json.dumps({"ok": True, "device": device.describe(gpu)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
