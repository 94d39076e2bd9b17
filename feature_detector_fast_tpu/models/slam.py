"""Monocular visual-odometry / SLAM pipeline (BASELINE.json config[3]).

Composition of the framework's layers into a trajectory estimator:

    frames -> detect+describe (FAST+BRIEF, fused device front-end)
           -> match consecutive pairs (Hamming as a +-1 matmul)
           -> essential-matrix RANSAC -> relative pose (unit baseline)
           -> triangulation + median-depth scale chaining (monocular
              scale propagation between consecutive pairs)
           -> pose-graph optimization over the chained odometry
           -> optional windowed bundle adjustment refinement

Device-shaped dataflow: every per-pair geometric estimate (RANSAC, pose
recovery, triangulation, transported depths) for the WHOLE sequence runs
as ONE vmapped device dispatch over a fixed-capacity (P, K, ...) batch —
the host never round-trips per pair.  Cross-pair linking (scale chaining,
loop-closure scale, multi-frame tracks) is exact integer slot indexing:
correspondence slot i of pair k IS keypoint slot i of frame k, and
``idx_b[k, i]`` is the matched keypoint slot of frame k+1 straight from
the matcher — no floating-point coordinate keys anywhere.

Two entry layers:
  * `run_vo_images`: full image pipeline (uses the device front-end),
  * `run_vo_matches`: from per-pair correspondence arrays — the geometric
    back half, testable against synthetic ground truth without rendering.

Monocular scale is unobservable; trajectories are evaluated with
scale-aligned ATE (utils.metrics.ate_rmse(with_scale=True), the TUM
monocular convention).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.metrics import ate_rmse
from ..utils.precision import matmul_highest
from . import ba as ba_lib
from . import brief, match, posegraph, twoview


@dataclasses.dataclass(frozen=True)
class VOConfig:
    threshold: int = 16
    count: int = 9
    max_keypoints: int = 512
    camera: twoview.Camera = twoview.Camera(300.0, 300.0, 160.0, 120.0)
    ransac_hypotheses: int = 256
    ransac_threshold: float = 1e-4
    pose_graph_iters: int = 10
    #: Geman-McClure scale (se3-log units) for pose-graph edges when loop
    #: closures are present: image-level loop hypotheses can be
    #: confidently wrong (a degenerate RANSAC model with many inliers),
    #: so their influence must REDESCEND toward zero past this residual
    #: norm instead of tearing the chain (a Huber kernel — constant
    #: influence past delta — measurably still lets one gross outlier
    #: edge drag a consistent chain; see posegraph.optimize).
    loop_robust_delta: float = 0.25
    #: Pose-graph iterations when loop closures are present (adaptive-LM
    #: retries consume iterations; loop graphs need more than chains).
    loop_pose_graph_iters: int = 40
    #: Max median-absolute-deviation of a loop pair's log depth ratios;
    #: dispersion above this means the pair's two-view geometry is
    #: inconsistent with the chain (degenerate models carry high inlier
    #: counts) and the hypothesis is dropped.
    loop_ratio_mad_max: float = 0.3
    #: Pose-graph weight of loop-closure edges relative to odometry
    #: edges (their scale-drift observations always enter the linear
    #: drift solve at full weight; this weights only the SE(3) residual).
    loop_edge_weight: float = 1.0
    #: Loop pairs closer than this many frames contribute only their
    #: scale-drift observation, not an SE(3) edge: short loops' pose
    #: estimates are barely independent of the chain (noise, not
    #: correction), while their depth-ratio drift observations stay
    #: valuable.
    loop_edge_min_gap: int = 0
    #: Median rotation-compensated disparity (radians, ~normalized-coord
    #: units) below which a loop pair is treated as a ZERO-PARALLAX
    #: REVISIT: the cameras coincide to within measurement noise, so its
    #: triangulated depths are legitimately meaningless (per-slot za/zb
    #: RATIOS stay well-conditioned — the near-singular denominator
    #: cancels) and the honest SE(3) measurement is [R | 0] — rotation
    #: from the pair, translation pinned to zero.  Round-4 ran such
    #: pairs through the depth-ratio MAD gates, where acceptance
    #: teetered on f32 rounding of garbage depths (a batch-shape change
    #: flipped it).  Default ~2 px at VGA focal lengths: real loop
    #: baselines give disparities an order above this.
    revisit_disparity_max: float = 4e-3
    #: Per-pair Gauss-Newton pose refinement: after essential RANSAC and
    #: cheirality pose recovery, each pair runs this many iterations of a
    #: tiny two-camera bundle adjustment (structure + second camera free,
    #: first camera gauge) INSIDE the same batched device dispatch.  The
    #: near-planar rendered scenes are a degenerate configuration for the
    #: 8-point essential matrix, leaving degree-level relative-rotation
    #: noise that reprojection GN removes (measured 0.45 -> 0.27 deg
    #: median on the staged circuit).  0 disables.
    pair_refine_iters: int = 6
    pair_refine_cg: int = 12
    seed: int = 0
    #: >1 detects+describes over a dyadic image pyramid
    #: (models.pyramid): each level contributes max_keypoints //
    #: pyramid_levels slots and matching runs over the concatenated
    #: multi-level sets, so features survive large scale changes (fast
    #: forward motion) that single-scale BRIEF cannot match across.
    pyramid_levels: int = 1


class PairBatch(NamedTuple):
    """Fixed-capacity correspondence batch for P frame pairs.

    Slot semantics: correspondence slot i of pair k is keypoint slot i of
    the pair's FIRST frame; ``idx_b[k, i]`` is the matched keypoint slot
    of the pair's second frame (-1 / invalid where unmatched).  Synthetic
    inputs whose slot is a landmark id use the identity mapping.
    """

    pa: np.ndarray  # (P, K, 2) normalized coords in the first frame
    pb: np.ndarray  # (P, K, 2) normalized coords in the second frame
    valid: np.ndarray  # (P, K) bool
    idx_b: np.ndarray  # (P, K) int32 second-frame keypoint slot, -1 invalid


class PairEstimates(NamedTuple):
    """Per-pair geometry from one batched device dispatch (host numpy).

    Convention: x_b = R x_a + t_unit (camera-frame, unit baseline), so
    cam_b_T_cam_a = [R | t_unit * scale] once a scale is chained on.
    """

    R: np.ndarray  # (P, 3, 3)
    t_unit: np.ndarray  # (P, 3)
    inl: np.ndarray  # (P, K) bool RANSAC inliers
    depths_a: np.ndarray  # (P, K) triangulated depth in the first frame
    depths_b: np.ndarray  # (P, K) the same points' depth in the second frame


def _as_pair_batch(
    pair_data: Sequence[Tuple[np.ndarray, ...]],
) -> PairBatch:
    """Normalize a list of (pa, pb, valid[, idx_b]) tuples into a padded
    PairBatch.  Missing idx_b defaults to the identity slot mapping (the
    synthetic-data convention: slot == landmark id in every frame)."""
    kmax = max(np.asarray(t[0]).shape[0] for t in pair_data)
    p = len(pair_data)
    pa = np.zeros((p, kmax, 2), np.asarray(pair_data[0][0]).dtype)
    pb = np.zeros_like(pa)
    valid = np.zeros((p, kmax), bool)
    idx_b = np.full((p, kmax), -1, np.int32)
    for k, entry in enumerate(pair_data):
        a, b, v = (np.asarray(x) for x in entry[:3])
        n = a.shape[0]
        pa[k, :n] = a
        pb[k, :n] = b
        valid[k, :n] = v
        if len(entry) > 3:
            idx_b[k, :n] = np.asarray(entry[3], np.int32)
        else:
            idx_b[k, :n] = np.arange(n, dtype=np.int32)
        idx_b[k, :n] = np.where(valid[k, :n], idx_b[k, :n], -1)
    return PairBatch(pa, pb, valid, idx_b)


@functools.partial(jax.jit, static_argnums=(4, 6, 7))
@matmul_highest
def _estimate_pairs_device(pa, pb, valid, keys, hypotheses, threshold,
                           refine_iters=0, refine_cg=12):
    """vmapped essential-RANSAC + pose recovery + triangulation — plus,
    with ``refine_iters`` > 0, a fused per-pair two-camera Gauss-Newton
    reprojection refinement — for a (P, K, 2) batch of correspondence
    sets: the whole sequence's two-view geometry in one XLA program."""
    def one(pa1, pb1, v1, key):
        E, inl = twoview.ransac_essential(
            pa1, pb1, v1, key, hypotheses, threshold
        )
        R, t, _ = twoview.recover_pose(E, pa1, pb1, inl)
        # Closed-form ray depths replace per-point SVD triangulation
        # everywhere in this dispatch (twoview.ray_depths docstring: the
        # tiny batched SVDs were the geometry stage's dominant cost).
        za, zb = twoview.ray_depths(R, t, pa1, pb1)
        if refine_iters > 0:
            # Two-camera BA on the RANSAC inliers: world = camera a,
            # camera b's 6 dof + inlier structure free.  Invalid slots
            # get a benign placeholder point — their residuals are
            # validity-masked, the placeholder only keeps the masked
            # Jacobian arithmetic finite.
            k = pa1.shape[0]
            qa1 = jnp.concatenate([pa1, jnp.ones_like(pa1[..., :1])],
                                  axis=-1)
            X = qa1 * za[..., None]  # frame-a (== world) landmark init
            ok = inl & (za > 1e-6) & jnp.isfinite(za)
            Xs = jnp.where(ok[:, None], X,
                           jnp.asarray([0.0, 0.0, 1.0], X.dtype))
            Tb = jnp.eye(4, dtype=pa.dtype)
            Tb = Tb.at[:3, :3].set(R).at[:3, 3].set(t)
            poses2 = jnp.stack([jnp.eye(4, dtype=pa.dtype), Tb])
            idx = jnp.arange(k, dtype=jnp.int32)
            prob = ba_lib.BAProblem(
                poses=poses2,
                points=Xs,
                obs_cam=jnp.concatenate([jnp.zeros(k, jnp.int32),
                                         jnp.ones(k, jnp.int32)]),
                obs_lm=jnp.concatenate([idx, idx]),
                obs_uv=jnp.concatenate([pa1, pb1], axis=0),
                obs_valid=jnp.concatenate([ok, ok]),
                n_fixed_cams=1,
            )
            newp, _, _ = ba_lib.optimize.__wrapped__(
                prob, refine_iters, refine_cg, 1e-6, 0.0
            )
            R = newp[1, :3, :3]
            t = newp[1, :3, 3]
            t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
            za, zb = twoview.ray_depths(R, t, pa1, pb1)
        return R, t, inl, za, zb

    return jax.vmap(one)(pa, pb, valid, keys)


def estimate_pairs(
    batch: PairBatch, config: VOConfig, seed_offset: int = 0,
    keys: Optional[jax.Array] = None,
) -> PairEstimates:
    """Batched two-view estimation: ONE device dispatch, ONE host fetch
    for all P pairs (SURVEY.md §3 — don't serialize the VO
    loop on the host/device boundary).  ``keys`` overrides the per-pair
    RANSAC keys (two-phase loop estimation re-estimates a SUBSET of pairs
    with refinement and must hand each pair its original key so the
    refined result is bit-identical to a full-batch refined run)."""
    p = batch.pa.shape[0]
    if keys is None:
        keys = jax.random.split(
            jax.random.PRNGKey(config.seed + seed_offset), p)
    out = _estimate_pairs_device(
        jnp.asarray(batch.pa),
        jnp.asarray(batch.pb),
        jnp.asarray(batch.valid),
        keys,
        config.ransac_hypotheses,
        config.ransac_threshold,
        int(config.pair_refine_iters),
        int(config.pair_refine_cg),
    )
    R, t, inl, da, db = jax.device_get(out)
    return PairEstimates(R, t, inl.astype(bool), da, db)


@contextlib.contextmanager
def _staged(times: Optional[dict], name: str):
    """Accumulate wall seconds of the enclosed stage into ``times[name]``
    (no-op when ``times`` is None).  Stages end with a host fetch of their
    device results, so wall time per stage is dispatch+compute+readback —
    the quantity a deployment sees (tools/exp_backend_stages.py)."""
    if times is None:
        yield
        return
    t0 = time.perf_counter()
    yield
    times[name] = times.get(name, 0.0) + time.perf_counter() - t0


def _scatter_rows(dst: np.ndarray, idx: np.ndarray,
                  rows: np.ndarray) -> np.ndarray:
    """Copy of ``dst`` with ``dst[idx] = rows`` (batch-row scatter)."""
    out = np.array(dst)
    out[idx] = rows
    return out


def _chain_scales(est: PairEstimates, idx_b: np.ndarray) -> np.ndarray:
    """Propagate monocular scale between consecutive pair estimates.

    Pair k triangulates in frame k's camera; pair k+1 in frame k+1's.  A
    point inlying in both pairs is linked EXACTLY through the shared
    frame: pair k's slot i lands on frame-(k+1) keypoint slot idx_b[k, i],
    which is pair k+1's correspondence slot.  Its depth seen from frame
    k+1 is depths_b[k] (up to pair k's scale) and depths_a[k+1] (up to
    pair k+1's), so the median depth ratio fixes the relative scale.
    First pair defines scale 1.
    """
    p, k_cap = est.inl.shape
    scales = np.ones(p)
    for k in range(1, p):
        m_prev = est.inl[k - 1] & (idx_b[k - 1] >= 0) & (
            est.depths_b[k - 1] > 1e-6
        )
        shared = np.full(k_cap, np.nan)
        shared[idx_b[k - 1, m_prev]] = est.depths_b[k - 1, m_prev]
        m_cur = est.inl[k] & (est.depths_a[k] > 1e-6)
        d_prev = shared[np.arange(k_cap)[m_cur]]
        d_cur = est.depths_a[k, m_cur]
        ok = np.isfinite(d_prev) & (d_prev > 1e-6)
        ratio = float(np.median(d_prev[ok] / d_cur[ok])) if ok.any() else 1.0
        scales[k] = scales[k - 1] * ratio
    return scales


def run_vo_matches(
    pair_data: Sequence[Tuple[np.ndarray, ...]],
    config: VOConfig,
    loop_pairs: Optional[Sequence[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]] = None,
    metrics: Optional[list] = None,
    ba_refine: bool = False,
    mesh=None,
    _internals: Optional[dict] = None,
    stage_times: Optional[dict] = None,
) -> np.ndarray:
    """Geometric VO from per-pair normalized correspondences.

    pair_data[k] = (pa, pb, valid[, idx_b]) for frames (k, k+1), already
    in normalized camera coordinates (idx_b = second-frame keypoint slot
    per correspondence; identity if omitted).  ``loop_pairs`` optionally
    adds non-consecutive constraints (i, j, pa, pb, valid) — loop
    closures — whose slots must be frame-i keypoint slots so their
    monocular scale links against pair i's depths by exact slot index.
    Returns (F, 4, 4) world_T_cam poses (frame 0 at identity), after
    pose-graph optimization.  ``metrics``, if given, is appended with one
    dict per pair (SURVEY.md §5.5 structured per-frame metrics).
    """
    if len(pair_data) == 0:
        # 0/1-frame sequence: no pairs to estimate, trajectory is frame 0
        # at the identity.
        return np.eye(4)[None]
    batch = _as_pair_batch(pair_data)
    with _staged(stage_times, "odom_estimate_pairs"):
        est = estimate_pairs(batch, config)
    if metrics is not None:
        for k in range(batch.pa.shape[0]):
            metrics.append({
                "pair": (k, k + 1),
                "matches": int(batch.valid[k].sum()),
                "inliers": int(est.inl[k].sum()),
            })

    scales = _chain_scales(est, batch.idx_b)

    # integrate odometry: world frame = camera 0
    # cam_{k+1}_T_cam_k = [R | s t]; world_T_cam_{k+1} =
    #     world_T_cam_k @ inv(cam_{k+1}_T_cam_k)
    p = batch.pa.shape[0]
    n = p + 1
    poses = [np.eye(4)]
    rels = []
    for k in range(p):
        Tba = np.eye(4)
        Tba[:3, :3] = est.R[k]
        Tba[:3, 3] = est.t_unit[k] * scales[k]
        rel = np.linalg.inv(Tba)  # cam_k_T_cam_{k+1}
        rels.append(rel)
        poses.append(poses[-1] @ rel)
    poses = np.stack(poses)

    edge_i = list(range(n - 1))
    edge_j = list(range(1, n))
    edge_T = list(rels)
    edge_w = [1.0] * (n - 1)

    ba_loop_links = []  # accepted loops' correspondences, for BA tracks
    rot_edges = None  # relative-rotation graph for BA's averaging stage
    # Loop-closure edges: ALL loop pairs estimated in one more batched
    # dispatch; each recovers its monocular scale against pair i's chained
    # depths by exact frame-i slot index.  Loop tuples may carry a sixth
    # element idx_b (frame-j keypoint slot per correspondence, as
    # propose_loop_closures emits): with it, a loop also OBSERVES the
    # relative scale drift between segments i and j (depth ratios at both
    # endpoints), and the drift is divided out of the whole chain by a
    # linear solve before the pose graph runs — an SE(3) pose graph
    # structurally cannot absorb monocular scale drift, and uncorrected
    # loop edges measurably made the trajectory worse, not better.
    if loop_pairs:
        lbatch = _as_pair_batch([e[2:] for e in loop_pairs])
        if lbatch.pa.shape[1] != batch.pa.shape[1]:
            # `est` was computed at batch's slot capacity, so batch must
            # never be re-padded here — align lbatch to it instead.  Loop
            # slots are frame-i keypoint slots; slots beyond the main
            # batch's capacity cannot link against est's depths anyway, so
            # a wider loop batch is truncated.
            k_cap = batch.pa.shape[1]
            extra = k_cap - lbatch.pa.shape[1]
            if extra > 0:
                lbatch = PairBatch(
                    np.pad(lbatch.pa, ((0, 0), (0, extra), (0, 0))),
                    np.pad(lbatch.pb, ((0, 0), (0, extra), (0, 0))),
                    np.pad(lbatch.valid, ((0, 0), (0, extra))),
                    np.pad(lbatch.idx_b, ((0, 0), (0, extra)),
                           constant_values=-1),
                )
            else:
                lbatch = PairBatch(
                    lbatch.pa[:, :k_cap],
                    lbatch.pb[:, :k_cap],
                    lbatch.valid[:, :k_cap],
                    lbatch.idx_b[:, :k_cap],
                )
        # Two-phase loop estimation (VERDICT r4 #1): phase 1 runs the
        # batched RANSAC WITHOUT the fused per-pair GN refinement over
        # every candidate; only pairs whose R,t will become graph
        # constraints (far-gap, enough inliers) are re-estimated WITH
        # refinement in a small second dispatch.  Near-gap loops
        # contribute only median depth-ratio drift observations, which
        # are robust to the degree-level rotation noise the refinement
        # removes — refining all of them was most of the loop-stage
        # device time (the GN refine is ~6x the RANSAC itself).
        cfg_fast = dataclasses.replace(config, pair_refine_iters=0)
        with _staged(stage_times, "loop_ransac"):
            lest = estimate_pairs(lbatch, cfg_fast, seed_offset=1)
        if config.pair_refine_iters > 0:
            gaps = np.asarray([int(e[1]) - int(e[0]) for e in loop_pairs])
            need = (gaps >= config.loop_edge_min_gap) & (
                lest.inl.sum(axis=1) >= 16)
            sel = np.nonzero(need)[0]
            if sel.size:
                # No sub-batch padding: a refined pair's result must not
                # depend on arbitrary batch-mates (near-degenerate revisit
                # pairs are numerically sensitive enough that even
                # duplicated-row padding changed their refined depths
                # through batched-matmul rounding).
                sub = PairBatch(lbatch.pa[sel], lbatch.pb[sel],
                                lbatch.valid[sel], lbatch.idx_b[sel])
                lkeys = jax.random.split(
                    jax.random.PRNGKey(config.seed + 1),
                    lbatch.pa.shape[0])[sel]
                with _staged(stage_times, "loop_refine"):
                    rsub = estimate_pairs(sub, config, keys=lkeys)
                lest = PairEstimates(
                    _scatter_rows(lest.R, sel, rsub.R),
                    _scatter_rows(lest.t_unit, sel, rsub.t_unit),
                    _scatter_rows(lest.inl, sel, rsub.inl),
                    _scatter_rows(lest.depths_a, sel, rsub.depths_a),
                    _scatter_rows(lest.depths_b, sel, rsub.depths_b),
                )
        k_cap = batch.pa.shape[1]

        def chain_depth_table(f: int) -> Tuple[np.ndarray, int]:
            """(per-frame-f-slot chain-unit depth table, segment index
            whose scale error it carries).  Frame f's chain depths come
            from pair f when it exists, else from pair f-1's second-frame
            depths remapped through its idx_b."""
            tbl = np.full(k_cap, np.nan)
            if f < p:
                m = est.inl[f] & (est.depths_a[f] > 1e-6)
                tbl[m] = est.depths_a[f, m] * scales[f]
                return tbl, f
            m = est.inl[f - 1] & (batch.idx_b[f - 1] >= 0) & (
                est.depths_b[f - 1] > 1e-6)
            tbl[batch.idx_b[f - 1, m]] = est.depths_b[f - 1, m] * scales[f - 1]
            return tbl, f - 1

        accepted = []  # (i, j, li, r_i, seg_j or None, log_drift or None)
        t_accept0 = time.perf_counter()
        for li, entry in enumerate(loop_pairs):
            i, j = int(entry[0]), int(entry[1])
            n_inl = int(lest.inl[li].sum())
            if n_inl < 16 or i >= p:
                continue
            # Zero-parallax revisit detection.  A coincident-camera pair
            # breaks essential RANSAC STRUCTURALLY: E -> 0, and any skew
            # E = [t]x scores every correspondence as an inlier
            # (q^T [t]x q == 0 identically), so lest.R for such a pair
            # is garbage (measured 90 deg off on a coincident revisit)
            # and its depth gates were a coin flip on f32 rounding.  So
            # the revisit test fits its OWN rotation: Kabsch on the
            # matched unit rays (well-conditioned rotation-only
            # Procrustes, one host-side 3x3 SVD), then gates on the
            # median R-compensated angular disparity.  Below the gate
            # the honest SE(3) measurement is [R_kabsch | 0], and the
            # drift observation is the DIRECT chain-depth ratio
            # (coincident cameras see each shared point at the same
            # physical depth, so chain_i/chain_j is the segments'
            # relative scale error — no loop triangulation involved).
            minl = lest.inl[li] & lbatch.valid[li]
            qa3 = np.concatenate(
                [lbatch.pa[li], np.ones((k_cap, 1), lbatch.pa.dtype)], 1)
            qb3 = np.concatenate(
                [lbatch.pb[li], np.ones((k_cap, 1), lbatch.pb.dtype)], 1)
            qa3 = qa3 / np.linalg.norm(qa3, axis=1, keepdims=True)
            qb3 = qb3 / np.linalg.norm(qb3, axis=1, keepdims=True)
            B = (qb3 * minl[:, None]).T @ qa3  # sum_i qb qa^T over inliers
            U, _, Vt = np.linalg.svd(B)
            R_rv = U @ np.diag([1.0, 1.0, np.linalg.det(U @ Vt)]) @ Vt
            disp = np.linalg.norm(np.cross(qa3 @ R_rv.T, qb3), axis=1)
            d_med = float(np.median(disp[minl])) if minl.any() else np.inf
            if d_med < config.revisit_disparity_max:
                seg_j = log_drift = None
                lidx = lbatch.idx_b[li]
                tbl_j, seg = chain_depth_table(j)
                m3 = (
                    est.inl[i] & lest.inl[li] & (lidx >= 0)
                    & (lidx < k_cap) & (est.depths_a[i] > 1e-6)
                )
                if len(entry) <= 5:
                    m3 = np.zeros_like(m3)
                d_i = est.depths_a[i] * scales[i]
                d_j = np.where(m3, tbl_j[np.clip(lidx, 0, k_cap - 1)],
                               np.nan)
                lrv = np.log(np.abs(d_i / d_j))
                ok3 = m3 & np.isfinite(lrv) & (d_j > 1e-6)
                if ok3.sum() >= 8:
                    med = float(np.median(lrv[ok3]))
                    if float(np.median(np.abs(lrv[ok3] - med))) \
                            <= config.loop_ratio_mad_max:
                        seg_j = seg
                        log_drift = med
                accepted.append((i, j, li, (0.0, R_rv), seg_j, log_drift))
                if len(entry) > 5:
                    ba_loop_links.append((
                        i, j, lbatch.pa[li], lbatch.pb[li],
                        lest.inl[li] & lbatch.valid[li], lbatch.idx_b[li],
                    ))
                continue
            # frame-i depths from the odometry chain, at chained scale
            m = (
                est.inl[i]
                & lest.inl[li]
                & (est.depths_a[i] > 1e-6)
                & (lest.depths_a[li] > 1e-6)
            )
            if m.sum() < 8:
                continue
            lr = np.log(est.depths_a[i, m] * scales[i]
                        / lest.depths_a[li, m])
            mad = float(np.median(np.abs(lr - np.median(lr))))
            if mad > config.loop_ratio_mad_max:
                # Dispersed depth ratios mean the loop pair's geometry is
                # inconsistent with the chain (a degenerate RANSAC model
                # can carry many inliers) — drop the hypothesis.
                continue
            r_i = float(np.exp(np.median(lr)))
            # Relative drift observation r_i/r_j needs frame-j chain
            # depths linked through the loop's REAL idx_b.  A 5-tuple
            # loop entry has no idx_b — _as_pair_batch fabricates an
            # identity mapping for it, which would pair unrelated
            # keypoint slots here, so the drift observation is skipped
            # for such entries (the loop still contributes its SE(3)
            # edge and r_i scale below).  Slots whose idx_b lies beyond
            # the main batch's capacity (a truncated wider loop pair)
            # are masked out rather than clipped onto slot k_cap-1,
            # which holds an unrelated keypoint's depth.
            seg_j = log_drift = None
            lidx = lbatch.idx_b[li]
            tbl_j, seg = chain_depth_table(j)
            m2 = (lest.inl[li] & (lidx >= 0) & (lidx < k_cap)
                  & (lest.depths_b[li] > 1e-6))
            if len(entry) <= 5:
                m2 = np.zeros_like(m2)
            d_chain_j = np.where(m2, tbl_j[np.clip(lidx, 0, k_cap - 1)],
                                 np.nan)
            ok2 = np.isfinite(d_chain_j) & m2
            if ok2.sum() >= 8:
                lrj = np.log(d_chain_j[ok2] / lest.depths_b[li, ok2])
                if float(np.median(np.abs(lrj - np.median(lrj)))) \
                        <= config.loop_ratio_mad_max:
                    r_j = float(np.exp(np.median(lrj)))
                    seg_j = seg
                    log_drift = float(np.log(r_i / r_j))
            accepted.append((i, j, li, r_i, seg_j, log_drift))
            if len(entry) > 5:
                # Real frame-j slot linkage: this loop's inlier
                # correspondences become long-range BA track links
                # (fabricated identity idx_b of a 5-tuple would pair
                # unrelated keypoints).
                ba_loop_links.append((
                    i, j, lbatch.pa[li], lbatch.pb[li],
                    lest.inl[li] & lbatch.valid[li], lbatch.idx_b[li],
                ))

        if stage_times is not None:
            stage_times["loop_accept_host"] = (
                stage_times.get("loop_accept_host", 0.0)
                + time.perf_counter() - t_accept0)

        # Per-segment scale-drift correction from the loops' relative
        # drift observations (linear LS; segment 0 is the gauge).
        c = np.ones(p)
        cons = [(i, sj, ld) for (i, _, _, _, sj, ld) in accepted
                if sj is not None and i != sj]
        if cons:
            ci = np.array([x[0] for x in cons], np.int32)
            cj = np.array([x[1] for x in cons], np.int32)
            cl = np.array([x[2] for x in cons])
            with _staged(stage_times, "scale_drift"):
                log_c = np.asarray(posegraph.solve_scale_drift(
                    p, jnp.asarray(ci), jnp.asarray(cj), jnp.asarray(cl),
                    jnp.ones(len(cons)),
                ))
            c = np.exp(log_c)
            # re-integrate the chain with drift divided out
            poses = [np.eye(4)]
            for k in range(p):
                rel = rels[k].copy()
                rel[:3, 3] = rel[:3, 3] / c[k]
                rels[k] = rel
                edge_T[k] = rel
                poses.append(poses[-1] @ rel)
            poses = np.stack(poses)

        for (i, j, li, r_i, seg_j, log_drift) in accepted:
            if j - i < config.loop_edge_min_gap:
                # No SE(3) edge, but the pair's drift observation (if
                # any) already entered solve_scale_drift above and may
                # have reshaped the whole chain — record it so the
                # metrics stream explains every applied correction.
                if metrics is not None:
                    metrics.append({
                        "pair": (i, j), "loop_closure": True,
                        "edge_added": False,
                        "matches": int(lbatch.valid[li].sum()),
                        "inliers": int(lest.inl[li].sum()),
                        "log_drift": log_drift,
                    })
                continue
            if isinstance(r_i, tuple):
                # zero-parallax revisit: rotation from the Kabsch fit,
                # translation pinned to zero (baseline unobservable)
                s_loop = 0.0
                R_edge = r_i[1]
            else:
                s_loop = r_i / c[i]
                R_edge = lest.R[li]
            Tji = np.eye(4)
            Tji[:3, :3] = R_edge
            Tji[:3, 3] = lest.t_unit[li] * s_loop
            edge_i.append(i)
            edge_j.append(j)
            edge_T.append(np.linalg.inv(Tji))  # measured T_i^-1 T_j
            edge_w.append(config.loop_edge_weight)
            if metrics is not None:
                metrics.append({
                    "pair": (i, j), "loop_closure": True,
                    "edge_added": True,
                    "matches": int(lbatch.valid[li].sum()),
                    "inliers": int(lest.inl[li].sum()), "scale": s_loop,
                    "log_drift": log_drift,
                })

    if loop_pairs and len(edge_i) > n - 1:
        # Relative-rotation graph for BA's rotation-averaging stage: the
        # SAME vetted edge set the pose graph uses (odometry + far-gap
        # accepted loops).  Short-gap loops are deliberately excluded:
        # measured on the staged circuit, their two-view rotations carry
        # 5+ deg median error (degenerate near-identical views), and
        # feeding them to the averaging stage DEGRADED absolute rotations
        # (3.5 deg out vs 1.1 deg with the vetted set) — enough to trap
        # BA again (posegraph.rotation_average docstring).
        rot_edges = (
            list(edge_i), list(edge_j),
            [np.asarray(T)[:3, :3] for T in edge_T], list(edge_w),
        )

    poses_j = jnp.asarray(poses)  # float32 unless x64 is enabled
    g = posegraph.PoseGraph(
        poses=poses_j,
        edge_i=jnp.asarray(edge_i, jnp.int32),
        edge_j=jnp.asarray(edge_j, jnp.int32),
        edge_T=jnp.asarray(np.stack(edge_T), poses_j.dtype),
        edge_valid=jnp.ones(len(edge_i), bool),
        edge_weight=jnp.asarray(edge_w, poses_j.dtype),
    )
    has_loops = len(edge_i) > n - 1
    with _staged(stage_times, "pose_graph"):
        opt_poses, _ = posegraph.optimize(
            g,
            config.loop_pose_graph_iters if has_loops
            else config.pose_graph_iters,
            "dense",
            robust_delta=config.loop_robust_delta if has_loops else 0.0,
        )
        result = np.asarray(opt_poses)
    if _internals is not None:
        _internals.update(batch=batch, est=est, graph_poses=result.copy(),
                          loop_links=list(ba_loop_links),
                          edges=(list(edge_i), list(edge_j), list(edge_T),
                                 list(edge_w)))
    if ba_refine:
        result = refine_with_ba(result, batch, est, mesh=mesh,
                                loop_links=ba_loop_links or None,
                                graph_edges=rot_edges,
                                stage_times=stage_times)
    return result


def frontend_features(
    frames: List[np.ndarray], config: VOConfig
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Detect+describe every frame in ONE batched dispatch; returns
    device-resident (xy, desc, dvalid).  Compute this once per sequence
    and pass it to both `frontend_matches` and `propose_loop_closures` —
    round 4 ran the full detect+describe TWICE per pipeline (VERDICT r4
    weak #1: `propose_loop_closures` re-featurized frames that
    `frontend_matches` had just featurized).

    ``frames`` may be a host frame list OR an already-device-resident
    (F, H, W) u8 stack (streaming deployments stage uploads ahead —
    serving.DetectorPipeline's pattern; tools/vo_bench.py --resident
    measures the pipeline with the transfer excluded)."""
    if isinstance(frames, jax.Array):
        stack = frames
    else:
        stack = jnp.asarray(np.stack(frames))
    return _frontend_features(stack, config)


def frontend_matches(
    frames: List[np.ndarray], config: VOConfig,
    features: Optional[Tuple[jax.Array, jax.Array, jax.Array]] = None,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """Run the device front-end over a frame list; returns per-consecutive-
    pair (pa, pb, valid, idx_b) in normalized camera coordinates, where
    slot i is frame k's keypoint slot i and idx_b the matched keypoint
    slot of frame k+1 (exact track linkage for scale chaining).

    Batched: ONE dispatch detects+describes every frame, one vmapped
    dispatch matches all consecutive pairs — per-frame dispatches would
    each pay a host round trip.  ``features`` supplies the
    per-frame (xy, desc, dvalid) from `frontend_features` to avoid
    re-running detection when the caller also proposes loop closures."""
    xy, desc, dvalid = (features if features is not None
                        else frontend_features(frames, config))

    def pair_match(kxy_a, da, va, kxy_b, db, vb):
        m = match.match.__wrapped__(da, va, db, vb)
        pa, pb, ok = match.match_points(kxy_a, kxy_b, m)
        na = twoview.normalize_points(pa.astype(jnp.float32), config.camera)
        nb = twoview.normalize_points(pb.astype(jnp.float32), config.camera)
        return na, nb, ok, m.idx_b

    na, nb, ok, idx = jax.jit(jax.vmap(pair_match))(
        xy[:-1], desc[:-1], dvalid[:-1],
        xy[1:], desc[1:], dvalid[1:],
    )
    na, nb, ok, idx = jax.device_get((na, nb, ok, idx))
    return [(na[k], nb[k], ok[k], idx[k]) for k in range(len(frames) - 1)]


def _frontend_features(stack: jax.Array, config: VOConfig):
    """Per-frame keypoint coordinates + descriptors + validity for a
    (F, H, W) stack: single-scale (brief) or multi-scale (pyramid) per
    ``config.pyramid_levels``.  Multi-scale slots concatenate the levels
    (coordinates at level-0 resolution), so matching — and slam's exact
    slot-index linkage — runs over the union of scales."""
    if config.pyramid_levels > 1:
        from . import pyramid

        k_per = max(1, config.max_keypoints // config.pyramid_levels)

        def one(im):
            f = pyramid.detect_and_describe_multiscale(
                im, config.threshold, config.count, k_per,
                n_levels=config.pyramid_levels,
            )
            return f.xy0, f.desc, f.valid

        return jax.vmap(one)(stack)
    kps, desc, dvalid = brief.detect_and_describe_batch(
        stack, config.threshold, config.count, config.max_keypoints
    )
    return kps.xy, desc, dvalid


@jax.jit
def _frame_signatures(desc: jax.Array, dvalid: jax.Array) -> jax.Array:
    """Pooled per-frame descriptor signature: mean of each BRIEF bit over
    the frame's valid keypoints — a (F, 256) float "bag of bits".  Frames
    seeing the same scene share bit statistics (each BRIEF bit is an
    intensity comparison anchored to repeatable corners), so signature
    similarity is a cheap whole-frame pre-gate for loop-closure matching.
    """
    f, k, w = desc.shape
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = ((desc[..., None] >> shifts) & jnp.uint32(1)).astype(jnp.float32)
    bits = bits.reshape(f, k, w * 32)
    wgt = dvalid.astype(jnp.float32)
    s = (bits * wgt[..., None]).sum(axis=1)
    return s / jnp.maximum(wgt.sum(axis=1), 1.0)[..., None]


def propose_loop_closures(
    frames: List[np.ndarray],
    config: VOConfig,
    gap: int = 5,
    min_matches: int = 60,
    chunk: int = 128,
    top_k: Optional[int] = None,
    features: Optional[Tuple[jax.Array, jax.Array, jax.Array]] = None,
) -> List[Tuple[int, int, np.ndarray, np.ndarray, np.ndarray]]:
    """Descriptor-based loop-closure candidates: match frame pairs at
    least ``gap`` apart.  One batched detect+describe dispatch, then vmapped
    match dispatches over the candidate pairs in fixed-size chunks of
    ``chunk`` (the (C, K, K) Hamming-distance intermediates grow
    quadratically in K — one flat dispatch over all O(F^2) candidates is
    multi-GB at F=60, K=1024; 128-pair chunks keep that at ~134 MB of
    device memory with few dispatches per sequence); pairs with enough mutual
    matches become
    (i, j, pa, pb, valid, idx_b) constraints for `run_vo_matches`.
    Returned slots are frame-i keypoint slots and idx_b the matched
    frame-j keypoint slot, as the loop scale-drift linkage requires.

    ``top_k`` gates the O(F^2) pair enumeration with a frame-level
    signature ranking (VERDICT r3 #2): each frame i only Hamming-matches
    its ``top_k`` most signature-similar partners j >= i + gap, making
    candidate matching O(F * top_k).  None = auto (exhaustive up to 64
    frames, top_k=8 beyond); 0 forces exhaustive.

    ``features`` supplies precomputed per-frame (xy, desc, dvalid) from
    `frontend_features`, skipping the detect+describe dispatch."""
    f = len(frames)
    if top_k is None:
        top_k = 0 if f <= 64 else 8
    xy, desc, dvalid = (features if features is not None
                        else frontend_features(frames, config))
    if top_k:
        sig = np.asarray(_frame_signatures(desc, dvalid))
        sig = sig - sig.mean(axis=0)  # center: shared-background bits
        nrm = np.linalg.norm(sig, axis=1)
        sim = (sig @ sig.T) / np.maximum(np.outer(nrm, nrm), 1e-9)
        cand = []
        for i in range(f):
            js = np.arange(i + gap, f)
            if js.size == 0:
                continue
            order = js[np.argsort(-sim[i, js])][: int(top_k)]
            cand.extend((i, int(j)) for j in np.sort(order))
    else:
        cand = [(i, j) for i in range(f) for j in range(i + gap, f)]
    if not cand:
        return []
    ii = np.asarray([c[0] for c in cand])
    jj = np.asarray([c[1] for c in cand])

    def pair_match(kxy_a, da, va, kxy_b, db, vb):
        m = match.match.__wrapped__(da, va, db, vb)
        pa, pb, ok = match.match_points(kxy_a, kxy_b, m)
        na = twoview.normalize_points(pa.astype(jnp.float32), config.camera)
        nb = twoview.normalize_points(pb.astype(jnp.float32), config.camera)
        return na, nb, ok, m.idx_b

    matcher = jax.jit(jax.vmap(pair_match))
    # Pad the last chunk to the full chunk size so every dispatch shares
    # one compiled program (a new chunk length is a new XLA program).
    n = len(cand)
    pad_to = min(chunk, n) if n <= chunk else chunk
    na_parts, nb_parts, ok_parts, idx_parts = [], [], [], []
    for s in range(0, n, chunk):
        sel = np.arange(s, min(s + chunk, n))
        if len(sel) < pad_to:
            sel = np.concatenate(
                [sel, np.full(pad_to - len(sel), sel[-1])])
        cna, cnb, cok, cidx = jax.device_get(matcher(
            xy[ii[sel]], desc[ii[sel]], dvalid[ii[sel]],
            xy[jj[sel]], desc[jj[sel]], dvalid[jj[sel]],
        ))
        take = min(s + chunk, n) - s
        na_parts.append(cna[:take])
        nb_parts.append(cnb[:take])
        ok_parts.append(cok[:take])
        idx_parts.append(cidx[:take])
    na = np.concatenate(na_parts)
    nb = np.concatenate(nb_parts)
    ok = np.concatenate(ok_parts)
    idx = np.concatenate(idx_parts)
    counts = ok.sum(axis=1)
    return [
        (int(ii[c]), int(jj[c]), na[c], nb[c], ok[c], idx[c])
        for c in range(len(cand))
        if counts[c] >= min_matches
    ]


def run_vo_images(
    frames: List[np.ndarray],
    config: VOConfig,
    *,
    loop_closure_gap: Optional[int] = None,
    metrics: Optional[list] = None,
    ba_refine: bool = False,
) -> np.ndarray:
    """Full pipeline: images -> trajectory (F, 4, 4); with
    ``loop_closure_gap`` set, distant frame pairs are matched and added as
    pose-graph constraints.  Frames are detected+described ONCE; the
    features feed both consecutive-pair matching and loop proposal."""
    feats = frontend_features(frames, config)
    loops = (
        propose_loop_closures(frames, config, gap=loop_closure_gap,
                              features=feats)
        if loop_closure_gap
        else None
    )
    return run_vo_matches(
        frontend_matches(frames, config, features=feats), config,
        loop_pairs=loops, metrics=metrics, ba_refine=ba_refine,
    )


def build_tracks(
    batch: PairBatch,
    est: PairEstimates,
    min_len: int = 3,
    loop_links: Optional[Sequence[Tuple[int, int, np.ndarray, np.ndarray,
                                        np.ndarray, np.ndarray]]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Link pair-wise inlier correspondences into multi-frame tracks.

    Linking is exact: pair k's inlier slot i observes frame k at keypoint
    slot i and frame k+1 at keypoint slot idx_b[k, i], so track identity
    propagates through (frame, slot) integer keys — no coordinate keys.

    ``loop_links`` — (i, j, pa, pb, inl, idx_b) per accepted loop pair —
    adds the LONG-RANGE links: loop slot s joins frame-i keypoint slot s
    to frame-j keypoint slot idx_b[s].  A loop link can merge two tracks
    that already exist on distant chain segments, so identity is resolved
    by union-find over the (frame, slot) nodes rather than sequential
    propagation (VERDICT r3 #1: without these links, loop-pair
    correspondences never became BA observations and BA structurally
    could not out-resolve the loop-closed pose graph it started from).

    A component observing one frame at two DIFFERENT keypoint slots is
    physically impossible (one 3-D point, one image) and marks a wrong
    link — such tracks are dropped whole.

    Returns flat observation arrays (obs_cam, obs_lm, obs_uv), sorted by
    (track, frame), for tracks observed in >= ``min_len`` frames.
    """
    p, k_cap = est.inl.shape
    empty = (np.zeros(0, np.int32), np.zeros(0, np.int32), np.zeros((0, 2)))

    parent: List[int] = []
    uv_list: List[np.ndarray] = []
    frame_list: List[int] = []
    node_id: dict = {}

    def get_node(f: int, s: int, uv) -> int:
        nid = node_id.get((f, s))
        if nid is None:
            nid = len(parent)
            node_id[(f, s)] = nid
            parent.append(nid)
            uv_list.append(uv)
            frame_list.append(f)
        return nid

    def find(a: int) -> int:
        root = a
        while parent[root] != root:
            root = parent[root]
        while parent[a] != root:  # path compression
            parent[a], a = root, parent[a]
        return root

    def union(a: int, b: int) -> None:
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[ra] = rb

    for k in range(p):
        m = est.inl[k] & (batch.idx_b[k] >= 0)
        for s in np.nonzero(m)[0]:
            union(get_node(k, int(s), batch.pa[k, s]),
                  get_node(k + 1, int(batch.idx_b[k, s]), batch.pb[k, s]))
    for (i, j, lpa, lpb, linl, lidx) in (loop_links or ()):
        m = np.asarray(linl, bool) & (np.asarray(lidx) >= 0)
        for s in np.nonzero(m)[0]:
            union(get_node(int(i), int(s), lpa[s]),
                  get_node(int(j), int(lidx[s]), lpb[s]))

    n_nodes = len(parent)
    if n_nodes == 0:
        return empty
    roots = np.fromiter((find(x) for x in range(n_nodes)), np.int64, n_nodes)
    frames = np.asarray(frame_list, np.int64)
    _, tid = np.unique(roots, return_inverse=True)
    n_tracks = int(tid.max()) + 1

    order = np.lexsort((frames, tid))
    t_sorted = tid[order]
    f_sorted = frames[order]
    # same track AND same frame in adjacent sorted rows -> conflicting
    # double observation of one frame -> whole track inconsistent
    dup = np.zeros(n_nodes, bool)
    dup[1:] = (t_sorted[1:] == t_sorted[:-1]) & (f_sorted[1:] == f_sorted[:-1])
    track_bad = np.zeros(n_tracks, bool)
    np.logical_or.at(track_bad, t_sorted[dup], True)

    counts = np.bincount(tid, minlength=n_tracks)
    keep = (~track_bad) & (counts >= min_len)
    remap = -np.ones(n_tracks, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    sel = keep[t_sorted]
    uv_arr = np.asarray(uv_list, np.float64).reshape(-1, 2)[order]
    return (
        f_sorted[sel].astype(np.int32),
        remap[t_sorted[sel]].astype(np.int32),
        uv_arr[sel],
    )


def triangulate_tracks(
    w2c: np.ndarray, obs_cam: np.ndarray, obs_lm: np.ndarray,
    obs_uv: np.ndarray, n_lm: int,
) -> np.ndarray:
    """Multi-view DLT triangulation of every track at once.

    Each observation contributes two homogeneous rows
    ``u*(P·X)_z - (P·X)_x`` / ``v*(P·X)_z - (P·X)_y`` (P = w2c[:3, :],
    K = I in normalized coordinates); per track the 4x4 normal matrix
    M = sum a a^T accumulates by segment sum, and X is the smallest-
    eigenvalue eigenvector of M.  Using ALL observations matters for
    loop tracks: their first/last frames sit at a revisit (tiny
    baseline), so any fixed two-view choice can be degenerate, while the
    mid-track views always span the real baseline."""
    Pm = w2c[obs_cam][:, :3, :]  # (O, 3, 4)
    r1 = obs_uv[:, 0, None] * Pm[:, 2] - Pm[:, 0]
    r2 = obs_uv[:, 1, None] * Pm[:, 2] - Pm[:, 1]
    rows = np.stack([r1, r2], axis=1)  # (O, 2, 4)
    M = np.zeros((n_lm, 4, 4))
    np.add.at(M, obs_lm, np.einsum("ori,orj->oij", rows, rows))
    _, V = np.linalg.eigh(M)
    X = V[..., 0]  # eigh sorts ascending: column 0 = smallest eigenvalue
    w = X[:, 3]
    w = np.where(np.abs(w) < 1e-9, np.where(w < 0, -1e-9, 1e-9), w)
    return X[:, :3] / w[:, None]


def refine_with_ba(
    poses: np.ndarray,
    batch: PairBatch,
    est: PairEstimates,
    iterations: int = 8,
    cg_iters: int = 30,
    mesh=None,
    windowed_threshold: int = 16,
    window: int = 8,
    stride: int = 5,
    loop_links=None,
    graph_edges=None,
    robust_delta: float = 0.01,
    loop_ba_rounds: int = 2,
    loop_ba_iters: int = 20,
    loop_cg_iters: int = 40,
    stage_times: Optional[dict] = None,
) -> np.ndarray:
    """Structure-from-motion refinement of a VO trajectory: build tracks
    (including loop-pair links), triangulate landmarks from the current
    poses, run Schur-complement BA (camera 0 gauge-fixed), return refined
    world_T_cam poses.

    Routing (VERDICT r3 #1 — BA must be the most ACCURATE stage):

    * WITH loop links: (1) rotation averaging over ``graph_edges``
      (posegraph.rotation_average) replaces the absolute rotations —
      the SE(3) pose graph's rotations carry scale-noise leakage that
      traps BA in a deformed minimum, while averaged rotations land
      inside the true basin; then (2) ``loop_ba_rounds`` rounds of
      {multi-view re-triangulation -> per-observation gating -> global
      Huber-IRLS BA}.  Global, not windowed: the long-range loop tracks
      are exactly the constraints a rigid window stitch cannot express.
      Measured on the staged 32-frame circuit: 1.82% (loop graph) ->
      0.80% ATE.
    * WITHOUT loops, >= ``windowed_threshold`` frames: sliding-window BA
      (models.windowed_ba) — overlapping ``window``-camera subproblems
      refine as one vmapped batch, sharded over the mesh's data axis
      when a mesh is given (sequence parallelism, SURVEY.md §5.7), and
      stitch back rigidly.
    * short loop-free trajectories: one global plain BA.

    With ``mesh`` the global solves run distributed (observations
    sharded, psum Schur reductions, parallel.ba_sharded)."""
    with _staged(stage_times, "tracks_host"):
        obs_cam, obs_lm, obs_uv = build_tracks(batch, est,
                                               loop_links=loop_links)
    if obs_lm.size == 0:
        return poses
    n_lm = int(obs_lm.max()) + 1

    def gated_problem(cur_poses: np.ndarray):
        """(w2c, pts, per-obs validity) under the current trajectory.

        Culling is PER-OBSERVATION (a track survives while >= 2
        observations do): whole-track culling silently deleted most long
        loop tracks, whose far endpoint naturally reprojects worst under
        the not-yet-refined trajectory — the very observations BA needs.
        """
        w2c = np.linalg.inv(cur_poses)
        pts = triangulate_tracks(w2c, obs_cam, obs_lm, obs_uv, n_lm)
        Xc = np.einsum("oij,oj->oi", w2c[obs_cam][:, :3, :3], pts[obs_lm]) \
            + w2c[obs_cam][:, :3, 3]
        depth_ok = Xc[:, 2] > 1e-3
        proj = Xc[:, :2] / np.maximum(Xc[:, 2:3], 1e-9)
        err = np.linalg.norm(proj - obs_uv, axis=1)
        obs_ok = depth_ok & (err < 0.02)
        n_valid = np.bincount(obs_lm[obs_ok], minlength=n_lm)
        return w2c, pts, obs_ok & (n_valid >= 2)[obs_lm]

    def solve(w2c, pts, valid, iters, cg, delta):
        problem = ba_lib.BAProblem(
            poses=jnp.asarray(w2c),
            points=jnp.asarray(pts),
            obs_cam=jnp.asarray(obs_cam),
            obs_lm=jnp.asarray(obs_lm),
            obs_uv=jnp.asarray(obs_uv),
            obs_valid=jnp.asarray(valid),
            # Only camera 0 is hard-fixed: pinning a second (noisy)
            # camera would anchor BA to its error.  The remaining scale
            # gauge is a damped null direction (monocular ATE is
            # scale-aligned anyway).
            n_fixed_cams=1,
        )
        if mesh is not None:
            from ..parallel import ba_sharded

            new_w2c, _, _ = ba_sharded.optimize_sharded(
                problem, None, iters, cg, 1e-4, delta, mesh=mesh
            )
        else:
            new_w2c, _, _ = ba_lib.optimize(problem, iters, cg, 1e-4, delta)
        return np.linalg.inv(np.asarray(new_w2c))

    n_cams = poses.shape[0]
    has_loops = loop_links is not None and len(loop_links) > 0

    if has_loops:
        cur = np.array(poses)
        if graph_edges is not None:
            with _staged(stage_times, "rotation_avg"):
                ei, ej, eR, ew = graph_edges
                eR = np.asarray([np.asarray(R)[:3, :3] for R in eR])
                Rw = np.asarray(posegraph.rotation_average(
                    jnp.asarray(cur[:, :3, :3], jnp.float32),
                    jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
                    jnp.asarray(eR, jnp.float32),
                    jnp.asarray(ew, jnp.float32),
                ))
                cur[:, :3, :3] = Rw
        for _ in range(int(loop_ba_rounds)):
            with _staged(stage_times, "triangulate_gate_host"):
                w2c, pts, valid = gated_problem(cur)
            with _staged(stage_times, "ba_solve"):
                cur = solve(w2c, pts, valid, int(loop_ba_iters),
                            int(loop_cg_iters), float(robust_delta))
        return cur

    with _staged(stage_times, "triangulate_gate_host"):
        w2c, pts, valid = gated_problem(poses)
    if n_cams >= int(windowed_threshold):
        # Sequence-parallel route: culled observations feed the sliding-
        # window builder; windows refine as one (mesh-shardable) batch.
        from . import windowed_ba

        sel = np.nonzero(valid)[0]
        with _staged(stage_times, "ba_solve"):
            new_w2c = windowed_ba.refine_trajectory_windowed(
                w2c, pts, obs_cam[sel], obs_lm[sel],
                np.asarray(obs_uv)[sel], window=int(window),
                stride=int(stride), iterations=int(iterations), mesh=mesh,
            )
        return np.linalg.inv(np.asarray(new_w2c))

    with _staged(stage_times, "ba_solve"):
        return solve(w2c, pts, valid, int(iterations), int(cg_iters), 0.0)


def evaluate_ate(
    est_poses: np.ndarray, gt_poses: np.ndarray
) -> float:
    """Scale-aligned ATE RMSE between world_T_cam trajectories."""
    return ate_rmse(est_poses[:, :3, 3], gt_poses[:, :3, 3], align=True,
                    with_scale=True)
