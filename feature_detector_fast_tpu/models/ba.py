"""Bundle adjustment with Schur-complement elimination.

New scope (BASELINE.json north_star: "distributed bundle adjustment with
... the Schur-complement reduction executed via psum/all-gather
collectives").

Problem: camera poses T_c (world->camera, SE3), landmarks X_l (world, 3D),
observations (cam, lm, uv) in normalized image coordinates; minimize
sum ||project(T_c X_l) - uv||^2 with Levenberg damping.

Design — everything is flat per-observation arrays + segment reductions:

  * per-observation residuals and the (2x6, 2x3) Jacobian blocks come from
    one vmapped jacfwd — no hand-derived block algebra,
  * Hll (3x3 per landmark), b_c, b_l accumulate via segment_sum over
    observations,
  * the reduced camera system S = Hcc - W Hll^-1 W^T is never formed:
    CG runs on its matvec, which is two segment reductions per
    application (obs -> landmark, obs -> camera).  Segment reductions over
    sharded observations become psum-of-partials on a device mesh — this
    exact function is reused by parallel.ba_sharded,
  * back-substitution recovers landmark updates from the camera step.

Gauge freedom: camera 0 is held fixed (delta masked), and for monocular
problems the caller should also fix scale (e.g. freeze camera 1's
translation norm or a landmark depth); tests use two fixed cameras.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..utils.precision import matmul_highest
from . import lie


class BAProblem(NamedTuple):
    poses: jax.Array  # (C, 4, 4) world->camera
    points: jax.Array  # (L, 3)
    obs_cam: jax.Array  # (O,) int32
    obs_lm: jax.Array  # (O,) int32
    obs_uv: jax.Array  # (O, 2) normalized image coords
    obs_valid: jax.Array  # (O,) bool
    n_fixed_cams: int = 1  # leading cameras held constant (gauge)


def project(pose: jax.Array, X: jax.Array) -> jax.Array:
    """world->camera pose (4,4), landmark (3,) -> normalized (2,)."""
    pc = lie.se3_apply(pose, X)
    z = jnp.maximum(pc[..., 2], 1e-6)
    return pc[..., :2] / z[..., None]


def _residual_one(delta_c, delta_l, pose, X, uv):
    """Residual of one observation under local updates (6,), (3,)."""
    T = lie.se3_exp(delta_c) @ pose
    return project(T, X + delta_l) - uv


def _jacobians(p: BAProblem, robust_delta: float = 0.0):
    """Per-observation residuals r (O, 2) and Jacobians Jc (O, 2, 6),
    Jl (O, 2, 3) at delta = 0, masked by validity.

    ``robust_delta`` > 0 applies Huber IRLS: residual and Jacobians are
    scaled by sqrt(w) with w = min(1, delta/||r||), so the Gauss-Newton
    normal equations become those of the Huber objective linearized at
    the current weights.  Loop-closure tracks make outlier observations
    structurally more likely (a wrong long-range link is one bad
    correspondence among hundreds of good ones), and a single unmodeled
    outlier measurably drags a whole camera in plain least squares."""
    poses_o = p.poses[p.obs_cam]
    pts_o = p.points[p.obs_lm]
    z6 = jnp.zeros(6, p.poses.dtype)
    z3 = jnp.zeros(3, p.poses.dtype)

    def one(pose, X, uv):
        r = _residual_one(z6, z3, pose, X, uv)
        Jc = jax.jacfwd(lambda d: _residual_one(d, z3, pose, X, uv))(z6)
        Jl = jax.jacfwd(lambda d: _residual_one(z6, d, pose, X, uv))(z3)
        return r, Jc, Jl

    r, Jc, Jl = jax.vmap(one)(poses_o, pts_o, p.obs_uv)
    if robust_delta > 0.0:
        rn = jnp.linalg.norm(r, axis=-1)
        w = jnp.minimum(1.0, robust_delta / jnp.maximum(rn, 1e-12))
        sw = jnp.sqrt(w)
        r = r * sw[:, None]
        Jc = Jc * sw[:, None, None]
        Jl = Jl * sw[:, None, None]
    valid = p.obs_valid
    r = jnp.where(valid[:, None], r, 0.0)
    Jc = jnp.where(valid[:, None, None], Jc, 0.0)
    Jl = jnp.where(valid[:, None, None], Jl, 0.0)
    # gauge: zero out Jacobians of fixed cameras
    free = p.obs_cam >= p.n_fixed_cams
    Jc = jnp.where(free[:, None, None], Jc, 0.0)
    return r, Jc, Jl


def _segment_sum(vals: jax.Array, idx: jax.Array, num: int) -> jax.Array:
    return jnp.zeros((num,) + vals.shape[1:], vals.dtype).at[idx].add(vals)


def _inv33(M: jax.Array) -> jax.Array:
    """Inverse of batched SPD 3x3 matrices via an UNROLLED Cholesky
    factorization (inv = L^-T L^-1) — pure elementwise arithmetic.
    `jnp.linalg.inv` lowers tiny batched inverses through an LU path
    that, like tiny batched SVDs, is slow on accelerators; every BA
    step inverts L damped Hll blocks, so this sits in the Schur hot
    loop.  Cholesky (not the adjugate/determinant closed form) because
    it is backward-stable in f32: the adjugate lost ~1e-3 relative
    accuracy on ill-conditioned damped blocks, which surfaced as a 6e-4
    sharded-vs-single cost divergence in tests/test_ba_sharded.py's f32
    agreement contract.  Callers pass damped (strictly SPD) blocks."""
    a11, a21, a31 = M[..., 0, 0], M[..., 1, 0], M[..., 2, 0]
    a22, a32, a33 = M[..., 1, 1], M[..., 2, 1], M[..., 2, 2]
    tiny = 1e-30
    l11 = jnp.sqrt(jnp.maximum(a11, tiny))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = jnp.sqrt(jnp.maximum(a22 - l21 * l21, tiny))
    l32 = (a32 - l31 * l21) / l22
    l33 = jnp.sqrt(jnp.maximum(a33 - l31 * l31 - l32 * l32, tiny))
    # L^-1 (lower triangular)
    i11 = 1.0 / l11
    i22 = 1.0 / l22
    i33 = 1.0 / l33
    i21 = -l21 * i11 * i22
    i32 = -l32 * i22 * i33
    i31 = (l21 * l32 - l31 * l22) * i11 * i22 * i33
    # inv = L^-T L^-1 (symmetric)
    m11 = i11 * i11 + i21 * i21 + i31 * i31
    m12 = i21 * i22 + i31 * i32
    m13 = i31 * i33
    m22 = i22 * i22 + i32 * i32
    m23 = i32 * i33
    m33 = i33 * i33
    X = jnp.stack([
        jnp.stack([m11, m12, m13], axis=-1),
        jnp.stack([m12, m22, m23], axis=-1),
        jnp.stack([m13, m23, m33], axis=-1),
    ], axis=-2)
    # One Newton-Schulz polish X <- X (2I - M X) (two tiny batched
    # matmuls): quadratically shrinks the f32 factorization residual on
    # the worst-conditioned blocks.
    eye2 = 2.0 * jnp.eye(3, dtype=M.dtype)
    return jnp.einsum("...ij,...jk->...ik", X,
                      eye2 - jnp.einsum("...ij,...jk->...ik", M, X))


class _System(NamedTuple):
    r: jax.Array
    Jc: jax.Array
    Jl: jax.Array
    Hll_inv: jax.Array  # (L, 3, 3) damped inverse
    b_c: jax.Array  # (C, 6)  = Jc^T r per camera
    b_l: jax.Array  # (L, 3)  = Jl^T r per landmark


def _build_system(p: BAProblem, damping, robust_delta: float = 0.0) -> _System:
    r, Jc, Jl = _jacobians(p, robust_delta)
    C = p.poses.shape[0]
    L = p.points.shape[0]
    Hll = _segment_sum(jnp.einsum("oij,oik->ojk", Jl, Jl), p.obs_lm, L)
    Hll = Hll + damping * jnp.eye(3, dtype=Hll.dtype)
    Hll_inv = _inv33(Hll)
    b_c = _segment_sum(jnp.einsum("oij,oi->oj", Jc, r), p.obs_cam, C)
    b_l = _segment_sum(jnp.einsum("oij,oi->oj", Jl, r), p.obs_lm, L)
    return _System(r, Jc, Jl, Hll_inv, b_c, b_l)


def _schur_matvec(sys: _System, p: BAProblem, v: jax.Array, damping,
                  psum=None, psum_lm=None) -> jax.Array:
    """Apply the reduced camera matrix S = Hcc + damp*I - W Hll^-1 W^T to
    v (C, 6).  Two obs->segment reductions.  `psum` reduces camera-side
    partials across ALL shards; `psum_lm` reduces landmark-side partials
    across the shards that replicate a landmark (== psum when landmarks
    are replicated; data-axis-only when landmarks shard over a model
    axis)."""
    C = p.poses.shape[0]
    L = p.points.shape[0]
    psum_lm = psum_lm or psum
    v_o = v[p.obs_cam]  # (O, 6)
    Jc_v = jnp.einsum("oij,oj->oi", sys.Jc, v_o)  # (O, 2)
    # Hcc v (per-camera), as obs partials
    hcc_v = _segment_sum(jnp.einsum("oij,oi->oj", sys.Jc, Jc_v), p.obs_cam, C)
    # W^T v per landmark: Jl^T (Jc v)
    wt_v = _segment_sum(jnp.einsum("oij,oi->oj", sys.Jl, Jc_v), p.obs_lm, L)
    if psum is not None:
        hcc_v = psum(hcc_v)
        wt_v = psum_lm(wt_v)
    u = jnp.einsum("lij,lj->li", sys.Hll_inv, wt_v)  # (L, 3)
    # W u per camera: Jc^T (Jl u)
    Jl_u = jnp.einsum("oij,oj->oi", sys.Jl, u[p.obs_lm])  # (O, 2)
    w_u = _segment_sum(jnp.einsum("oij,oi->oj", sys.Jc, Jl_u), p.obs_cam, C)
    if psum is not None:
        w_u = psum(w_u)
    return hcc_v + damping * v - w_u


def _cg(matvec, b, iters: int):
    x = jnp.zeros_like(b)
    r = b
    p = r
    rs = jnp.sum(r * r)

    def body(i, state):
        x, r, p, rs = state
        ap = matvec(p)
        alpha = rs / jnp.maximum(jnp.sum(p * ap), 1e-20)
        x = x + alpha * p
        r2 = r - alpha * ap
        rs_new = jnp.sum(r2 * r2)
        beta = rs_new / jnp.maximum(rs, 1e-20)
        p2 = r2 + beta * p
        return x, r2, p2, rs_new

    x, _, _, _ = jax.lax.fori_loop(0, iters, body, (x, r, p, rs))
    return x


@matmul_highest
def ba_step(p: BAProblem, damping, cg_iters: int, psum=None, psum_lm=None,
            robust_delta: float = 0.0):
    """One damped Gauss-Newton step via Schur elimination.

    Returns (new_poses, new_points, cost_before).  With `psum`, the
    segment reductions are treated as shard-local partials reduced across
    the mesh (observations sharded; poses replicated).  `psum_lm` (defaults
    to `psum`) reduces landmark-side partials — pass a data-axis-only
    reduction when landmark state shards over a model axis.
    ``robust_delta`` > 0 makes it a Huber-IRLS step (see _jacobians); the
    returned cost is then the IRLS surrogate sum(w r^2), not the Huber
    objective — use `total_cost(p, robust_delta)` to monitor the latter.
    """
    psum_lm = psum_lm or psum
    sys = _build_system(p, damping, robust_delta)
    b_c = sys.b_c
    b_l = sys.b_l
    if psum is not None:
        b_c = psum(b_c)
        b_l = psum_lm(b_l)
        # Hll must also be globally reduced; rebuild inverse from partials.
        L = p.points.shape[0]
        Hll_partial = _segment_sum(
            jnp.einsum("oij,oik->ojk", sys.Jl, sys.Jl), p.obs_lm, L
        )
        Hll = psum_lm(Hll_partial) + damping * jnp.eye(3, dtype=b_l.dtype)
        sys = sys._replace(Hll_inv=_inv33(Hll))

    # reduced rhs: -(b_c - W Hll^-1 b_l)
    u = jnp.einsum("lij,lj->li", sys.Hll_inv, b_l)
    Jl_u = jnp.einsum("oij,oj->oi", sys.Jl, u[p.obs_lm])
    w_u = _segment_sum(jnp.einsum("oij,oi->oj", sys.Jc, Jl_u), p.obs_cam,
                       p.poses.shape[0])
    if psum is not None:
        w_u = psum(w_u)
    rhs = -(b_c - w_u)

    delta_c = _cg(lambda v: _schur_matvec(sys, p, v, damping, psum, psum_lm),
                  rhs, cg_iters)
    # n_fixed_cams may arrive traced (it rides inside the problem pytree),
    # so gauge-fix with a mask rather than a slice.
    cam_free = jnp.arange(p.poses.shape[0]) >= p.n_fixed_cams
    delta_c = jnp.where(cam_free[:, None], delta_c, 0.0)

    # back-substitute landmarks: delta_l = -Hll^-1 (b_l + W^T delta_c)
    Jc_dc = jnp.einsum("oij,oj->oi", sys.Jc, delta_c[p.obs_cam])
    wt_dc = _segment_sum(jnp.einsum("oij,oi->oj", sys.Jl, Jc_dc), p.obs_lm,
                         p.points.shape[0])
    if psum is not None:
        wt_dc = psum_lm(wt_dc)
    delta_l = -jnp.einsum("lij,lj->li", sys.Hll_inv, b_l + wt_dc)

    new_poses = lie.se3_exp(delta_c) @ p.poses
    new_points = p.points + delta_l
    cost = jnp.sum(sys.r * sys.r)
    if psum is not None:
        cost = psum(cost)
    return new_poses, new_points, cost


def _residuals(p: BAProblem) -> jax.Array:
    """Validity-masked residuals (O, 2) without the Jacobian passes."""
    z6 = jnp.zeros(6, p.poses.dtype)
    z3 = jnp.zeros(3, p.poses.dtype)
    r = jax.vmap(
        lambda pose, X, uv: _residual_one(z6, z3, pose, X, uv)
    )(p.poses[p.obs_cam], p.points[p.obs_lm], p.obs_uv)
    return jnp.where(p.obs_valid[:, None], r, 0.0)


@matmul_highest
def total_cost(p: BAProblem, robust_delta: float = 0.0) -> jax.Array:
    """Objective value: plain sum of squares, or the Huber objective when
    ``robust_delta`` > 0 (rho(r) = r^2 for ||r|| < delta, else
    delta*(2||r|| - delta)) — the cost the IRLS steps descend."""
    r = _residuals(p)
    if robust_delta <= 0.0:
        return jnp.sum(r * r)
    rn2 = jnp.sum(r * r, axis=-1)
    rn = jnp.sqrt(jnp.maximum(rn2, 1e-24))
    rho = jnp.where(rn < robust_delta, rn2,
                    robust_delta * (2.0 * rn - robust_delta))
    return jnp.sum(jnp.where(p.obs_valid, rho, 0.0))


@functools.partial(jax.jit, static_argnums=(1, 2, 4))
@matmul_highest
def optimize(p: BAProblem, iterations: int = 10, cg_iters: int = 30,
             damping: float = 1e-4, robust_delta: float = 0.0,
             ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """LM-damped BA.  Returns (poses, points, per-iteration cost).  Steps
    that increase the cost are rejected (damping fixed — simple but
    robust for well-conditioned SLAM windows).  ``robust_delta`` > 0
    switches to Huber-IRLS steps with acceptance guarded on the TRUE
    Huber objective, so every accepted step strictly decreases it."""

    def step(carry, _):
        poses, points = carry
        pp = p._replace(poses=poses, points=points)
        # ba_step already evaluated the residuals of pp while building the
        # system — consume its cost instead of re-running total_cost's
        # Jacobian pass (matches parallel/ba_sharded.optimize_sharded).
        # Under IRLS the surrogate cost is not the objective: both sides
        # of the acceptance test use the Huber objective instead.
        new_poses, new_points, c_old = ba_step(pp, damping, cg_iters,
                                               robust_delta=robust_delta)
        if robust_delta > 0.0:
            c_old = total_cost(pp, robust_delta)
        c_new = total_cost(p._replace(poses=new_poses, points=new_points),
                           robust_delta)
        better = c_new < c_old
        poses = jnp.where(better, new_poses, poses)
        points = jnp.where(better, new_points, points)
        return (poses, points), jnp.minimum(c_new, c_old)

    (poses, points), costs = jax.lax.scan(
        step, (p.poses, p.points), None, length=iterations
    )
    return poses, points, costs
