"""Distributed bundle adjustment: observations sharded over the mesh,
Schur-complement reductions as psum collectives.

This is the BASELINE.json north_star's distributed layer: keyframes/map
observations partition across devices; each device computes its local
Jacobian/segment partials; `psum` across devices assembles the global
normal equations; every device then runs the identical (replicated)
CG on the reduced camera system, so poses/points stay consistent with no
parameter server.

Implementation: `models.ba.ba_step` already takes a `psum` hook at every
segment reduction; here we wrap it in `shard_map` with observations
sharded on the `data` axis and states replicated.  Determinism note:
psum-of-partials changes floating-point summation order vs single-device,
so equivalence is to numerical tolerance, not bit-exact (SURVEY.md §7 v —
the parity bound for distributed BA is ATE-based by design).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

from ..models import ba as ba_lib
from . import mesh as meshlib


def pad_observations(p: ba_lib.BAProblem, multiple: int) -> ba_lib.BAProblem:
    """Pad the observation arrays to a device-count multiple with invalid
    slots (cap-style padding keeps shard shapes equal)."""
    o = p.obs_cam.shape[0]
    pad = (-o) % multiple
    if pad == 0:
        return p
    z = lambda a, fill: jnp.concatenate(
        [a, jnp.full((pad,) + a.shape[1:], fill, a.dtype)]
    )
    return p._replace(
        obs_cam=z(p.obs_cam, 0),
        obs_lm=z(p.obs_lm, 0),
        obs_uv=z(p.obs_uv, 0.0),
        obs_valid=z(p.obs_valid, False),
    )


def ba_step_sharded(
    p: ba_lib.BAProblem, mesh: Mesh, damping: float = 1e-6, cg_iters: int = 30,
    robust_delta: float = 0.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One distributed Gauss-Newton/Schur step.

    Observations shard over the `data` mesh axis; poses and points are
    replicated.  Returns (new_poses, new_points, cost) — identical on all
    devices.  ``robust_delta`` > 0 makes it a Huber-IRLS step (weights are
    per-observation, so sharding is unaffected; see models.ba._jacobians).
    """
    n_dev = mesh.shape[meshlib.DATA_AXIS]
    p = pad_observations(p, n_dev)

    obs_spec = P(meshlib.DATA_AXIS)
    rep = P()

    def local_step(poses, points, obs_cam, obs_lm, obs_uv, obs_valid, nf):
        lp = ba_lib.BAProblem(
            poses, points, obs_cam, obs_lm, obs_uv, obs_valid, nf
        )
        psum = lambda x: jax.lax.psum(x, meshlib.DATA_AXIS)
        return ba_lib.ba_step(lp, damping, cg_iters, psum=psum,
                              robust_delta=robust_delta)

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(rep, rep, obs_spec, obs_spec, obs_spec, obs_spec, rep),
        out_specs=(rep, rep, rep),
    )
    nf = jnp.asarray(p.n_fixed_cams, jnp.int32)
    return fn(p.poses, p.points, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_valid, nf)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5),
                   static_argnames=("mesh",))
def optimize_sharded(
    p: ba_lib.BAProblem,
    key_unused=None,
    iterations: int = 8,
    cg_iters: int = 30,
    damping: float = 1e-6,
    robust_delta: float = 0.0,
    *,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Distributed LM-damped BA loop (jitted once per mesh/shape).
    ``robust_delta`` > 0: Huber-IRLS steps, acceptance guarded on the
    true Huber objective (mirrors models.ba.optimize)."""

    def step(carry, _):
        poses, points = carry
        pp = p._replace(poses=poses, points=points)
        new_poses, new_points, cost = ba_step_sharded(
            pp, mesh, damping, cg_iters, robust_delta
        )
        if robust_delta > 0.0:
            cost = ba_lib.total_cost(pp, robust_delta)
        c_new = ba_lib.total_cost(
            p._replace(poses=new_poses, points=new_points), robust_delta)
        better = c_new < cost
        poses = jnp.where(better, new_poses, poses)
        points = jnp.where(better, new_points, points)
        return (poses, points), jnp.minimum(c_new, cost)

    (poses, points), costs = jax.lax.scan(
        step, (p.poses, p.points), None, length=iterations
    )
    return poses, points, costs


def ba_step_sharded2d(
    p: ba_lib.BAProblem, mesh: Mesh, damping: float = 1e-6, cg_iters: int = 30,
    robust_delta: float = 0.0,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """One Gauss-Newton/Schur step on a 2-D (data x model) mesh.

    Observations shard over `data`; LANDMARK STATE (points, Hll blocks,
    back-substitution) shards over `model` — the reduced camera system is
    assembled with psum over both axes, while landmark-side reductions
    psum over `data` only (each landmark lives on exactly one model
    shard).  This is the "Schur-complement reduced camera system sharded
    over mesh axes" layout (SURVEY.md §2.9): camera state replicates
    (small), map state partitions (large).

    Returns (new_poses replicated, new_points gathered (L, 3), cost).
    """
    n_data = mesh.shape[meshlib.DATA_AXIS]
    n_model = mesh.shape[meshlib.MODEL_AXIS]
    p = pad_observations(p, n_data)

    # pad landmarks to a model-shard multiple (padded landmarks have no
    # observations; their damped Hll is invertible and their delta is 0)
    L = p.points.shape[0]
    pad_l = (-L) % n_model
    points = jnp.concatenate(
        [p.points, jnp.zeros((pad_l, 3), p.points.dtype)]
    ) if pad_l else p.points
    l_shard = (L + pad_l) // n_model

    obs_spec = P(meshlib.DATA_AXIS)
    rep = P()

    def local_step(poses, pts_local, oc, ol, uv, valid, nf):
        m_idx = jax.lax.axis_index(meshlib.MODEL_AXIS)
        off = m_idx * l_shard
        ol_local = ol - off
        mine = (ol_local >= 0) & (ol_local < l_shard) & valid
        ol_safe = jnp.clip(ol_local, 0, l_shard - 1)
        lp = ba_lib.BAProblem(poses, pts_local, oc, ol_safe, uv, mine, nf)
        psum_all = lambda x: jax.lax.psum(
            x, (meshlib.DATA_AXIS, meshlib.MODEL_AXIS))
        psum_data = lambda x: jax.lax.psum(x, meshlib.DATA_AXIS)
        # Huber-IRLS weights are per-observation and every observation
        # is live on exactly one (data, model) cell (`mine`), so the
        # robust path needs no extra collectives.
        return ba_lib.ba_step(lp, damping, cg_iters, psum=psum_all,
                              psum_lm=psum_data, robust_delta=robust_delta)

    fn = shard_map(
        local_step,
        mesh=mesh,
        in_specs=(rep, P(meshlib.MODEL_AXIS), obs_spec, obs_spec, obs_spec,
                  obs_spec, rep),
        out_specs=(rep, P(meshlib.MODEL_AXIS), rep),
    )
    nf = jnp.asarray(p.n_fixed_cams, jnp.int32)
    new_poses, new_points, cost = fn(
        p.poses, points, p.obs_cam, p.obs_lm, p.obs_uv, p.obs_valid, nf
    )
    return new_poses, new_points[:L], cost
