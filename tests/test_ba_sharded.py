"""Distributed BA on the spoofed 8-device CPU mesh: collective-math
equivalence with the single-device optimizer (SURVEY.md §4)."""

import jax
import numpy as np
import pytest

#: Fast-lane exclusion (VERDICT r3 #7): this module is SLAM/distributed-
#: heavy; `pytest -m 'not slow'` skips it for kernel iteration.
pytestmark = pytest.mark.slow

import jax.numpy as jnp

from feature_detector_fast_tpu.models import ba
from feature_detector_fast_tpu.parallel import ba_sharded, mesh as meshlib
from test_ba import make_ba_problem


@pytest.fixture(autouse=True)
def _x64(x64):
    """Strict sharded-vs-single equivalence runs under scoped float64:
    psum changes float summation ORDER, and CG amplifies that
    reduction-order noise, so tight elementwise tolerances are only
    meaningful where the noise floor (~1e-13 relative in f64) sits far
    below them.  The f32 regime is covered separately by
    test_sharded_step_f32_cost_agreement, which asserts what f32 CAN
    guarantee (cost agreement + same convergence), not raw pose entries
    at 1e-6."""
    yield


def test_sharded_step_matches_single_device(rng):
    gt_poses, gt_pts, p = make_ba_problem(rng, n_cams=5, n_pts=40)
    mesh = meshlib.make_mesh()

    poses1, points1, cost1 = ba.ba_step(p, 1e-6, 30)
    poses8, points8, cost8 = ba_sharded.ba_step_sharded(p, mesh, 1e-6, 30)
    # psum partial order changes float summation: tolerance, not bit-exact
    np.testing.assert_allclose(np.asarray(cost8), np.asarray(cost1), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(poses8), np.asarray(poses1),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(points8), np.asarray(points1),
                               atol=1e-5)


def test_sharded_step_f32_cost_agreement(rng, x64):
    """f32 regime (what the device runs): psum reduction-order noise makes raw
    pose entries diverge (observed up to ~1e-3 relative through 30 CG
    iterations), so the defensible f32 contract is that both steps reach
    the SAME cost basin: post-step total cost agrees to a few ulps of the
    cost's own conditioning, and both reduce the initial cost equally."""
    del x64  # fixture requested only to restore state; run body in f32
    jax.config.update("jax_enable_x64", False)
    gt_poses, gt_pts, p = make_ba_problem(rng, n_cams=5, n_pts=40)
    assert p.poses.dtype == jnp.float32
    mesh = meshlib.make_mesh()
    c0 = float(ba.total_cost(p))
    poses1, points1, _ = ba.ba_step(p, 1e-6, 30)
    poses8, points8, _ = ba_sharded.ba_step_sharded(p, mesh, 1e-6, 30)
    c1 = float(ba.total_cost(p._replace(poses=poses1, points=points1)))
    c8 = float(ba.total_cost(p._replace(poses=poses8, points=points8)))
    assert c1 < c0 * 0.5 and c8 < c0 * 0.5  # both steps made real progress
    # same basin: costs agree to f32 reduction-order tolerance
    np.testing.assert_allclose(c8, c1, rtol=1e-4)


def test_sharded_optimize_converges(rng):
    gt_poses, gt_pts, p = make_ba_problem(rng, n_cams=5, n_pts=40)
    mesh = meshlib.make_mesh()
    c0 = float(ba.total_cost(p))
    poses, points, costs = ba_sharded.optimize_sharded(p, None, 10, 30, 1e-6,
                                                      mesh=mesh)
    assert float(costs[-1]) < c0 * 1e-6
    err = np.abs(np.asarray(poses) - gt_poses).max()
    assert err < 1e-3, err


def test_sharded_handles_nondivisible_observation_count(rng):
    gt_poses, gt_pts, p = make_ba_problem(rng, n_cams=4, n_pts=30)
    # drop 5 observations so O is not a multiple of 8
    o = int(p.obs_cam.shape[0]) - 5
    p2 = ba.BAProblem(p.poses, p.points, p.obs_cam[:o], p.obs_lm[:o],
                      p.obs_uv[:o], p.obs_valid[:o], p.n_fixed_cams)
    mesh = meshlib.make_mesh()
    poses1, points1, cost1 = ba.ba_step(p2, 1e-6, 20)
    poses8, points8, cost8 = ba_sharded.ba_step_sharded(p2, mesh, 1e-6, 20)
    np.testing.assert_allclose(np.asarray(poses8), np.asarray(poses1),
                               atol=1e-6)


def test_sharded2d_matches_single_device(rng):
    """2-D mesh: observations over `data`, landmarks over `model` — must
    agree with the single-device step to float tolerance.  Sizes are
    deliberately non-divisible (37 landmarks over 2 model shards; 180
    observations over 4 data shards after dropping 5) so both padding
    paths are exercised in the same (expensive) shard_map compile."""
    gt_poses, gt_pts, p = make_ba_problem(rng, n_cams=5, n_pts=37)
    o = int(p.obs_cam.shape[0]) - 5
    p = ba.BAProblem(p.poses, p.points, p.obs_cam[:o], p.obs_lm[:o],
                     p.obs_uv[:o], p.obs_valid[:o], p.n_fixed_cams)
    mesh = meshlib.make_mesh(n_data=4, n_model=2)
    # enough CG iterations that both runs reach the same converged step —
    # an under-converged CG amplifies psum reduction-order noise
    poses1, points1, cost1 = ba.ba_step(p, 1e-6, 80)
    poses2, points2, cost2 = ba_sharded.ba_step_sharded2d(p, mesh, 1e-6, 80)
    np.testing.assert_allclose(np.asarray(cost2), np.asarray(cost1),
                               rtol=1e-9)
    # CG amplifies psum reduction-order noise: tolerance, not bit-exact
    np.testing.assert_allclose(np.asarray(poses2), np.asarray(poses1),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(points2), np.asarray(points1),
                               atol=1e-4)


def test_sharded_robust_matches_single_device(rng):
    """Round-4 Huber-IRLS path: the 1-D and 2-D sharded robust steps must
    agree with the single-device robust step (per-observation weights are
    shard-local, so the collectives are unchanged)."""
    gt_poses, gt_pts, p = make_ba_problem(rng, n_cams=5, n_pts=37)
    # make a few observations gross outliers so the weights matter
    uv = np.asarray(p.obs_uv).copy()
    uv[::17] += 0.3
    p = ba.BAProblem(p.poses, p.points, p.obs_cam, p.obs_lm,
                     jnp.asarray(uv), p.obs_valid, p.n_fixed_cams)
    delta = 0.01
    poses1, points1, cost1 = ba.ba_step(p, 1e-6, 80, robust_delta=delta)
    mesh1 = meshlib.make_mesh(n_data=8)
    poses8, points8, cost8 = ba_sharded.ba_step_sharded(
        p, mesh1, 1e-6, 80, robust_delta=delta)
    np.testing.assert_allclose(np.asarray(cost8), np.asarray(cost1),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(poses8), np.asarray(poses1),
                               atol=1e-5)
    mesh2 = meshlib.make_mesh(n_data=4, n_model=2)
    poses2d, points2d, cost2d = ba_sharded.ba_step_sharded2d(
        p, mesh2, 1e-6, 80, robust_delta=delta)
    np.testing.assert_allclose(np.asarray(cost2d), np.asarray(cost1),
                               rtol=1e-6)
    np.testing.assert_allclose(np.asarray(poses2d), np.asarray(poses1),
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(points2d), np.asarray(points1),
                               atol=1e-4)
