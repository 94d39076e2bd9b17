"""Two-view geometry: essential matrix estimation, pose recovery,
triangulation — batched RANSAC as one device dispatch.

New scope (BASELINE.json config[3]: "FAST + descriptor matching +
pose-graph on a monocular sequence").  Design: RANSAC is not a loop with
early exit — it is a BATCH of H hypotheses evaluated in parallel (vmapped
8-point solves + vectorized inlier counts), then an argmax.  Fixed-capacity
correspondence slots with validity bits come straight from the matcher.

All math in normalized camera coordinates (intrinsics applied by the
caller via `normalize_points`).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp


class Camera(NamedTuple):
    """Pinhole intrinsics."""

    fx: float
    fy: float
    cx: float
    cy: float

    def matrix(self, dtype=jnp.float32) -> jax.Array:
        return jnp.asarray(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype,
        )


def normalize_points(pts: jax.Array, cam: Camera) -> jax.Array:
    """Pixel (..., 2) -> normalized camera coordinates (..., 2)."""
    x = (pts[..., 0] - cam.cx) / cam.fx
    y = (pts[..., 1] - cam.cy) / cam.fy
    return jnp.stack([x, y], axis=-1)


def _epipolar_rows(pa: jax.Array, pb: jax.Array) -> jax.Array:
    """(N, 9) epipolar constraint rows: row_i . vec(E) = pb_i^T E pa_i."""
    xa, ya = pa[..., 0], pa[..., 1]
    xb, yb = pb[..., 0], pb[..., 1]
    ones = jnp.ones_like(xa)
    return jnp.stack(
        [xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya, ones], axis=-1
    )


def _sym3_eigs_smallest(M: jax.Array):
    """Closed-form eigensystem pieces of a symmetric PSD (3, 3) matrix:
    (lam1, lam2, lam3, v3) with lam1 >= lam2 >= lam3 (Cardano's
    trigonometric solution of the characteristic cubic) and v3 the unit
    eigenvector of lam3 (best-conditioned cross product of two rows of
    M - lam3 I).  Pure elementwise arithmetic — batches for free."""
    q = jnp.trace(M) / 3.0
    Mq = M - q * jnp.eye(3, dtype=M.dtype)
    p2 = jnp.sum(Mq * Mq) / 6.0
    p = jnp.sqrt(jnp.maximum(p2, 1e-30))
    B = Mq / p
    detB = (
        B[0, 0] * (B[1, 1] * B[2, 2] - B[1, 2] * B[2, 1])
        - B[0, 1] * (B[1, 0] * B[2, 2] - B[1, 2] * B[2, 0])
        + B[0, 2] * (B[1, 0] * B[2, 1] - B[1, 1] * B[2, 0])
    )
    r = jnp.clip(detB / 2.0, -1.0, 1.0)
    phi = jnp.arccos(r) / 3.0
    lam1 = q + 2.0 * p * jnp.cos(phi)
    lam3 = q + 2.0 * p * jnp.cos(phi + 2.0 * jnp.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    S = M - lam3 * jnp.eye(3, dtype=M.dtype)
    c01 = jnp.cross(S[0], S[1])
    c02 = jnp.cross(S[0], S[2])
    c12 = jnp.cross(S[1], S[2])
    cands = jnp.stack([c01, c02, c12])
    norms = jnp.linalg.norm(cands, axis=1)
    v = cands[jnp.argmax(norms)]
    return lam1, lam2, lam3, v / jnp.maximum(jnp.linalg.norm(v), 1e-30)


def _sym3_smallest_eigvec(M: jax.Array) -> jax.Array:
    """Unit eigenvector of the smallest eigenvalue (see
    _sym3_eigs_smallest)."""
    return _sym3_eigs_smallest(M)[3]


def _essential_project(E: jax.Array) -> jax.Array:
    """Closed-form projection of a 3x3 matrix onto the essential
    manifold (singular values (s, s, 0)) — NO SVD.

    With M = E^T E (eigenvalues lam1 >= lam2 >= lam3 = squared singular
    values, all from Cardano), the projection is

        E_ess = sbar * E (a M + b I)(I - v3 v3^T),

    where (a, b) interpolate f(lam) = 1/sqrt(lam) through lam1, lam2 —
    on the rank-2 span the operator aM + bI IS V diag(1/s1, 1/s2) V^T,
    so E(aM+bI)P = u1 v1^T + u2 v2^T without ever forming the
    eigenvectors v1, v2 (whose cross-product construction is singular
    exactly in the common essential case lam1 ~= lam2; the interpolated
    operator is basis-free and stable there, switching to the analytic
    limit a = -1/(2 lbar^{3/2}) when lam1 - lam2 underflows).

    Scoring UNPROJECTED hypotheses was a measured quality bug twice
    over: full-rank E from degenerate samples wins bogus consensus
    (odometry 3.3% -> 11% ATE), and rank-2-only enforcement still left
    median pair rotation error at 0.36 deg vs 0.24 with the full
    projection (round-5 probes) — the equal-singular-value constraint
    is real information for ESSENTIAL matrices, unlike fundamental."""
    M = E.T @ E
    lam1, lam2, lam3, v3 = _sym3_eigs_smallest(M)
    eps = 1e-30
    lam1 = jnp.maximum(lam1, eps)
    lam2 = jnp.maximum(lam2, eps)
    s1 = jnp.sqrt(lam1)
    s2 = jnp.sqrt(lam2)
    sbar = 0.5 * (s1 + s2)
    dl = lam1 - lam2
    lbar = 0.5 * (lam1 + lam2)
    a_nd = (1.0 / s1 - 1.0 / s2) / jnp.where(jnp.abs(dl) < eps, 1.0, dl)
    a_deg = -0.5 / (lbar * jnp.sqrt(lbar))
    deg = jnp.abs(dl) < 1e-6 * lam1
    a = jnp.where(deg, a_deg, a_nd)
    b = jnp.where(deg, 1.5 / jnp.sqrt(lbar), 1.0 / s1 - a_nd * lam1)
    W = a * M + b * jnp.eye(3, dtype=E.dtype)
    P = jnp.eye(3, dtype=E.dtype) - jnp.outer(v3, v3)
    return sbar * (E @ (W @ P))


def _nullvec_rows8(A: jax.Array) -> jax.Array:
    """Unit vector orthogonal to the 8 rows of A (8, 9) — the 8-point
    null vector — by UNROLLED modified Gram-Schmidt with one
    re-orthogonalization pass: ~1k scalar multiply-adds that vmap into
    batched elementwise XLA ops.

    Crucially this works on the ROWS, not the normal matrix: forming
    A^T A squares the conditioning, and the f32 noise of a normal-
    equation null vector (inverse iteration, exact Cholesky inner
    solves) measurably degraded RANSAC — staged-circuit loop-stage ATE
    1.44 -> 2.3 — while MGS at cond(A) keeps f32 accuracy.  Two fixed
    deflation seeds guard against a seed lying in the row space; the
    larger deflated residual wins."""
    eps = 1e-30
    q = []
    for i in range(8):
        v = A[i]
        for _ in range(2):  # MGS + re-orthogonalization
            for qj in q:
                v = v - jnp.dot(qj, v) * qj
        q.append(v / jnp.sqrt(jnp.maximum(jnp.dot(v, v), eps)))

    def deflate(seed):
        v = seed
        for _ in range(2):
            for qj in q:
                v = v - jnp.dot(qj, v) * qj
        return v

    s1 = deflate(jnp.full((9,), 1.0 / 3.0, A.dtype))
    alt = jnp.zeros((9,), A.dtype).at[4].set(1.0).at[2].set(-0.5)
    s2 = deflate(alt)
    n1 = jnp.dot(s1, s1)
    n2 = jnp.dot(s2, s2)
    v = jnp.where(n1 >= n2, s1, s2)
    return v / jnp.sqrt(jnp.maximum(jnp.maximum(n1, n2), eps))


def _eight_point_hyp(pa: jax.Array, pb: jax.Array) -> jax.Array:
    """RANSAC hypothesis 8-point solve, SVD-free: row-space null vector
    by unrolled Gram-Schmidt (`_nullvec_rows8`), then the closed-form
    FULL essential projection (`_essential_project`).  Matches the
    SVD-based `_eight_point` to f32 working accuracy (median pair
    rotation error 0.238 vs 0.239 deg on the rendered staged circuit)
    without the tiny batched SVDs."""
    A = _epipolar_rows(pa, pb)
    E = _nullvec_rows8(A).reshape(3, 3)
    return _essential_project(E)


def _eight_point(pa: jax.Array, pb: jax.Array) -> jax.Array:
    """Essential matrix from >= 8 normalized correspondences (N, 2) each.

    Linear 8-point: build the epipolar constraint matrix, take the
    null-ish singular vector, project onto the essential manifold
    (two equal singular values, third zero).
    """
    xa, ya = pa[..., 0], pa[..., 1]
    xb, yb = pb[..., 0], pb[..., 1]
    ones = jnp.ones_like(xa)
    # constraint: pb^T E pa = 0
    A = jnp.stack(
        [xb * xa, xb * ya, xb, yb * xa, yb * ya, yb, xa, ya, ones], axis=-1
    )  # (N, 9)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    e = vt[..., -1, :]
    E = e.reshape(*e.shape[:-1], 3, 3)
    u, s, vt2 = jnp.linalg.svd(E)
    sbar = (s[..., 0] + s[..., 1]) / 2.0
    s_proj = jnp.stack([sbar, sbar, jnp.zeros_like(sbar)], axis=-1)
    return u @ (s_proj[..., :, None] * vt2)


def sampson_error(E: jax.Array, pa: jax.Array, pb: jax.Array) -> jax.Array:
    """First-order geometric (Sampson) epipolar error for E, batched over
    points: pa, pb (N, 2) normalized; returns (N,)."""
    ha = jnp.concatenate([pa, jnp.ones_like(pa[..., :1])], axis=-1)  # (N,3)
    hb = jnp.concatenate([pb, jnp.ones_like(pb[..., :1])], axis=-1)
    Ea = ha @ jnp.swapaxes(E, -1, -2)  # = (E @ pa)^T rows -> (N, 3)
    Etb = hb @ E  # (N, 3)
    num = jnp.sum(hb * Ea, axis=-1) ** 2
    den = Ea[..., 0] ** 2 + Ea[..., 1] ** 2 + Etb[..., 0] ** 2 + Etb[..., 1] ** 2
    return num / jnp.maximum(den, 1e-12)


@functools.partial(jax.jit, static_argnums=(4,))
def ransac_essential(
    pa: jax.Array,
    pb: jax.Array,
    valid: jax.Array,
    key: jax.Array,
    hypotheses: int = 256,
    threshold: float = 1e-4,
) -> Tuple[jax.Array, jax.Array]:
    """Batched-hypothesis RANSAC for E.

    pa, pb: (K, 2) normalized correspondences (slots), valid: (K,) bool.
    Returns (E (3, 3), inlier mask (K,)).  All H hypotheses are solved and
    scored in parallel (no data-dependent control flow), then the best is
    re-fit on its inliers once.
    """
    k = pa.shape[0]
    # Minimal samples WITHOUT replacement: rank a uniform key per (slot,
    # hypothesis), push invalid slots to the back, take each hypothesis's
    # 8 best — 8 DISTINCT valid slots whenever >= 8 exist.  Sampling with
    # replacement made a hypothesis contain duplicate correspondences with
    # high probability at small n_valid (~55% at 20), and a duplicated row
    # leaves the 8-point system rank-deficient — a wasted hypothesis.
    r = jax.random.uniform(key, (hypotheses, k))
    r = jnp.where(valid[None, :], r, 2.0)  # invalid slots rank last
    _, sample_idx = jax.lax.top_k(-r, 8)  # (H, 8) distinct slot indices

    Es = jax.vmap(lambda si: _eight_point_hyp(pa[si], pb[si]))(sample_idx)  # (H,3,3)
    errs = jax.vmap(lambda E: sampson_error(E, pa, pb))(Es)  # (H, K)
    inl = (errs < threshold) & valid[None, :]
    scores = inl.sum(axis=-1)
    best = jnp.argmax(scores)
    best_inl = inl[best]

    # Guided re-fit iterations on the running inlier set (weighted by the
    # inlier mask so the solves stay static-shape); keep whichever model
    # has the larger consensus.
    E_final, inl_final, score_final = Es[best], best_inl, scores[best]
    for _ in range(2):
        w = inl_final.astype(pa.dtype)[:, None]
        E_refit = _eight_point_weighted(pa, pb, w)
        err_refit = sampson_error(E_refit, pa, pb)
        inl_refit = (err_refit < threshold) & valid
        use = inl_refit.sum() >= score_final
        E_final = jnp.where(use, E_refit, E_final)
        inl_final = jnp.where(use, inl_refit, inl_final)
        score_final = jnp.maximum(inl_refit.sum(), score_final)
    return E_final, inl_final


def _eight_point_weighted(pa, pb, w):
    """Inlier-weighted refit: smallest eigenvector of the (9, 9) normal
    matrix (the (K, 9)^T (K, 9) product is one small matmul; the round-4 code
    ran a FULL-matrices SVD of the (K, 9) row matrix — a (K, K) U factor
    for K = 512 slots — per refit).  eigh on a 9x9 runs per PAIR, not
    per hypothesis, so its cost is negligible, and it keeps full f32
    eigenvector accuracy, which
    the refit needs (it feeds recover_pose and the final inlier set —
    an approximate refit null vector measurably cost BA accuracy on the
    staged circuit).  One 3x3 SVD then projects onto the essential
    manifold."""
    A = _epipolar_rows(pa, pb) * w
    N = A.T @ A
    _, V = jnp.linalg.eigh(N)
    E = V[:, 0].reshape(3, 3)  # eigh sorts ascending
    u, s, vt2 = jnp.linalg.svd(E)
    sbar = (s[0] + s[1]) / 2.0
    return u @ jnp.diag(jnp.asarray([sbar, sbar, 0.0], E.dtype)) @ vt2


def triangulate(
    Ra: jax.Array, ta: jax.Array, Rb: jax.Array, tb: jax.Array,
    pa: jax.Array, pb: jax.Array,
) -> jax.Array:
    """Linear (DLT) triangulation, batched over correspondences.

    (Ra|ta), (Rb|tb): world->camera extrinsics; pa, pb (N, 2) normalized.
    Returns (N, 3) world points.
    """
    Pa = jnp.concatenate([Ra, ta[..., None]], axis=-1)  # (3, 4)
    Pb = jnp.concatenate([Rb, tb[..., None]], axis=-1)

    def one(qa, qb):
        rows = jnp.stack(
            [
                qa[0] * Pa[2] - Pa[0],
                qa[1] * Pa[2] - Pa[1],
                qb[0] * Pb[2] - Pb[0],
                qb[1] * Pb[2] - Pb[1],
            ]
        )
        _, _, vt = jnp.linalg.svd(rows)
        X = vt[-1]
        return X[:3] / jnp.where(jnp.abs(X[3]) < 1e-12, 1e-12, X[3])

    return jax.vmap(one)(pa, pb)


def ray_depths(
    R: jax.Array, t: jax.Array, pa: jax.Array, pb: jax.Array
) -> Tuple[jax.Array, jax.Array]:
    """Closed-form two-view ray depths, batched over correspondences.

    Solves min || za * (R qa) - zb * qb + t ||^2 for the depths (za, zb)
    along the two rays (qa = [pa, 1], qb = [pb, 1]; convention
    x_b = R x_a + t) — a 2x2 least squares with a Cramer solution, so
    the whole batch is elementwise arithmetic: no per-point SVD.

    Round-4 motivation: the homogeneous-DLT `triangulate` runs one 4x4
    SVD per correspondence, and the VO pipeline triangulated every pair
    SIX times (4 cheirality candidates + depths + refine), and tiny
    batched SVDs were the most expensive op in the geometry stage.
    Cheirality needs only the SIGNS of (za, zb) and scale chaining needs
    depth RATIOS, both of which this least-squares form provides with
    2x2 conditioning (the f32 3x3 normal-equation DLT loses up to ~0.3
    units on low-parallax points — measured and rejected; full-accuracy
    multi-view structure still uses DLT/SVD in BA init).

    Degenerate (near-parallel) rays give a near-zero denominator; the
    clamp sends such depths to huge magnitudes, which every consumer
    gates (depth > eps, finite checks)."""
    qa = jnp.concatenate([pa, jnp.ones_like(pa[..., :1])], axis=-1)
    qb = jnp.concatenate([pb, jnp.ones_like(pb[..., :1])], axis=-1)
    u = qa @ R.T  # (N, 3) rotated first-frame rays
    uu = jnp.sum(u * u, axis=-1)
    vv = jnp.sum(qb * qb, axis=-1)
    uv = jnp.sum(u * qb, axis=-1)
    ut = u @ t
    vt = qb @ t
    den = uu * vv - uv * uv
    den = jnp.where(jnp.abs(den) < 1e-12, 1e-12, den)
    za = (uv * vt - ut * vv) / den
    zb = (uu * vt - uv * ut) / den
    return za, zb


def recover_pose(
    E: jax.Array, pa: jax.Array, pb: jax.Array, valid: jax.Array
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Decompose E into the (R, t) with maximal cheirality support.

    Convention: camera A at identity, camera B extrinsic x_b = R x_a + t
    (world frame = camera A).  Returns (R (3,3), t (3,) unit norm,
    n_support).  All four candidates are evaluated branchlessly.
    """
    u, s, vt = jnp.linalg.svd(E)
    # Make U and V proper rotations individually (negating a column/row of
    # an orthogonal matrix with det=-1); then U W V^T and U W^T V^T are
    # guaranteed rotations.
    u = u * jnp.sign(jnp.linalg.det(u))
    vt = vt * jnp.sign(jnp.linalg.det(vt))
    W = jnp.asarray([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = u @ W @ vt
    R2 = u @ W.T @ vt
    t = u[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    def support(R, tt):
        # Cheirality needs only depth SIGNS: the closed-form ray depths
        # replace a per-point 4x4 SVD triangulation (see ray_depths).
        za, zb = ray_depths(R, tt, pa, pb)
        finite = jnp.isfinite(za) & jnp.isfinite(zb)
        return ((za > 1e-6) & (zb > 1e-6) & valid & finite).sum()

    cands = [(R1, t), (R1, -t), (R2, t), (R2, -t)]
    supports = jnp.stack([support(R, tt) for R, tt in cands])
    Rs = jnp.stack([c[0] for c in cands])
    ts = jnp.stack([c[1] for c in cands])
    best = jnp.argmax(supports)
    return Rs[best], ts[best], supports[best]
