"""SO(3)/SE(3) Lie group operations, batched and jit-friendly.

New scope (BASELINE.json: pose-graph optimization, bundle adjustment).
Everything is pure jnp, works under vmap/jit/grad, and is dtype-following
(float32 on the device; tests may run float64 on CPU).  Small-angle branches use
Taylor series selected with jnp.where so gradients stay finite.

Conventions: rotations are 3x3 matrices; se(3) tangent vectors are
xi = (rho, phi) with translation part first; T = [[R, t], [0, 1]] acts as
T(p) = R p + t.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

_EPS = 1e-8


def hat(w: jax.Array) -> jax.Array:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([z, -wz, wy], axis=-1),
            jnp.stack([wz, z, -wx], axis=-1),
            jnp.stack([-wy, wx, z], axis=-1),
        ],
        axis=-2,
    )


def vee(m: jax.Array) -> jax.Array:
    """(..., 3, 3) skew -> (..., 3)."""
    return jnp.stack([m[..., 2, 1], m[..., 0, 2], m[..., 1, 0]], axis=-1)


def _safe_theta(w: jax.Array):
    """(theta2, theta_safe, small) with gradient-safe sqrt: theta_safe is 1
    where theta is tiny (the Taylor branch is used there), so no NaN grads
    propagate from sqrt at zero."""
    theta2 = jnp.sum(w * w, axis=-1, keepdims=True)[..., None]
    small = theta2 < 1e-8
    theta_safe = jnp.sqrt(jnp.where(small, 1.0, theta2))
    return theta2, theta_safe, small


def _sinc(theta2, theta, small):
    """sin(theta)/theta with Taylor fallback."""
    return jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)


def _cosc(theta2, theta, small):
    """(1 - cos(theta))/theta^2 with Taylor fallback.  Denominators use the
    guarded theta (1 where small), never raw theta2 — the unselected branch
    of a jnp.where still propagates NaN gradients from 0/0."""
    return jnp.where(small, 0.5 - theta2 / 24.0,
                     (1.0 - jnp.cos(theta)) / (theta * theta))


def so3_exp(w: jax.Array) -> jax.Array:
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3) (Rodrigues)."""
    theta2, theta, small = _safe_theta(w)
    K = hat(w)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + _sinc(theta2, theta, small) * K + _cosc(theta2, theta, small) * K2


def so3_log(R: jax.Array) -> jax.Array:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Autodiff-safe at (and near) the identity: no arccos-at-1 or
    norm-at-0 appears in any branch, selected or not — an unselected
    jnp.where branch that produces inf in its own derivative still
    poisons gradients with 0 * inf = NaN, so every branch must be finite
    everywhere.  theta comes from atan2(|skew|, (tr-1)/2) with a guarded
    sqrt; the near-pi branch clamps its arccos input strictly inside
    (-1, 1).
    """
    tr = jnp.trace(R, axis1=-2, axis2=-1)
    cos = jnp.clip((tr - 1.0) / 2.0, -1.0, 1.0)
    w = vee(R - jnp.swapaxes(R, -1, -2)) / 2.0  # = sin(theta) * axis
    s2 = jnp.sum(w * w, axis=-1)  # = sin(theta)^2
    small = s2 < 1e-12
    sin_safe = jnp.sqrt(jnp.where(small, 1.0, s2))
    theta = jnp.arctan2(sin_safe, cos)
    # General: log = w * theta / sin(theta); small angles: theta ~ sin,
    # log = w * (1 + theta^2/6 + ...)
    scale = jnp.where(small, 1.0 + s2 / 6.0, theta / sin_safe)
    general = w * scale[..., None]
    # Near pi sin -> 0 while |log| -> pi: extract the axis from the
    # symmetric part instead.  Magnitudes come from the diagonal
    # (R_ii = cos + (1-cos) a_i^2); RELATIVE signs cannot come from the
    # vanishing skew part w — they come from the symmetric off-diagonals
    # S_ij = (1-cos) a_i a_j (positive factor near pi), anchored at the
    # largest-magnitude component k (set a_k > 0, then sign(a_j) =
    # sign(S_kj)).  The remaining GLOBAL sign is recovered from w while
    # sin(theta) is still nonzero; at exactly pi the two signs give the
    # same rotation, so the +1 fallback is exact there.
    near_pi = cos < -0.999
    theta_pi = jnp.arccos(jnp.clip(cos, -1.0 + 1e-7, 1.0 - 1e-7))
    diag = jnp.diagonal(R, axis1=-2, axis2=-1)
    axis_sq = jnp.clip(
        (diag - cos[..., None]) / (1.0 - cos[..., None] + _EPS), 0.0, None
    )
    axis_abs = jnp.sqrt(axis_sq + _EPS)
    sym = (R + jnp.swapaxes(R, -1, -2)) / 2.0
    k = jnp.argmax(axis_sq, axis=-1)
    row_k = jnp.take_along_axis(sym, k[..., None, None], axis=-2)[..., 0, :]
    is_k = jax.nn.one_hot(k, 3, dtype=R.dtype)
    rel = jnp.where(
        is_k > 0.5, 1.0, jnp.sign(jnp.where(jnp.abs(row_k) > 0, row_k, 1.0))
    )
    axis = axis_abs * rel
    dot_w = jnp.sum(w * axis, axis=-1, keepdims=True)
    g = jnp.sign(jnp.where(jnp.abs(dot_w) > 1e-6, dot_w, 1.0))
    pi_branch = axis * g * theta_pi[..., None]
    return jnp.where(near_pi[..., None], pi_branch, general)


def se3_exp(xi: jax.Array) -> jax.Array:
    """se(3) tangent (..., 6) [rho, phi] -> (..., 4, 4) transform."""
    rho, phi = xi[..., :3], xi[..., 3:]
    theta2, theta, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=xi.dtype), K.shape)
    R = eye + _sinc(theta2, theta, small) * K + _cosc(theta2, theta, small) * K2
    # Left Jacobian V
    c3 = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - jnp.sin(theta)) / (theta * theta * theta),
    )
    V = eye + _cosc(theta2, theta, small) * K + c3 * K2
    t = (V @ rho[..., None])[..., 0]
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], xi.dtype), top[..., :1, :].shape
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_log(T: jax.Array) -> jax.Array:
    """(..., 4, 4) -> (..., 6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    theta2, theta, small = _safe_theta(phi)
    K = hat(phi)
    K2 = K @ K
    eye = jnp.broadcast_to(jnp.eye(3, dtype=T.dtype), K.shape)
    # V^{-1} = I - K/2 + c * K^2,  c = (1 - theta cot(theta/2) / 2) / theta^2
    half = theta / 2.0
    cot_term = half * jnp.cos(half) / jnp.sin(jnp.where(small, 1.0, half))
    c = jnp.where(
        small, 1.0 / 12.0 + theta2 / 720.0, (1.0 - cot_term) / (theta * theta)
    )
    Vinv = eye - K / 2.0 + c * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return jnp.concatenate([rho, phi], axis=-1)


def se3_inverse(T: jax.Array) -> jax.Array:
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    ti = -(Rt @ t[..., None])[..., 0]
    top = jnp.concatenate([Rt, ti[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.asarray([0.0, 0.0, 0.0, 1.0], T.dtype), top[..., :1, :].shape
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_compose(A: jax.Array, B: jax.Array) -> jax.Array:
    return A @ B


def se3_apply(T: jax.Array, p: jax.Array) -> jax.Array:
    """Apply (..., 4, 4) to points (..., 3)."""
    return (T[..., :3, :3] @ p[..., None])[..., 0] + T[..., :3, 3]


def se3_identity(dtype=jnp.float32) -> jax.Array:
    return jnp.eye(4, dtype=dtype)
