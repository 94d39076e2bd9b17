"""Binary descriptor matching as a matrix product.

Hamming distance between BRIEF descriptors is classically a popcount(xor)
loop; the same quantity is a matmul: with descriptors as +-1 vectors,
dot(a, b) = BITS - 2 * hamming(a, b).  One (K x 256) @ (256 x K) bf16
matmul (exact: +-1 terms, at most 256 of them, f32 accumulation) yields
the full distance matrix in one shot.

Matching policy: mutual nearest neighbors with Lowe ratio test (on
distances, best < ratio * second-best) — standard for SLAM front-ends.
Fixed-capacity slots with validity bits, like the rest of the front-end.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .brief import BITS, WORDS


class Matches(NamedTuple):
    """Fixed-capacity match set: for each slot of image A, the matched slot
    of image B (or -1)."""

    idx_b: jax.Array  # (K,) int32, -1 where unmatched
    dist: jax.Array  # (K,) int32 Hamming distance (BITS+1 where unmatched)


def unpack_pm1(desc: jax.Array, valid: jax.Array) -> jax.Array:
    """(K, WORDS) uint32 -> (K, BITS) bf16 in {-1, +1} (0 rows where
    invalid)."""
    k = desc.shape[0]
    shifts = jnp.arange(32, dtype=jnp.uint32)
    bits = (desc[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    pm1 = bits.reshape(k, BITS).astype(jnp.bfloat16) * 2 - 1
    return jnp.where(valid[:, None], pm1, 0)


def hamming_matrix(
    desc_a: jax.Array, valid_a: jax.Array, desc_b: jax.Array, valid_b: jax.Array
) -> jax.Array:
    """(Ka, Kb) int32 Hamming distances; invalid rows/cols read BITS + 1."""
    a = unpack_pm1(desc_a, valid_a)
    b = unpack_pm1(desc_b, valid_b)
    dot = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    dist = ((BITS - dot) / 2).astype(jnp.int32)
    bad = ~(valid_a[:, None] & valid_b[None, :])
    return jnp.where(bad, BITS + 1, dist)


@functools.partial(jax.jit, static_argnums=(4,))
def match(
    desc_a: jax.Array,
    valid_a: jax.Array,
    desc_b: jax.Array,
    valid_b: jax.Array,
    max_dist: int = 64,
    ratio_num: int = 9,
    ratio_den: int = 10,
) -> Matches:
    """Mutual-nearest matching with ratio test.

    A slot a matches b iff: b = argmin_b' d(a, b'), a = argmin_a' d(a', b),
    d <= max_dist, and d * ratio_den < second_best * ratio_num (integer
    ratio test, default 0.9).
    """
    d = hamming_matrix(desc_a, valid_a, desc_b, valid_b)

    best_b = jnp.argmin(d, axis=1).astype(jnp.int32)  # (Ka,)
    best_ab = jnp.min(d, axis=1)
    # second best along rows
    d_wo = d.at[jnp.arange(d.shape[0]), best_b].set(BITS + 1)
    second = jnp.min(d_wo, axis=1)

    best_a = jnp.argmin(d, axis=0).astype(jnp.int32)  # (Kb,)
    mutual = best_a[best_b] == jnp.arange(d.shape[0], dtype=jnp.int32)

    ok = (
        mutual
        & (best_ab <= max_dist)
        & (best_ab * ratio_den < second * ratio_num)
        & valid_a
    )
    return Matches(jnp.where(ok, best_b, -1), jnp.where(ok, best_ab, BITS + 1))


def match_points(
    kps_a_xy: jax.Array, kps_b_xy: jax.Array, matches: Matches
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Gather matched coordinate pairs: (pts_a (K,2), pts_b (K,2),
    valid (K,)) with unmatched slots zeroed."""
    ok = matches.idx_b >= 0
    sel = jnp.where(ok, matches.idx_b, 0)
    return (
        jnp.where(ok[:, None], kps_a_xy, 0),
        jnp.where(ok[:, None], kps_b_xy[sel], 0),
        ok,
    )
