"""Multi-scale (pyramid) FAST detection and description.

The reference detector is single-scale; real SLAM front-ends detect over
an image pyramid for scale invariance.  Dyadic levels built by
2x2 box averaging (one fused XLA reduce per level), per-level fused
detection, fixed K keypoint slots per level, descriptors computed on the
level image, coordinates reported at level-0 resolution.
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from . import brief


def downsample2(image: jax.Array) -> jax.Array:
    """2x2 box average with round-half-up, uint8 -> uint8 (dimensions
    truncate to even)."""
    h, w = image.shape
    he, we = h - h % 2, w - w % 2
    x = image[:he, :we].astype(jnp.int32).reshape(he // 2, 2, we // 2, 2)
    return ((x.sum(axis=(1, 3)) + 2) // 4).astype(jnp.uint8)


def build_pyramid(image: jax.Array, n_levels: int) -> List[jax.Array]:
    """[level0 (original), level1 (1/2), ...]; stops early if a level gets
    smaller than the descriptor-safe minimum."""
    levels = [image]
    for _ in range(1, n_levels):
        nxt = downsample2(levels[-1])
        if min(nxt.shape) < 2 * brief.BORDER + 8:
            break
        levels.append(nxt)
    return levels


class MultiscaleFeatures(NamedTuple):
    """Per-slot arrays over all levels concatenated (K_total = sum K_l)."""

    xy0: jax.Array  # (K, 2) int32 coordinates at level-0 resolution
    xy: jax.Array  # (K, 2) int32 coordinates at the native level
    level: jax.Array  # (K,) int32
    score: jax.Array  # (K,) int32
    desc: jax.Array  # (K, WORDS) uint32
    valid: jax.Array  # (K,) bool


def detect_and_describe_multiscale(
    image: jax.Array,
    threshold: int,
    count: int,
    k_per_level: int,
    n_levels: int = 4,
) -> MultiscaleFeatures:
    """FAST + BRIEF over a dyadic pyramid; each level contributes up to
    ``k_per_level`` top-scoring keypoints.  Level-l coordinates map to
    level 0 as x0 = x * 2^l (the top-left convention)."""
    levels = build_pyramid(image, n_levels)
    xs0, xs, lv, sc, ds, va = [], [], [], [], [], []
    for l, img_l in enumerate(levels):
        kps, desc, dvalid = brief.detect_and_describe(
            img_l, threshold, count, k_per_level
        )
        xs.append(kps.xy)
        xs0.append(kps.xy * (1 << l))
        lv.append(jnp.full((k_per_level,), l, jnp.int32))
        sc.append(kps.score)
        ds.append(desc)
        va.append(kps.valid & dvalid)
    return MultiscaleFeatures(
        xy0=jnp.concatenate(xs0),
        xy=jnp.concatenate(xs),
        level=jnp.concatenate(lv),
        score=jnp.concatenate(sc),
        desc=jnp.concatenate(ds),
        valid=jnp.concatenate(va),
    )
