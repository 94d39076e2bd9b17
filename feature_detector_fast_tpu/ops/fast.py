"""Dense, branchless FAST detection as fused XLA elementwise pipelines.

This is the XLA-native re-design of the reference's AVX2 detector
(`/root/reference/src/fast_simd.rs`).  The reference's structure — cardinal
prefilter (fast_simd.rs:368-556), per-candidate dual-gather arc test
(fast_simd.rs:115-297), rotated-mask consecutive scan (fast_simd.rs:244-295),
streaming 3-row nonmax (fast_simd.rs:588-616) — is replaced by a single
dense, predicated computation over the whole image:

  * the 16 circle taps are STATIC SLICES of a zero-padded image (no gathers;
    XLA fuses them into the consuming elementwise ops),
  * the wraparound n-consecutive arc test is an O(log n) addition-chain of
    ANDs over 16 boolean planes (`ops.windows`),
  * both score functions are evaluated densely and predicated by the
    keypoint mask (vector lanes can't early-out; predication is the idiom),
  * 3x3 strict-max nonmax is a fused 8-neighbor compare on the score map.

Semantics are bit-exact with the reference / OpenCV:
  * bright:  p_circle - c >  t   (strict; fast_simd.rs:415-433 uses strict
    unsigned compares on saturating c+t / c-t bounds — equivalent to strict
    integer comparison, which is what we use),
  * dark:    c - p_circle >  t,
  * keypoint iff some circular window of `count` taps is all-bright or
    all-dark (opencv_compat.rs:140-165),
  * detection region x in [3, W-4], y in [3, H-4] (fast_simd.rs:342,368),
  * MaxThreshold score: min(|max_s min_{window}|, |min_s max_{window}|) over
    center-minus-tap differences (opencv_compat.rs:172-209),
  * SumAbsolute score: max(sum of bright excesses, sum of dark excesses)
    (opencv_compat.rs:278-299),
  * nonmax: a keypoint survives iff its score strictly exceeds the scores of
    all 8 neighbors (non-keypoints score 0), and rows y==3 and y==H-4 are
    dropped after competing (opencv_compat.rs:236-260; the reference SIMD
    path's "y==4 skip" quirk, fast_simd.rs:590-592, is the same rule seen
    from the streaming side).

All functions take config fields as Python ints / enums: they are trace-time
constants, so each config monomorphizes its own fused XLA program — the
analogue of the reference's const-generic dispatch (fast_simd.rs:847-859).
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..config import NonmaxMode
from ..geometry import CIRCLE, RADIUS
from . import windows

# Internal integer dtype for difference math.  The reference's u8
# saturating-bounds trick (fast_simd.rs:406-407) exists only because AVX2
# lacks unsigned compares — in i32 the comparisons are simply strict
# integer compares.
_IDT = jnp.int32


def circle_taps(image: jax.Array) -> List[jax.Array]:
    """The 16 circle-tap planes as statically shifted views of ``image``.

    ``taps[i][y, x] == image[y + dy_i, x + dx_i]`` wherever that is
    in-bounds; out-of-bounds positions read zero-padding and are masked off
    downstream by the interior mask.  This replaces the reference's two
    `_mm256_i32gather_epi32` + shuffle wrangle (fast_simd.rs:133-215) with
    16 aligned vector loads that XLA fuses into the compute.
    """
    h, w = image.shape
    r = RADIUS
    padded = jnp.pad(image, r)  # zeros; only the interior is ever trusted
    return [
        jax.lax.slice(padded, (r + dy, r + dx), (r + dy + h, r + dx + w))
        for (dx, dy) in CIRCLE
    ]


def interior_mask(shape: Tuple[int, int]) -> jax.Array:
    """Boolean mask of the detectable region x in [3, W-4], y in [3, H-4]."""
    h, w = shape
    r = RADIUS
    row = (jnp.arange(h) >= r) & (jnp.arange(h) < h - r)
    col = (jnp.arange(w) >= r) & (jnp.arange(w) < w - r)
    return row[:, None] & col[None, :]


def _bright_dark(
    center: jax.Array, taps: Sequence[jax.Array], threshold: int
) -> Tuple[List[jax.Array], List[jax.Array]]:
    """Per-tap strict threshold-exceedance masks.

    bright[i]: tap strictly brighter than center by more than t.
    dark[i]:   tap strictly darker  than center by more than t.
    (reference: opencv_compat.rs:115-122 via delta = center - tap)
    """
    t = int(threshold)
    c = center.astype(_IDT)
    bright = [p.astype(_IDT) - c > t for p in taps]
    dark = [c - p.astype(_IDT) > t for p in taps]
    return bright, dark


def detect_mask(image: jax.Array, threshold: int, count: int) -> jax.Array:
    """Dense keypoint candidacy mask (no nonmax), bit-exact with the
    reference's detect (opencv_compat.rs:79-169, fast_simd.rs:301-620)."""
    taps = circle_taps(image)
    bright, dark = _bright_dark(image, taps, threshold)
    is_b = windows.ring_any_window_all(bright, int(count), jnp.logical_and, jnp.logical_or)
    is_d = windows.ring_any_window_all(dark, int(count), jnp.logical_and, jnp.logical_or)
    return (is_b | is_d) & interior_mask(image.shape)


def score_max_threshold(image: jax.Array, count: int) -> jax.Array:
    """Dense MaxThreshold (OpenCV) score map, uint16.

    For each pixel: differences d_i = center - tap_i over the 16-ring;
    extreme_highest = max_s min(window of `count` at s),
    extreme_lowest  = min_s max(window of `count` at s),
    score = min(|extreme_highest|, |extreme_lowest|)
    (reference: opencv_compat.rs:172-209; the SIMD minpos contortions at
    fast_simd.rs:623-718 compute the same thing).
    """
    taps = circle_taps(image)
    c = image.astype(_IDT)
    diffs = [c - p.astype(_IDT) for p in taps]
    eh = windows.ring_max_of_window_min(diffs, int(count), jnp.minimum, jnp.maximum)
    el = windows.ring_min_of_window_max(diffs, int(count), jnp.minimum, jnp.maximum)
    return jnp.minimum(jnp.abs(eh), jnp.abs(el)).astype(jnp.uint16)


def score_sum_abs(image: jax.Array, threshold: int) -> jax.Array:
    """Dense SumAbsolute (paper eq. 3) score map, uint16.

    score = max( sum_{bright i} (d_i - t), sum_{dark i} (-d_i - t) )
    with d_i = tap_i - center for bright, center - tap_i for dark
    (reference: opencv_compat.rs:278-299, fast_simd.rs:722-749).
    """
    t = int(threshold)
    taps = circle_taps(image)
    c = image.astype(_IDT)
    zero = jnp.zeros(image.shape, _IDT)
    sum_light = zero
    sum_dark = zero
    for p in taps:
        d = p.astype(_IDT) - c
        sum_light = sum_light + jnp.where(d > t, d - t, 0)
        sum_dark = sum_dark + jnp.where(-d > t, -d - t, 0)
    return jnp.maximum(sum_light, sum_dark).astype(jnp.uint16)


def nonmax_mask(kp: jax.Array, score: jax.Array) -> jax.Array:
    """3x3 strict-maximum suppression on a keypoint-masked score map.

    A keypoint survives iff score > every 8-neighbor score, where
    non-keypoints contribute 0 (any keypoint scores >= 1, so this is
    equivalent to the reference's membership-gated compare,
    opencv_compat.rs:241-258).  Rows y==3 and y==H-4 participate as
    neighbors but are themselves dropped (opencv_compat.rs:238-240).

    Neighbor shifts use jnp.roll: wraparound only transports rows/cols in
    the zero-score 3-pixel border, so it cannot affect the result.
    """
    h, w = kp.shape
    s = jnp.where(kp, score.astype(jnp.int32), 0)
    neigh = jnp.full(kp.shape, -1, jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            neigh = jnp.maximum(neigh, jnp.roll(s, (-dy, -dx), axis=(0, 1)))
    keep = kp & (s > neigh)
    rows = jnp.arange(h)
    keep_row = (rows != RADIUS) & (rows != h - RADIUS - 1)
    return keep & keep_row[:, None]


def detect_dense(
    image: jax.Array, threshold: int, count: int, nonmax: NonmaxMode
) -> Tuple[jax.Array, jax.Array]:
    """Full dense pipeline: (final keypoint mask, score map).

    With nonmax OFF the score map is all zeros (never computed); otherwise
    score is the selected dense score, predicated by candidacy, and the mask
    is post-suppression.  Everything fuses under one jit.
    """
    nonmax = NonmaxMode(nonmax)
    kp = detect_mask(image, threshold, count)
    if nonmax is NonmaxMode.OFF:
        return kp, jnp.zeros(image.shape, jnp.uint16)
    if nonmax is NonmaxMode.MAX_THRESHOLD:
        score = score_max_threshold(image, count)
    else:
        score = score_sum_abs(image, threshold)
    score = jnp.where(kp, score, 0).astype(jnp.uint16)
    return nonmax_mask(kp, score), score


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def detect_dense_jit(
    image: jax.Array, threshold: int, count: int, nonmax: NonmaxMode
) -> Tuple[jax.Array, jax.Array]:
    """Jitted entry: one fused XLA program per (shape, config)."""
    return detect_dense(image, threshold, count, nonmax)
