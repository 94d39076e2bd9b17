"""Circular windowed reductions over the 16 circle taps.

The heart of FAST is the wraparound "n consecutive" arc test.  The reference
implements it by rotating a byte mask 16 times and testing all-ones
(fast_simd.rs:244-295); its score kernel runs 16 explicit windowed min/max
scans (fast_simd.rs:663-695).  Neither shape suits dense vector code:
lanes cannot branch per pixel and rotate-heavy inner loops serialize.

Instead we use doubling chains.  Let ``g_k[s]`` be the reduction (AND /
min / max) of ``k`` consecutive ring elements starting at position ``s``:

    g_1[s]    = m[s]
    g_{2k}[s] = combine(g_k[s], g_k[(s + k) mod 16])

Only the power-of-two levels {1, 2, 4, 8} are kept live (they are shared
by every window length); an arbitrary length n window at start s is then
folded on the fly from n's binary decomposition —
``w_n[s] = g_8[s] . g_4[s+8] . g_1[s+12]`` for n = 13 — and immediately
reduced into the accumulator.  This caps resident planes at 4 levels x 16.
The GPU kernels (ops/fast_triton.py) use these chains for the MaxThreshold
score; their boolean arc test runs the same doubling on 16-bit masks
instead, and `ring_any_window_all` below is its differential-test
formulation as well as the XLA pipeline's.

These helpers are array-library agnostic: they work for jnp arrays, numpy
arrays, or values inside a Pallas kernel, since they only call the
supplied combine.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, TypeVar

T = TypeVar("T")

RING = 16


def _power_levels(planes: Sequence[T], combine) -> Dict[int, List[T]]:
    lv: Dict[int, List[T]] = {1: list(planes)}
    for k in (2, 4, 8):
        h = k // 2
        lv[k] = [combine(lv[h][s], lv[h][(s + h) % RING]) for s in range(RING)]
    return lv


def _decompose(n: int) -> List[int]:
    """Split n in 1..=16 into power-of-two parts <= 8 (16 -> [8, 8])."""
    if n == RING:
        return [8, 8]
    return [bit for bit in (8, 4, 2, 1) if n & bit]


def _window_at(lv: Dict[int, List[T]], n: int, s: int, combine) -> T:
    """Reduction of the length-n window starting at s, folded from the
    power-of-two decomposition of n over the shared levels."""
    acc = None
    off = 0
    for part in _decompose(n):
        term = lv[part][(s + off) % RING]
        acc = term if acc is None else combine(acc, term)
        off += part
    return acc


def _check(planes: Sequence[T], n: int) -> None:
    if not (1 <= n <= RING):
        raise ValueError(f"window length must be in 1..=16, got {n}")
    if len(planes) != RING:
        raise ValueError(f"expected {RING} planes, got {len(planes)}")


def ring_windowed(planes: Sequence[T], n: int, combine) -> List[T]:
    """All 16 circular windowed reductions of length ``n``:
    ``out[s] = combine(planes[s], ..., planes[(s+n-1) % 16])``.
    ``combine`` must be associative (AND, OR, min, max, +)."""
    _check(planes, n)
    lv = _power_levels(planes, combine)
    return [_window_at(lv, n, s, combine) for s in range(RING)]


def ring_any_window_all(planes: Sequence[T], n: int, logical_and, logical_or) -> T:
    """Does ANY circular window of length ``n`` have all elements true?

    This is the FAST arc test: planes[i] is the per-pixel boolean "circle
    point i exceeds the threshold"; the result is the per-pixel keypoint
    candidacy (reference semantics: opencv_compat.rs:140-165).
    """
    _check(planes, n)
    lv = _power_levels(planes, logical_and)
    acc = None
    for s in range(RING):
        w = _window_at(lv, n, s, logical_and)
        acc = w if acc is None else logical_or(acc, w)
    return acc


def ring_max_of_window_min(planes: Sequence[T], n: int, minimum, maximum) -> T:
    """max over starts s of (min over the length-n window at s).

    Used by the MaxThreshold score: ``extreme_highest`` in the reference
    (opencv_compat.rs:195-199).
    """
    _check(planes, n)
    lv = _power_levels(planes, minimum)
    acc = None
    for s in range(RING):
        w = _window_at(lv, n, s, minimum)
        acc = w if acc is None else maximum(acc, w)
    return acc


def ring_min_of_window_max(planes: Sequence[T], n: int, minimum, maximum) -> T:
    """min over starts s of (max over the length-n window at s).

    ``extreme_lowest`` in the reference (opencv_compat.rs:201-204).
    """
    _check(planes, n)
    lv = _power_levels(planes, maximum)
    acc = None
    for s in range(RING):
        w = _window_at(lv, n, s, maximum)
        acc = w if acc is None else minimum(acc, w)
    return acc
