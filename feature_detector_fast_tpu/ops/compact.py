"""Dense-mask to keypoint-list compaction.

Device programs have static shapes, so detection produces a dense (H, W)
mask or packed words; the variable-length keypoint list the reference API
returns (`Vec<Point>`, lib.rs:56-64) is recovered by compaction.

A direct `jnp.nonzero` over the 2M-pixel mask lowers to a full-size sort.
Instead compaction is hierarchical, exploiting keypoint sparsity
(~0.5-1% of pixels):

  1. pack the mask 32 pixels/word in row-major order (shift + minor-axis
     reduce),
  2. group words into SUPER_SPAN-word *superwords* (256 px each) and
     select the nonzero superwords' indices with `lax.top_k` over a
     descending-index key — an 8x smaller partial sort than word-level
     selection,
  3. gather the selected superwords' word-bit rows whole.

When the cap covers the whole superword grid, `_select_nonzero_supers`
emits the identity superword layout instead — no sort, no gather; that is
where api._grow_cap's overflow retry lands.  Frames that FIT their initial
cap keep the small-cap top_k path and its small readback buffer.

The (superword-index, word-bits-row) pairs are a complete, ordered sparse
encoding (~72 KB/frame at the default cap); expanding to flat pixel
indices is a trivial bit loop done on the host (runtime/native.py, numpy
fallback here).  Emission order stays row-major ((y, x) lexicographic),
matching the reference's row-scan push order (fast_simd.rs:550) — this
matters for golden hashing.

Caps never drop keypoints: true superword counts are returned so callers
retry with a bigger cap on overflow (SURVEY.md §7 hard part iv).

Word-level selection (`compact_mask_words`) is kept as the semantic
reference the superword path is differentially tested against.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

WORD_BITS = 32
#: Words per superword.  8 x 32 = 256 px per selection key: big enough to
#: shrink the top_k by 8x, small enough that keypoint-bearing regions stay
#: dense within a selected span (the gathered payload grows only ~12%).
SUPER_SPAN = 8


def pack_mask_words(mask: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Pack a boolean mask into 32-pixel words (row-major flat order).

    Returns (words int32 (ceil(H*W/32),), n int32 total set pixels).
    """
    flat = mask.reshape(-1)
    pad = (-flat.size) % WORD_BITS
    if pad:
        flat = jnp.concatenate([flat, jnp.zeros((pad,), flat.dtype)])
    w = flat.reshape(-1, WORD_BITS).astype(jnp.int32)
    shifts = jax.lax.broadcasted_iota(jnp.int32, w.shape, 1)
    bits = (w << shifts).sum(axis=1, dtype=jnp.int32)
    n = jax.lax.population_count(bits.view(jnp.uint32)).sum(dtype=jnp.int32)
    return bits, n


def compact_mask_words(
    mask: jax.Array, max_words: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Hierarchical compaction: returns (word_idx (max_words,) int32,
    word_bits (max_words,) int32, n_points, n_words).

    ``word_idx`` holds the ascending indices of nonzero 32-pixel words
    (padded with n_total_words); ``word_bits`` their packed bits (padded
    with 0).  Overflow detection: ``n_words > max_words``.
    """
    bits, n = pack_mask_words(mask)
    widx, wbits, n_words = _select_nonzero_words(bits, max_words)
    return widx, wbits, n, n_words


def _select_nonzero_words(
    bits: jax.Array, max_words: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Select the (ascending) indices + bits of nonzero words, capped.

    Uses top_k with a descending-index key: the k largest keys are the k
    smallest nonzero indices — same first-max_words-words contract as a
    capped nonzero, but a partial sort instead of a full one."""
    nw = bits.shape[0]
    nzw = bits != 0
    n_words = jnp.sum(nzw, dtype=jnp.int32)
    key = jnp.where(nzw, nw - 1 - jnp.arange(nw, dtype=jnp.int32), -1)
    k_eff = min(int(max_words), nw)  # top_k needs k <= size
    topv, topi = jax.lax.top_k(key, k_eff)
    widx = jnp.where(topv >= 0, topi, nw).astype(jnp.int32)
    if k_eff < int(max_words):
        fill = jnp.full((int(max_words) - k_eff,), nw, jnp.int32)
        widx = jnp.concatenate([widx, fill])
    safe = jnp.minimum(widx, nw - 1)
    wbits = jnp.where(widx < nw, bits[safe], 0)
    return widx, wbits, n_words


def _select_nonzero_supers(
    bits: jax.Array, max_supers: int
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Select the (ascending) indices + word-bit rows of nonzero
    SUPER_SPAN-word superwords, capped.

    Returns (super_idx (max_supers,) int32 padded with the grid's total
    superword count ns, super_bits (max_supers, SUPER_SPAN) int32 padded
    with 0, n_supers int32 true nonzero-superword count)."""
    nw = bits.shape[0]
    ns = -(-nw // SUPER_SPAN)
    pad = ns * SUPER_SPAN - nw
    if pad:
        bits = jnp.concatenate([bits, jnp.zeros((pad,), bits.dtype)])
    rows = bits.reshape(ns, SUPER_SPAN)
    nz = jnp.any(rows != 0, axis=1)
    n_supers = jnp.sum(nz, dtype=jnp.int32)
    if int(max_supers) >= ns:
        # The cap covers the whole grid, so selection cannot shrink the
        # result — emit the identity superword layout instead: ascending
        # by construction, zero superwords marked with the ns padding
        # sentinel and zero bits (every decoder skips zero-bit words, so
        # interleaved padding is a valid encoding).  This skips the
        # top_k partial sort AND the row gather — on dense frames whose
        # right-sized cap approaches the grid size (the 1080p golden
        # frame's OFF config has ~70% nonzero superwords), top_k is
        # selecting almost everything and is pure overhead.
        idx = jnp.arange(ns, dtype=jnp.int32)
        sidx = jnp.where(nz, idx, ns)
        sbits = rows  # a zero superword's row is already all-zero
        if int(max_supers) > ns:
            pad_n = int(max_supers) - ns
            sidx = jnp.concatenate([sidx, jnp.full((pad_n,), ns, jnp.int32)])
            sbits = jnp.concatenate(
                [sbits, jnp.zeros((pad_n, SUPER_SPAN), sbits.dtype)])
        return sidx, sbits, n_supers
    key = jnp.where(nz, ns - 1 - jnp.arange(ns, dtype=jnp.int32), -1)
    k_eff = int(max_supers)
    topv, topi = jax.lax.top_k(key, k_eff)
    sidx = jnp.where(topv >= 0, topi, ns).astype(jnp.int32)
    safe = jnp.minimum(sidx, ns - 1)
    sbits = jnp.where((sidx < ns)[:, None], rows[safe], 0)
    return sidx, sbits, n_supers


def compact_mask_supers(
    mask: jax.Array, max_supers: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Superword-hierarchical compaction of a dense mask: returns
    (super_idx (max_supers,) int32, super_bits (max_supers, SUPER_SPAN)
    int32, n_points, n_supers).  Overflow: ``n_supers > max_supers``."""
    bits, n = pack_mask_words(mask)
    sidx, sbits, n_supers = _select_nonzero_supers(bits, max_supers)
    return sidx, sbits, n, n_supers


def compact_packed_supers(
    words2d: jax.Array, max_supers: int
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """`compact_mask_supers` for a kernel that already emitted packed words
    (fast_triton.detect_words: (rows, words per row) i32).  Same return
    contract."""
    bits = words2d.reshape(-1)
    n = jax.lax.population_count(bits.view(jnp.uint32)).sum(dtype=jnp.int32)
    sidx, sbits, n_supers = _select_nonzero_supers(bits, max_supers)
    return sidx, sbits, n, n_supers


def supers_to_words(
    super_idx: np.ndarray, super_bits: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side lowering of a superword encoding (..., cap_s) +
    (..., cap_s, SUPER_SPAN) to the word encoding (..., cap_s * SUPER_SPAN)
    x2 — padding superwords lower to zero-bit words, which every decoder
    skips."""
    super_idx = np.asarray(super_idx, np.int64)
    super_bits = np.asarray(super_bits)
    j = np.arange(SUPER_SPAN, dtype=np.int64)
    widx = (super_idx[..., None] * SUPER_SPAN + j).reshape(
        super_idx.shape[:-1] + (-1,)
    )
    wbits = super_bits.reshape(super_bits.shape[:-2] + (-1,))
    return widx.astype(np.int32), wbits


def expand_supers_host(
    super_idx: np.ndarray, super_bits: np.ndarray, n_points: int, width: int
) -> np.ndarray:
    """Expand a superword encoding to an (N, 2) uint32 (x, y) array on the
    host, preserving row-major order."""
    widx, wbits = supers_to_words(super_idx, super_bits)
    return expand_words_host(widx, wbits.view(np.uint32), n_points, width)


def expand_words_host(
    word_idx: np.ndarray, word_bits: np.ndarray, n_points: int, width: int
) -> np.ndarray:
    """Expand (word_idx, word_bits) to an (N, 2) uint32 (x, y) array on the
    host, preserving row-major order."""
    word_idx = np.asarray(word_idx, np.int64)
    word_bits = np.asarray(word_bits, np.uint32)
    live = word_bits != 0
    word_idx = word_idx[live]
    word_bits = word_bits[live]
    if word_idx.size == 0:
        return np.zeros((0, 2), np.uint32)
    # (n_words, 32) bit matrix; bit b of word w -> flat index w*32 + b.
    bitmat = (word_bits[:, None] >> np.arange(WORD_BITS, dtype=np.uint32)) & 1
    flat = (word_idx[:, None] * WORD_BITS + np.arange(WORD_BITS))[bitmat.astype(bool)]
    assert flat.size == n_points, (flat.size, n_points)
    return np.stack([flat % width, flat // width], axis=-1).astype(np.uint32)


# ---------------------------------------------------------------------------
# Legacy full-sort compaction (kept for differential tests).
# ---------------------------------------------------------------------------


def compact_mask(mask: jax.Array, max_points: int) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Direct nonzero compaction: (xy (max_points, 2) uint32, n, overflow).
    A full-size sort — use `compact_mask_supers` in hot paths."""
    h, w = mask.shape
    flat = mask.reshape(-1)
    n = jnp.sum(flat, dtype=jnp.int32)
    (idx,) = jnp.nonzero(flat, size=int(max_points), fill_value=h * w)
    x = (idx % w).astype(jnp.uint32)
    y = (idx // w).astype(jnp.uint32)
    return jnp.stack([x, y], axis=-1), n, n > max_points


@functools.partial(jax.jit, static_argnums=(1,))
def compact_mask_jit(mask: jax.Array, max_points: int):
    return compact_mask(mask, max_points)
