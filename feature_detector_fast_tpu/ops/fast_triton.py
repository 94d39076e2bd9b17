"""FAST detection to packed keypoint words, as Pallas kernels for the GPU.

`ops/fast.py` is the plain reference: XLA fuses its taps and scores, but
the 3x3 nonmax rolls a full score plane and `compact.pack_mask_words`
reduces a dense boolean plane.  These kernels read the u8 frame (which
stays in L2) and write 32-pixel words, so the dense mask never reaches
device memory:

  * `OFF`: one kernel per (rows x cols) tile — the 16 circle taps are
    masked loads at shifted offsets of the frame, the bright and dark
    rings become 16-bit masks in registers, the n-of-16 arc test is an
    AND-doubling chain on those masks, and the keypoint bits are packed
    into words and stored.
  * `MAX_THRESHOLD` / `SUM_ABSOLUTE`: the same kernel writes the
    keypoint-masked score plane (u16) instead, and a second kernel reads
    it at the 9 offsets of the 3x3 neighbourhood, keeps strict maxima and
    packs them.  Triton cannot shift a tile held in registers, so the
    neighbours' scores come back through memory (L1/L2) rather than from
    a halo recomputed in the same program.

Word layout (the one place it is stated): every image row owns
``padded_width(w) // 32`` words; bit b of word j in row y is pixel
(32 j + b, y), and the columns past ``w`` are zero.  Flat keypoint
indices therefore encode ``y * padded_width(w) + x``.

The kernels go through Pallas' Triton route.  ``interpret=True`` runs
them on the CPU for tests.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import NonmaxMode
from ..geometry import CIRCLE, RADIUS
from . import windows
from .compact import WORD_BITS

#: Tile shapes (rows, cols) and warps per program, by kernel.  Columns are
#: a multiple of WORD_BITS so a tile owns whole words.
_TILE = {
    NonmaxMode.OFF: (16, 128, 4),
    NonmaxMode.SUM_ABSOLUTE: (16, 128, 4),
    NonmaxMode.MAX_THRESHOLD: (8, 64, 2),
}
_NONMAX_TILE = (16, 128, 4)


def padded_width(w: int) -> int:
    """Columns in which packed words encode flat indices."""
    return -(-int(w) // WORD_BITS) * WORD_BITS


def _arc_any(bits: jax.Array, count: int) -> jax.Array:
    """Does the 16-bit ring mask ``bits`` (uint32) hold ``count``
    consecutive set bits, wrapping around?  Bit s of ``run[k]`` is set iff
    ring bits s..s+k-1 are all set; a window of ``count`` folds the
    power-of-two runs of its binary decomposition."""
    x = bits | (bits << 16)  # the ring twice: windows never wrap
    run = {1: x}
    for k in (2, 4, 8):
        run[k] = run[k // 2] & (run[k // 2] >> (k // 2))
    acc, off = None, 0
    for part in windows._decompose(count):
        term = run[part] >> off
        acc = term if acc is None else acc & term
        off += part
    return (acc & 0xFFFF) != 0


def _tile_coords(th: int, tw: int):
    rows = pl.program_id(0) * th + jnp.arange(th, dtype=jnp.int32)
    cols = pl.program_id(1) * tw + jnp.arange(tw, dtype=jnp.int32)
    return rows[:, None], cols[None, :]


def _load_shifted(ref, rows, cols, dy: int, dx: int, h: int, w: int):
    """``ref[rows + dy, cols + dx]`` as int32, 0 outside the array."""
    r = rows + dy
    c = cols + dx
    ok = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    v = plgpu.load(ref.at[r, c], mask=ok, other=0)
    return v.astype(jnp.int32)


def _pack_words(keep: jax.Array, cols: jax.Array) -> jax.Array:
    """(th, tw) bool -> (th, tw // 32) int32 words, bit = column % 32."""
    th, tw = keep.shape
    bits = keep.astype(jnp.int32) << (cols % WORD_BITS)
    return jnp.sum(bits.reshape(th, tw // WORD_BITS, WORD_BITS), axis=2)


def _store_words(words_ref, words, rows, tw: int, h: int):
    n_wcols = words_ref.shape[1]
    wcols = (pl.program_id(1) * (tw // WORD_BITS)
             + jnp.arange(tw // WORD_BITS, dtype=jnp.int32))[None, :]
    plgpu.store(words_ref.at[rows, wcols], words,
                mask=(rows < h) & (wcols < n_wcols))


def _detect_kernel(img_ref, out_ref, *, threshold: int, count: int,
                   nonmax: NonmaxMode, th: int, tw: int):
    """One tile: keypoint words (OFF) or the keypoint-masked score."""
    h, w = img_ref.shape
    rows, cols = _tile_coords(th, tw)
    c = _load_shifted(img_ref, rows, cols, 0, 0, h, w)
    t = int(threshold)
    bright = jnp.zeros(c.shape, jnp.uint32)
    dark = jnp.zeros(c.shape, jnp.uint32)
    diffs = []
    sum_light = jnp.zeros(c.shape, jnp.int32)
    sum_dark = jnp.zeros(c.shape, jnp.int32)
    for i, (dx, dy) in enumerate(CIRCLE):
        d = _load_shifted(img_ref, rows, cols, dy, dx, h, w) - c  # tap - c
        bright = bright | ((d > t).astype(jnp.uint32) << i)
        dark = dark | ((-d > t).astype(jnp.uint32) << i)
        if nonmax is NonmaxMode.SUM_ABSOLUTE:
            sum_light = sum_light + jnp.where(d > t, d - t, 0)
            sum_dark = sum_dark + jnp.where(-d > t, -d - t, 0)
        elif nonmax is NonmaxMode.MAX_THRESHOLD:
            diffs.append(-d)  # center - tap, as the reference scores it
    interior = ((rows >= RADIUS) & (rows < h - RADIUS)
                & (cols >= RADIUS) & (cols < w - RADIUS))
    kp = (_arc_any(bright, count) | _arc_any(dark, count)) & interior
    if nonmax is NonmaxMode.OFF:
        _store_words(out_ref, _pack_words(kp, cols), rows, tw, h)
        return
    if nonmax is NonmaxMode.SUM_ABSOLUTE:
        score = jnp.maximum(sum_light, sum_dark)
    else:
        eh = windows.ring_max_of_window_min(diffs, count, jnp.minimum,
                                            jnp.maximum)
        el = windows.ring_min_of_window_max(diffs, count, jnp.minimum,
                                            jnp.maximum)
        score = jnp.minimum(jnp.abs(eh), jnp.abs(el))
    score = jnp.where(kp, score, 0).astype(out_ref.dtype)
    plgpu.store(out_ref.at[rows, cols], score, mask=(rows < h) & (cols < w))


def _nonmax_kernel(score_ref, words_ref, *, th: int, tw: int):
    """One tile of 3x3 strict-maximum suppression, packed to words.  A
    pixel survives iff its (keypoint-masked) score beats all 8
    neighbours; rows y == 3 and y == H-4 compete but are dropped."""
    h, w = score_ref.shape
    rows, cols = _tile_coords(th, tw)
    s = _load_shifted(score_ref, rows, cols, 0, 0, h, w)
    neigh = jnp.zeros(s.shape, jnp.int32)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dy or dx:
                neigh = jnp.maximum(
                    neigh, _load_shifted(score_ref, rows, cols, dy, dx, h, w))
    keep = (s > neigh) & (rows != RADIUS) & (rows != h - RADIUS - 1)
    _store_words(words_ref, _pack_words(keep, cols), rows, tw, h)


def _call(kernel, out_shape, grid, num_warps: int, interpret: bool, name: str):
    return pl.pallas_call(
        kernel,
        out_shape=out_shape,
        grid=grid,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps,
                                             num_stages=1),
        interpret=interpret,
        name=name,
    )


def detect_words(image: jax.Array, threshold: int, count: int,
                 nonmax: NonmaxMode, interpret: bool = False) -> jax.Array:
    """(H, padded_width(W) // 32) int32 keypoint words of a u8 frame,
    post-nonmax; bit-exact with packing `fast.detect_dense`'s mask row by
    row.  Batch with `jax.vmap`."""
    nonmax = NonmaxMode(nonmax)
    if not 0 <= int(threshold) <= 255:
        raise ValueError(f"threshold must be in 0..=255, got {threshold}")
    h, w = image.shape
    words_shape = jax.ShapeDtypeStruct((h, padded_width(w) // WORD_BITS),
                                       jnp.int32)
    th, tw, warps = _TILE[nonmax]
    detect = functools.partial(_detect_kernel, threshold=int(threshold),
                               count=int(count), nonmax=nonmax, th=th, tw=tw)
    grid = (pl.cdiv(h, th), pl.cdiv(w, tw))
    if nonmax is NonmaxMode.OFF:
        return _call(detect, words_shape, grid, warps, interpret,
                     "fast_words_off")(image)
    score = _call(detect, jax.ShapeDtypeStruct((h, w), jnp.uint16), grid,
                  warps, interpret, f"fast_score_{nonmax.value}")(image)
    th, tw, warps = _NONMAX_TILE
    return _call(functools.partial(_nonmax_kernel, th=th, tw=tw), words_shape,
                 (pl.cdiv(h, th), pl.cdiv(w, tw)), warps, interpret,
                 "fast_nonmax_words")(score)
