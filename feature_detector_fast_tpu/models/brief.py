"""BRIEF binary descriptors.

New scope beyond the reference detector (BASELINE.json north_star:
"BRIEF-style descriptor extraction and matching").  Design choices:

  * fixed-capacity keypoint slots (top-K by score) — static shapes under
    jit; invalid slots carry a validity bit instead of changing shape,
  * 5x5 box smoothing computed densely (fused XLA cumsum/slice ops) before
    sampling — the classic BRIEF pre-smoothing,
  * the 256 point-pair samples are one batched gather from the smoothed
    image (K x 512 samples), the only gather in the front-end,
  * descriptors packed to (K, 8) uint32; Hamming matching is a +-1
    matmul (see models.match).

The sampling pattern is a fixed, seeded isotropic Gaussian pair set
(classic BRIEF-256), generated once at import with numpy so it is
identical across hosts and backends.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

#: Descriptor length in bits and packed uint32 words.
BITS = 256
WORDS = BITS // 32

#: Patch half-size: pattern offsets lie in [-PATCH_R, PATCH_R].
PATCH_R = 15
#: Keypoints closer than this to the border get invalid descriptors
#: (pattern + smoothing halo).
BORDER = PATCH_R + 3


def _make_pattern(seed: int = 0x1EAF) -> np.ndarray:
    """(BITS, 2, 2) int32 array of (dx, dy) pairs, Gaussian sigma = R/2,
    clipped to the patch."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(0.0, PATCH_R / 2.0, size=(BITS, 2, 2))
    return np.clip(np.round(pts), -PATCH_R, PATCH_R).astype(np.int32)


PATTERN: np.ndarray = _make_pattern()

#: Orientation quantization for steered (rotation-aware) BRIEF.
N_ANGLE_BINS = 30


def _quadrant_decomposition():
    """Each orientation bin's angle decomposes as 90 deg * q + rho with
    rho in (-45, 45]; 90-degree rotations are exact integer-grid
    isometries, so only the residual rho needs a rounded pattern table.
    The 30 bins share just 15 distinct residuals (gcd structure of
    12-degree steps vs 90-degree quadrants).

    Returns (quadrant (N_ANGLE_BINS,), residual_bin (N_ANGLE_BINS,),
    residual_angles_deg (N_RESIDUAL,))."""
    qs, rbs, residuals = [], [], []
    for b in range(N_ANGLE_BINS):
        theta = 360.0 * b / N_ANGLE_BINS
        q = int(round(theta / 90.0)) % 4
        rho = round(theta - 90.0 * round(theta / 90.0), 9)
        if rho not in residuals:
            residuals.append(rho)
        qs.append(q)
        rbs.append(residuals.index(rho))
    return (np.asarray(qs, np.int32), np.asarray(rbs, np.int32),
            np.asarray(residuals, np.float64))


QUADRANT, RESIDUAL_BIN, _RESIDUAL_ANGLES = _quadrant_decomposition()
N_RESIDUAL_BINS = len(_RESIDUAL_ANGLES)


def _rot90_points(q: int, x: np.ndarray, y: np.ndarray):
    """Rotate integer points by 90 deg * q (exact)."""
    for _ in range(q % 4):
        x, y = -y, x
    return x, y


def _make_residual_patterns() -> np.ndarray:
    """(N_RESIDUAL_BINS, BITS, 2, 2) int32: the base pattern rotated to
    each residual angle (rounded to the pixel grid, clipped to the patch)."""
    out = np.zeros((N_RESIDUAL_BINS, BITS, 2, 2), np.int32)
    x = PATTERN[..., 0]
    y = PATTERN[..., 1]
    for r, ang in enumerate(_RESIDUAL_ANGLES):
        a = np.deg2rad(ang)
        c, s = np.cos(a), np.sin(a)
        out[r, ..., 0] = np.clip(np.round(c * x - s * y), -PATCH_R, PATCH_R)
        out[r, ..., 1] = np.clip(np.round(s * x + c * y), -PATCH_R, PATCH_R)
    return out


RESIDUAL_PATTERNS: np.ndarray = _make_residual_patterns()


def _make_rotated_patterns() -> np.ndarray:
    """(N_ANGLE_BINS, BITS, 2, 2) int32: the steered-BRIEF table (ORB
    style), DEFINED as the 90-degree isometries of the residual tables:
    90-degree rotations are exact on the pixel grid, so only the residual
    angle is rounded.  (Direct per-bin rounding differs on 87/30720 coords
    where cos/sin land samples exactly on half-integers — the
    decomposition is the canonical table.)"""
    out = np.zeros((N_ANGLE_BINS, BITS, 2, 2), np.int32)
    for b in range(N_ANGLE_BINS):
        rp = RESIDUAL_PATTERNS[RESIDUAL_BIN[b]]
        x, y = _rot90_points(int(QUADRANT[b]), rp[..., 0], rp[..., 1])
        out[b, ..., 0] = x
        out[b, ..., 1] = y
    return out


ROTATED_PATTERNS: np.ndarray = _make_rotated_patterns()


def _boxsum_chain(x: jax.Array, r: int) -> jax.Array:
    """(2r+1)-square box sum, zero-padded at borders, EXACT integer math.

    Doubling-chain shifted adds instead of cumsum: window sums of length
    2L come from two length-L sums, and (2r+1) is folded from its binary
    decomposition — ~2 log2(r) plane adds per axis.  (An f32 cumsum
    formulation accumulates prefix sums far beyond the 24-bit mantissa,
    so large-image moments would lose integer exactness; i32 shifted adds
    are exact.)"""
    n = 2 * r + 1

    def box1d(v, axis):
        m = v.shape[axis]
        pad_shape = list(v.shape)
        pad_shape[axis] = r
        z = jnp.zeros(pad_shape, v.dtype)
        vp = jnp.concatenate([z, v, z], axis=axis)  # m + 2r
        # s[L][j] = sum vp[j .. j+L-1]
        levels = {1: vp}
        L = 1
        while 2 * L <= n:
            prev = levels[L]
            span = prev.shape[axis] - L
            levels[2 * L] = (
                jax.lax.slice_in_dim(prev, 0, span, axis=axis)
                + jax.lax.slice_in_dim(prev, L, L + span, axis=axis)
            )
            L *= 2
        acc = None
        off = 0
        for part in sorted((p for p in levels if n & p), reverse=True):
            term = jax.lax.slice_in_dim(levels[part], off, off + m, axis=axis)
            acc = term if acc is None else acc + term
            off += part
        return acc

    return box1d(box1d(x, 0), 1)


def orientation_bins(image: jax.Array, kps: "Keypoints") -> jax.Array:
    """Intensity-centroid orientation per keypoint, quantized to
    N_ANGLE_BINS (ORB's moment method, computed densely).

    The patch moments m10 = sum I(x,y)(x - xc) and m01 over a
    (2R+1)-square patch come from three dense integer box filters (of I*x,
    I*y, I), sampled at the keypoints — no per-keypoint patch gathers.
    All moment arithmetic is exact i32 (peak magnitude 255*1919*961 <
    2^31; the final m10/m01 are < 2^24 so their f32 casts are exact too).
    """
    h, w = image.shape
    img = image.astype(jnp.int32)
    xs = jnp.arange(w, dtype=jnp.int32)[None, :]
    ys = jnp.arange(h, dtype=jnp.int32)[:, None]

    r = PATCH_R
    s_i = _boxsum_chain(img, r)
    s_ix = _boxsum_chain(img * xs, r)
    s_iy = _boxsum_chain(img * ys, r)

    kx = kps.xy[:, 0]
    ky = kps.xy[:, 1]
    flat = lambda m: m.reshape(-1)[jnp.clip(ky * w + kx, 0, h * w - 1)]
    m10 = (flat(s_ix) - kx * flat(s_i)).astype(jnp.float32)
    m01 = (flat(s_iy) - ky * flat(s_i)).astype(jnp.float32)
    angle = jnp.arctan2(m01, m10)  # [-pi, pi]
    bins = jnp.round(angle / (2.0 * jnp.pi) * N_ANGLE_BINS).astype(jnp.int32)
    return jnp.mod(bins, N_ANGLE_BINS)


def box_blur5(image: jax.Array) -> jax.Array:
    """5x5 box sum via separable shifted adds (dense, fused).  Returns
    int32 sums (not divided — BRIEF only compares, scale cancels).
    Integer adds are associative, so this equals a cumsum formulation
    bit for bit."""
    img = image.astype(jnp.int32)

    def box1d(x, axis):
        n = x.shape[axis]
        inner = sum(
            jax.lax.slice_in_dim(x, d, n - 4 + d, axis=axis) for d in range(1, 5)
        ) + jax.lax.slice_in_dim(x, 0, n - 4, axis=axis)
        # pad edges by clamping (2 rows/cols each side)
        first = jax.lax.slice_in_dim(inner, 0, 1, axis=axis)
        last = jax.lax.slice_in_dim(inner, inner.shape[axis] - 1, inner.shape[axis], axis=axis)
        reps_first = jnp.concatenate([first] * 2, axis=axis)
        reps_last = jnp.concatenate([last] * 2, axis=axis)
        return jnp.concatenate([reps_first, inner, reps_last], axis=axis)

    return box1d(box1d(img, 0), 1)


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (device-resident, static shape)."""

    xy: jax.Array  # (K, 2) int32 — (x, y); undefined where ~valid
    score: jax.Array  # (K,) int32
    valid: jax.Array  # (K,) bool


def _sel_group(n: int, k: int) -> int:
    """Pixels per selection group in the two-level top-K (see select_topk).

    The two levels touch n/G + k*G keys, so G wants to shrink as k grows
    (G ~ sqrt(n / k)).  The choice of G changes the cost only, never the
    result (see select_topk); it has not been tuned on the GPU."""
    return 64 if n < 1500 * k else 128


def _topk_key(mask: jax.Array, score: jax.Array) -> Tuple[jax.Array, int]:
    """Packed (clipped score, reversed row-major index) int31 selection key
    per pixel, -1 where masked — ties break toward smaller index, keeping
    selection deterministic across backends.  The index field is sized to
    the image; the score clip uses whatever bits remain (1023 at 1080p)."""
    h, w = mask.shape
    idx_bits = max(1, (h * w - 1).bit_length())
    if idx_bits > 29:
        raise ValueError(f"image too large for top-k key packing: {h}x{w}")
    max_score = (1 << (31 - idx_bits)) - 1
    flat_mask = mask.reshape(-1)
    flat_score = jnp.minimum(score.reshape(-1).astype(jnp.int32), max_score)
    idx = jnp.arange(h * w, dtype=jnp.int32)
    key = jnp.where(flat_mask, (flat_score << idx_bits) | (h * w - 1 - idx), -1)
    return key, idx_bits


def _decode_topk(
    topv: jax.Array, idx_bits: int, h: int, w: int, score: jax.Array
) -> Keypoints:
    """Unpack selected keys to Keypoints.  Reported scores are regathered
    EXACTLY from the score plane (k cheap scalar gathers) — the key's
    score field is clipped to the bits left over by index packing (1023
    at 1080p; see _topk_key) and must not leak to consumers."""
    valid = topv >= 0
    sel = jnp.where(valid, h * w - 1 - (topv & ((1 << idx_bits) - 1)), 0)
    x = (sel % w).astype(jnp.int32)
    y = (sel // w).astype(jnp.int32)
    s = jnp.where(valid, score.reshape(-1)[sel].astype(jnp.int32), 0)
    return Keypoints(jnp.stack([x, y], axis=-1), s, valid)


def select_topk(mask: jax.Array, score: jax.Array, k: int) -> Keypoints:
    """Deterministic top-K keypoints by (score, then row-major position).

    Ordering uses the score CLIPPED to the bits left over by index
    packing (1023 at 1080p, 4095 at VGA — see _topk_key): corners whose
    scores all exceed the clip rank by position among themselves.
    Reported Keypoints.score values are exact (regathered), never
    clipped.

    Two-level selection instead of one top_k over all H*W keys (a
    near-full-image partial sort):
    group pixels G per group (G ~ sqrt(H*W/k), see _sel_group), take each
    group's max key (a cheap lane reduce), top_k the H*W/G group maxima,
    then top_k the selected groups' gathered key rows.  Provably
    identical to the flat top_k for any G: a global top-k key lives in a
    group whose max ranks top-k (each better-ranked group contributes at
    least one better key)."""
    h, w = mask.shape
    key, idx_bits = _topk_key(mask, score)
    n = h * w
    gsz = _sel_group(n, int(k))
    ns = -(-n // gsz)
    pad = ns * gsz - n
    if pad:
        key = jnp.concatenate([key, jnp.full((pad,), -1, jnp.int32)])
    rows = key.reshape(ns, gsz)
    k_s = min(int(k), ns)
    _, si = jax.lax.top_k(rows.max(axis=1), k_s)
    cand = rows[si].reshape(-1)  # (k_s * gsz,)
    k2 = min(int(k), cand.shape[0])
    topv, _ = jax.lax.top_k(cand, k2)
    if k2 < int(k):
        topv = jnp.concatenate(
            [topv, jnp.full((int(k) - k2,), -1, jnp.int32)])
    return _decode_topk(topv, idx_bits, h, w, score)


def _select_topk_flat(mask: jax.Array, score: jax.Array, k: int) -> Keypoints:
    """Reference implementation: one top_k over every pixel's key.  Kept as
    the differential oracle for select_topk."""
    h, w = mask.shape
    key, idx_bits = _topk_key(mask, score)
    topv, _ = jax.lax.top_k(key, min(int(k), h * w))
    if int(k) > h * w:
        topv = jnp.concatenate(
            [topv, jnp.full((int(k) - h * w,), -1, jnp.int32)])
    return _decode_topk(topv, idx_bits, h, w, score)


@functools.partial(jax.jit, static_argnums=())
def describe(image: jax.Array, kps: Keypoints) -> Tuple[jax.Array, jax.Array]:
    """BRIEF-256 descriptors at the keypoint slots.

    Returns (desc (K, WORDS) uint32, valid (K,) bool) — valid goes False
    for slots whose patch leaves the image.
    """
    h, w = image.shape
    blur = box_blur5(image).reshape(-1)

    pat = jnp.asarray(PATTERN)  # (BITS, 2, 2)
    off_flat = pat[..., 1] * w + pat[..., 0]  # (BITS, 2)
    # Both pattern endpoints ride ONE (2*BITS,) offset vector, so the
    # gather output has no tiny trailing dimension.
    off_cat = jnp.concatenate([off_flat[:, 0], off_flat[:, 1]])  # (2*BITS,)

    base = kps.xy[:, 1] * w + kps.xy[:, 0]  # (K,)
    inb = (
        kps.valid
        & (kps.xy[:, 0] >= BORDER)
        & (kps.xy[:, 0] < w - BORDER)
        & (kps.xy[:, 1] >= BORDER)
        & (kps.xy[:, 1] < h - BORDER)
    )
    safe_base = jnp.where(inb, base, 0)
    sample_idx = safe_base[:, None] + off_cat[None, :]  # (K, 2*BITS)
    samples = blur[jnp.clip(sample_idx, 0, h * w - 1)]
    bits = samples[:, :BITS] < samples[:, BITS:]  # (K, BITS)

    return _pack_bits(bits), inb


def _pack_bits(bits: jax.Array) -> jax.Array:
    """(K, BITS) bool -> (K, WORDS) uint32, bit b of word j = bit 32j+b."""
    shifts = jnp.arange(32, dtype=jnp.uint32)
    grouped = bits.reshape(-1, WORDS, 32).astype(jnp.uint32)
    return (grouped << shifts[None, None, :]).sum(axis=-1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnums=())
def describe_oriented(
    image: jax.Array, kps: Keypoints
) -> Tuple[jax.Array, jax.Array]:
    """Steered BRIEF-256 (ORB-style): the sampling pattern is rotated to
    each keypoint's intensity-centroid orientation (quantized to
    N_ANGLE_BINS), making descriptors rotation-aware.  Same return
    contract as :func:`describe`."""
    h, w = image.shape
    blur = box_blur5(image).reshape(-1)
    bins = orientation_bins(image, kps)  # (K,)

    pats = jnp.asarray(ROTATED_PATTERNS)  # (B, BITS, 2, 2)
    off_flat = pats[..., 1] * w + pats[..., 0]  # (B, BITS, 2)
    # Endpoint-major (B, 2*BITS) offsets, then one row gather per keypoint
    # — keeps every gather output free of tiny trailing dims (see
    # describe()).
    off_cat = jnp.concatenate([off_flat[..., 0], off_flat[..., 1]], axis=-1)
    off_k = off_cat[bins]  # (K, 2*BITS)

    base = kps.xy[:, 1] * w + kps.xy[:, 0]
    inb = (
        kps.valid
        & (kps.xy[:, 0] >= BORDER)
        & (kps.xy[:, 0] < w - BORDER)
        & (kps.xy[:, 1] >= BORDER)
        & (kps.xy[:, 1] < h - BORDER)
    )
    safe_base = jnp.where(inb, base, 0)
    sample_idx = safe_base[:, None] + off_k  # (K, 2*BITS)
    samples = blur[jnp.clip(sample_idx, 0, h * w - 1)]
    bits = samples[:, :BITS] < samples[:, BITS:]

    return _pack_bits(bits), inb


def detect_and_describe(
    image: jax.Array, threshold: int, count: int, k: int,
    oriented: bool = False,
) -> Tuple[Keypoints, jax.Array, jax.Array]:
    """Front-end step: FAST (SumAbsolute scores) -> top-K -> BRIEF.

    ``oriented=True`` uses steered BRIEF (rotation-aware) at the cost of
    the orientation moment filters.  Returns (keypoints, desc (K, WORDS)
    uint32, desc_valid (K,) bool); fully fused under jit, device-resident.
    """
    from ..config import NonmaxMode
    from ..ops import fast

    mask, score = fast.detect_dense(image, threshold, count,
                                    NonmaxMode.SUM_ABSOLUTE)
    kps = select_topk(mask, score, k)
    describe_fn = describe_oriented if oriented else describe
    desc, dvalid = describe_fn.__wrapped__(image, kps)
    return kps, desc, dvalid


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def detect_and_describe_batch(
    images: jax.Array, threshold: int, count: int, k: int,
    oriented: bool = False,
) -> Tuple[Keypoints, jax.Array, jax.Array]:
    """Batched front-end: one fused dispatch for a whole (B, H, W) frame
    stack — the serving path.  Returns batch-leading Keypoints /
    descriptors."""
    return jax.vmap(
        lambda im: detect_and_describe(im, threshold, count, k, oriented)
    )(images)
