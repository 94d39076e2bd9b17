"""Host-facing detection API.

Mirrors the reference's `lib.rs` entry points: free function ``detect``
(lib.rs:62-64) and ``Config.detect`` (lib.rs:56-58), returning keypoints in
row-major order exactly like the reference's `Vec<Point>`.

Design: the device side is ONE jit program per (shape, config, cap) —
detect + score + nonmax + hierarchical superword compaction — so a
detection costs a single dispatch and a single small result fetch.  A
batched variant amortizes dispatch further; it is the production serving
path and what `bench.py` measures.  `detector_route` picks the Pallas
kernels on the GPU and the XLA reference on the CPU.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config, NonmaxMode, Point
from .ops import compact, fast, fast_triton

ImageLike = Union[np.ndarray, jax.Array]

#: Initial superword-compaction cap (256-pixel superwords containing >= 1
#: keypoint; ops.compact.SUPER_SPAN words each); grows geometrically on
#: overflow, so even a pathological all-corners image is handled without
#: dropping keypoints.
_DEFAULT_SUPER_CAP = 1 << 11


def detector_route(platform: Optional[str] = None) -> str:
    """The one place the detector's implementation is chosen, from the
    platform JAX runs on: ``"triton"`` (the Pallas kernels of
    ops/fast_triton.py) on the GPU, ``"xla"`` (ops/fast.py, the plain
    reference) on the CPU.  Any other platform is an error."""
    platform = platform or jax.default_backend()
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no FAST detector for platform {platform!r}")


def effective_width(w: int) -> int:
    """Width in which compacted flat indices are encoded: the GPU kernel's
    per-row word layout (fast_triton.padded_width), or the true width."""
    if detector_route() == "triton":
        return fast_triton.padded_width(w)
    return int(w)


def _max_super_cap(h: int, w: int) -> int:
    """Upper bound on nonzero superwords: the whole word grid, so the
    identity-layout cap `_grow_cap` jumps to can never overflow."""
    n_words = -(-h * effective_width(w) // compact.WORD_BITS)
    return -(-n_words // compact.SUPER_SPAN)


def tight_cap(n_supers: int, floor: int = 512) -> int:
    """Right-sized compaction cap for a known true superword count: ~12%
    headroom, rounded to a 512 multiple (bounds the number of distinct
    compiled programs)."""
    return max(int(floor), -(-(n_supers + n_supers // 8) // 512) * 512)


def _grow_cap(cap: int, n_supers: int, max_cap: int) -> int:
    """Overflow-retry cap growth: jump straight to the full-grid bound,
    where ops.compact emits the identity superword layout (no top_k, no
    gather).  That layout can never overflow again, so any frame costs at
    most one retry; frames that fit their initial cap keep the small-cap
    top_k path and its small readback buffer."""
    del cap, n_supers
    return max_cap


def _compact_xla(image, threshold: int, count: int, nonmax: NonmaxMode,
                 max_supers: int):
    mask, _ = fast.detect_dense(image, threshold, count, nonmax)
    return compact.compact_mask_supers(mask, max_supers)


def _compact_triton(image, threshold: int, count: int, nonmax: NonmaxMode,
                    max_supers: int, interpret: bool = False):
    words = fast_triton.detect_words(image, threshold, count, nonmax,
                                     interpret=interpret)
    return compact.compact_packed_supers(words, max_supers)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _detect_compact(image, threshold: int, count: int, nonmax: NonmaxMode,
                    max_supers: int):
    """Fused detect + hierarchical superword compaction.  Returns
    (super_idx, super_bits, n_points, n_supers); see ops.compact.  Indices
    encode flat positions over `effective_width(w)` columns."""
    if detector_route() == "triton":
        return _compact_triton(image, threshold, count, nonmax, max_supers)
    return _compact_xla(image, threshold, count, nonmax, max_supers)


#: Score upper bound across modes: MaxThreshold <= 255 (a u8 threshold);
#: SumAbsolute <= 16 * 255.  The bisection below runs over [0, _SCORE_MAX].
_SCORE_MAX = 4096


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _detect_strongest_compact(image, threshold: int, count: int,
                              nonmax: NonmaxMode, k: int, max_supers: int):
    """Detect, then keep only the ~k HIGHEST-SCORING keypoints — without
    any full-plane sort.

    Selection bisects the score threshold T on device — each of
    the 13 static steps is one plane compare + popcount reduce — to the
    LARGEST T with count(score >= T) >= min(k, total); the surviving mask
    then rides the normal superword compaction.  Deterministic, fixed
    compute, row-major output.  Returns (super_idx, super_bits, n_points,
    n_supers, t_star); n_points >= k only by score ties at T*.
    """
    mask, score = fast.detect_dense(image, threshold, count, nonmax)
    mask = mask.astype(bool)
    s = jnp.where(mask, score.astype(jnp.int32), -1)
    total = jnp.sum(mask, dtype=jnp.int32)
    want = jnp.minimum(jnp.int32(int(k)), total)

    # Invariant: count(s >= lo) >= want, count(s >= hi) < want.
    lo, hi = jnp.int32(0), jnp.int32(_SCORE_MAX + 1)
    for _ in range(13):  # 2**13 > _SCORE_MAX + 1
        mid = (lo + hi) // 2
        c = jnp.sum(s >= mid, dtype=jnp.int32)
        ok = c >= want
        lo = jnp.where(ok, mid, lo)
        hi = jnp.where(ok, hi, mid)
    keep = mask & (s >= lo)
    sidx, sbits, n, n_supers = compact.compact_mask_supers(keep, max_supers)
    return sidx, sbits, n, n_supers, lo


def detect_strongest_arrays(
    image: ImageLike,
    config: Optional[Config] = None,
    *,
    k: int,
    max_supers: Optional[int] = None,
) -> Tuple[np.ndarray, int]:
    """Detect and keep the ~k strongest keypoints (requires a score mode).

    Returns (xy (N, 2) uint32 in row-major order, score threshold used).
    N >= min(k, total detected): the cut is the largest score threshold
    whose survivor count still reaches k, so N exceeds k only when
    several keypoints tie exactly at that threshold (the reference has no
    per-keypoint budget API; this mirrors OpenCV-style retainBest without
    the host-side sort)."""
    config = config or Config()
    if config.nonmax is NonmaxMode.OFF:
        raise ValueError("detect_strongest requires a score mode "
                         "(MAX_THRESHOLD or SUM_ABSOLUTE)")
    img = _as_device_image(image, 2)
    h, w = img.shape
    cap = int(max_supers or _DEFAULT_SUPER_CAP)
    max_cap = _max_super_cap(h, w)
    while True:
        sidx, sbits, n, n_supers, t_star = _detect_strongest_compact(
            img, int(config.threshold), int(config.count), config.nonmax,
            int(k), cap,
        )
        n_supers = int(n_supers)
        if n_supers <= cap:
            xy = _expand_batch(
                np.asarray(sidx)[None], np.asarray(sbits)[None],
                np.asarray([int(n)]), int(w),
            )[0]
            return xy, int(t_star)
        cap = _grow_cap(cap, n_supers, max_cap)


def _as_device_image(image: ImageLike, expect_ndim: int) -> jax.Array:
    img = jnp.asarray(image)
    if img.dtype != jnp.uint8:
        raise TypeError(f"expected a uint8 grayscale image, got dtype {img.dtype}")
    if img.ndim != expect_ndim:
        raise ValueError(
            f"expected a {expect_ndim}-D image array, got shape {img.shape}"
        )
    return img


def detect_arrays(
    image: ImageLike,
    config: Optional[Config] = None,
    *,
    max_supers: Optional[int] = None,
) -> np.ndarray:
    """Detect keypoints; returns an (N, 2) uint32 array of (x, y) rows in
    row-major image order.  ``max_supers`` only sets the initial compaction
    cap — on overflow the cap grows and detection reruns, so results are
    always complete (SURVEY.md §7 hard part iv)."""
    config = config or Config()
    img = _as_device_image(image, 2)
    h, w = img.shape
    cap = int(max_supers or _DEFAULT_SUPER_CAP)
    max_cap = _max_super_cap(h, w)
    w_eff = effective_width(w)
    while True:
        sidx, sbits, n, n_supers = _detect_compact(
            img, int(config.threshold), int(config.count), config.nonmax, cap
        )
        n_supers = int(n_supers)
        if n_supers <= cap:
            return _expand_batch(
                np.asarray(sidx)[None], np.asarray(sbits)[None],
                np.asarray([int(n)]), w_eff,
            )[0]
        cap = _grow_cap(cap, n_supers, max_cap)


def detect(
    image: ImageLike,
    config: Optional[Config] = None,
    *,
    max_supers: Optional[int] = None,
) -> List[Point]:
    """Detect keypoints as a list of :class:`Point` (reference: lib.rs:62-64)."""
    xy = detect_arrays(image, config, max_supers=max_supers)
    return [Point(int(x), int(y)) for x, y in xy]


# ---------------------------------------------------------------------------
# Batched serving path
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _detect_compact_batch(images, threshold: int, count: int, nonmax: NonmaxMode,
                          max_supers: int):
    def one(im):
        return _detect_compact.__wrapped__(im, threshold, count, nonmax, max_supers)

    return jax.vmap(one)(images)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _detect_compact_batch_packed(images, threshold: int, count: int,
                                 nonmax: NonmaxMode, max_supers: int):
    """Batched detect + compact with a SINGLE packed int32 output per frame:
    slot 0 the true keypoint count, slot 1 the true nonzero-superword
    count, slots [128, 128+cap) the superword indices, slots
    [128+cap, 128+cap*(1+SUPER_SPAN)) the superwords' word bits (row-major
    (cap, SUPER_SPAN)).  One output array means one device->host fetch per
    round."""
    ms = int(max_supers)

    def one(im):
        sidx, sbits, n, n_supers = _detect_compact.__wrapped__(
            im, threshold, count, nonmax, ms
        )
        head = jnp.zeros((128,), jnp.int32).at[0].set(n).at[1].set(n_supers)
        return jnp.concatenate([head, sidx, sbits.reshape(-1)])

    return jax.vmap(one)(images)


def _expand_batch(sidx: np.ndarray, sbits: np.ndarray, n_np: np.ndarray,
                  width: int) -> List[np.ndarray]:
    """Expand a (B, cap) + (B, cap, SUPER_SPAN) superword batch to
    per-frame (N_i, 2) arrays — through the native threaded host runtime
    when available (runtime/native.py), else the numpy path."""
    from .runtime import native as _native

    if _native.available():
        cap = max(1, int(n_np.max(initial=0)))
        out = _native.expand_supers_batch(sidx, sbits.view(np.uint32), width,
                                          per_frame_cap=cap)
    else:
        out = [
            compact.expand_supers_host(sidx[i], sbits[i], int(n_np[i]), width)
            for i in range(sidx.shape[0])
        ]
    for i, kp in enumerate(out):
        assert kp.shape[0] == int(n_np[i]), (kp.shape, int(n_np[i]))
    return out


def unpack_batch_packed(packed: np.ndarray, max_supers: int, width: int):
    """Host-side decode of `_detect_compact_batch_packed` output into a list
    of (N_i, 2) uint32 keypoint arrays."""
    n_supers = packed[:, 1]
    if int(n_supers.max(initial=0)) > max_supers:
        raise OverflowError(
            f"superword cap exceeded: {int(n_supers.max())} > {max_supers}")
    span = compact.SUPER_SPAN
    sidx = packed[:, 128 : 128 + max_supers]
    sbits = packed[:, 128 + max_supers : 128 + max_supers * (1 + span)]
    return _expand_batch(sidx, sbits.reshape(-1, max_supers, span),
                         packed[:, 0], width)


def detect_batch_arrays(
    images: ImageLike,
    config: Optional[Config] = None,
    *,
    max_supers: Optional[int] = None,
) -> List[np.ndarray]:
    """Detect over a (B, H, W) u8 batch in one dispatch; returns a list of
    per-frame (N_i, 2) uint32 arrays."""
    config = config or Config()
    imgs = _as_device_image(images, 3)
    b, h, w = imgs.shape
    cap = int(max_supers or _DEFAULT_SUPER_CAP)
    max_cap = _max_super_cap(h, w)
    w_eff = effective_width(w)
    while True:
        sidx, sbits, n, n_supers = _detect_compact_batch(
            imgs, int(config.threshold), int(config.count), config.nonmax, cap
        )
        n_supers_np = np.asarray(n_supers)
        if n_supers_np.max(initial=0) <= cap:
            sidx, sbits, n_np = np.asarray(sidx), np.asarray(sbits), np.asarray(n)
            return _expand_batch(sidx, sbits, n_np, w_eff)
        cap = _grow_cap(cap, int(n_supers_np.max()), max_cap)


def detect_batch_device(
    images: jax.Array,
    config: Optional[Config] = None,
    *,
    max_supers: int = _DEFAULT_SUPER_CAP,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Device-resident batched detection for on-device consumers (descriptors,
    matching): returns (super_idx (B, cap), super_bits (B, cap,
    SUPER_SPAN), n (B,), n_supers (B,)) without any host transfer."""
    config = config or Config()
    return _detect_compact_batch(
        images, int(config.threshold), int(config.count), config.nonmax,
        int(max_supers),
    )
