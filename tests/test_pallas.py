"""GPU FAST kernels (ops/fast_triton.py) vs the XLA reference, in
interpret mode on the CPU.

The kernels emit per-row packed keypoint words; every case checks them
against `compact.pack_mask_words` of `fast.detect_dense`'s mask on the
padded word grid — fuzz images, the committed real frame, configs,
counts, and awkward shapes (tile remainders, tiny and flat images).
"""

import numpy as np
import pytest

from feature_detector_fast_tpu.config import NonmaxMode
from feature_detector_fast_tpu.ops import compact, fast, fast_triton, windows

CONFIGS = [
    (16, 9, NonmaxMode.OFF),
    (16, 9, NonmaxMode.MAX_THRESHOLD),
    (16, 9, NonmaxMode.SUM_ABSOLUTE),
    (10, 12, NonmaxMode.MAX_THRESHOLD),
    (32, 16, NonmaxMode.SUM_ABSOLUTE),
]


def reference_words(img, threshold, count, nonmax):
    """pack_mask_words of the XLA mask, row by row on the padded grid."""
    import jax.numpy as jnp

    mask, _ = fast.detect_dense_jit(img, threshold, count, nonmax)
    h, w = img.shape
    padded = np.zeros((h, fast_triton.padded_width(w)), bool)
    padded[:, :w] = np.asarray(mask)
    bits, n = compact.pack_mask_words(jnp.asarray(padded))
    return np.asarray(bits).reshape(h, -1), int(n)


def assert_same(img, threshold, count, nonmax):
    got = np.asarray(fast_triton.detect_words(img, threshold, count, nonmax,
                                              interpret=True))
    want, _ = reference_words(img, threshold, count, nonmax)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_pallas_matches_dense_random(rng, cfg):
    img = rng.integers(0, 256, (64, 128), np.uint8)
    assert_same(img, *cfg)


@pytest.mark.parametrize(
    "shape", [(26, 32), (32, 128), (40, 200), (97, 130), (200, 300)]
)
def test_pallas_shapes(rng, shape):
    img = rng.integers(0, 256, shape, np.uint8)
    assert_same(img, 16, 9, NonmaxMode.MAX_THRESHOLD)
    assert_same(img, 16, 9, NonmaxMode.OFF)


def test_pallas_reference_image(reference_image):
    for cfg in CONFIGS:
        assert_same(reference_image, *cfg)


def test_pallas_flat_image():
    img = np.full((64, 128), 128, np.uint8)
    assert_same(img, 16, 9, NonmaxMode.SUM_ABSOLUTE)


@pytest.mark.parametrize("pattern", ["white", "black", "checker", "gradient"])
def test_pallas_pathological_images(pattern):
    """Degenerate inputs: uniform fields have no keypoints; checkerboards
    and gradients must still bit-match the XLA path."""
    h, w = 64, 128
    if pattern == "white":
        img = np.full((h, w), 255, np.uint8)
    elif pattern == "black":
        img = np.zeros((h, w), np.uint8)
    elif pattern == "checker":
        yy, xx = np.mgrid[:h, :w]
        img = (((yy // 4 + xx // 4) % 2) * 255).astype(np.uint8)
    else:
        img = np.tile(np.arange(w, dtype=np.uint8)[None, :] * 2, (h, 1))
    assert_same(img, 16, 9, NonmaxMode.MAX_THRESHOLD)
    assert_same(img, 16, 9, NonmaxMode.OFF)
    if pattern in ("white", "black"):
        words = fast_triton.detect_words(img, 16, 9, NonmaxMode.OFF,
                                         interpret=True)
        assert not np.asarray(words).any()


@pytest.mark.parametrize("cfg", CONFIGS, ids=str)
def test_packed_words_kernel_matches_dense_pack(rng, cfg):
    """The kernel's words compact to exactly what the dense path's do:
    same superwords, same count, and zero words past the true width."""
    from feature_detector_fast_tpu import api

    img = rng.integers(0, 256, (40, 200), np.uint8)  # 200 -> 7 words/row
    threshold, count, nonmax = cfg
    words = np.asarray(fast_triton.detect_words(img, threshold, count, nonmax,
                                                interpret=True))
    want, n_ref = reference_words(img, threshold, count, nonmax)
    np.testing.assert_array_equal(words, want)
    assert not (words[:, -1] >> (200 - 6 * 32)).any()  # columns >= 200
    sidx, sbits, n, n_supers = api._compact_triton(
        img, threshold, count, nonmax, 64, interpret=True)
    got = compact.expand_supers_host(np.asarray(sidx), np.asarray(sbits),
                                     int(n), fast_triton.padded_width(200))
    mask, _ = fast.detect_dense_jit(img, threshold, count, nonmax)
    yx = np.argwhere(np.asarray(mask))
    np.testing.assert_array_equal(got, yx[:, ::-1].astype(np.uint32))
    assert int(n) == n_ref == len(yx)


def test_padded_dims_and_super_cap_bound():
    """On the kernel's route the superword-cap bound (api._max_super_cap)
    covers exactly the per-row word grid: true height x padded width."""
    from unittest import mock

    from feature_detector_fast_tpu import api

    with mock.patch.object(api, "detector_route", lambda: "triton"):
        assert api.effective_width(200) == 224
        assert api.effective_width(1920) == 1920
        cap = api._max_super_cap(1080, 200)
    n_words = 1080 * (224 // 32)
    assert cap == -(-n_words // compact.SUPER_SPAN)


def test_threshold_contract(rng):
    """The kernels take the reference's u8 threshold (lib.rs:41) and stay
    bit-exact at both ends of the range."""
    img = rng.integers(0, 256, (64, 128), np.uint8)
    for bad in (-1, 256, 300):
        with pytest.raises(ValueError):
            fast_triton.detect_words(img, bad, 9, NonmaxMode.OFF,
                                     interpret=True)
    for t in (0, 255):
        assert_same(img, t, 9, NonmaxMode.OFF)
        assert_same(img, t, 9, NonmaxMode.SUM_ABSOLUTE)


@pytest.mark.parametrize("count", range(1, 17))
def test_arc_bit_chain_matches_ring_windows(count):
    """The kernels' 16-bit arc test equals the boolean-plane ring test of
    ops.windows on every one of the 2**16 masks."""
    masks = np.arange(1 << 16, dtype=np.uint32)
    got = np.asarray(fast_triton._arc_any(masks, count))
    planes = [((masks >> i) & 1).astype(bool) for i in range(16)]
    want = windows.ring_any_window_all(planes, count, np.logical_and,
                                       np.logical_or)
    np.testing.assert_array_equal(got, want)


def test_kernel_batches_under_vmap(rng):
    """The serving path vmaps the kernels over a frame batch."""
    import jax

    imgs = rng.integers(0, 256, (3, 40, 96), np.uint8)
    for nonmax in (NonmaxMode.OFF, NonmaxMode.SUM_ABSOLUTE):
        got = np.asarray(jax.vmap(lambda im: fast_triton.detect_words(
            im, 16, 9, nonmax, interpret=True))(imgs))
        for i in range(imgs.shape[0]):
            np.testing.assert_array_equal(
                got[i], reference_words(imgs[i], 16, 9, nonmax)[0])


@pytest.mark.gpu
@pytest.mark.parametrize("nonmax", list(NonmaxMode), ids=lambda m: m.value)
def test_compiled_kernel_matches_xla_on_gpu(gpu, rng, nonmax):
    """The kernels as the card compiles them (no interpret mode) against
    the XLA reference on the same card, at a tile-remainder shape."""
    img = rng.integers(0, 256, (97, 230), np.uint8)
    got = np.asarray(fast_triton.detect_words(img, 16, 9, nonmax))
    want, _ = reference_words(img, 16, 9, nonmax)
    np.testing.assert_array_equal(got, want)
