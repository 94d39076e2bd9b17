"""Hierarchical word compaction: parity with direct nonzero, order, caps."""

import numpy as np
import pytest

from feature_detector_fast_tpu.ops import compact


def reference_points(mask):
    ys, xs = np.nonzero(mask)
    return np.stack([xs, ys], axis=-1).astype(np.uint32)


@pytest.mark.parametrize("shape", [(8, 8), (26, 32), (33, 70), (200, 300)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_word_compaction_roundtrip(rng, shape, density):
    mask = rng.random(shape) < density
    h, w = shape
    cap = -(-h * w // 32)  # no overflow possible
    widx, wbits, n, n_words = compact.compact_mask_words(mask, cap)
    assert int(n) == mask.sum()
    got = compact.expand_words_host(np.asarray(widx), np.asarray(wbits), int(n), w)
    np.testing.assert_array_equal(got, reference_points(mask))


def test_word_compaction_row_major_order(rng):
    mask = rng.random((40, 64)) < 0.1
    widx, wbits, n, n_words = compact.compact_mask_words(mask, 128)
    got = compact.expand_words_host(np.asarray(widx), np.asarray(wbits), int(n), 64)
    keys = [(int(y), int(x)) for x, y in got]
    assert keys == sorted(keys)


def test_word_compaction_overflow_detectable(rng):
    mask = np.ones((32, 32), bool)
    widx, wbits, n, n_words = compact.compact_mask_words(mask, 4)
    assert int(n_words) == 32 * 32 // 32
    assert int(n_words) > 4  # caller must retry


@pytest.mark.parametrize("shape", [(8, 8), (26, 32), (33, 70), (200, 300)])
@pytest.mark.parametrize("density", [0.0, 0.01, 0.3, 1.0])
def test_superword_compaction_roundtrip(rng, shape, density):
    mask = rng.random(shape) < density
    h, w = shape
    cap = -(-(-(-h * w // 32)) // compact.SUPER_SPAN)  # no overflow possible
    sidx, sbits, n, n_supers = compact.compact_mask_supers(mask, cap)
    assert int(n) == mask.sum()
    got = compact.expand_supers_host(np.asarray(sidx), np.asarray(sbits),
                                     int(n), w)
    np.testing.assert_array_equal(got, reference_points(mask))


def test_superword_matches_word_selection(rng):
    """Superword selection is a regrouping of the word-level semantic
    reference: lowering the superword encoding to words and dropping
    zero-bit entries must reproduce the word-level selection exactly."""
    for density in (0.005, 0.05, 0.4):
        mask = rng.random((64, 128)) < density
        widx, wbits, n, n_words = compact.compact_mask_words(mask, 256)
        sidx, sbits, sn, n_supers = compact.compact_mask_supers(mask, 64)
        assert int(n) == int(sn)
        lw_idx, lw_bits = compact.supers_to_words(np.asarray(sidx),
                                                  np.asarray(sbits))
        live = lw_bits != 0
        ref_live = np.asarray(wbits) != 0
        np.testing.assert_array_equal(lw_idx[live],
                                      np.asarray(widx)[ref_live])
        np.testing.assert_array_equal(lw_bits[live],
                                      np.asarray(wbits)[ref_live])


def test_superword_overflow_detectable(rng):
    mask = np.ones((64, 32), bool)
    sidx, sbits, n, n_supers = compact.compact_mask_supers(mask, 4)
    assert int(n_supers) == 64 * 32 // 32 // compact.SUPER_SPAN
    assert int(n_supers) > 4  # caller must retry


def test_packed_batch_roundtrip(rng):
    from feature_detector_fast_tpu import Config, NonmaxMode
    from feature_detector_fast_tpu.api import (
        _detect_compact_batch_packed,
        detect_arrays,
        unpack_batch_packed,
    )

    imgs = rng.integers(0, 256, (3, 26, 64), np.uint8)
    cap = 64
    packed = np.asarray(
        _detect_compact_batch_packed(imgs, 16, 9, NonmaxMode.MAX_THRESHOLD, cap)
    )
    kps = unpack_batch_packed(packed, cap, 64)
    for i in range(3):
        want = detect_arrays(imgs[i], Config(16, 9, NonmaxMode.MAX_THRESHOLD))
        np.testing.assert_array_equal(kps[i], want)


def test_padded_grid_compaction_matches_true_grid(rng):
    """The GPU route compacts on the kernel's per-row padded word grid and
    decodes with the padded width; validate that math on the CPU through
    the interpret-mode kernel."""
    from feature_detector_fast_tpu.config import NonmaxMode
    from feature_detector_fast_tpu.ops import fast_triton

    img = rng.integers(0, 256, (40, 200), np.uint8)  # W pads 200 -> 224
    words = fast_triton.detect_words(img, 16, 9, NonmaxMode.MAX_THRESHOLD,
                                     interpret=True)
    wp = fast_triton.padded_width(200)
    assert words.shape == (40, wp // 32)
    sidx, sbits, n, n_supers = compact.compact_packed_supers(words, 64)
    got = compact.expand_supers_host(np.asarray(sidx), np.asarray(sbits),
                                     int(n), wp)
    from feature_detector_fast_tpu import Config, detect_arrays
    want = detect_arrays(img, Config(16, 9, NonmaxMode.MAX_THRESHOLD))
    np.testing.assert_array_equal(got, want)


def test_native_expand_matches_numpy(rng):
    """C++ host-runtime expansion must be bit-identical to the numpy path
    (order included), single-frame and threaded-batch."""
    from feature_detector_fast_tpu.runtime import native

    if not native.available():
        pytest.skip("no native toolchain")

    w = 96
    batch, mw = 5, 40
    widx = np.sort(
        rng.choice(200, size=(batch, mw), replace=False).astype(np.int32), axis=1
    )
    wbits = rng.integers(0, 1 << 32, (batch, mw), dtype=np.uint32)
    wbits[:, -7:] = 0  # padding tail (expansion must skip zero words)
    counts = []
    for f in range(batch):
        ref = compact.expand_words_host(widx[f], wbits[f],
                                        int(np.unpackbits(wbits[f].view(np.uint8)).sum()), w)
        got = native.expand_words(widx[f], wbits[f], w)
        np.testing.assert_array_equal(got, ref)
        counts.append(len(ref))
    outs = native.expand_words_batch(widx, wbits, w, per_frame_cap=max(counts), threads=3)
    for f in range(batch):
        ref = compact.expand_words_host(widx[f], wbits[f], counts[f], w)
        np.testing.assert_array_equal(outs[f], ref)


def test_native_expand_supers_matches_numpy(rng):
    """C++ superword expansion must be bit-identical to the numpy path
    (order included), single-frame and threaded-batch."""
    from feature_detector_fast_tpu.runtime import native

    if not native.available():
        pytest.skip("no native toolchain")

    w, span = 96, compact.SUPER_SPAN
    batch, ms = 5, 12
    sidx = np.stack([
        np.sort(rng.choice(40, size=ms, replace=False)) for _ in range(batch)
    ]).astype(np.int32)
    sbits = rng.integers(0, 1 << 32, (batch, ms, span), dtype=np.uint32)
    sbits[:, -3:] = 0  # padding tail (expansion must skip zero rows)
    sbits[:, :, 2] = 0  # zero words inside live superwords too
    counts = []
    for f in range(batch):
        n = int(np.unpackbits(sbits[f].view(np.uint8)).sum())
        ref = compact.expand_supers_host(sidx[f], sbits[f], n, w)
        got = native.expand_supers(sidx[f], sbits[f], w)
        np.testing.assert_array_equal(got, ref)
        counts.append(len(ref))
    outs = native.expand_supers_batch(sidx, sbits, w,
                                      per_frame_cap=max(counts), threads=3)
    for f in range(batch):
        ref = compact.expand_supers_host(sidx[f], sbits[f], counts[f], w)
        np.testing.assert_array_equal(outs[f], ref)
