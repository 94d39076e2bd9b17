"""Differential tests: dense XLA detector vs scalar oracle vs cv2.

Tier-3 analogue of the reference's tests/compare.rs: run the fast path and
the oracle on the same images and require identical keypoint vectors for
the five reference configs (tests/compare.rs:66-114) plus the full count
sweep 9..=16 the reference supports (lib.rs:45-48).
"""

import cv2
import numpy as np
import pytest

from feature_detector_fast_tpu import Config, NonmaxMode, detect_arrays
from feature_detector_fast_tpu.oracle import naive

REFERENCE_CONFIGS = [
    Config(16, 9, NonmaxMode.OFF),
    Config(16, 9, NonmaxMode.MAX_THRESHOLD),
    Config(16, 9, NonmaxMode.SUM_ABSOLUTE),
    Config(16, 12, NonmaxMode.SUM_ABSOLUTE),
    Config(32, 12, NonmaxMode.SUM_ABSOLUTE),
]


def as_tuples(xy):
    return [(int(x), int(y)) for x, y in xy]


@pytest.mark.parametrize("config", REFERENCE_CONFIGS, ids=str)
def test_dense_matches_oracle_random(rng, config):
    for _ in range(2):
        img = rng.integers(0, 256, (26, 32), np.uint8)
        fast_kps = as_tuples(detect_arrays(img, config))
        oracle_kps = [(p.x, p.y) for p in naive.detector(img, config)]
        assert fast_kps == oracle_kps


@pytest.mark.parametrize("count", list(range(9, 17)))
def test_dense_matches_oracle_count_sweep(rng, count):
    config = Config(threshold=12, count=count, nonmax=NonmaxMode.MAX_THRESHOLD)
    img = rng.integers(0, 256, (26, 32), np.uint8)
    fast_kps = as_tuples(detect_arrays(img, config))
    oracle_kps = [(p.x, p.y) for p in naive.detector(img, config)]
    assert fast_kps == oracle_kps


def test_dense_matches_cv2_reference_image(reference_image):
    """OpenCV parity on the committed frame — the headline property
    (README.md:7).  cv2 is the real OpenCV, not a reimplementation."""
    img = reference_image

    det = cv2.FastFeatureDetector_create(
        threshold=16, nonmaxSuppression=False,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    cv2_off = sorted((int(k.pt[0]), int(k.pt[1])) for k in det.detect(img))
    ours_off = sorted(as_tuples(detect_arrays(img, Config(16, 9, NonmaxMode.OFF))))
    assert ours_off == cv2_off

    det_nm = cv2.FastFeatureDetector_create(
        threshold=16, nonmaxSuppression=True,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    cv2_nm = sorted((int(k.pt[0]), int(k.pt[1])) for k in det_nm.detect(img))
    ours_nm = sorted(
        as_tuples(detect_arrays(img, Config(16, 9, NonmaxMode.MAX_THRESHOLD))))
    assert ours_nm == cv2_nm


def test_dense_matches_cv2_native_1080p():
    """OpenCV parity at the reference's true benchmark scale: the committed
    natural-statistics 1080p frame (media/golden_1080p.png, 24130 OFF
    keypoints vs the reference frame's 23184 — README.md:58-59).

    MaxThreshold differs from MODERN cv2 in exactly the border rows
    y==3 and y==H-4: OpenCV 3.2 — the parity target the reference pins
    (opencv_compat.rs:238-240, fast_simd.rs:590-592) — drops nonmax
    keypoints there, and later OpenCV keeps them.  So OFF must match
    bit-exactly, and MaxThreshold must match after trimming those two rows
    from the modern-cv2 output (with every cv2-only point IN those rows)."""
    import os

    from feature_detector_fast_tpu.utils.image import load_luma8

    img = load_luma8(os.path.join(os.path.dirname(__file__), os.pardir,
                                  "media", "golden_1080p.png"))
    h = img.shape[0]

    det = cv2.FastFeatureDetector_create(
        threshold=16, nonmaxSuppression=False,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    cv2_off = sorted((int(k.pt[0]), int(k.pt[1])) for k in det.detect(img))
    ours_off = sorted(as_tuples(detect_arrays(img, Config(16, 9, NonmaxMode.OFF))))
    assert ours_off == cv2_off

    det_nm = cv2.FastFeatureDetector_create(
        threshold=16, nonmaxSuppression=True,
        type=cv2.FAST_FEATURE_DETECTOR_TYPE_9_16)
    cv2_nm = set((int(k.pt[0]), int(k.pt[1])) for k in det_nm.detect(img))
    ours_nm = set(
        as_tuples(detect_arrays(img, Config(16, 9, NonmaxMode.MAX_THRESHOLD))))
    assert ours_nm - cv2_nm == set()
    border_only = cv2_nm - ours_nm
    assert all(y in (3, h - 4) for _, y in border_only), border_only
    assert set(p for p in cv2_nm if p[1] not in (3, h - 4)) == ours_nm


def test_dense_emission_order_row_major(reference_image):
    """Keypoints come out in row-major (y, x) order like the reference's
    row-scan push order (fast_simd.rs:550)."""
    xy = detect_arrays(reference_image, Config(16, 9, NonmaxMode.OFF))
    keys = [(int(y), int(x)) for x, y in xy]
    assert keys == sorted(keys)


def test_super_cap_overflow_retry(reference_image):
    """A tiny initial compaction cap must not drop keypoints (SURVEY.md §7 iv)."""
    full = as_tuples(detect_arrays(reference_image, Config(16, 9, NonmaxMode.OFF)))
    capped = as_tuples(
        detect_arrays(reference_image, Config(16, 9, NonmaxMode.OFF), max_supers=4))
    assert capped == full


def test_grow_cap_jumps_to_identity():
    """Cap policy: ANY overflow retry jumps straight to the full-grid
    identity cap, so a frame costs at most one retry ever."""
    from feature_detector_fast_tpu.api import _grow_cap

    assert _grow_cap(2048, 2875, 8100) == 8100
    assert _grow_cap(4, 5, 8100) == 8100
    assert _grow_cap(8100, 8100, 8100) == 8100


@pytest.mark.parametrize(
    "nonmax,count",
    [(m, n) for m in NonmaxMode for n in range(9, 17)],
    ids=lambda v: v.value if isinstance(v, NonmaxMode) else str(v),
)
def test_dense_matches_native_oracle_all_configs(reference_image, nonmax,
                                                 count):
    """ops/fast.py against the C++ scalar oracle on the real 300x200 frame
    in every (nonmax mode x count 9..16) configuration at t=16 — the set
    the GPU smoke run checks at 1080p."""
    from feature_detector_fast_tpu.oracle import native
    from feature_detector_fast_tpu.ops import fast

    mask, _ = fast.detect_dense_jit(reference_image, 16, count, nonmax)
    yx = np.argwhere(np.asarray(mask))
    want = native.detect_arrays(reference_image, Config(16, count, nonmax))
    np.testing.assert_array_equal(yx[:, ::-1].astype(np.uint32), want)
