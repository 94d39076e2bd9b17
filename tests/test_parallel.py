"""Multi-device front-end tests on the spoofed 8-device CPU mesh."""

import jax
import numpy as np
import pytest

#: Fast-lane exclusion (VERDICT r3 #7): this module is SLAM/distributed-
#: heavy; `pytest -m 'not slow'` skips it for kernel iteration.
pytestmark = pytest.mark.slow

from feature_detector_fast_tpu.config import Config, NonmaxMode
from feature_detector_fast_tpu.ops import fast
from feature_detector_fast_tpu.parallel import frontend, mesh as meshlib


def test_virtual_devices_present():
    assert len(jax.devices()) == 8


def test_sharded_batch_detect_matches_single_device(rng):
    mesh = meshlib.make_mesh()
    images = rng.integers(0, 256, (8, 32, 64), np.uint8)
    mask, score = frontend.detect_batch_sharded(
        images, 16, 9, NonmaxMode.MAX_THRESHOLD, mesh=mesh
    )
    mask, score = np.asarray(mask), np.asarray(score)
    for i in range(images.shape[0]):
        m1, s1 = fast.detect_dense_jit(images[i], 16, 9, NonmaxMode.MAX_THRESHOLD)
        np.testing.assert_array_equal(mask[i], np.asarray(m1))
        np.testing.assert_array_equal(score[i], np.asarray(s1))


def test_graft_entry_dryrun():
    import __graft_entry__ as ge

    fn, args = ge.entry()
    jax.eval_shape(fn, *args)  # traces + shape-checks without compiling
    ge.dryrun_multichip(8)
