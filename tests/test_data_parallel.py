"""Data-parallel detection on the 8-device CPU mesh against one device —
the path `chip_smoke.py --four-cards` runs on four GPUs."""

import jax
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from feature_detector_fast_tpu.config import NonmaxMode
from feature_detector_fast_tpu.parallel import frontend, mesh as meshlib


@pytest.mark.parametrize("nonmax", list(NonmaxMode), ids=lambda m: m.value)
def test_sharded_detection_matches_single_device(rng, nonmax):
    mesh = meshlib.make_mesh()
    n = mesh.shape[meshlib.DATA_AXIS]
    frames = rng.integers(0, 256, (2 * n, 24, 40), np.uint8)
    sharded = jax.device_put(frames,
                             NamedSharding(mesh, P(meshlib.DATA_AXIS)))
    mask, score = frontend.detect_batch_sharded(sharded, 16, 9, nonmax,
                                                mesh=mesh)
    assert len(mask.sharding.device_set) == n
    want_mask, want_score = jax.jit(frontend.detect_batch,
                                    static_argnums=(1, 2, 3))(
        jax.device_put(frames, jax.devices()[0]), 16, 9, nonmax)
    np.testing.assert_array_equal(np.asarray(mask), np.asarray(want_mask))
    np.testing.assert_array_equal(np.asarray(score), np.asarray(want_score))
