"""Device mesh construction and sharding helpers.

The reference is single-core SIMD; all multi-device structure here is new
scope (SURVEY.md §2.9).  Axis conventions used across the framework:

  * ``data``  — frames / image batches (embarrassingly parallel front-end)
  * ``model`` — landmark/camera blocks inside bundle adjustment

Collectives are XLA-generated (`psum`, `all_gather`, `ppermute`) via
`shard_map` over these axes.  Every GPU of a host reaches every other at
the same NVLink rate, so a mesh's shape follows the algorithm alone.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    *,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (data, model) mesh over the available devices.

    Defaults to all devices on the data axis — the natural layout for the
    per-frame front-end.  BA runs re-mesh with ``n_model > 1``.
    """
    devs = list(devices if devices is not None else jax.devices())
    if n_data is None:
        n_data = len(devs) // n_model
    if n_data * n_model > len(devs):
        raise ValueError(
            f"mesh {n_data}x{n_model} needs {n_data * n_model} devices, "
            f"have {len(devs)}"
        )
    grid = np.array(devs[: n_data * n_model]).reshape(n_data, n_model)
    return Mesh(grid, (DATA_AXIS, MODEL_AXIS))


def data_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (batch) dimension over the data axis."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
