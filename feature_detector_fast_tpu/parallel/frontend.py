"""Data-parallel front-end: batched FAST detection over a device mesh.

Frames shard over the ``data`` mesh axis; each device runs the fused dense
detector on its shard (vmapped over local frames).  This is the device
analogue of running the reference detector on N cores — except the sharding
is declarative and XLA inserts any cross-device movement (SURVEY.md §2.9).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import NonmaxMode
from ..ops import fast
from . import mesh as meshlib


def detect_batch(
    images: jax.Array, threshold: int, count: int, nonmax: NonmaxMode
) -> Tuple[jax.Array, jax.Array]:
    """vmapped dense detection over a (B, H, W) u8 batch."""
    fn = lambda img: fast.detect_dense(img, threshold, count, nonmax)
    return jax.vmap(fn)(images)


@functools.partial(jax.jit, static_argnums=(1, 2, 3), static_argnames=("mesh",))
def detect_batch_sharded(
    images: jax.Array,
    threshold: int,
    count: int,
    nonmax: NonmaxMode,
    *,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array]:
    """Batched detection with the batch dimension sharded over ``data``.

    Output masks/scores keep the same sharding, so downstream per-frame
    stages (descriptors, matching) stay local to the producing device.
    """
    sharding = NamedSharding(mesh, P(meshlib.DATA_AXIS))
    images = jax.lax.with_sharding_constraint(images, sharding)
    mask, score = detect_batch(images, threshold, count, nonmax)
    mask = jax.lax.with_sharding_constraint(mask, sharding)
    score = jax.lax.with_sharding_constraint(score, sharding)
    return mask, score
