"""Pipelined detection serving.

Formalizes the production serving pattern the benchmark measures: frames
stream through in batches, each batch is ONE fused device dispatch
(detect + score + nonmax + word compaction), and host readback overlaps
across in-flight batches via async copies, which hides the transfer
latencies behind device work.

    pipe = DetectorPipeline(Config(16, 9, NonmaxMode.MAX_THRESHOLD))
    for batch in frame_batches:          # (B, H, W) uint8 each
        pipe.submit(batch)
        for kps in pipe.ready():         # completed earlier batches
            ...
    for kps in pipe.drain():             # flush the tail
        ...
"""

from __future__ import annotations

from collections import deque
from typing import Deque, Iterator, List, Optional, Tuple

import numpy as np

from .api import (
    _DEFAULT_SUPER_CAP,
    _detect_compact_batch_packed,
    effective_width,
    unpack_batch_packed,
)
from .config import Config


class DetectorPipeline:
    """Keeps up to ``depth`` batches in flight on the device."""

    def __init__(self, config: Optional[Config] = None, *, depth: int = 2,
                 max_supers: int = _DEFAULT_SUPER_CAP):
        self.config = config or Config()
        self.depth = int(depth)
        self.max_supers = int(max_supers)
        self._inflight: Deque[Tuple[object, int]] = deque()

    def _args(self):
        c = self.config
        return (int(c.threshold), int(c.count), c.nonmax, self.max_supers)

    def submit(self, batch: np.ndarray) -> None:
        """Enqueue a (B, H, W) uint8 batch (non-blocking dispatch)."""
        import jax

        if batch.ndim != 3 or batch.dtype != np.uint8:
            raise ValueError("expected a (B, H, W) uint8 batch")
        packed = _detect_compact_batch_packed(
            jax.device_put(batch), *self._args()
        )
        packed.copy_to_host_async()
        self._inflight.append((packed, batch.shape[-1]))

    def _decode(self, packed, width) -> List[np.ndarray]:
        # unpack_batch_packed performs the overflow check and raises.
        return unpack_batch_packed(np.asarray(packed), self.max_supers,
                                   effective_width(width))

    def ready(self) -> Iterator[List[np.ndarray]]:
        """Yield per-frame keypoint lists of batches beyond the pipeline
        depth (blocks only on the oldest batch)."""
        while len(self._inflight) > self.depth:
            packed, width = self._inflight.popleft()
            yield self._decode(packed, width)

    def drain(self) -> Iterator[List[np.ndarray]]:
        """Flush all remaining in-flight batches."""
        while self._inflight:
            packed, width = self._inflight.popleft()
            yield self._decode(packed, width)
