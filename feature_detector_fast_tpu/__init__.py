"""feature_detector_fast_tpu — a FAST feature detection & SLAM framework
in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`iwanders/feature_detector_fast` (an AVX2 FAST detector with bit-exact
OpenCV 3.2 parity), grown into a SLAM/SfM engine:

  * `ops.fast` — dense branchless FAST detection as fused XLA pipelines
  * `ops.fast_triton` — the GPU kernels: detection to packed keypoint
    words (Pallas through Triton)
  * `oracle` — scalar & native differential oracles (the `opencv_compat`
    role from the reference)
  * `models` — descriptors, matching, pose estimation, pose graph, bundle
    adjustment
  * `parallel` — mesh/sharding layers for multi-chip and multi-host runs

Public API parity with the reference (`src/lib.rs`):

    >>> from feature_detector_fast_tpu import Config, NonmaxMode, detect
    >>> kps = detect(gray_u8_image, Config(threshold=16, count=9,
    ...                                    nonmax=NonmaxMode.OFF))
"""

from .config import Config, NonmaxMode, Point
from .api import detect, detect_arrays

__all__ = [
    "Config",
    "NonmaxMode",
    "Point",
    "detect",
    "detect_arrays",
]

__version__ = "0.1.0"
