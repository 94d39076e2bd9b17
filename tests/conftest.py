"""Test configuration: run JAX on CPU with 8 virtual devices.

Multi-chip sharding layers are tested the standard JAX way — a spoofed
8-device host-platform mesh (SURVEY.md §4).  Must run before jax imports.

Tests marked ``gpu`` need the card: `pytest tests/ -m gpu` leaves JAX on
its default platform, and the `gpu` fixture skips them where there is no
GPU.  Every other selection runs on the CPU.
"""

import os
import re
import sys

# Tests import repo-root modules (bench, __graft_entry__); pytest does not
# put the rootdir on sys.path, so invoking from another cwd would fail.
sys.path.insert(0, os.path.join(os.path.dirname(__file__), os.pardir))

# The mesh tests assume exactly 8 virtual
# devices, so an incompatible pre-set count is REPLACED (keeping it would
# fail every mesh test with a confusing count mismatch).
xla_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" in xla_flags:
    xla_flags = re.sub(
        r"--xla_force_host_platform_device_count=\d+",
        "--xla_force_host_platform_device_count=8", xla_flags)
    os.environ["XLA_FLAGS"] = xla_flags
else:
    os.environ["XLA_FLAGS"] = (
        xla_flags + " --xla_force_host_platform_device_count=8"
    ).strip()

# XLA:CPU's multi-threaded LLVM codegen has segfaulted flakily deep into
# long test sessions (inside backend_compile_and_load, at a different
# test each time, while every module passes in isolation).  Serializing
# the per-module codegen split is the mitigation; compile wall time on
# the CPU suite is dominated by tracing/optimization, not codegen, so the
# cost is small.
if "xla_cpu_parallel_codegen_split_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_cpu_parallel_codegen_split_count=1"

import jax
import numpy as np
import pytest


def pytest_configure(config):
    # Everything but `-m gpu` runs on the CPU whatever accelerator the
    # machine has; jax.config wins over the environment as long as it is
    # set before first backend use (collection comes after this hook).
    if config.getoption("markexpr", "").strip() != "gpu":
        jax.config.update("jax_platforms", "cpu")


@pytest.fixture()
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX runs on {devices[0].platform}")
    return devices[0]


@pytest.fixture()
def x64():
    """Scoped float64 for geometry/SLAM numerics.  Modules used to flip
    jax_enable_x64 globally at IMPORT time, which contaminated every
    other module in the session (pytest imports all test files before
    running any test) — the bit-exact detector/kernel differentials were
    silently running under x64 promotion instead of the x32 semantics the
    device uses.  Request this fixture (usually via an autouse module fixture)
    instead."""
    old = jax.config.read("jax_enable_x64")
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


@pytest.fixture(scope="session")
def reference_image() -> np.ndarray:
    """The committed 300x200 gray frame from the reference repo
    (media/Screenshot315_torch_grey.png, tests/compare.rs:24-25)."""
    from feature_detector_fast_tpu.utils.image import load_luma8

    return load_luma8(os.path.join(os.path.dirname(__file__), "..", "media",
                                   "Screenshot315_torch_grey.png"))


@pytest.fixture()
def rng() -> np.random.Generator:
    """Fresh deterministic stream per test — results must not depend on
    which other tests ran first."""
    return np.random.default_rng(0x5EED)


def fuzz_keypoints(rng, h: int, w: int, k: int):
    """Shared keypoint fuzzer for the descriptor-kernel parity suites:
    coordinates anywhere in the image (including the border), ~10% of
    slots invalid."""
    from feature_detector_fast_tpu.models import brief

    xy = np.stack([
        rng.integers(0, w, k), rng.integers(0, h, k)
    ], axis=-1).astype(np.int32)
    valid = rng.random(k) < 0.9
    return brief.Keypoints(xy, np.zeros(k, np.int32), valid)
