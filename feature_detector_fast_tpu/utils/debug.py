"""Numerical-debug facilities (SURVEY.md §5.2 — the race-detection /
sanitizer slot, for jitted device code).

The reference has no sanitizers; its `unsafe` SIMD relies on Rust's borrow
rules.  For jitted programs the analogue of "sanitizers" is numeric:
NaN/Inf tripwires, plus collective-determinism assertions for distributed
code (collectives must produce identical replicated values on every
device — a desync is the device version of a data race).

Also hosts the vector pretty-printers (`pi`/`pl` analogues,
fast_simd.rs:827-844) for dumping mask/score planes as hex rows.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import numpy as np


@contextlib.contextmanager
def nan_checking() -> Iterator[None]:
    """Enable jax's debug-nans tripwire in a scope: any NaN produced by a
    jitted computation raises immediately (re-runs un-jitted to locate)."""
    import jax

    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_finite(tree, name: str = "value") -> None:
    """Host-side finiteness assertion over a pytree of arrays."""
    import jax

    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        arr = np.asarray(leaf)
        if np.issubdtype(arr.dtype, np.floating) and not np.isfinite(arr).all():
            raise FloatingPointError(
                f"non-finite values in {name}{jax.tree_util.keystr(path)}"
            )


def assert_replicas_identical(per_device: np.ndarray, atol: float = 0.0,
                              name: str = "collective output") -> None:
    """Assert a (n_devices, ...) stack of per-replica values is identical
    (or within atol) across devices — the determinism check distributed
    tests run on collective results."""
    ref = per_device[0]
    for i, other in enumerate(per_device[1:], 1):
        if atol == 0.0:
            if not np.array_equal(ref, other):
                raise AssertionError(
                    f"{name}: replica {i} differs bit-wise from replica 0"
                )
        else:
            np.testing.assert_allclose(
                other, ref, atol=atol,
                err_msg=f"{name}: replica {i} deviates from replica 0")


def dump_plane_hex(plane: np.ndarray, max_rows: int = 8, max_cols: int = 32) -> str:
    """Hex-dump the corner of a 2-D integer plane (the `pi`/`pl` vector
    printer analogue, fast_simd.rs:827-844).  Column width adapts to the
    plane's value range — byte planes stay compact like the reference's
    byte printer, while i32 mask/score/packed-word planes align at 8
    digits so rows remain visually comparable."""
    plane = np.asarray(plane)
    vals = plane[:max_rows, :max_cols].astype(np.int64) & 0xFFFFFFFF
    width = 2 if (vals.size == 0 or vals.max() <= 0xFF) else 8
    rows = []
    for r in vals:
        rows.append(" ".join(f"{int(v):0{width}x}" for v in r))
    return "\n".join(rows)
