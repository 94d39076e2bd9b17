"""Matmul-precision control for the geometry stack.

JAX's DEFAULT matmul precision lets an accelerator run f32 matmuls in a
reduced format: TF32 (~10 mantissa bits) on an NVIDIA GPU's tensor
cores.  The detector/descriptor math does not care — its one matmul (the
+-1 Hamming product) is exact in bf16 — but reduced precision silently
corrupts the geometry stack, where normal-equation products (J^T J,
Schur einsums) square condition numbers and then lose them: an earlier
accelerator's bf16 default moved the F=64 VGA loop+BA pipeline from 1.7%
ATE (CPU) to 3.1%, with BA landing WORSE than odometry.

``matmul_highest`` wraps a function so everything traced inside runs
with `jax.default_matmul_precision("highest")` (full f32; no TF32).  The
geometry matmuls are tiny next to the image kernels, so the cost is
noise; the correctness is not.

Apply it UNDER `jax.jit` (the context must be active at trace time):

    @functools.partial(jax.jit, static_argnums=(...,))
    @matmul_highest
    def my_geometry_fn(...): ...

`fn.__wrapped__`-style re-use then still goes through the precision
scope (functools.wraps chains it).
"""

from __future__ import annotations

import functools

import jax


def matmul_highest(fn):
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        with jax.default_matmul_precision("highest"):
            return fn(*args, **kwargs)

    return wrapper
