"""Checkpoint / resume for SLAM state (SURVEY.md §5.4 — new scope).

The reference detector is stateless; the SLAM layers accumulate state
(trajectory, landmarks, pose graph) that must survive preemption.  Orbax is the standard JAX checkpointer and handles device arrays,
sharded arrays, and async saves; this wrapper pins the framework's state
schema and a simple latest-step resume flow.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np


def _ocp():
    import orbax.checkpoint as ocp

    return ocp


def _arrayify(state):
    """Orbax's standard handler rejects bare python/numpy scalars; promote
    every scalar leaf to a 0-d ndarray."""
    import jax

    return jax.tree.map(
        lambda x: np.asarray(x) if isinstance(x, (int, float, np.generic)) else x,
        state,
    )


def save_state(directory: str, step: int, state: Dict[str, Any]) -> None:
    """Save a pytree state dict under `directory/step_<n>`."""
    ocp = _ocp()
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(path, _arrayify(state), force=True)
    ckptr.wait_until_finished()


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = []
    for name in os.listdir(directory):
        if name.startswith("step_"):
            try:
                steps.append(int(name.split("_", 1)[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore_state(
    directory: str, step: Optional[int] = None, template: Optional[Dict] = None
) -> Optional[Dict[str, Any]]:
    """Restore the given (or latest) step; returns None if nothing saved.
    `template` (a matching pytree of arrays) restores with exact
    dtypes/shapes — recommended."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    ocp = _ocp()
    path = os.path.join(os.path.abspath(directory), f"step_{step}")
    ckptr = ocp.StandardCheckpointer()
    if template is not None:
        return ckptr.restore(path, template)
    return ckptr.restore(path)
