"""Multi-host orchestration: initialization, failure detection, and
preemption-safe execution (SURVEY.md §5.3/§5.8 — new scope).

There is no NCCL/MPI transport to manage by hand: XLA emits the
collectives (NCCL on GPUs) once `jax.distributed.initialize` has formed
the process group.  What the framework owns is:

  * `initialize()` — idempotent process-group setup from explicit
    arguments or a coordinator address in the environment (no-op
    single-host),
  * `healthcheck()` — an all-reduce heartbeat across hosts; a hung or
    dead peer surfaces as a timeout here, the practical failure detector
    across hosts,
  * `CheckpointedLoop` — preemption-safe iteration: periodic orbax saves
    plus resume-from-latest, the standard recovery pattern for preemptible
    fleets.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..utils import checkpoint as ckpt


_log = logging.getLogger(__name__)

_initialized = False

#: Environment markers whose presence means `jax.distributed.initialize()`
#: can find the coordinator on its own.
_CLUSTER_ENV_VARS = (
    "JAX_COORDINATOR_ADDRESS",
    "COORDINATOR_ADDRESS",
)


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Form the multi-host process group (idempotent).  With explicit
    arguments they are passed through; with none, auto-detection runs via
    `jax.distributed.initialize()` whenever a cluster environment marker
    is present (a coordinator address in the environment) — a plain
    single-host run stays a no-op rather than failing on a missing
    coordinator.  Returns this host's process index."""
    global _initialized
    import jax

    explicit = (
        coordinator_address is not None
        or num_processes is not None
        or process_id is not None
    )
    auto = any(os.environ.get(v) for v in _CLUSTER_ENV_VARS)
    if not _initialized and explicit:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
        _initialized = True
    elif not _initialized and auto:
        # Best-effort auto-detection: a coordinator variable alone may not
        # be enough to form the group — fall back to single-host rather
        # than failing, but SAY SO: a real cluster misconfiguration
        # otherwise degrades to a silent single-host run.
        try:
            jax.distributed.initialize()
            _initialized = True
        except (ValueError, RuntimeError) as e:
            _log.warning(
                "jax.distributed auto-initialization failed (%s: %s); "
                "continuing single-host.  If this IS a multi-host run, "
                "pass coordinator_address/num_processes/process_id "
                "explicitly.", type(e).__name__, e)
    return jax.process_index()


#: At most ONE heartbeat collective is ever in flight: a wedged peer blocks
#: the psum indefinitely, and re-issuing a new collective per call would
#: accumulate one blocked daemon thread per healthcheck against a dead peer.
_hc_lock = threading.Lock()
_hc_inflight: Dict[str, Any] = {"thread": None}


def _heartbeat_collective() -> bool:
    """The actual heartbeat: a tiny psum across every host's local devices
    (global axis over all processes); True iff the global device count
    comes back."""
    import jax

    # pmap shards a host array over local devices itself (one element per
    # device) — no deprecated device_put_replicated needed.
    x = np.ones((jax.local_device_count(),), np.int32)
    total = jax.pmap(lambda v: jax.lax.psum(v, "i"), axis_name="i")(x)
    return int(np.asarray(total)[0]) == jax.device_count()


def healthcheck(
    timeout_s: float = 60.0,
    _collective: Optional[Callable[[], bool]] = None,
) -> bool:
    """Cross-host heartbeat.  Returns True iff the heartbeat collective
    completes within ``timeout_s`` with the expected global device count.

    The collective runs in a daemon thread so a WEDGED peer — the failure
    this detector exists for, which blocks the psum indefinitely — turns
    into a timely False instead of hanging the caller.  The in-flight
    collective is a singleton: while a previous heartbeat is still blocked,
    further healthchecks return False immediately instead of stacking more
    blocked threads (the answer is already "unhealthy").  Callers are
    expected to checkpoint and abort so the scheduler restarts the slice.

    ``_collective`` is a test seam replacing the psum heartbeat."""
    fn = _collective or _heartbeat_collective
    with _hc_lock:
        prev = _hc_inflight["thread"]
        if prev is not None and prev.is_alive():
            return False
        result: Dict[str, Any] = {}

        def run():
            try:
                result["ok"] = fn()
            except Exception as e:  # noqa: BLE001 — any failure is a failed heartbeat
                _log.warning("heartbeat collective failed: %s: %s",
                             type(e).__name__, e)
                result["ok"] = False

        t = threading.Thread(target=run, daemon=True)
        _hc_inflight["thread"] = t
        t.start()
    t.join(timeout_s)
    return bool(result.get("ok", False))


class CheckpointedLoop:
    """Preemption-safe iteration driver.

    Wraps a step function with resume-from-latest and periodic saves:

        loop = CheckpointedLoop(dir, every=50)
        state, start = loop.resume(init_state)
        for step in range(start, n_steps):
            state = step_fn(state)
            loop.maybe_save(step, state)
    """

    def __init__(self, directory: str, every: int = 100):
        self.directory = directory
        self.every = int(every)

    def resume(self, init_state: Dict[str, Any]):
        """Returns (state, next_step): restored from the latest checkpoint
        if one exists, else (init_state, 0)."""
        step = ckpt.latest_step(self.directory)
        if step is None:
            return init_state, 0
        template = ckpt._arrayify(init_state)
        state = ckpt.restore_state(self.directory, step, template)
        return state, step + 1

    def maybe_save(self, step: int, state: Dict[str, Any]) -> bool:
        """Save every `every` steps; process 0 writes (single-writer)."""
        import jax

        if (step + 1) % self.every != 0:
            return False
        if jax.process_index() == 0:
            ckpt.save_state(self.directory, step, state)
        return True
