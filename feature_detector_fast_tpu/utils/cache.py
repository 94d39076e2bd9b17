"""Persistent XLA compilation cache setup.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at one fixed
path inside the checkout (``.xla_cache/``, listed in ``.gitignore``):
the path is part of what a later run must find again, so it never
depends on a temporary name, a process id or the time.  Call `enable()`
before the first jit execution; it is idempotent.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

#: The checkout's own cache directory.
DEFAULT_DIR = os.path.abspath(os.path.join(
    os.path.dirname(__file__), os.pardir, os.pardir, ".xla_cache"))


def _machine_tag() -> str:
    """Short fingerprint of the host CPU's ISA feature set.  XLA:CPU
    persists AOT-compiled executables that embed the compile machine's
    vector ISA, and loading one compiled for a wider ISA crashes; keying
    the CPU cache by the feature flags keeps each machine's entries
    apart."""
    import hashlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.md5(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    return "unknown"


def cache_dir(platform: str) -> str | None:
    """The directory `enable` sets for ``platform``, or None when the
    environment variable already names one."""
    if os.environ.get(ENV_VAR):
        return None
    if platform == "cpu":
        return os.path.join(DEFAULT_DIR, f"cpu-{_machine_tag()}")
    return os.path.join(DEFAULT_DIR, platform)


def enable() -> None:
    import jax

    path = cache_dir(jax.default_backend())
    if path is not None:
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
