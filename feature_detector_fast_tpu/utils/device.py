"""The accelerator a measurement or smoke run is made on.

Entry points that report device numbers call `require_gpu` first: a run
that finds no GPU fails instead of measuring the CPU under a device
metric's name.
"""

from __future__ import annotations

import subprocess


def require_gpu():
    """The first JAX device; raises SystemExit unless it is a GPU."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"no GPU: JAX found {devices[0].platform} devices only")
    return devices[0]


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=30,
    ).stdout.strip()
    return out.splitlines()[0]


def describe(device) -> dict:
    """Device record every printed result carries."""
    import jax

    return {"platform": device.platform, "kind": device.device_kind,
            "count": len(jax.devices())}
