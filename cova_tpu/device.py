"""The accelerator a measurement runs on.

Benchmarks and the chip smoke test measure the GPU path; on a host
where JAX finds no GPU they stop instead of measuring the CPU."""

from __future__ import annotations

import subprocess


class NoAcceleratorError(RuntimeError):
    """JAX's default device is not a GPU."""


def require_gpu(devices=None):
    """JAX's first device when it is a GPU; NoAcceleratorError otherwise."""
    import jax

    devices = jax.devices() if devices is None else devices
    d = devices[0]
    if d.platform != "gpu":
        raise NoAcceleratorError(
            f"no GPU: JAX's default device is {d.platform} ({d.device_kind})"
        )
    return d


def card_line() -> str:
    """The first card's name and power limit as nvidia-smi reports them
    (`name, power.limit`): a card set below its maximum power runs
    slower under load, so every measurement carries this line."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def describe(devices=None) -> dict:
    """platform, device_kind and count of the devices JAX sees."""
    import jax

    devices = jax.devices() if devices is None else devices
    return {"platform": devices[0].platform, "kind": devices[0].device_kind,
            "count": len(devices)}
