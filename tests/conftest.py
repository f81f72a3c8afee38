"""Test configuration: the CPU with 8 virtual devices by default, so
multi-device sharding paths run without accelerators. A run that sets
JAX_PLATFORMS itself (e.g. `cuda,cpu` on a GPU host) keeps it; tests
marked `gpu` take the `gpu` fixture, which skips them where JAX finds no
GPU."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import sys  # noqa: E402

import jax  # noqa: E402
import pytest  # noqa: E402

# The suite compiles thousands of small CPU programs; persisting them
# would write ~400 MB into the checkout's cache directory per run.
jax.config.update("jax_enable_compilation_cache", False)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu():
    """JAX's first GPU; skips the test when there is none."""
    import jax

    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs an NVIDIA GPU; JAX found none")
    return gpus[0]
