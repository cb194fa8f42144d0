"""Test env: CPU backend with 8 virtual devices, x64 enabled.

Must run before jax initializes — pytest imports conftest before any test
module, so setting env vars here is sufficient.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# A pytest plugin may import jax before this conftest runs, in which case
# the env var above is too late — force the platform via config too.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips itself where there is none"
    )
