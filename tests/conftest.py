"""Test harness config.

Tests run on the CPU with 8 virtual XLA devices (so mesh and sharding logic
is exercised without several accelerators) and with float64 enabled,
because parity gates against the NumPy oracle are evaluated at 1e-6 rtol
like the reference's float64 LAPACK path.

Tests marked ``gpu`` need an NVIDIA card and skip without one.  Run them on
a machine with the card by letting JAX see it:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX sees none.  Decided
    here, at run time, so every test collects the same way everywhere."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip(
            "needs an NVIDIA GPU: JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu"
        )
    return devs[0]
