"""Test configuration: JAX on a virtual 8-device CPU mesh.

Multi-device sharding logic is validated on fake CPU devices (SURVEY.md §4.5).
Tests marked ``gpu`` need the card: they take the ``gpu`` fixture, which
skips them when JAX finds no GPU. ``python chip_smoke.py`` runs them on the
card (``JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu``).
"""

import os

# CPU unless the caller asked for the GPU: tests must be hermetic and
# exercise the virtual multi-device mesh; the ``gpu`` tests compare the card
# with the CPU backend in one process.
_platforms = os.environ.get("JAX_PLATFORMS", "").split(",")
if not {"cuda", "gpu"} & set(_platforms):
    os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The env var must be in place before backends initialize, but jax may
# already have parsed its config from an earlier import.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# Persistent compilation cache: repeat suite runs skip CPU re-compiles of the
# decode/sim graphs (the dominant suite cost after construction fixtures).
_cache = os.path.join(os.path.dirname(os.path.dirname(__file__)), ".jax_cache_tests")
jax.config.update("jax_compilation_cache_dir", _cache)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_enable_xla_caches", "all")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU; skipped when JAX finds none"
    )


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device, or skip: decided here, never at import."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs a GPU; JAX found none (run `python chip_smoke.py` on the card)")


@pytest.fixture
def cpu():
    return jax.devices("cpu")[0]
