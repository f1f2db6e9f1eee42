"""Test configuration: CPU backend with 8 virtual devices, float64.

Gradient-parity and correctness tests run on CPU in f64. A test that
needs an NVIDIA GPU is marked `gpu` and takes the `gpu_device` fixture,
which skips where JAX finds none; on a machine with a card,
`GOLDFISH_TEST_GPU=1 python -m pytest -m gpu tests/` lifts the CPU pin
and runs them. `chip_smoke.py` is the full run on the card.
"""

import os

# Virtual device count must be set before the CPU backend initializes.
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

# The config update, not only JAX_PLATFORMS, pins the CPU: it holds even
# when jax was imported before this file.
if os.environ.get("GOLDFISH_TEST_GPU") != "1":
    jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)


import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled-executable memory between test modules: the suite
    compiles hundreds of distinct XLA CPU programs and the in-process
    executable cache eventually crashes the CPU backend compiler
    (SIGSEGV ~70-85% into a single-process full run). Same-module
    tests keep their cache; cross-module reuse is minimal anyway."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU; skips where JAX finds none. Decided here, when the
    test runs, so every xdist worker collects the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs an NVIDIA GPU (GOLDFISH_TEST_GPU=1 on a GPU "
                    "machine)")
    return gpus[0]
