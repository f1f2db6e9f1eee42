"""Global configuration: dtypes, precision policy, compile cache.

The reference stack runs everything in float64 through PETSc/MUMPS
(reference: GOLDFISH/utils/opt_utils.py:106-209). So does this one on
its normal path: the solve paths, the benches and the tests run with
JAX x64 on, and the tangent is factored natively in f64.

  - `solve_dtype`: dtype used for states/residuals/linear algebra:
    float64 when JAX x64 is enabled, float32 otherwise. The f32 case
    is only what JAX gives without x64; no entry point relies on it.
  - Call :func:`use_x64` early (before creating arrays) to flip JAX
    into float64 mode; `GOLDFISH_X64=1` does it at import.

Compile cache: when `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it
and nothing here touches the cache. Otherwise compiled programs are
kept in `.jax_cache/` at the root of the checkout (`CACHE_DIR`), a
fixed path, so a second process on the same tree finds them again. A
process pinned to the CPU platform keeps no cache.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp


def use_x64(enable: bool = True) -> None:
    """Enable/disable 64-bit mode globally (must run before tracing)."""
    jax.config.update("jax_enable_x64", enable)


def x64_enabled() -> bool:
    return bool(jax.config.read("jax_enable_x64"))


def solve_dtype():
    """Default dtype for states / linear algebra."""
    return jnp.float64 if x64_enabled() else jnp.float32


def index_dtype():
    return jnp.int32


# Environment knob: GOLDFISH_X64=1 enables x64 at import time.
if os.environ.get("GOLDFISH_X64", "0") == "1":  # pragma: no cover
    use_x64(True)

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def compile_cache_dir(env=None) -> str | None:
    """The directory this module gives JAX's persistent compile cache:
    None when `JAX_COMPILATION_CACHE_DIR` is set (JAX honours it
    itself), else the fixed in-checkout `CACHE_DIR`."""
    env = os.environ if env is None else env
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return CACHE_DIR


def _enable_compile_cache():
    # No backend query here: initializing the backend at import would
    # pre-empt the platform choice of the entry point (chip_smoke.py)
    # and jax.distributed.initialize (_boot.py). A process pinned to
    # the CPU (the test suite) keeps no cache: XLA:CPU executables are
    # specific to the host's CPU features.
    path = compile_cache_dir()
    if path is not None and jax.config.jax_platforms != "cpu":
        jax.config.update("jax_compilation_cache_dir", path)


_enable_compile_cache()
