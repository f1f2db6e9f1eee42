"""Linear solves for the tangent systems, and the choice of solver path.

The reference leans on MUMPS f64 direct solves through PETSc
(reference: GOLDFISH/utils/opt_utils.py:156-209 `solve_Ax_b`, and KSP
CG at :106-133). Two solver paths exist:

  - ``"direct"``: native f64 LU, inside one jitted ``lax.while_loop``
    Newton (solver/implicit.py); adjoint solves refine the LU answer
    against the exact tangent (``refined_solve``). XLA hands the dense
    factorization to LAPACK on the CPU and to cuSOLVER on an NVIDIA
    GPU. This is the default on both platforms.
  - ``"mixed"``: the emulated-f64 stack for hardware without an f64
    factorization. Here that is GMRES-IR (Carson & Higham, SIAM 2018):
    symmetric Jacobi equilibration, an f32 LU preconditioner and an f64
    Krylov loop, plus the persistent blocked-Cholesky factor and the
    host-composed Newton loops (solver/devicechol.py). KL-shell tangents
    have cond ~ 1e10-1e12, far beyond a plain f32 solve, hence the
    refinement.

``mode()`` maps the JAX platform to a path (``PLATFORM_PATH``); the GPU
entry is the winner of the direct/mixed A/B on the card (PERF.md). Only
``set_mode`` or ``GOLDFISH_LINEAR=direct|mixed`` select ``"mixed"``.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp

__all__ = ["linear_solve", "refined_solve", "set_mode", "mode",
           "platform_path", "PLATFORM_PATH", "jit_for_path"]

# Solver path per JAX platform. Both factor the f64 tangent natively;
# the GPU entry was chosen by timing both paths on an H100 (PERF.md).
PLATFORM_PATH = {"cpu": "direct", "gpu": "direct"}

_MODE: str | None = None


def set_mode(m: str | None):
    """'direct', 'mixed', or None for the platform's path."""
    global _MODE
    assert m in (None, "direct", "mixed")
    _MODE = m


def platform_path(platform: str) -> str:
    """The solver path for a JAX platform name; unknown platforms raise
    instead of guessing."""
    try:
        return PLATFORM_PATH[platform]
    except KeyError:
        raise ValueError(
            f"no solver path for JAX platform {platform!r} (known: "
            f"{sorted(PLATFORM_PATH)}); force one with set_mode() or "
            "GOLDFISH_LINEAR=direct|mixed") from None


def mode() -> str:
    """The solver path of this process: set_mode(), else the
    GOLDFISH_LINEAR environment variable, else the path of the default
    backend. It reads the process's backend, not the device of any
    array: a CPU computation inside a GPU process must set its path
    explicitly."""
    if _MODE is not None:
        return _MODE
    env = os.environ.get("GOLDFISH_LINEAR")
    if env in ("direct", "mixed"):
        return env
    return platform_path(jax.default_backend())


def refined_solve(K, b, matvec, sweeps=2):
    """Solve A x = b, where `matvec` is the exact action of A (the jvp
    of the residual) and K its assembled approximation: f64 LU of K,
    then `sweeps` iterative-refinement sweeps against `matvec`.

    At KL-shell conditioning the rounding of the assembled tangent (and,
    on a GPU, its run-to-run atomic summation order) moves an unrefined
    adjoint gradient by ~1e-7 relative; two sweeps reach the exact
    tangent's answer to ~1e-12, the same one the mixed path's
    certificate-checked solves reach. Each sweep costs one matvec and
    one O(N^2) substitution against the O(N^3) factor."""
    lu = jax.scipy.linalg.lu_factor(K)
    x = jax.scipy.linalg.lu_solve(lu, b)
    for _ in range(sweeps):
        x = x + jax.scipy.linalg.lu_solve(lu, b - matvec(x))
    return x


def jit_for_path(fn):
    """`jax.jit(fn)` on the direct path, so a whole evaluation (Newton,
    objective, adjoint) is one program; `fn` itself on the mixed path,
    whose host-composed loops cannot be traced."""
    return jax.jit(fn) if mode() == "direct" else fn


def _equilibrate(K):
    d = jax.lax.rsqrt(jnp.abs(jnp.diagonal(K)) + 1e-300)
    return K * d[:, None] * d[None, :], d


def mixed_solve(K, b, tol=1e-11, restart=32, maxiter=8):
    """GMRES-IR: f32 LU preconditioner, working-dtype Krylov loop."""
    Keq, dscale = _equilibrate(K)
    lu, piv = jax.scipy.linalg.lu_factor(Keq.astype(jnp.float32))
    beq = dscale * b

    def Aop(y):
        return Keq @ y

    def Mop(r):
        y = jax.scipy.linalg.lu_solve((lu, piv), r.astype(jnp.float32))
        return y.astype(K.dtype)

    y, _ = jax.scipy.sparse.linalg.gmres(
        Aop, beq, tol=tol, atol=0.0, restart=restart, maxiter=maxiter,
        M=Mop, solve_method="batched")
    return dscale * y


def factor(K):
    """Reusable factorization of K (dispatches on mode()).

    'direct': native LU. 'mixed': equilibration + f32 LU + K itself
    (kept for the f64 GMRES-IR matvecs)."""
    if mode() == "direct":
        return ("direct", jax.scipy.linalg.lu_factor(K))
    Keq, dscale = _equilibrate(K)
    lu, piv = jax.scipy.linalg.lu_factor(Keq.astype(jnp.float32))
    return ("mixed", (Keq, dscale, lu, piv))


def factor_solve(fac, b, tol=1e-11, restart=32, maxiter=8):
    """Solve K x = b with a factorization from `factor`."""
    kind, payload = fac
    if kind == "direct":
        return jax.scipy.linalg.lu_solve(payload, b)
    Keq, dscale, lu, piv = payload
    beq = dscale * b

    def Aop(y):
        return Keq @ y

    def Mop(r):
        y = jax.scipy.linalg.lu_solve((lu, piv), r.astype(jnp.float32))
        return y.astype(b.dtype)

    y, _ = jax.scipy.sparse.linalg.gmres(
        Aop, beq, tol=tol, atol=0.0, restart=restart, maxiter=maxiter,
        M=Mop, solve_method="batched")
    return dscale * y


def linear_solve(K, b, tol=1e-11):
    """Solve K x = b (dense K, single RHS vector b).

    Dispatches at trace time on `mode()`: native f64 LU, or GMRES-IR
    on the mixed path.
    """
    if mode() == "direct":
        return jnp.linalg.solve(K, b)
    return mixed_solve(K, b, tol=tol)


def cast_floating(tree, dtype):
    """Cast every inexact-dtype leaf of a pytree (e.g. SystemData)."""
    return jax.tree_util.tree_map(
        lambda x: x.astype(dtype)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.inexact)
        else x,
        tree)
