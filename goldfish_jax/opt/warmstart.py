"""Secant warm-start extrapolation across optimizer iterations.

A warm-started implicit solve entering at the PREVIOUS iterate's
solution has an entry residual first-order in the design step — two
Newton iterations on the mixed path (forcing-limited contraction, then
floor polish). Extrapolating the state along the last design step,

    d0 = d_prev + a * (d_prev - d_prev2),
    a  = <dx_new, dx_prev> / |dx_prev|^2   (clipped),

makes the entry residual SECOND-order in the step: warm solves then
converge in 0-1 iterations. The role of the reference's persistent
`spline_funcs` warm starts (GOLDFISH/om_comps/disp_states_comp.py:
solve_nonlinear reuse), upgraded with the secant model. A wrong
prediction (optimizer direction change) costs at most one extra
Newton iteration — the line search guards descent.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

__all__ = ["SecantWarmStart"]


@jax.jit
def _alpha(dx_new, dx_old):
    num = jnp.vdot(dx_old, dx_new)
    den = jnp.vdot(dx_old, dx_old) + 1e-300
    a = jnp.clip(num / den, -2.0, 2.0)
    # non-finite step metrics (a rejected NaN trial left garbage in a
    # recorded design key) must yield a = 0, not poison the prediction
    return jnp.where(jnp.isfinite(a), a, 0.0)


@jax.jit
def _extrapolate(d, d2, a):
    out = d + a * (d - d2)
    # a seed is only a seed: if any extrapolated entry is non-finite
    # (e.g. one recorded state held inf/nan), fall back to the last
    # converged state elementwise, and to zero where even that is bad —
    # downstream certificate gates stay the exactness authority, but a
    # NaN seed wastes a whole fallback solve (round-5 pegasus: nan
    # pipe certificates at iteration-1 jac)
    safe_d = jnp.where(jnp.isfinite(d), d, 0.0)
    return jnp.where(jnp.isfinite(out), out, safe_d)


class SecantWarmStart:
    """Track (design, state) pairs; predict the next warm start.

    `design` is any flat array (or pytree leaf) the caller uses to
    measure optimizer steps; `state` is the converged solution to
    extrapolate (e.g. the displacement vector, or xi)."""

    def __init__(self):
        self._x = None
        self._d = None
        self._x2 = None
        self._d2 = None

    def predict(self, x, default):
        """Warm start for design point `x`; `default` when history is
        insufficient (cold start / first iteration)."""
        if self._x is None:
            return default
        if self._x2 is None:
            return self._d
        a = _alpha(jnp.ravel(x) - jnp.ravel(self._x),
                   jnp.ravel(self._x) - jnp.ravel(self._x2))
        return _extrapolate(self._d, self._d2, a)

    def update(self, x, d):
        """Record the converged state at design point `x`."""
        self._x2, self._d2 = self._x, self._d
        self._x, self._d = x, d
