"""Implicit displacement operation — framework-agnostic adapter surface.

Mirrors the 6-method protocol of the reference's `DispImOpeartion`
(reference: GOLDFISH/operations/disp_imop.py: solve_nonlinear :38-44,
linearize :46-56, apply_linear fwd/rev :58-128, solve_linear fwd/rev
:130-142) so the OpenMDAO / CSDL thin wrappers can drive this build the
way they drive the reference. Differences, by design:

  - vectors at the boundary are FLAT REAL-DOF numpy arrays
    (node-major xyz), converted to/from the padded device layout with
    `CPLayout`; the PETSc nest-vec plumbing disappears;
  - `linearize` caches the state, and the four matvec methods are
    jitted jvp/vjp closures through the residual — no stored
    dRIGAdu/dRIGAdCP/dRIGAdh matrices;
  - linear solves are the mixed-precision dense path of solver/linalg
    (the MUMPS replacement); K is symmetric so fwd == rev.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.design.pipeline import CPLayout
from goldfish_jax.opt.warmstart import SecantWarmStart
from goldfish_jax.solver.implicit import newton_solve
from goldfish_jax.solver.linalg import linear_solve
from goldfish_jax.solver.system import (
    NonMatchingSystem,
    assemble_K,
    residual,
)

__all__ = ["DispImOperation"]


class DispImOperation:
    """Implicit operation R(d; cp, h) = 0 over flat real-dof vectors."""

    def __init__(self, system: NonMatchingSystem, rtol=1e-10, max_it=30,
                 warm_start=True):
        self.system = system
        self.data = system.data
        self.layout = CPLayout(system.metas, system.stack.max_cp)
        self.rtol = rtol
        self.max_it = max_it
        self.vec_size = self.layout.n_flat * 3
        self.h_size = self.layout.n_flat
        self._state = None
        # secant extrapolation of successive converged states across
        # optimizer iterations (opt/warmstart.py): the role of the
        # reference keeping `spline_funcs` warm between solves
        # (GOLDFISH/om_comps/disp_states_comp.py solve_nonlinear),
        # upgraded to a second-order-accurate entry point
        self._ws = SecantWarmStart() if warm_start else None

        lay = self.layout

        def _res_flat(cp_f, h_f, d_f):
            cp = lay.to_padded(cp_f.reshape(-1, 3))
            h = lay.to_padded(h_f)
            d = lay.to_padded(d_f.reshape(-1, 3))
            r = residual(self.data, d, cp, h)
            return lay.to_flat(r).reshape(-1)

        self._res_flat = jax.jit(_res_flat)
        self._jvp = jax.jit(lambda args, tans: jax.jvp(
            _res_flat, args, tans)[1])

        def _vjp(args, ct):
            _, f = jax.vjp(_res_flat, *args)
            return f(ct)

        self._vjp = jax.jit(_vjp)

        def _K_flat(cp_f, h_f, d_f):
            cp = lay.to_padded(cp_f.reshape(-1, 3))
            h = lay.to_padded(h_f)
            d = lay.to_padded(d_f.reshape(-1, 3))
            return assemble_K(self.data, d, cp, h)

        self._K_flat = jax.jit(_K_flat)

        def _solve(cp_f, h_f, d0_f):
            cp = lay.to_padded(cp_f.reshape(-1, 3))
            h = lay.to_padded(h_f)
            d0 = lay.to_padded(d0_f.reshape(-1, 3))
            d, it, rn = newton_solve(self.data, cp, h, d0,
                                     rtol=self.rtol, max_it=self.max_it)
            return lay.to_flat(d).reshape(-1), it, rn

        self._solve = jax.jit(_solve)

        # padded <-> flat K index map (flat real dofs into the padded
        # N = P*C*3 ordering)
        idx = np.asarray(self.layout._idx)  # (P, C) -> flat cp index
        P, C = idx.shape
        keep = idx.ravel() < self.layout.n_flat
        rows = np.nonzero(keep)[0]
        order = np.argsort(idx.ravel()[keep])
        cp_rows = rows[order]  # padded cp slot of each flat cp index
        self._dof_rows = (cp_rows[:, None] * 3
                          + np.arange(3)[None, :]).ravel()

    # ------------------------------------------------------- protocol
    def apply_nonlinear(self, cp, h, d):
        return np.asarray(self._res_flat(jnp.asarray(cp), jnp.asarray(h),
                                         jnp.asarray(d)))

    def solve_nonlinear(self, cp, h, d0=None):
        d0 = np.zeros(self.vec_size) if d0 is None else d0
        if self._ws is not None:
            x = jnp.concatenate([jnp.asarray(cp).ravel(),
                                 jnp.asarray(h).ravel()])
            d0 = self._ws.predict(x, jnp.asarray(d0))
        d, it, rn = self._solve(jnp.asarray(cp), jnp.asarray(h),
                                jnp.asarray(d0))
        if self._ws is not None:
            self._ws.update(x, d)
        return np.asarray(d)

    def linearize(self, cp, h, d):
        self._state = (jnp.asarray(cp), jnp.asarray(h), jnp.asarray(d))
        self._K_cache = None

    def _K_reduced(self):
        if self._K_cache is None:
            K = np.asarray(self._K_flat(*self._state))
            r = self._dof_rows
            self._K_cache = jnp.asarray(K[np.ix_(r, r)])
        return self._K_cache

    def apply_linear_fwd(self, d_cp=None, d_h=None, d_d=None):
        """dR = dR/dcp dcp + dR/dh dh + dR/dd dd."""
        cp, h, d = self._state
        z = jnp.zeros_like
        tans = (jnp.asarray(d_cp) if d_cp is not None else z(cp),
                jnp.asarray(d_h) if d_h is not None else z(h),
                jnp.asarray(d_d) if d_d is not None else z(d))
        return np.asarray(self._jvp(self._state, tans))

    def apply_linear_rev(self, d_r):
        """(cp_bar, h_bar, d_bar) = (dR/d.)^T d_r."""
        outs = self._vjp(self._state, jnp.asarray(d_r))
        return tuple(np.asarray(o) for o in outs)

    def solve_linear_fwd(self, rhs):
        """K dd = rhs (the Newton/tangent solve)."""
        return np.asarray(linear_solve(self._K_reduced(), jnp.asarray(rhs)))

    def solve_linear_rev(self, rhs):
        """K^T lam = rhs; K symmetric (potential Hessian) -> same solve
        (reference needed separate MUMPS transpose solves,
        GOLDFISH/utils/opt_utils.py:156-209)."""
        return self.solve_linear_fwd(rhs)
