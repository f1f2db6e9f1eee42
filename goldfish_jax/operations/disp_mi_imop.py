"""Moving-intersection implicit displacement operation (adapter surface).

Mirror of the reference's `DispMintImOpeartion`
(reference: GOLDFISH/operations/disp_mi_imop.py — same 6-method
protocol as disp_imop with the extra xi input and dRIGAdxi matvec terms
:54-108) plus the CP->xi operation (`CPIGA2XiImOperation`,
reference: operations/cpiga2xi_imop.py). Vectors at the boundary are
flat numpy; all inner kernels are the jitted argument-passing functions
of solver/system_mi.py and geometry/cpiga2xi.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.design.pipeline import CPLayout
from goldfish_jax.opt.warmstart import SecantWarmStart
from goldfish_jax.solver.system_mi import (
    MINonMatchingSystem,
    adjoint_solve_mi,
    newton_solve_mi,
    residual_mi,
)

__all__ = ["DispMintImOperation", "CPIGA2XiImOperation"]


class CPIGA2XiImOperation:
    """Implicit CP -> xi solve with linearize/solve_linear semantics
    (reference: operations/cpiga2xi_imop.py:40-102). The factorized
    dR/dxi of the reference's SuperLU becomes a batched dense solve
    inside the jitted adjoint."""

    def __init__(self, mi_system: MINonMatchingSystem, warm_start=True):
        self.sys = mi_system
        self.c2x = mi_system.c2x
        self.layout = CPLayout(mi_system.metas, mi_system.stack.max_cp)
        self.xi_size = int(np.prod(self.c2x.xi0_flat.shape))
        # secant-extrapolated xi warm starts: a warm xi0 cuts the xi
        # Newton from ~20 iterations to 1-3
        self._ws = SecantWarmStart() if warm_start else None

    def solve_nonlinear(self, cp_flat):
        cp = self.layout.to_padded(
            jnp.asarray(cp_flat).reshape(-1, 3))
        xi0 = None
        if self._ws is not None:
            x = jnp.asarray(cp_flat).ravel()
            xi0 = self._ws.predict(x, None)
            if xi0 is not None:
                # an overshooting secant seed outside the parametric
                # domain can settle Newton on a spurious root or stall
                # it across a knot line — clamp; a merely-bad in-domain
                # seed just costs iterations
                xi0 = jnp.clip(xi0, 0.0, 1.0)
        xi = self.c2x.solve(cp, xi0)
        if self._ws is not None:
            self._ws.update(x, xi)
        return np.asarray(xi).ravel()

    def apply_nonlinear(self, cp_flat, xi_flat):
        from goldfish_jax.geometry.cpiga2xi import _c2x_res

        cp = self.layout.to_padded(jnp.asarray(cp_flat).reshape(-1, 3))
        x = jnp.asarray(xi_flat).reshape(self.c2x.xi0_flat.shape)
        r = _c2x_res(self.c2x.ss, self.c2x.mi, cp, x,
                     p=self.c2x.p, q=self.c2x.q)
        return np.asarray(r).ravel()

    def vjp(self, cp_flat, xi_flat, xi_bar):
        """d(xi)/d(cp)^T @ xi_bar via the implicit-function adjoint."""
        from goldfish_jax.geometry.cpiga2xi import _c2x_adjoint

        cp = self.layout.to_padded(jnp.asarray(cp_flat).reshape(-1, 3))
        x = jnp.asarray(xi_flat).reshape(self.c2x.xi0_flat.shape)
        g = jnp.asarray(xi_bar).reshape(x.shape)
        dcp = _c2x_adjoint(self.c2x.ss, self.c2x.mi, cp, x, g,
                           p=self.c2x.p, q=self.c2x.q)
        return np.asarray(self.layout.to_flat(dcp)).ravel()

    # ------- split 6-method protocol (OpenMDAO ImplicitComponent) -------
    def linearize(self, cp_flat, xi_flat):
        self._state = (np.asarray(cp_flat), np.asarray(xi_flat))

    def _args(self):
        cp_f, xi_f = self._state
        cp = self.layout.to_padded(jnp.asarray(cp_f).reshape(-1, 3))
        x = jnp.asarray(xi_f).reshape(self.c2x.xi0_flat.shape)
        return cp, x

    def _jac(self):
        from goldfish_jax.geometry.cpiga2xi import _c2x_jac

        cp, x = self._args()
        return _c2x_jac(self.c2x.ss, self.c2x.mi, cp, x,
                        p=self.c2x.p, q=self.c2x.q)  # (I, 4N, 4N)

    def apply_linear_fwd(self, d_cp=None, d_xi=None):
        """dR = dR/dcp dcp + dR/dxi dxi (jvp through the residual)."""
        from goldfish_jax.geometry.cpiga2xi import _c2x_res

        cp, x = self._args()
        lay = self.layout

        def res(cp_, x_):
            return _c2x_res.__wrapped__(self.c2x.ss, self.c2x.mi, cp_,
                                        x_, p=self.c2x.p, q=self.c2x.q)

        tcp = jnp.zeros_like(cp) if d_cp is None else lay.to_padded(
            jnp.asarray(d_cp).reshape(-1, 3))
        txi = jnp.zeros_like(x) if d_xi is None else jnp.asarray(
            d_xi).reshape(x.shape)
        out = jax.jvp(res, (cp, x), (tcp, txi))[1]
        return np.asarray(out).ravel()

    def apply_linear_rev(self, d_r):
        """(cp_bar, xi_bar) = (dR/d.)^T d_r."""
        from goldfish_jax.geometry.cpiga2xi import _c2x_res

        cp, x = self._args()

        def res(cp_, x_):
            return _c2x_res.__wrapped__(self.c2x.ss, self.c2x.mi, cp_,
                                        x_, p=self.c2x.p, q=self.c2x.q)

        _, f = jax.vjp(res, cp, x)
        g = jnp.asarray(d_r).reshape(x.shape)
        dcp, dxi = f(g)
        return (np.asarray(self.layout.to_flat(dcp)).ravel(),
                np.asarray(dxi).ravel())

    def solve_linear_fwd(self, rhs):
        J = self._jac()
        r = jnp.asarray(rhs).reshape(self.c2x.xi0_flat.shape)
        return np.asarray(
            jnp.linalg.solve(J, r[..., None])[..., 0]).ravel()

    def solve_linear_rev(self, rhs):
        J = self._jac()
        r = jnp.asarray(rhs).reshape(self.c2x.xi0_flat.shape)
        return np.asarray(jnp.linalg.solve(
            jnp.swapaxes(J, -1, -2), r[..., None])[..., 0]).ravel()


class DispMintImOperation:
    """Implicit displacement with moving-intersection input xi."""

    def __init__(self, mi_system: MINonMatchingSystem, rtol=1e-10,
                 max_it=30, warm_start=True):
        self.sys = mi_system
        self.layout = CPLayout(mi_system.metas, mi_system.stack.max_cp)
        self.rtol = rtol
        self.max_it = max_it
        self.vec_size = self.layout.n_flat * 3
        self._state = None
        self._ws = SecantWarmStart() if warm_start else None

    def _unpack(self, cp_f, h_f, d_f, xi_f):
        lay = self.layout
        return (lay.to_padded(jnp.asarray(cp_f).reshape(-1, 3)),
                lay.to_padded(jnp.asarray(h_f)),
                lay.to_padded(jnp.asarray(d_f).reshape(-1, 3)),
                jnp.asarray(xi_f).reshape(self.sys.c2x.xi0_flat.shape))

    def solve_nonlinear(self, cp_f, h_f, xi_f, d0_f=None):
        d0_f = np.zeros(self.vec_size) if d0_f is None else d0_f
        if self._ws is not None:
            x = jnp.concatenate([jnp.asarray(cp_f).ravel(),
                                 jnp.asarray(h_f).ravel(),
                                 jnp.asarray(xi_f).ravel()])
            d0_f = self._ws.predict(x, jnp.asarray(d0_f))
        cp, h, d0, xi = self._unpack(cp_f, h_f, d0_f, xi_f)
        s = self.sys
        d, it, rn = newton_solve_mi(s.data, s.mi, s.co, s.ss, s.pdeg,
                                    s.qdeg, cp, h, xi, d0,
                                    rtol=self.rtol, max_it=self.max_it)
        if self._ws is not None:
            self._ws.update(x, self.layout.to_flat(d).ravel())
        return np.asarray(self.layout.to_flat(d)).ravel()

    def apply_nonlinear(self, cp_f, h_f, xi_f, d_f):
        cp, h, d, xi = self._unpack(cp_f, h_f, d_f, xi_f)
        s = self.sys
        r = residual_mi(s.data, s.mi, s.co, s.ss, s.pdeg, s.qdeg, d, cp,
                        h, xi)
        return np.asarray(self.layout.to_flat(r)).ravel()

    def linearize(self, cp_f, h_f, xi_f, d_f):
        self._state = (cp_f, h_f, xi_f, d_f)
        self._K_cache = None

    # ------- split 6-method protocol (OpenMDAO ImplicitComponent) -------
    def _padded_state(self):
        cp_f, h_f, xi_f, d_f = self._state
        return self._unpack(cp_f, h_f, d_f, xi_f)

    def _res_fn(self):
        s = self.sys

        def res(cp, h, xi, d):
            return residual_mi(s.data, s.mi, s.co, s.ss, s.pdeg, s.qdeg,
                               d, cp, h, xi)

        return res

    def apply_linear_fwd(self, d_cp=None, d_h=None, d_xi=None, d_d=None):
        cp, h, d, xi = self._padded_state()
        lay = self.layout
        tans = (
            jnp.zeros_like(cp) if d_cp is None
            else lay.to_padded(jnp.asarray(d_cp).reshape(-1, 3)),
            jnp.zeros_like(h) if d_h is None
            else lay.to_padded(jnp.asarray(d_h)),
            jnp.zeros_like(xi) if d_xi is None
            else jnp.asarray(d_xi).reshape(xi.shape),
            jnp.zeros_like(d) if d_d is None
            else lay.to_padded(jnp.asarray(d_d).reshape(-1, 3)),
        )
        out = jax.jvp(self._res_fn(), (cp, h, xi, d), tans)[1]
        return np.asarray(lay.to_flat(out)).ravel()

    def apply_linear_rev(self, d_r):
        """(cp_bar, h_bar, xi_bar, d_bar) = (dR/d.)^T d_r."""
        cp, h, d, xi = self._padded_state()
        lay = self.layout
        _, f = jax.vjp(self._res_fn(), cp, h, xi, d)
        g = lay.to_padded(jnp.asarray(d_r).reshape(-1, 3))
        dcp, dh, dxi, dd = f(g)
        return (np.asarray(lay.to_flat(dcp)).ravel(),
                np.asarray(lay.to_flat(dh[..., None])).ravel(),
                np.asarray(dxi).ravel(),
                np.asarray(lay.to_flat(dd)).ravel())

    def _K_reduced(self):
        if getattr(self, "_K_cache", None) is not None:
            return self._K_cache
        from goldfish_jax.solver.system_mi import assemble_K_mi

        cp, h, d, xi = self._padded_state()
        s = self.sys
        K = np.asarray(assemble_K_mi(s.data, s.mi, s.co, s.ss, s.pdeg,
                                     s.qdeg, d, cp, h, xi))
        lay = self.layout
        idx = np.asarray(lay._idx)
        keep = idx.ravel() < lay.n_flat
        rows = np.nonzero(keep)[0]
        order = np.argsort(idx.ravel()[keep])
        cp_rows = rows[order]
        dof_rows = (cp_rows[:, None] * 3 + np.arange(3)[None, :]).ravel()
        self._K_cache = jnp.asarray(K[np.ix_(dof_rows, dof_rows)])
        return self._K_cache

    def solve_linear_fwd(self, rhs):
        from goldfish_jax.solver.linalg import linear_solve

        return np.asarray(linear_solve(self._K_reduced(),
                                       jnp.asarray(rhs)))

    def solve_linear_rev(self, rhs):
        # K symmetric (Hessian of one scalar potential)
        return self.solve_linear_fwd(rhs)

    def solve_linear_rev_and_accumulate(self, dJ_dd_flat):
        """One-call reverse mode: lam = K^-T g; returns
        (cp_bar, h_bar, xi_bar) = -(dR/d.)^T lam — the composition the
        OM adapter performs via solve_linear + apply_linear."""
        cp_f, h_f, xi_f, d_f = self._state
        cp, h, d, xi = self._unpack(cp_f, h_f, d_f, xi_f)
        g = self.layout.to_padded(
            jnp.asarray(dJ_dd_flat).reshape(-1, 3))
        s = self.sys
        dcp, dh, dxi = adjoint_solve_mi(s.data, s.mi, s.co, s.ss, s.pdeg,
                                        s.qdeg, d, cp, h, xi, g)
        return (np.asarray(self.layout.to_flat(dcp)).ravel(),
                np.asarray(self.layout.to_flat(dh[..., None])).ravel(),
                np.asarray(dxi).ravel())
