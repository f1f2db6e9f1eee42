"""Penalty coupling with MOVING intersections: energy as a function of
the intersection coordinates xi.

The reference implements this as mortar-mesh movement + transfer-matrix
rebuilds + ~300 lines of hand-derived matrix calculus for dRIGA/dxi
(reference: GOLDFISH/nonmatching_opt.py:533-623 create_diff_
intersections/update_xi/update_transfer_matrices and :1042-1341
dRIGAdxi_sub). Here the SAME Herrema-style penalty density
(physics/coupling.qp_penalty_density) is evaluated at basis rows traced
through ops/bspline_jax at the CURRENT xi — so d(penalty)/dxi,
d(penalty)/dCP and the coupling stiffness are all plain JAX AD.

Quadrature: the xi sample points themselves, trapezoid weights in the
curve parameter s in [0, 1]; curve tangents dxi/ds from neighbor
differences (one-sided at the ends). All padded points carry zero
weight.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.geometry.cpiga2xi import MovingIntersections
from goldfish_jax.ops.bspline_jax import SurfSet, surface_basis
from goldfish_jax.physics.coupling import qp_penalty_density

__all__ = ["MICoupling", "build_mi_coupling", "penalty_energy_mi",
           "interface_hessians_mi"]


class MICoupling(NamedTuple):
    """Penalty scales + quadrature weights; I intersections, N points."""

    w_s: jnp.ndarray       # (I, N) trapezoid weights (0 on padding)
    ad_scale: jnp.ndarray  # (I,) penalty_coefficient / h_m
    ar_scale: jnp.ndarray  # (I,)


def build_mi_coupling(surfs, mi: MovingIntersections,
                      penalty_coefficient: float = 1.0e3,
                      dtype=jnp.float64) -> MICoupling:
    """Trapezoid weights + penalty scales from the INITIAL geometry
    (h_m frozen at setup, matching PENGoLINS' mortar-size convention)."""
    I, N = mi.n_int, mi.n_max
    w = np.zeros((I, N))
    ad = np.zeros(I)
    n_pts = np.asarray(mi.n_pts)
    xi0 = np.asarray(mi.xi0)
    pairA = np.asarray(mi.pairA)
    for i in range(I):
        n = int(n_pts[i])
        w[i, :n] = 1.0 / (n - 1)
        w[i, 0] = w[i, n - 1] = 0.5 / (n - 1)
        # initial curve length on side A (host evaluation)
        sA = surfs[pairA[i]]
        pts = np.stack([
            sA.evaluate(np.array([xi0[i, k, 0, 0]]),
                        np.array([xi0[i, k, 0, 1]]))[0, 0]
            for k in range(n)])
        length = float(np.sum(np.linalg.norm(np.diff(pts, axis=0), axis=-1)))
        h_m = max(length / (n - 1), 1e-14)
        ad[i] = penalty_coefficient / h_m
    return MICoupling(
        w_s=jnp.asarray(w, dtype=dtype),
        ad_scale=jnp.asarray(ad, dtype=dtype),
        ar_scale=jnp.asarray(ad, dtype=dtype),
    )


def _rational_rows(ss: SurfSet, p: int, q: int, ip, t):
    """(conn (L,), R0 (L,), R1 (L, 2)) rational basis rows at traced t."""
    conn, wN = surface_basis(ss, p, q, ip, t)

    def r0(tt):
        _, wN2 = surface_basis(ss, p, q, ip, tt)
        return wN2 / jnp.sum(wN2)

    R0 = wN / jnp.sum(wN)
    R1 = jax.jacfwd(r0)(t)  # (L, 2)
    return conn, R0, R1


def _curve_tangents(xiS, n_pts, dtype):
    """dxi/ds at every sample of one curve side: (N, 2).

    Central differences in the interior, one-sided at the real ends.
    Padded rows (k > n_pts-1) replicate the LAST REAL point, so their
    neighbor differences are exactly zero — which would feed _unit(0)
    NaNs into the penalty density that the zero quadrature weight cannot
    mask (0*NaN = NaN). Padding discipline: padded rows carry the last
    real point's tangent instead.
    """
    N = xiS.shape[0]
    n1i = (n_pts - 1).astype(dtype)
    fwdd = jnp.roll(xiS, -1, axis=0) - xiS      # k -> k+1 - k
    bwdd = xiS - jnp.roll(xiS, 1, axis=0)
    k = jnp.arange(N)
    last = n_pts - 1
    interior = (k > 0) & (k < last)
    dxi = jnp.where(interior[:, None], 0.5 * (fwdd + bwdd) * n1i,
                    jnp.where((k == 0)[:, None], fwdd * n1i,
                              bwdd * n1i))
    dxi_last = jnp.take(dxi, last, axis=0)
    return jnp.where((k > last)[:, None], dxi_last, dxi)


def _point_contributions(ss, p, q, mi: MovingIntersections, xi, d, cp,
                         h_coef, E_int, co: MICoupling):
    """Penalty density * dl at every (intersection, point): (I, N)."""
    I, N = mi.n_int, mi.n_max

    def one_int(iA, iB, xiI, n_pts, wsI, adI, arI, EI):
        xiA, xiB = xiI[:, 0, :], xiI[:, 1, :]
        dxiA = _curve_tangents(xiA, n_pts, xi.dtype)
        dxiB = _curve_tangents(xiB, n_pts, xi.dtype)

        rowsA = jax.vmap(lambda t: _rational_rows(ss, p, q, iA, t))(xiA)
        rowsB = jax.vmap(lambda t: _rational_rows(ss, p, q, iB, t))(xiB)
        connA, RA0, RA1 = rowsA
        connB, RB0, RB1 = rowsB

        deA = d[iA][connA]      # (N, L, 3)
        deB = d[iB][connB]
        peA = cp[iA][connA]
        peB = cp[iB][connB]
        heA = h_coef[iA][connA]  # (N, L)
        heB = h_coef[iB][connB]

        dens = qp_penalty_density(
            (RA0, RA1[..., 0], RA1[..., 1]),
            (RB0, RB1[..., 0], RB1[..., 1]),
            dxiA, dxiB, deA, deB, peA, peB, heA, heB,
            EI, adI, arI)
        return dens * wsI

    return jax.vmap(one_int)(mi.pairA, mi.pairB,
                             xi.reshape(I, N, 2, 2), mi.n_pts,
                             co.w_s, co.ad_scale[:, None],
                             co.ar_scale[:, None], E_int[:, None])


def penalty_energy_mi(ss: SurfSet, p: int, q: int, mi: MovingIntersections,
                      co: MICoupling, xi, d, cp, h_coef, E):
    """Total coupling penalty at the current intersection coordinates.

    xi: (I, 4N) flattened (the CPIGA2Xi solution); fully differentiable
    in xi, d, cp, h."""
    if mi is None or mi.n_int == 0:
        return jnp.zeros(())
    E_int = jnp.maximum(E[mi.pairA], E[mi.pairB])
    dens = _point_contributions(ss, p, q, mi, xi, d, cp, h_coef, E_int, co)
    return jnp.sum(dens)


def interface_hessians_mi(ss, p, q, mi: MovingIntersections, co: MICoupling,
                          xi, d, cp, h_coef, E):
    """Exact coupling stiffness blocks at traced xi:
    (I, N, 6L, 6L) Hessians wrt stacked [deA; deB] locals, plus the
    (I, N, L) conn arrays needed to scatter them."""
    I, N = mi.n_int, mi.n_max
    E_int = jnp.maximum(E[mi.pairA], E[mi.pairB])
    xiR = xi.reshape(I, N, 2, 2)

    def one_point(iA, iB, xiAk, xiBk, dxiAk, dxiBk, wsk, adI, arI, EI):
        connA, RA0, RA1 = _rational_rows(ss, p, q, iA, xiAk)
        connB, RB0, RB1 = _rational_rows(ss, p, q, iB, xiBk)
        L = RA0.shape[0]
        peA, peB = cp[iA][connA], cp[iB][connB]
        heA, heB = h_coef[iA][connA], h_coef[iB][connB]
        dA0, dB0 = d[iA][connA], d[iB][connB]

        def f(x):
            da = x[: 3 * L].reshape(L, 3)
            db = x[3 * L:].reshape(L, 3)
            return wsk * qp_penalty_density(
                (RA0, RA1[..., 0], RA1[..., 1]),
                (RB0, RB1[..., 0], RB1[..., 1]),
                dxiAk, dxiBk, da, db, peA, peB, heA, heB, EI, adI, arI)

        x0 = jnp.concatenate([dA0.reshape(-1), dB0.reshape(-1)])
        return jax.hessian(f)(x0), connA, connB

    def one_int(iA, iB, xiI, n_pts, wsI, adI, arI, EI):
        xiA, xiB = xiI[:, 0, :], xiI[:, 1, :]
        dxiA = _curve_tangents(xiA, n_pts, xi.dtype)
        dxiB = _curve_tangents(xiB, n_pts, xi.dtype)
        return jax.vmap(one_point,
                        in_axes=(None, None, 0, 0, 0, 0, 0, None, None, None)
                        )(iA, iB, xiA, xiB, dxiA, dxiB, wsI, adI, arI, EI)

    return jax.vmap(one_int)(mi.pairA, mi.pairB, xiR, mi.n_pts, co.w_s,
                             co.ad_scale, co.ar_scale, E_int)
