"""Load models: dead areal loads, point loads, follower pressure.

Replaces the reference's UFL source terms + FEniCS PointSource
(reference: GOLDFISH/tests/test_slr.py:134-138 source terms,
test_tbeam.py:113-119 PointSource) and the aero linear-spline pressure
coupling (reference: GOLDFISH/nonmatching_opt.py:1582-1665).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.geometry.patch_stack import PatchStack
from goldfish_jax.ops.bspline import rational_basis_2d
from goldfish_jax.physics.kl_shell import external_work_dead_load, surface_fields

__all__ = ["PointLoads", "build_point_loads", "EdgeLoads",
           "build_edge_loads", "external_work", "follower_pressure_work"]


class PointLoads(NamedTuple):
    """Stacked point loads: F . u(xi) at fixed parametric points."""

    patch: jnp.ndarray  # (n,) int32
    conn: jnp.ndarray   # (n, L) int32
    R0: jnp.ndarray     # (n, L)
    F: jnp.ndarray      # (n, 3)


def build_point_loads(surfs: list[NURBS], entries, max_loc: int,
                      dtype=jnp.float64) -> PointLoads | None:
    """entries: list of (patch_index, xi (2,), force (3,))."""
    if not entries:
        return None
    patch, conns, R0s, Fs = [], [], [], []
    for (ip, xi, F) in entries:
        s = surfs[ip]
        p, q = s.degree
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], p, q, s.weights,
            np.asarray(xi, dtype=np.float64)[None, :], nd=0)
        c = np.zeros(max_loc, dtype=np.int64)
        r = np.zeros(max_loc)
        c[: conn.shape[1]] = conn[0]
        r[: conn.shape[1]] = tab[(0, 0)][0]
        patch.append(ip)
        conns.append(c)
        R0s.append(r)
        Fs.append(np.asarray(F, dtype=np.float64))
    return PointLoads(
        patch=jnp.asarray(patch, dtype=jnp.int32),
        conn=jnp.asarray(np.stack(conns), dtype=jnp.int32),
        R0=jnp.asarray(np.stack(R0s), dtype=dtype),
        F=jnp.asarray(np.stack(Fs), dtype=dtype),
    )


def point_load_work(pl: PointLoads, d):
    """sum_i F_i . u(xi_i)."""
    dp = d[pl.patch]  # (n, C, 3)
    de = jax.vmap(lambda c, idx: c[idx])(dp, pl.conn)  # (n, L, 3)
    u = jnp.einsum("nl,nlk->nk", pl.R0, de)
    return jnp.sum(pl.F * u)


class EdgeLoads(NamedTuple):
    """Dead line loads along parametric edges: int f . u dl with the
    line measure |dX/ds| evaluated on the (differentiable) reference
    control points — the analogue of the reference's `ds`-measure source
    terms (reference: demos_om/thickness_opt/plate/
    plate_var_th_opt_wint.py:299-310)."""

    patch: jnp.ndarray  # (M,) int32, one entry per quadrature point
    conn: jnp.ndarray   # (M, L) int32
    R0: jnp.ndarray     # (M, L) basis values
    R1s: jnp.ndarray    # (M, L) directional derivative along the edge
    w: jnp.ndarray      # (M,) 1D quadrature weights (parametric)
    F: jnp.ndarray      # (M, 3) force per unit length


def build_edge_loads(surfs: list[NURBS], entries, max_loc: int, nq: int = 4,
                     dtype=jnp.float64) -> EdgeLoads | None:
    """entries: list of (patch, direction, side, force (3,)) — a dead
    line load on a whole parametric edge. direction/side follow the
    tIGAr side convention (geometry/patch_stack.side_dofs)."""
    from goldfish_jax.ops.quadrature import gauss_points_1d

    if not entries:
        return None
    patch, conns, R0s, R1s, ws, Fs = [], [], [], [], [], []
    for (ip, direction, side, F) in entries:
        s = surfs[ip]
        p, q = s.degree
        # quadrature along the free direction, per knot span
        free_dir = 1 - direction
        kts = np.unique(s.knots[free_dir])
        g, wg = gauss_points_1d(nq)
        for a, b in zip(kts[:-1], kts[1:]):
            ss = 0.5 * (a + b) + 0.5 * (b - a) * g
            ww = 0.5 * (b - a) * wg
            xi = np.zeros((nq, 2))
            xi[:, direction] = float(side)
            xi[:, free_dir] = ss
            conn, tab = rational_basis_2d(
                s.knots[0], s.knots[1], p, q, s.weights, xi, nd=1)
            dkey = (1, 0) if free_dir == 0 else (0, 1)
            for k in range(nq):
                c = np.zeros(max_loc, dtype=np.int64)
                r0 = np.zeros(max_loc)
                r1 = np.zeros(max_loc)
                c[: conn.shape[1]] = conn[k]
                r0[: conn.shape[1]] = tab[(0, 0)][k]
                r1[: conn.shape[1]] = tab[dkey][k]
                patch.append(ip)
                conns.append(c)
                R0s.append(r0)
                R1s.append(r1)
                ws.append(ww[k])
                Fs.append(np.asarray(F, dtype=np.float64))
    return EdgeLoads(
        patch=jnp.asarray(patch, dtype=jnp.int32),
        conn=jnp.asarray(np.stack(conns), dtype=jnp.int32),
        R0=jnp.asarray(np.stack(R0s), dtype=dtype),
        R1s=jnp.asarray(np.stack(R1s), dtype=dtype),
        w=jnp.asarray(ws, dtype=dtype),
        F=jnp.asarray(np.stack(Fs), dtype=dtype),
    )


def edge_load_work(el: EdgeLoads, d, cp):
    """sum_m w_m (F_m . u_m) |dX/ds|_m."""
    g = jax.vmap(lambda c, idx: c[idx])
    de = g(d[el.patch], el.conn)    # (M, L, 3)
    pe = g(cp[el.patch], el.conn)
    u = jnp.einsum("ml,mlk->mk", el.R0, de)
    t = jnp.einsum("ml,mlk->mk", el.R1s, pe)
    dl = jnp.linalg.norm(t, axis=-1)
    return jnp.sum(el.w * dl * jnp.sum(el.F * u, -1))


def follower_pressure_work(stack: PatchStack, d, cp, pressure):
    """Work of a uniform follower (normal) pressure per patch.

    Exact potential for constant p: W = p/3 int x . (x_,u X x_,v) dxi
    (volume-swept form). pressure: (P,) outward-normal magnitude.
    """
    X = surface_fields(stack, cp)
    u = surface_fields(stack, d)
    x = X["v"] + u["v"]
    xu = X["du"] + u["du"]
    xv = X["dv"] + u["dv"]
    X0 = X["v"]
    vol_cur = jnp.sum(x * jnp.cross(xu, xv), -1)
    vol_ref = jnp.sum(X0 * jnp.cross(X["du"], X["dv"]), -1)
    dens = (vol_cur - vol_ref) / 3.0
    return jnp.sum(pressure[:, None, None] * dens * stack.wq)


def areal_field_work(stack: PatchStack, d, cp, f_coef):
    """Work of a distributed dead load given as a CP coefficient FIELD
    f_coef: (P, C, 3) (force density per reference area, interpolated
    with the displacement basis). This is the aero-coupling input
    surface: dJ/d f_coef by AD replaces the reference's
    `set_aero_linear_splines` + `dRIGAdPaero` machinery (reference:
    GOLDFISH/nonmatching_opt.py:1582-1665)."""
    X = surface_fields(stack, cp)
    u = surface_fields(stack, d)
    f = surface_fields(stack, f_coef)
    J = jnp.linalg.norm(jnp.cross(X["du"], X["dv"]), axis=-1)
    fu = jnp.sum(f["v"] * u["v"], -1)
    return jnp.sum(fu * J * stack.wq)


def external_work(stack: PatchStack, d, cp, f_areal=None, point_loads=None,
                  pressure=None, edge_loads=None, f_field=None):
    W = jnp.zeros(())
    if f_areal is not None:
        W = W + external_work_dead_load(stack, d, cp, f_areal)
    if point_loads is not None:
        W = W + point_load_work(point_loads, d)
    if pressure is not None:
        W = W + follower_pressure_work(stack, d, cp, pressure)
    if edge_loads is not None:
        W = W + edge_load_work(edge_loads, d, cp)
    if f_field is not None:
        W = W + areal_field_work(stack, d, cp, f_field)
    return W
