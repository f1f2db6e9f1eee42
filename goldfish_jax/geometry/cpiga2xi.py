"""Implicit control-points -> intersection-coordinates map (CPIGA2Xi).

Moving-intersection machinery: given the patches' control points, find
the parametric coordinates xi of n sample points along each patch-patch
intersection, on BOTH sides. Mirrors the formulation of the reference's
`CPIGA2Xi` (reference: GOLDFISH/cpiga2xi.py — residual :401-501 =
physical coincidence + equal-arc-length spacing + end-point pinning;
`solve_xi` scipy fsolve :503-566; hand-built sparse Jacobians
:569-802), with every derivative replaced by JAX AD through the traced
NURBS evaluator (ops/bspline_jax.py) and the whole solve batched over
intersections as one jitted damped-Newton iteration on device.

Unknowns per intersection, padded to N points: x = [xiA (N,2); xiB
(N,2)] flattened (4N). Residual slots (exactly 4N):

  block1 (3N): S_A(xiA_k) - S_B(xiB_k)            [coincidence]
  block2 (N-2): |dS_A|^2_{k+1} - |dS_A|^2_k       [uniform spacing]
  block3 (2):  xiA[0/n-1, end_dir] - end_val      [ends slide on edges]

Padded points k >= n are pinned to their initial values through the
padded slots of blocks 1-2 (3 + 1 pins per padded point), keeping the
batched Jacobian square and well-conditioned.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.ops.bspline_jax import SurfSet, make_surf_set, surface_point

__all__ = ["MovingIntersections", "build_moving_intersections", "CPIGA2Xi"]


class MovingIntersections(NamedTuple):
    """Padded device data; I intersections, N max points each."""

    pairA: jnp.ndarray    # (I,) int32
    pairB: jnp.ndarray    # (I,)
    n_pts: jnp.ndarray    # (I,) int32 real points
    mask: jnp.ndarray     # (I, N) 1.0 for real points
    end_dir: jnp.ndarray  # (I, 2) int32: pinned coordinate at each end (A side)
    end_val: jnp.ndarray  # (I, 2)
    xi0: jnp.ndarray      # (I, N, 2, 2) initial [.., 0, :]=xiA, [.., 1, :]=xiB
    # edge-to-edge bookkeeping (reference: GOLDFISH/cpiga2xi.py:231-302
    # edge-constraint machinery): when BOTH sides' curves run along
    # parametric edges (e.g. co-tangent seams of a smooth multi-patch
    # cylinder) the 3D coincidence Jacobian is rank-2 per point — the
    # residual then pins both edge coordinates and keeps only the
    # along-curve coincidence projection
    both_edges: jnp.ndarray  # (I,) 1.0 when both sides are edge curves
    epin_dir: jnp.ndarray    # (I, 2) int32: pinned coord on side A / B
    epin_val: jnp.ndarray    # (I, 2)

    @property
    def n_int(self):
        return self.pairA.shape[0]

    @property
    def n_max(self):
        return self.mask.shape[1]


def build_moving_intersections(specs, n_pts_list, dtype=jnp.float64):
    """specs: InterfaceSpec-like objects — straight segments
    (xi_ends_*) or general CURVED parametric polylines (xi_pts_*, the
    reference's intersections_para_coords format); n_pts_list: points
    per intersection (>= 3). End pinning follows each END SEGMENT's
    dominant parametric direction on side A (the reference's
    edge-constraint bookkeeping, GOLDFISH/cpiga2xi.py:142-203) — for a
    curved polyline the two ends may pin different coordinates."""
    from goldfish_jax.physics.coupling import (
        polyline_interp,
        spec_polylines,
    )

    I = len(specs)
    N = max(n_pts_list)
    pairA = np.zeros(I, dtype=np.int32)
    pairB = np.zeros(I, dtype=np.int32)
    n_pts = np.asarray(n_pts_list, dtype=np.int32)
    mask = np.zeros((I, N))
    end_dir = np.zeros((I, 2), dtype=np.int32)
    end_val = np.zeros((I, 2))
    xi0 = np.zeros((I, N, 2, 2))
    both_edges = np.zeros(I)
    epin_dir = np.zeros((I, 2), dtype=np.int32)
    epin_val = np.zeros((I, 2))
    edge_side = np.zeros((I, 2), dtype=bool)
    for i, spec in enumerate(specs):
        pairA[i], pairB[i] = spec.pair
        n = int(n_pts[i])
        assert n >= 3
        mask[i, :n] = 1.0
        plA, plB = spec_polylines(spec)
        s = np.linspace(0.0, 1.0, n)
        xi0[i, :n, 0, :], _ = polyline_interp(plA, s)
        xi0[i, :n, 1, :], _ = polyline_interp(plB, s)
        # per-end pinned coordinate: the end segment's DOMINANT
        # (along-curve) direction is held at its end value, leaving
        # the transverse coordinate free to slide along the edge
        d0 = np.abs(plA[1] - plA[0])
        d1 = np.abs(plA[-1] - plA[-2])
        end_dir[i] = (int(np.argmax(d0)), int(np.argmax(d1)))
        end_val[i] = (plA[0, end_dir[i, 0]], plA[-1, end_dir[i, 1]])
        xi0[i, n:] = xi0[i, n - 1]  # padded points sit at the last real one
        # edge-on-both-sides detection (per side: one coordinate is
        # constant at a parameter-box boundary along the whole curve)
        for side, pl in ((0, plA), (1, plB)):
            for c in range(2):
                col = pl[:, c]
                if np.all(np.abs(col - col[0]) < 1e-9) and \
                        (abs(col[0]) < 1e-9 or abs(col[0] - 1) < 1e-9):
                    epin_dir[i, side] = c
                    epin_val[i, side] = col[0]
                    edge_side[i, side] = True
                    break
        both_edges[i] = float(edge_side[i, 0] and edge_side[i, 1])
    return MovingIntersections(
        pairA=jnp.asarray(pairA), pairB=jnp.asarray(pairB),
        n_pts=jnp.asarray(n_pts), mask=jnp.asarray(mask, dtype=dtype),
        end_dir=jnp.asarray(end_dir), end_val=jnp.asarray(end_val, dtype=dtype),
        xi0=jnp.asarray(xi0, dtype=dtype),
        both_edges=jnp.asarray(both_edges, dtype=dtype),
        epin_dir=jnp.asarray(epin_dir),
        epin_val=jnp.asarray(epin_val, dtype=dtype))


def _residual_one(ss: SurfSet, p, q, cp, iA, iB, n, mask, end_dir, end_val,
                  xi0, both_edges, epin_dir, epin_val, x):
    """Residual (4N,) for one intersection; x = flattened (N,2,2) xi."""
    N = mask.shape[0]
    xi = x.reshape(N, 2, 2)
    xiA, xiB = xi[:, 0, :], xi[:, 1, :]
    ptsA = jax.vmap(lambda t: surface_point(ss, p, q, iA, cp, t))(xiA)
    ptsB = jax.vmap(lambda t: surface_point(ss, p, q, iB, cp, t))(xiB)

    k = jnp.arange(N)
    real = mask > 0.5

    # block1: coincidence, padded rows pin [xiA0, xiA1, xiB0] to xi0
    coin = ptsA - ptsB                               # (N, 3)
    # EDGE-TO-EDGE intersections (both curves on parametric edges, e.g.
    # co-tangent seams): the raw 3D coincidence is rank-2 per point —
    # replace it with [pin edge coord A, pin edge coord B, along-curve
    # coincidence projection] (reference edge-constraint bookkeeping,
    # GOLDFISH/cpiga2xi.py:231-302)
    tan = jnp.roll(ptsA, -1, axis=0) - jnp.roll(ptsA, 1, axis=0)
    tan = tan.at[0].set(ptsA[1] - ptsA[0])
    last = n - 1
    tan_last = jnp.take(ptsA, last, axis=0) - jnp.take(
        ptsA, jnp.maximum(last - 1, 0), axis=0)
    tan = jnp.where((k >= last)[:, None], tan_last, tan)
    that = tan / (jnp.linalg.norm(tan, axis=-1, keepdims=True) + 1e-300)
    coin_edge = jnp.stack([
        jnp.take_along_axis(xiA, epin_dir[0][None, None].repeat(N, 0),
                            axis=1)[:, 0] - epin_val[0],
        jnp.take_along_axis(xiB, epin_dir[1][None, None].repeat(N, 0),
                            axis=1)[:, 0] - epin_val[1],
        jnp.sum(coin * that, axis=-1)], axis=-1)
    coin = jnp.where(both_edges > 0.5, coin_edge, coin)
    pin1 = jnp.stack([xi[:, 0, 0] - xi0[:, 0, 0],
                      xi[:, 0, 1] - xi0[:, 0, 1],
                      xi[:, 1, 0] - xi0[:, 1, 0]], axis=-1)
    b1 = jnp.where(real[:, None], coin, pin1).reshape(-1)

    # block2: uniform spacing of side-A physical points; rows k = 0..N-3
    seg = jnp.sum((ptsA[1:] - ptsA[:-1]) ** 2, -1)   # (N-1,)
    sp = seg[1:] - seg[:-1]                          # (N-2,)
    # row k is real iff point k+2 is real; padded row pins xiB1 of k+2
    row_real = real[2:]
    pin2 = xi[2:, 1, 1] - xi0[2:, 1, 1]
    b2 = jnp.where(row_real, sp, pin2)

    # block3: end points slide along fixed parametric lines of side A
    iend = n - 1
    b3 = jnp.stack([
        xiA[0, end_dir[0]] - end_val[0],
        xiA[iend, end_dir[1]] - end_val[1]])
    return jnp.concatenate([b1, b2, b3])


def _mi_args(mi: MovingIntersections):
    return (mi.pairA, mi.pairB, mi.n_pts, mi.mask, mi.end_dir,
            mi.end_val, mi.xi0, mi.both_edges, mi.epin_dir, mi.epin_val)


@partial(jax.jit, static_argnames=("p", "q"))
def _c2x_res(ss, mi, cp, x, *, p, q):
    def res_one(iA, iB, n, mask, ed, ev, xi0, be, epd, epv, xx):
        return _residual_one(ss, p, q, cp, iA, iB, n, mask, ed, ev,
                             xi0, be, epd, epv, xx)

    return jax.vmap(res_one)(*_mi_args(mi), x)


@partial(jax.jit, static_argnames=("p", "q"))
def _c2x_jac(ss, mi, cp, x, *, p, q):
    def res_one(iA, iB, n, mask, ed, ev, xi0, be, epd, epv, xx):
        return _residual_one(ss, p, q, cp, iA, iB, n, mask, ed, ev,
                             xi0, be, epd, epv, xx)

    return jax.vmap(jax.jacfwd(res_one, argnums=10))(*_mi_args(mi), x)


@partial(jax.jit, static_argnames=("p", "q", "max_it"))
def _c2x_newton(ss, mi, cp, x0, *, p, q, rtol=1e-12, max_it=20):
    """Batched damped Newton over intersections; x: (I, 4N)."""

    def res(x):
        return _c2x_res.__wrapped__(ss, mi, cp, x, p=p, q=q)

    def jac(x):
        return _c2x_jac.__wrapped__(ss, mi, cp, x, p=p, q=q)

    def rnorm(x):
        return jnp.max(jnp.linalg.norm(res(x), axis=-1))

    def cond(state):
        x, it, rn = state
        return (it < max_it) & (rn > rtol)

    def body(state):
        x, it, _ = state
        r = res(x)
        J = jac(x)
        dx = jnp.linalg.solve(J, -r[..., None])[..., 0]

        def ls_cond(s):
            alpha, j = s
            rt = res(x + alpha * dx)
            ok = (jnp.linalg.norm(rt)
                  <= (1 - 1e-4 * alpha) * jnp.linalg.norm(r))
            return jnp.logical_not(ok) & (j < 20)

        alpha, _ = jax.lax.while_loop(
            ls_cond, lambda s: (0.5 * s[0], s[1] + 1),
            (jnp.asarray(1.0, x.dtype), jnp.int32(0)))
        x = x + alpha * dx
        return x, it + 1, rnorm(x)

    x, it, rn = jax.lax.while_loop(cond, body,
                                   (x0, jnp.int32(0), rnorm(x0)))
    return x, it, rn


@partial(jax.jit, static_argnames=("p", "q"))
def _c2x_res_jac(ss, mi, cp, x, *, p, q):
    """Residual + Jacobian in one program (the mixed path's host xi
    loop and its damped fallback)."""
    r = _c2x_res.__wrapped__(ss, mi, cp, x, p=p, q=q)
    J = _c2x_jac.__wrapped__(ss, mi, cp, x, p=p, q=q)
    return r, J


def _batched_f32ir_solve(J, b, n_ir):
    """Batched solve J x = b (J (I,M,M) f64) ON DEVICE: f32 LU +
    f64 iterative refinement. Unlike the shell tangents (cond ~1e12,
    where f32 factorization is unusable), the xi systems are small
    geometric Jacobians (cond ~1e3-1e5): each IR sweep contracts the
    error by ~cond*eps32, so a few sweeps reach f64 grade — and the
    whole solve stays inside one XLA program without an f64
    factorization. Returns
    (x, ratio) with ratio = |last correction|/|x| as the convergence
    certificate."""
    f32 = jnp.float32
    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(J.astype(f32))

    def subst(rhs):
        s = jax.vmap(lambda l, p_, b_: jax.scipy.linalg.lu_solve(
            (l, p_), b_))(lu, piv, rhs.astype(f32))
        return s.astype(b.dtype)

    x = subst(b)

    def sweep(_, carry):
        x, _ = carry
        resid = b - jnp.einsum("imn,in->im", J, x)
        dx = subst(resid)
        return x + dx, jnp.linalg.norm(dx)

    x, last_dx = jax.lax.fori_loop(0, n_ir, sweep,
                                   (x, jnp.linalg.norm(x)))
    return x, last_dx / (jnp.linalg.norm(x) + 1e-300)


@partial(jax.jit, static_argnames=("p", "q", "n_ir"))
def _c2x_step(ss, mi, cp, x, *, p, q, n_ir=3):
    """ONE fused full-Newton xi step: residual + Jacobian + batched
    f32-LU/f64-IR solve + trial residual, a single device program.
    The host loop around it only checks norms and (rarely) falls back
    to the damped path: one dispatch and one readback per Newton
    iteration."""
    r = _c2x_res.__wrapped__(ss, mi, cp, x, p=p, q=q)
    J = _c2x_jac.__wrapped__(ss, mi, cp, x, p=p, q=q)
    dx, ratio = _batched_f32ir_solve(J, -r, n_ir)
    x_new = x + dx
    r_new = _c2x_res.__wrapped__(ss, mi, cp, x_new, p=p, q=q)
    rn = jnp.max(jnp.linalg.norm(r, axis=-1))
    rn_new = jnp.max(jnp.linalg.norm(r_new, axis=-1))
    return x_new, rn, rn_new, ratio


def _c2x_newton_host(ss, mi, cp, x0, *, p, q, rtol=1e-12, max_it=20):
    import numpy as np

    from goldfish_jax.utils.evtrace import trace

    trace("xi_newton.enter")
    x = x0
    for it in range(max_it):
        # optimistic fused full step (the warm/normal case): accept on
        # sufficient decrease, one dispatch per Newton iteration
        x_new, rn_, rn_new_, _ = _c2x_step(ss, mi, cp, x, p=p, q=q)
        # ONE batched readback (sequential float() fetches sync the
        # host once EACH)
        rn, rn_new = (float(v) for v in
                      jax.device_get((rn_, rn_new_)))
        trace("xi_newton.step", it=it, rn=rn, rn_new=rn_new)
        if rn <= rtol:
            return x, it, rn
        if rn_new <= (1 - 1e-4) * rn:
            x = x_new
            if rn_new <= rtol:
                return x, it + 1, rn_new
            continue
        # full step did not contract (cold/pathological state):
        # damped fallback for THIS iteration — host f64 solve +
        # backtracking on the batched residual norm
        r, J = _c2x_res_jac(ss, mi, cp, x, p=p, q=q)
        dx = jnp.asarray(np.linalg.solve(
            np.asarray(J), -np.asarray(r)[..., None])[..., 0],
            dtype=x.dtype)
        alpha = 1.0
        for _ in range(20):
            rt = _c2x_res(ss, mi, cp, x + alpha * dx, p=p, q=q)
            if float(jnp.max(jnp.linalg.norm(rt, axis=-1))) \
                    <= (1 - 1e-4 * alpha) * rn:
                break
            alpha *= 0.5
        x = x + alpha * dx
    # convergence on the MAX per-intersection norm, matching the jitted
    # device solver (_c2x_newton): the aggregate norm can hide one
    # badly-converged intersection among many
    r = _c2x_res(ss, mi, cp, x, p=p, q=q)
    return x, max_it, float(jnp.max(jnp.linalg.norm(r, axis=-1)))


@partial(jax.jit, static_argnames=("p", "q"))
def _c2x_res_vjp(ss, mi, cp, x, lam, *, p, q):
    def r_of_cp(cp_):
        return _c2x_res.__wrapped__(ss, mi, cp_, x, p=p, q=q)

    _, vjp = jax.vjp(r_of_cp, cp)
    (dcp,) = vjp(-lam)
    return dcp


@partial(jax.jit, static_argnames=("p", "q"))
def _c2x_adjoint_direct(ss, mi, cp, x, g, *, p, q):
    J = _c2x_jac.__wrapped__(ss, mi, cp, x, p=p, q=q)
    lam = jnp.linalg.solve(jnp.swapaxes(J, -1, -2), g[..., None])[..., 0]
    return _c2x_res_vjp.__wrapped__(ss, mi, cp, x, lam, p=p, q=q)


@partial(jax.jit, static_argnames=("p", "q", "n_ir"))
def _c2x_adjoint_f32ir(ss, mi, cp, x, g, *, p, q, n_ir=3):
    """Fused mixed-path backward: Jacobian + batched transpose
    f32-LU/f64-IR solve + residual vjp, ONE device program (see
    _c2x_step). Returns (dcp, ratio) — ratio is the IR certificate;
    the caller falls back to the exact host solve when it fails."""
    J = _c2x_jac.__wrapped__(ss, mi, cp, x, p=p, q=q)
    lam, ratio = _batched_f32ir_solve(jnp.swapaxes(J, -1, -2), g, n_ir)
    return _c2x_res_vjp.__wrapped__(ss, mi, cp, x, lam, p=p, q=q), ratio


def _c2x_adjoint(ss, mi, cp, x, g, *, p, q):
    """Implicit-function backward: dR/dxi^T lam = g, dcp = -lam^T
    dR/dcp. On the mixed path one fused device program (f32 LU + f64
    IR — the xi systems are low-cond, unlike the shell tangents), with
    an exact host f64 solve as certificate-guarded fallback; on the
    direct path a batched f64 LU."""
    from goldfish_jax.solver.linalg import mode as _mode

    if _mode() == "mixed":
        dcp, ratio = _c2x_adjoint_f32ir(ss, mi, cp, x, g, p=p, q=q)
        if float(ratio) <= 1e-9:
            return dcp
        import numpy as np

        _, J = _c2x_res_jac(ss, mi, cp, x, p=p, q=q)
        Jt = np.swapaxes(np.asarray(J), -1, -2)
        lam = jnp.asarray(
            np.linalg.solve(Jt, np.asarray(g)[..., None])[..., 0],
            dtype=x.dtype)
        return _c2x_res_vjp(ss, mi, cp, x, lam, p=p, q=q)
    return _c2x_adjoint_direct(ss, mi, cp, x, g, p=p, q=q)


class CPIGA2Xi:
    """Differentiable xi(cp) via batched damped Newton + custom_vjp.

    Host facade; all solves/jacobians jitted. The implicit-function
    backward pass factors dR/dxi once per intersection (the reference
    SuperLU-factorizes the same matrix,
    GOLDFISH/operations/cpiga2xi_imop.py:40-58)."""

    def __init__(self, surfs, specs, n_pts_list=None, rtol=1e-12,
                 max_it=20):
        self.surfs = surfs
        self.ss, (self.p, self.q) = make_surf_set(surfs)
        if n_pts_list is None:
            n_pts_list = [max(int(s.n_mortar_el) + 1, 3) for s in specs]
        self.mi = build_moving_intersections(specs, n_pts_list)
        self.rtol = rtol
        self.max_it = max_it

        # All jitted kernels take (ss, mi, ...) as ARGUMENTS, so the
        # compiled programs do not embed them.
        p, q = self.p, self.q
        rtol_, max_it_ = rtol, max_it

        @jax.custom_vjp
        def solve_xi(cp, x0):
            from goldfish_jax.solver.linalg import mode as _mode

            if _mode() == "mixed":
                x, _, _ = _c2x_newton_host(self.ss, self.mi, cp, x0,
                                           p=p, q=q, rtol=rtol_,
                                           max_it=max_it_)
                return x
            x, _, _ = _c2x_newton(self.ss, self.mi, cp, x0, p=p, q=q,
                                  rtol=rtol_, max_it=max_it_)
            return x

        def fwd(cp, x0):
            x = solve_xi(cp, x0)
            return x, (cp, x)

        def bwd(resids, g):
            cp, x = resids
            dcp = _c2x_adjoint(self.ss, self.mi, cp, x, g, p=p, q=q)
            return dcp, jnp.zeros_like(x)

        solve_xi.defvjp(fwd, bwd)
        self._solve_xi = solve_xi

    # ------------------------------------------------------------ API
    @property
    def xi0_flat(self):
        I, N = self.mi.n_int, self.mi.n_max
        return self.mi.xi0.reshape(I, 4 * N)

    def solve(self, cp, x0=None):
        """Differentiable xi(cp): (I, 4N) flattened coordinates."""
        x0 = self.xi0_flat if x0 is None else x0
        return self._solve_xi(cp, x0)

    def residual_norm(self, cp, x):
        r = _c2x_res(self.ss, self.mi, cp, x, p=self.p, q=self.q)
        return float(jnp.max(jnp.linalg.norm(r, axis=-1)))


def xi_edge_constraints(mi: MovingIntersections, tol: float = 1e-9):
    """Edge-type xi constraints (reference: IntXiEdgeComp,
    GOLDFISH/om_comps/int_xi_edge_comp.py — constraint xi_dof - val = 0
    with a constant 0/1 Jacobian).

    For every intersection whose initial curve runs along a constant
    parametric coordinate of side A or B, returns the flat dof indices
    (into the (I, N, 2, 2)-raveled xi vector) and target values pinning
    that coordinate for ALL points. Feed to the optimizer as linear
    equality constraints on the xi design/state vector.
    """
    import numpy as np

    xi0 = np.asarray(mi.xi0)
    n_pts = np.asarray(mi.n_pts)
    I, N = xi0.shape[0], xi0.shape[1]
    dofs, vals = [], []
    for i in range(I):
        n = int(n_pts[i])
        for side in (0, 1):
            for c in (0, 1):
                col = xi0[i, :n, side, c]
                if np.all(np.abs(col - col[0]) < tol) and \
                        (abs(col[0]) < tol or abs(col[0] - 1) < tol):
                    for k in range(n):
                        dofs.append(((i * N + k) * 2 + side) * 2 + c)
                        vals.append(float(col[0]))
    return np.asarray(dofs, dtype=np.int64), np.asarray(vals)


def xi_interior_dofs(mi: MovingIntersections, tol: float = 1e-9):
    """Flat dofs of the xi vector that are FREE to move strictly inside
    (0, 1) — the meaningful support of in-domain bound constraints
    (the reference XiConsComp role, reference: demos_om/shape_opt_mint/
    tube/custom_comps/xi_cons_comp.py:17-36 + tube_shopt_mi_4patch_wffd
    .py:233-234 `lower=0., upper=1.`).

    Excludes (a) padded points beyond each intersection's n_pts,
    (b) edge-pinned coordinate columns (`xi_edge_constraints`), (c) the
    end-pinned coordinates (end_dir at the first/last point), and
    (d) MATING-side (side B) endpoint coordinates sitting ON the 0/1
    boundary at an end whose side-A pin is itself a DOMAIN-BOUNDARY
    isoline (`end_val` at 0/1): there the seam terminates on patch A's
    edge, the mating patch meets it along its own edge, and coincidence
    forces the side-B coordinate to stay at 0/1 — a KS max/min
    aggregate over the full vector would otherwise read 0/1 from these
    pinned dofs and make the bound constraint unsatisfiable by
    construction (e.g. the 4-patch tube's seam ends on the end
    circles: side-B u is forced to the same end circle).

    Exclusion (d) deliberately does NOT drop a coordinate that merely
    STARTS at 0/1 without that structural force (advisor finding,
    round 4): a side-A non-end_dir coordinate at a corner slides along
    the pinned isoline and can move off the corner, and a side-B
    boundary start at an INTERIOR end pin (`end_val` strictly inside)
    is coincidental — both stay in the aggregate so the optimizer
    cannot drag them outside [0, 1] unconstrained. Callers must
    re-derive this set if a topology change re-pins seam ends.
    """
    import numpy as np

    xi0 = np.asarray(mi.xi0)
    n_pts = np.asarray(mi.n_pts)
    end_dir = np.asarray(mi.end_dir)
    end_val = np.asarray(mi.end_val)
    I, N = xi0.shape[0], xi0.shape[1]
    edge_dofs = set(xi_edge_constraints(mi, tol=tol)[0].tolist())

    def boundary_end(i, k, n):
        # which end (0/1) this point is, or None if interior; the end
        # counts only if its side-A pin value is on the domain boundary
        end = 0 if k == 0 else (1 if k == n - 1 else None)
        if end is None:
            return None
        ev = float(end_val[i, end])
        return end if (abs(ev) < tol or abs(ev - 1.0) < tol) else None

    out = []
    for i in range(I):
        n = int(n_pts[i])
        for k in range(n):
            for side in (0, 1):
                for c in (0, 1):
                    dof = ((i * N + k) * 2 + side) * 2 + c
                    if dof in edge_dofs:
                        continue
                    if side == 0 and (
                            (k == 0 and c == int(end_dir[i, 0]))
                            or (k == n - 1 and c == int(end_dir[i, 1]))):
                        continue
                    v = float(xi0[i, k, side, c])
                    if (side == 1
                            and boundary_end(i, k, n) is not None
                            and (abs(v) < tol or abs(v - 1.0) < tol)):
                        continue
                    out.append(dof)
    return np.asarray(out, dtype=np.int64)
