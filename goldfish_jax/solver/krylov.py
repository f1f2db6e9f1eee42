"""Matrix-free Newton-Krylov path for large patch counts.

The dense tangent of solver/system.py is O((P*C*3)^2) memory — fine to
~10k dofs, wrong for pegasus-class models (90 patches, SURVEY.md
section 5 scaling axes). This module provides the scalable path the
reference gets from distributed PETSc KSP (reference:
GOLDFISH/utils/opt_utils.py:106-133 CG+Jacobi):

  - `tangent_matvec` (solver/system.py): exact K @ v as one jvp through
    the residual — never materializes K;
  - per-patch block-Jacobi preconditioner: the (3C, 3C) diagonal blocks
    assembled from element Hessians only (interface coupling excluded),
    factored once per Newton step with a batched f32 LU (vmapped on the
    device) — the analogue of PETSc's block preconditioners;
  - preconditioned GMRES in the working dtype. GMRES, not CG: the f32
    block solves carry O(cond * eps_f32) error, so the preconditioner
    is not accurately SPD — CG's rz inner products go negative and the
    recurrence collapses, while GMRES only loses iterations
    (the same reason the dense path uses GMRES-IR, solver/linalg.py).

Patch-sharded execution: the matvec is a jvp through patch-batched
einsums, so under a `parallel.sharding` mesh the same code runs SPMD
with XLA collectives for the interface terms.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from goldfish_jax.physics import kl_shell
from goldfish_jax.solver.linalg import cast_floating
from goldfish_jax.solver.system import SystemData, assemble_K, tangent_matvec

__all__ = ["patch_block_precond", "PairSchwarz", "full_f32_precond",
           "gmres_solve", "newton_krylov_solve", "build_solve_fn_krylov"]


def full_f32_precond(data: SystemData, d, cp, h):
    """Equilibrated f32 LU of the FULL tangent, assembled in f32.

    The memory-lean variant of the dense GMRES-IR preconditioner
    (solver/linalg.py): assembly in f32 costs ~1e-7 relative error in K
    — irrelevant for a preconditioner — and avoids the f64 Hessian
    assembly entirely. O(N^2) f32 memory: viable to ~30-50k
    dofs; beyond that use PairSchwarz.
    """
    data32 = cast_floating(data, jnp.float32)
    K32 = assemble_K(data32, d.astype(jnp.float32),
                     cp.astype(jnp.float32), h.astype(jnp.float32))
    dsc = jax.lax.rsqrt(jnp.abs(jnp.diagonal(K32)) + 1e-30)
    Keq = K32 * dsc[:, None] * dsc[None, :]
    lu, piv = jax.scipy.linalg.lu_factor(Keq)
    return ("full", (lu, piv, dsc))


def patch_block_precond(data: SystemData, d, cp, h):
    """Factored per-patch diagonal blocks of K: returns (lu, piv) with
    lu: (P, 3C, 3C) in f32. Padding/fixed dofs carry identity rows.

    The same-patch (A-A / B-B) quadrants of the interface penalty
    Hessians ARE included: they are what anchors the rigid-body modes of
    patches without Dirichlet BCs — without them the floating patches'
    blocks are singular and the preconditioner is garbage.
    """
    from goldfish_jax.physics.coupling import interface_hessians

    stack = data.stack
    P, C = stack.n_patches, stack.max_cp
    n = 3 * C
    Ke = kl_shell.element_hessians(stack, d, cp, h, data.E, data.nu,
                                   pressure=data.pressure)
    # local dof -> within-patch dof
    li = (stack.conn[..., :, None] * 3
          + jnp.arange(3, dtype=stack.conn.dtype)).reshape(
        P, Ke.shape[1], -1)  # (P, E, 3L)

    def scatter_patch(Kp, lip):
        Kblk = jnp.zeros((n, n), dtype=Kp.dtype)
        return Kblk.at[lip[..., :, None], lip[..., None, :]].add(Kp)

    Kb = jax.vmap(scatter_patch)(Ke, li)  # (P, 3C, 3C)

    if data.ifs is not None and data.ifs.n_interfaces > 0:
        ifs = data.ifs
        Ki = interface_hessians(ifs, d, cp, h, data.E)  # (I, Nq, 6L, 6L)
        L3 = Ki.shape[-1] // 2
        for conn, pair, sl in ((ifs.connA, ifs.pairA, slice(0, L3)),
                               (ifs.connB, ifs.pairB, slice(L3, 2 * L3))):
            lif = (conn[..., :, None] * 3
                   + jnp.arange(3, dtype=conn.dtype)).reshape(
                conn.shape[0], conn.shape[1], -1)  # (I, Nq, 3L)
            Kq = Ki[..., sl, sl]
            Kb = Kb.at[pair[:, None, None, None],
                       lif[..., :, None], lif[..., None, :]].add(Kq)

    free = data.free.reshape(P, n)
    Kb = Kb * free[:, :, None] * free[:, None, :]
    Kb = Kb + jax.vmap(jnp.diag)(1.0 - free)
    dsc = jax.lax.rsqrt(jnp.abs(jax.vmap(jnp.diagonal)(Kb)) + 1e-300)
    Keq = Kb * dsc[:, :, None] * dsc[:, None, :]
    lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(Keq.astype(jnp.float32))
    return lu, piv, dsc


class PairSchwarz:
    """Overlapping additive Schwarz over INTERFACE PAIRS.

    Block-Jacobi fails on penalty-coupled patches: the stiffest entries
    of K are the inter-patch penalty blocks, which live OFF the patch
    diagonal. Each Schwarz subdomain here is the coupled 2-patch system
    of one interface — its (6C, 6C) block contains both patches'
    element stiffness, the FULL penalty block of its own interface, and
    the self-quadrants of every other interface touching either patch.
    Application is MULTIPLICATIVE over edge-colors of the patch graph
    (parallel within a color — disjoint patches — sequential across
    colors, updating the residual with one tangent matvec per color).
    Additive overlap damping does NOT work here: each pair solve
    individually satisfies its own penalty constraint, and summing
    overlapping solutions violates neighbouring interfaces' penalties,
    amplifying errors by the penalty scale (~1e7). Multiplicative sweeps
    fix each constraint in turn.

    The subdomain STRUCTURE (pair lists, edge coloring) is static and
    precomputed on the host; `assemble` and `apply` are jit-compatible
    and batched per color (vmapped f32 LU).
    """

    def __init__(self, data: SystemData):
        import numpy as np

        assert data.ifs is not None and data.ifs.n_interfaces > 0
        self.P = data.stack.n_patches
        self.C = data.stack.max_cp
        self.pairA = np.asarray(data.ifs.pairA)
        self.pairB = np.asarray(data.ifs.pairB)
        self.I = len(self.pairA)
        count = np.zeros(self.P, dtype=np.int64)
        for a, b in zip(self.pairA, self.pairB):
            count[a] += 1
            count[b] += 1
        self.count = count
        self.iso = np.nonzero(count == 0)[0]  # isolated patches
        # per interface i: other interfaces whose A/B side touches
        # side A (patch pairA[i]) or side B
        self.extra = []  # list of (j, src_side, dst_side)
        for i in range(self.I):
            lst = []
            for j in range(self.I):
                if j == i:
                    continue
                for src, pj in (("A", self.pairA[j]), ("B", self.pairB[j])):
                    if pj == self.pairA[i]:
                        lst.append((j, src, 0))
                    if pj == self.pairB[i]:
                        lst.append((j, src, 1))
            self.extra.append(lst)
        # greedy edge coloring: interfaces in one color touch disjoint
        # patch sets, so their pair solves compose without overlap
        colors: list[list[int]] = []
        for i in range(self.I):
            placed = False
            for col in colors:
                pats = {int(self.pairA[j]) for j in col} | \
                       {int(self.pairB[j]) for j in col}
                if int(self.pairA[i]) not in pats and \
                        int(self.pairB[i]) not in pats:
                    col.append(i)
                    placed = True
                    break
            if not placed:
                colors.append([i])
        self.colors = [np.asarray(c, dtype=np.int64) for c in colors]

    def assemble(self, data: SystemData, d, cp, h):
        from goldfish_jax.physics.coupling import interface_hessians

        stack = data.stack
        P, C = self.P, self.C
        n = 3 * C
        Ke = kl_shell.element_hessians(stack, d, cp, h, data.E, data.nu,
                                   pressure=data.pressure)
        li = (stack.conn[..., :, None] * 3
              + jnp.arange(3, dtype=stack.conn.dtype)).reshape(
            P, Ke.shape[1], -1)

        def scatter_patch(Kp, lip):
            Kblk = jnp.zeros((n, n), dtype=Kp.dtype)
            return Kblk.at[lip[..., :, None], lip[..., None, :]].add(Kp)

        Kp = jax.vmap(scatter_patch)(Ke, li)      # (P, 3C, 3C)
        ifs = data.ifs
        Ki = interface_hessians(ifs, d, cp, h, data.E)  # (I, Nq, 6L, 6L)
        L3 = Ki.shape[-1] // 2

        def iface_local(conn):
            return (conn[..., :, None] * 3
                    + jnp.arange(3, dtype=conn.dtype)).reshape(
                conn.shape[0], conn.shape[1], -1)  # (I, Nq, 3L)

        liA, liB = iface_local(ifs.connA), iface_local(ifs.connB)

        def self_quadrant(Kq, lif):
            """(Nq, 3L, 3L) + (Nq, 3L) -> (3C, 3C)."""
            Kblk = jnp.zeros((n, n), dtype=Kq.dtype)
            return Kblk.at[lif[..., :, None], lif[..., None, :]].add(Kq)

        QAA = jax.vmap(self_quadrant)(Ki[..., :L3, :L3], liA)  # (I,3C,3C)
        QBB = jax.vmap(self_quadrant)(Ki[..., L3:, L3:], liB)

        def cross_block(KAB, lifA, lifB):
            Kblk = jnp.zeros((n, n), dtype=KAB.dtype)
            return Kblk.at[lifA[..., :, None], lifB[..., None, :]].add(KAB)

        QAB = jax.vmap(cross_block)(Ki[..., :L3, L3:], liA, liB)

        blocks = []
        for i in range(self.I):
            a, b = int(self.pairA[i]), int(self.pairB[i])
            KA = Kp[a] + QAA[i]
            KB = Kp[b] + QBB[i]
            for (j, src, dst) in self.extra[i]:
                Q = QAA[j] if src == "A" else QBB[j]
                if dst == 0:
                    KA = KA + Q
                else:
                    KB = KB + Q
            top = jnp.concatenate([KA, QAB[i]], axis=1)
            bot = jnp.concatenate([QAB[i].T, KB], axis=1)
            Kpair = jnp.concatenate([top, bot], axis=0)
            fa = data.free[a].reshape(-1)
            fb = data.free[b].reshape(-1)
            f = jnp.concatenate([fa, fb])
            Kpair = Kpair * f[:, None] * f[None, :] + jnp.diag(1.0 - f)
            blocks.append(Kpair)
        Kpairs = jnp.stack(blocks)  # (I, 6C, 6C)
        # symmetric Jacobi equilibration before the f32 factorization:
        # penalty-anchored pair blocks reach cond ~ 1e12 (entries 1e12
        # against the identity rows of fixed dofs); without scaling the
        # f32 LU solve is meaningless
        dsc = jax.lax.rsqrt(jnp.abs(
            jax.vmap(jnp.diagonal)(Kpairs)) + 1e-300)  # (I, 6C)
        Keq = Kpairs * dsc[:, :, None] * dsc[:, None, :]
        lu, piv = jax.vmap(jax.scipy.linalg.lu_factor)(
            Keq.astype(jnp.float32))

        iso = None
        if len(self.iso):
            Kiso = []
            for p in self.iso:
                f = data.free[int(p)].reshape(-1)
                Kb = Kp[int(p)] * f[:, None] * f[None, :] + jnp.diag(1.0 - f)
                Kiso.append(Kb)
            Kiso = jnp.stack(Kiso)
            dsi = jax.lax.rsqrt(jnp.abs(
                jax.vmap(jnp.diagonal)(Kiso)) + 1e-300)
            Kieq = Kiso * dsi[:, :, None] * dsi[:, None, :]
            lui, pivi = jax.vmap(jax.scipy.linalg.lu_factor)(
                Kieq.astype(jnp.float32))
            iso = (lui, pivi, dsi)
        return (lu, piv, dsc, iso)

    def apply(self, fac, r, matvec):
        """r: (P, C, 3) -> M^{-1} r: multiplicative sweep over colors
        (one tangent `matvec` between colors), equilibrated f32 pair
        solves within each color."""
        lu, piv, dsc, iso = fac
        P, C = self.P, self.C
        n = 3 * C
        rf0 = r.reshape(P, n)
        z = jnp.zeros_like(rf0)
        if iso is not None:
            lui, pivi, dsi = iso
            riso = rf0[jnp.asarray(self.iso)]
            rsi = (dsi.astype(r.dtype) * riso).astype(jnp.float32)
            zi = jax.vmap(jax.scipy.linalg.lu_solve)((lui, pivi), rsi)
            z = z.at[jnp.asarray(self.iso)].set(
                dsi.astype(r.dtype) * zi.astype(r.dtype))
        rc = rf0
        for c, col in enumerate(self.colors):
            ia = jnp.asarray(self.pairA[col])
            ib = jnp.asarray(self.pairB[col])
            dsc_c = dsc[jnp.asarray(col)].astype(r.dtype)
            rloc = jnp.concatenate([rc[ia], rc[ib]], axis=1)  # (nc, 6C)
            rs = (dsc_c * rloc).astype(jnp.float32)
            y = jax.vmap(jax.scipy.linalg.lu_solve)(
                (lu[jnp.asarray(col)], piv[jnp.asarray(col)]), rs)
            y = dsc_c * y.astype(r.dtype)
            z = z.at[ia].add(y[:, :n]).at[ib].add(y[:, n:])
            if c + 1 < len(self.colors):
                rc = rf0 - matvec(z.reshape(r.shape)).reshape(P, n)
        return z.reshape(r.shape)


def _apply_precond(precond, r):
    """r: (P, C, 3) -> M^{-1} r via the batched equilibrated patch LU."""
    lu, piv, dsc = precond
    P = r.shape[0]
    rl = (dsc.astype(r.dtype) * r.reshape(P, -1)).astype(jnp.float32)
    z = jax.vmap(jax.scipy.linalg.lu_solve)((lu, piv), rl)
    return (dsc.astype(r.dtype) * z.astype(r.dtype)).reshape(r.shape)


def gmres_solve(data: SystemData, d, cp, h, b, precond, rtol=1e-10,
                restart=32, maxiter=20, n_ir=3):
    """Preconditioned GMRES on K x = b (shapes (P, C, 3)) with OUTER
    iterative refinement: the f32 preconditioner noise floors a single
    GMRES call near ~1e-7 relative; restarting from the exact f64
    residual (r = b - Kx) recovers full f64 accuracy.

    `precond` is either a patch-block factorization or a
    (PairSchwarz, factorization) tuple. Trace-compatible (call from
    inside jit)."""

    def Aop(v):
        return tangent_matvec(data, d, cp, h, v)

    if isinstance(precond, tuple) and isinstance(precond[0], PairSchwarz):
        ps, fac = precond
        Mop = lambda r: ps.apply(fac, r, Aop)
    elif isinstance(precond, tuple) and precond[0] == "full":
        lu, piv, dsc = precond[1]

        def Mop(r):
            rf = (dsc.astype(r.dtype)
                  * r.reshape(-1)).astype(jnp.float32)
            z = jax.scipy.linalg.lu_solve((lu, piv), rf)
            return (dsc.astype(r.dtype) * z.astype(r.dtype)).reshape(r.shape)
    else:
        Mop = lambda r: _apply_precond(precond, r)

    x = jnp.zeros_like(b)
    r = b
    for _ in range(n_ir):
        dx, _ = jax.scipy.sparse.linalg.gmres(
            Aop, r, tol=rtol, atol=0.0, restart=restart, maxiter=maxiter,
            M=Mop, solve_method="batched")
        x = x + dx
        r = b - Aop(x)
    return x, jnp.int32(0)


@partial(jax.jit, static_argnames=("max_newton", "max_cg", "schwarz"))
def newton_krylov_solve(data: SystemData, cp, h, d0, rtol=1e-8,
                        cg_rtol=1e-6, max_newton=30, max_cg=500,
                        schwarz: "PairSchwarz | None" = None):
    """Matrix-free damped Newton-Krylov (large-model forward solve).

    Same globalization/stagnation logic as solver/implicit.newton_solve
    but with GMRES directions; the preconditioner (pair-Schwarz when
    `schwarz` is given, else patch-block Jacobi) refreshes every
    iteration.
    """
    from goldfish_jax.solver.system import residual, total_potential

    r_ref = jnp.linalg.norm(residual(data, jnp.zeros_like(d0), cp, h))
    r0n = jnp.linalg.norm(residual(data, d0, cp, h))
    r_ref = jnp.maximum(jnp.maximum(r_ref, r0n * 1e-6), 1e-300)
    eps = jnp.finfo(d0.dtype).eps

    def cond(state):
        d, it, rn, done = state
        return (it < max_newton) & (~done) & (rn > rtol * r_ref)

    def body(state):
        d, it, _, _ = state
        r = residual(data, d, cp, h)
        rn0 = jnp.linalg.norm(r)
        if schwarz is not None:
            precond = (schwarz, schwarz.assemble(data, d, cp, h))
        else:
            precond = full_f32_precond(data, d, cp, h)
        delta, _ = gmres_solve(data, d, cp, h, -r, precond, rtol=cg_rtol,
                               restart=32, maxiter=max_cg // 32 + 1)
        delta = delta * data.free
        Pi0 = total_potential(data, d, cp, h)
        slope = jnp.sum(r * delta)
        done = jnp.abs(slope) <= 4.0 * eps * jnp.abs(Pi0) + 1e-300

        def ls_cond(s):
            alpha, j = s
            d_try = d + alpha * delta
            pi_ok = total_potential(data, d_try, cp, h) <= (
                Pi0 + 1e-4 * alpha * slope + 16 * eps * jnp.abs(Pi0))
            # SVK energy is NOT convex far from equilibrium: a full
            # step can LOWER Pi while |r| explodes into a crumpled
            # state where the next GMRES direction degenerates — also
            # require the residual not to blow up
            rn_ok = jnp.linalg.norm(residual(data, d_try, cp, h)) <= \
                4.0 * jnp.maximum(rn0, r_ref)
            return jnp.logical_not(pi_ok & rn_ok) & (j < 30) \
                & jnp.logical_not(done)

        alpha, _ = jax.lax.while_loop(
            ls_cond, lambda s: (0.5 * s[0], s[1] + 1),
            (jnp.asarray(1.0, dtype=d0.dtype), jnp.int32(0)))
        d = d + alpha * delta
        rn = jnp.linalg.norm(residual(data, d, cp, h))
        return d, it + 1, rn, done

    d, it, rn, _ = jax.lax.while_loop(
        cond, body, (d0, jnp.int32(0), r0n, jnp.asarray(False)))
    return d, it, rn


def build_solve_fn_krylov(data: SystemData, rtol=1e-9, cg_rtol=1e-8,
                          max_newton=30, max_cg=500):
    """Differentiable MATRIX-FREE solve(cp, h, d0) -> d for
    pegasus-class models: Newton-Krylov forward (colored multiplicative
    pair-Schwarz preconditioner), GMRES-IR adjoint — no dense (N, N)
    tangent is ever materialized (the reference's MUMPS role at this
    scale is distributed PETSc; reference:
    demos_om/thickness_opt/pegasus/pegasus_var_th_opt_wint.py:203-206).
    """
    from goldfish_jax.solver.system import residual

    schwarz = PairSchwarz(data)

    @jax.custom_vjp
    def solve(cp, h, d0):
        d, _, _ = newton_krylov_solve(data, cp, h, d0, rtol=rtol,
                                      cg_rtol=cg_rtol,
                                      max_newton=max_newton,
                                      max_cg=max_cg, schwarz=schwarz)
        return d

    def fwd(cp, h, d0):
        d = solve(cp, h, d0)
        return d, (d, cp, h)

    def bwd(res, g):
        d, cp, h = res
        fac = schwarz.assemble(data, d, cp, h)
        lam, _ = gmres_solve(data, d, cp, h, g * data.free,
                             (schwarz, fac), rtol=cg_rtol, restart=32,
                             maxiter=max_cg // 32 + 1)
        lam = lam * data.free
        _, vjp = jax.vjp(lambda cp_, h_: residual(data, d, cp_, h_),
                         cp, h)
        dcp, dh = vjp(-lam)
        return dcp, dh, jnp.zeros_like(d)

    solve.defvjp(fwd, bwd)
    return solve
