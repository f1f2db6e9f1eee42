"""Non-matching system with MOVING intersections (shape optimization).

The reference's moving-intersection pipeline (SURVEY.md section 3.2):
CPIGA2XiComp (implicit CP -> xi) feeding DispMintStatesComp (implicit
displacement with xi input, mortar meshes rebuilt every update,
dRIGA/dxi hand-derived). Here:

    xi  = CPIGA2Xi.solve(cp)                  [custom_vjp implicit map]
    d   = solve_mi(cp, h, xi, d0)             [custom_vjp Newton solve]
    J   = objective(d, cp, h)

and jax.grad composes the two implicit-function adjoints — the chain
rule the reference wires manually across OpenMDAO components.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from goldfish_jax.geometry.cpiga2xi import CPIGA2Xi
from goldfish_jax.physics import kl_shell
from goldfish_jax.physics.coupling_mi import (
    build_mi_coupling,
    interface_hessians_mi,
    penalty_energy_mi,
)
from goldfish_jax.physics.loads import external_work
from goldfish_jax.solver.linalg import linear_solve, refined_solve
from goldfish_jax.solver.system import (
    NonMatchingSystem,
    SystemData,
    element_global_dofs,
)

__all__ = ["MINonMatchingSystem", "total_potential_mi", "residual_mi",
           "assemble_K_mi", "newton_solve_mi", "newton_solve_mi_host",
           "adjoint_solve_mi", "build_solve_fn_mi"]


def total_potential_mi(data: SystemData, mi, co, ss, p, q, d, cp, h, xi):
    from goldfish_jax.physics.contact import contact_energy

    W = kl_shell.internal_energy(data.stack, d, cp, h, data.E, data.nu)
    W = W + penalty_energy_mi(ss, p, q, mi, co, xi, d, cp, h, data.E)
    W = W + contact_energy(data.contact, data.stack, d, cp)
    W = W - external_work(data.stack, d, cp, data.f_areal,
                          data.point_loads, data.pressure, data.edge_loads,
                          data.f_field)
    return W


def residual_mi(data, mi, co, ss, p, q, d, cp, h, xi):
    r = jax.grad(total_potential_mi, argnums=6)(
        data, mi, co, ss, p, q, d, cp, h, xi)
    return r * data.free


def _gii_from_conn(mi, connA, connB, C):
    """Global dofs (I, N, 6L) of the stacked [A; B] locals per
    (intersection, point) from the traced conn arrays."""
    L = connA.shape[-1]

    def side(conn, pair):
        base = (pair[:, None, None] * C + conn) * 3
        return (base[..., None]
                + jnp.arange(3, dtype=base.dtype)).reshape(
                    conn.shape[0], conn.shape[1], 3 * L)

    return jnp.concatenate(
        [side(connA, mi.pairA), side(connB, mi.pairB)], axis=-1)


def assemble_K_mi(data, mi, co, ss, p, q, d, cp, h, xi):
    """Dense BC-reduced tangent: element blocks (shared with the static
    path) + moving-interface blocks scattered via the traced conn."""
    stack = data.stack
    P, C = stack.n_patches, stack.max_cp
    N = P * C * 3
    Ke = kl_shell.element_hessians(stack, d, cp, h, data.E, data.nu,
                                   pressure=data.pressure)
    gi = element_global_dofs(stack)
    K = jnp.zeros((N, N), dtype=Ke.dtype)
    K = K.at[gi[..., :, None], gi[..., None, :]].add(Ke)

    Ki, connA, connB = interface_hessians_mi(
        ss, p, q, mi, co, xi, d, cp, h, data.E)
    # global dofs of stacked [A; B] locals per (interface, point)
    gii = _gii_from_conn(mi, connA, connB, C)
    K = K.at[gii[..., :, None], gii[..., None, :]].add(Ki)

    if data.contact is not None:
        from goldfish_jax.physics.contact import contact_hessians

        C3 = C * 3
        Hc = contact_hessians(data.contact, stack, d, cp)
        for k in range(int(data.contact.pa.shape[0])):
            a0 = data.contact.pa[k] * C3
            b0 = data.contact.pb[k] * C3
            for (r0, c0, blk) in ((a0, a0, Hc[k, :C3, :C3]),
                                  (a0, b0, Hc[k, :C3, C3:]),
                                  (b0, a0, Hc[k, C3:, :C3]),
                                  (b0, b0, Hc[k, C3:, C3:])):
                K = jax.lax.dynamic_update_slice(
                    K, jax.lax.dynamic_slice(K, (r0, c0), (C3, C3))
                    + blk, (r0, c0))

    free = data.free.reshape(-1)
    K = K * free[:, None] * free[None, :]
    K = K + jnp.diag(1.0 - free)
    return K


@partial(jax.jit, static_argnames=("p", "q", "max_it"))
def newton_solve_mi(data, mi, co, ss, p, q, cp, h, xi, d0, rtol=1e-10,
                    atol=1e-14, max_it=30):
    """Damped Newton at fixed xi (mirror of solver/implicit.newton_solve;
    see its docstring for the globalization/stagnation logic)."""
    Pi = lambda d_: total_potential_mi(data, mi, co, ss, p, q, d_, cp, h, xi)
    res = lambda d_: residual_mi(data, mi, co, ss, p, q, d_, cp, h, xi)

    r_ref = jnp.linalg.norm(res(jnp.zeros_like(d0)))
    r0n = jnp.linalg.norm(res(d0))
    r_ref = jnp.maximum(jnp.maximum(r_ref, r0n * 1e-6), 1e-300)
    eps = jnp.finfo(d0.dtype).eps

    # see solver/implicit.py: directions always go through linear_solve
    # (GMRES-IR on the mixed path) — raw f32 factorization directions
    # are noise at shell-tangent conditioning
    def direction(d, r):
        K = assemble_K_mi(data, mi, co, ss, p, q, d, cp, h, xi)
        return linear_solve(K, -r.reshape(-1)).reshape(r.shape)

    def cond(state):
        d, it, rnorm, done, best, stall = state
        return (it < max_it) & (~done) & (rnorm > atol) & (rnorm > rtol * r_ref)

    def body(state):
        d, it, rn_prev, _, best, stall = state
        r = res(d)
        delta = direction(d, r) * data.free
        Pi0 = Pi(d)
        slope = jnp.sum(r * delta)
        # see solver/implicit.newton_solve: on stiff systems the slope
        # underflows the energy resolution while |r| still contracts —
        # "done" also requires residual stagnation
        slope_tiny = jnp.abs(slope) <= 4.0 * eps * jnp.abs(Pi0) + 1e-300

        def ls_cond(s):
            alpha, j = s
            ok = Pi(d + alpha * delta) <= (
                Pi0 + 1e-4 * alpha * slope + 16 * eps * jnp.abs(Pi0))
            return jnp.logical_not(ok) & (j < 30) \
                & jnp.logical_not(slope_tiny)

        alpha, _ = jax.lax.while_loop(
            ls_cond, lambda s: (0.5 * s[0], s[1] + 1),
            (jnp.asarray(1.0, dtype=d0.dtype), jnp.int32(0)))
        d = d + alpha * delta
        rnew = jnp.linalg.norm(res(d))
        res_stalled = rnew > 0.5 * rn_prev
        # stagnation guard (see solver/implicit.py): stall only when
        # BOTH energy and residual stopped improving
        Pi_new = Pi(d)
        no_progress = (Pi_new >= Pi0 - 64 * eps * jnp.abs(Pi0)) \
            & res_stalled
        stall = jnp.where(no_progress, stall + 1, jnp.int32(0))
        best = jnp.minimum(best, rnew)
        done = (slope_tiny & res_stalled) | (stall >= 3)
        return d, it + 1, rnew, done, best, stall

    d, it, rn, *_ = jax.lax.while_loop(
        cond, body,
        (d0, jnp.int32(0), r0n, jnp.asarray(False), r0n, jnp.int32(0)))
    return d, it, rn


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_residual_mi(data, mi, co, ss, p, q, cp, h, xi, d):
    return residual_mi(data, mi, co, ss, p, q, d, cp, h, xi)


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_potential_mi(data, mi, co, ss, p, q, cp, h, xi, d):
    return total_potential_mi(data, mi, co, ss, p, q, d, cp, h, xi)


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_res_pot_mi(data, mi, co, ss, p, q, cp, h, xi, d):
    """residual + |r| + potential in ONE program (one readback per
    Newton iteration instead of three; mirror of
    implicit._jit_res_pot)."""
    r = residual_mi(data, mi, co, ss, p, q, d, cp, h, xi)
    return r, jnp.linalg.norm(r), total_potential_mi(
        data, mi, co, ss, p, q, d, cp, h, xi)


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_K_mi(data, mi, co, ss, p, q, cp, h, xi, d):
    return assemble_K_mi(data, mi, co, ss, p, q, d, cp, h, xi)


@partial(jax.jit, static_argnames=("p", "q", "nb", "n_ir"))
def _jvp_ir_solve_mi(data, mi, co, ss, L, invs, dscale, cp, h, xi, d, b,
                     *, p, q, nb, n_ir):
    """MI variant of devicechol._jvp_ir_solve: fused substitution +
    IR sweeps whose matvec is the exact jvp through residual_mi —
    exact solves against K_mi(d) without fresh assembly, stale-factor
    tolerant, with the in-program convergence certificate."""
    from goldfish_jax.solver.blocked_cholesky import _chol_substitute

    N = dscale.shape[0]
    Np = L.shape[0]

    def subst(r):
        rn = dscale * r.reshape(-1)
        if Np != N:
            rn = jnp.concatenate(
                [rn, jnp.zeros(Np - N, dtype=rn.dtype)])
        y = _chol_substitute(L, invs, rn, nb)
        return (dscale * y[:N]).reshape(b.shape)

    def matvec(v):
        mv = jax.jvp(lambda dd: residual_mi(data, mi, co, ss, p, q, dd,
                                            cp, h, xi),
                     (d,), (v * data.free,))[1]
        return mv * data.free

    x = subst(b)

    def sweep(_, carry):
        x, _ = carry
        r = (b - matvec(x)) * data.free
        dx = subst(r)
        return x + dx, jnp.linalg.norm(dx)

    x, last_dx = jax.lax.fori_loop(0, n_ir, sweep,
                                   (x, jnp.linalg.norm(x)))
    return x, last_dx / (jnp.linalg.norm(x) + 1e-300)


# --- Woodbury seam correction -----------------------------------------
# The MI tangent's xi-sensitivity is concentrated in the interface
# penalty block: a one-design-step xi motion leaves the element blocks
# ~1e-3-stale (benign for IR) but changes the seam rows enough that the
# IR iteration matrix has spectral radius O(0.3-1) along the Newton
# step's direction (measured on hardware AND CPU, /tmp probe round 3) —
# forcing a full refactorization EVERY warm solve (~2.5 s). The fix:
# precondition with P = K_ref + U dKi U^T where U selects the seam dof
# subspace (M ~ a few hundred) and dKi is the CURRENT-minus-ref
# interface Hessian — a Woodbury correction whose per-solve cost is one
# small device program. Substitutions become
#     P^-1 r = s - V (U s),   s = K_ref^-1 r,
# with V = W Cinv dK_m (N, M) prebuilt per solve from W = K_ref^-1 U^T
# (computed once per refactorization by multi-RHS substitution) and the
# capacitance C = I + dK_m U W inverted by f32-inverse + Newton-Schulz
# polish (all matmuls; the capacitance is low-cond). Scatter-free
# throughout: U is a dense one-hot matrix and dK_m assembles by one-hot
# einsum (the repo's matmul-assembly discipline).


@partial(jax.jit, static_argnames=("nb",))
def _wb_basis(L, invs, dscale, Uoh, *, nb):
    """Per-refactorization Woodbury basis: W = K_ref^-1 U^T (N, M) via
    multi-RHS blocked substitution, and G = U W (M, M). One program."""
    from goldfish_jax.solver.blocked_cholesky import _chol_substitute_multi

    N = dscale.shape[0]
    Np = L.shape[0]
    B = dscale[:, None] * Uoh.T
    if Np != N:
        B = jnp.concatenate(
            [B, jnp.zeros((Np - N, B.shape[1]), dtype=B.dtype)])
    Y = _chol_substitute_multi(L, invs, B, nb)
    W = dscale[:, None] * Y[:N]
    return W, Uoh @ W


@partial(jax.jit, static_argnames=("p", "q"))
def _wb_prep(data, mi, co, ss, Ki_ref, gii_ref, urows, W, G, cp, h, xi,
             d, *, p, q):
    """Per-solve Woodbury update: current interface Hessians, compact
    dK_m via one-hot einsums, capacitance inverse (f32 inverse +
    Newton-Schulz polish to f64), and the applied correction
    V = W Cinv dK_m (N, M). Returns (V, in_u): in_u=False means a seam
    point's support escaped the DILATED U subspace since the
    factorization (multi-span xi motion) — the caller must refactor.
    Single-span knot crossings stay inside U (the subspace is dilated
    by one CP index in each direction at snapshot time) and are
    handled exactly: the current and reference penalty blocks scatter
    through their OWN one-hot maps."""
    C = data.stack.max_cp
    Ki, connA, connB = interface_hessians_mi(
        ss, p, q, mi, co, xi, d, cp, h, data.E)
    gii = _gii_from_conn(mi, connA, connB, C)
    # one-hot maps into the compact seam subspace; padded urows slots
    # are -1 (match nothing), fixed dofs are excluded from urows so BC
    # masking is automatic
    oh = (gii[..., :, None] == urows[None, None, None, :]).astype(
        Ki.dtype)
    oh_ref = (gii_ref[..., :, None] == urows[None, None, None, :]
              ).astype(Ki.dtype)
    # every FREE current-support dof must be representable in U
    freeg = jnp.take(data.free.reshape(-1), gii) > 0.5
    in_u = jnp.all((jnp.sum(oh, axis=-1) > 0.5) | ~freeg)
    dKm = jnp.einsum("ikjm,ikjl,ikln->mn", oh, Ki, oh) \
        - jnp.einsum("ikjm,ikjl,ikln->mn", oh_ref, Ki_ref, oh_ref)
    M = urows.shape[0]
    Cm = jnp.eye(M, dtype=Ki.dtype) + dKm @ G
    X = jnp.linalg.inv(Cm.astype(jnp.float32)).astype(Ki.dtype)
    eye = jnp.eye(M, dtype=Ki.dtype)
    for _ in range(3):
        X = X + X @ (eye - Cm @ X)
    V = W @ (X @ dKm)
    return V, in_u


@partial(jax.jit, static_argnames=("p", "q", "nb", "n_ir"))
def _jvp_ir_solve_mi_wb(data, mi, co, ss, L, invs, dscale, Uoh, V, cp,
                        h, xi, d, b, *, p, q, nb, n_ir):
    """_jvp_ir_solve_mi with Woodbury-corrected substitutions: the
    preconditioner tracks the CURRENT seam position, so warm-stale
    factors keep IR contraction at the benign element-staleness level
    instead of diverging along the Newton direction."""
    from goldfish_jax.solver.blocked_cholesky import _chol_substitute

    N = dscale.shape[0]
    Np = L.shape[0]

    def subst(r):
        rn = dscale * r.reshape(-1)
        if Np != N:
            rn = jnp.concatenate(
                [rn, jnp.zeros(Np - N, dtype=rn.dtype)])
        y = _chol_substitute(L, invs, rn, nb)
        s = dscale * y[:N]
        s = s - V @ (Uoh @ s)
        return s.reshape(b.shape)

    def matvec(v):
        mv = jax.jvp(lambda dd: residual_mi(data, mi, co, ss, p, q, dd,
                                            cp, h, xi),
                     (d,), (v * data.free,))[1]
        return mv * data.free

    x = subst(b)

    def sweep(_, carry):
        x, _ = carry
        r = (b - matvec(x)) * data.free
        dx = subst(r)
        return x + dx, jnp.linalg.norm(dx)

    x, last_dx = jax.lax.fori_loop(0, n_ir, sweep,
                                   (x, jnp.linalg.norm(x)))
    return x, last_dx / (jnp.linalg.norm(x) + 1e-300)


@partial(jax.jit, static_argnames=("p", "q", "nb", "n_ir"))
def _jvp_ir_solve_mi_wb_seeded(data, mi, co, ss, L, invs, dscale, Uoh,
                               V, cp, h, xi, d, b, x0, *, p, q, nb,
                               n_ir):
    """Seeded `_jvp_ir_solve_mi_wb` (see devicechol's seeded variant):
    starts from x0 (the secant-extrapolated previous adjoint), skipping
    the substitution-from-b and one sweep. A bad seed only fails the
    certificate — the caller falls back to the unseeded program."""
    from goldfish_jax.solver.blocked_cholesky import _chol_substitute

    N = dscale.shape[0]
    Np = L.shape[0]

    def subst(r):
        rn = dscale * r.reshape(-1)
        if Np != N:
            rn = jnp.concatenate(
                [rn, jnp.zeros(Np - N, dtype=rn.dtype)])
        y = _chol_substitute(L, invs, rn, nb)
        s = dscale * y[:N]
        s = s - V @ (Uoh @ s)
        return s.reshape(b.shape)

    def matvec(v):
        mv = jax.jvp(lambda dd: residual_mi(data, mi, co, ss, p, q, dd,
                                            cp, h, xi),
                     (d,), (v * data.free,))[1]
        return mv * data.free

    def sweep(_, carry):
        x, _ = carry
        r = (b - matvec(x)) * data.free
        dx = subst(r)
        return x + dx, jnp.linalg.norm(dx)

    x, last_dx = jax.lax.fori_loop(0, n_ir, sweep,
                                   (x0, jnp.linalg.norm(x0)))
    return x, last_dx / (jnp.linalg.norm(x) + 1e-300)


@partial(jax.jit, static_argnames=("p", "q", "nb", "n_ir"))
def _jit_dir_mi_wb(data, mi, co, ss, L, invs, dscale, Uoh, V, cp, h,
                   xi, d, r, *, p, q, nb, n_ir):
    """Woodbury-corrected fused Newton direction: jvp-IR solve +
    certificate + Armijo slope in ONE program (one readback instead
    of three: solve, mask, slope)."""
    x, ratio = _jvp_ir_solve_mi_wb.__wrapped__(
        data, mi, co, ss, L, invs, dscale, Uoh, V, cp, h, xi, d, -r,
        p=p, q=q, nb=nb, n_ir=n_ir)
    delta = x * data.free
    return delta, ratio, jnp.sum(r * delta)


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_Ki_gii(data, mi, co, ss, cp, h, xi, d, *, p, q):
    """Interface Hessians + their global dofs at one state (the
    Woodbury reference snapshot)."""
    Ki, connA, connB = interface_hessians_mi(
        ss, p, q, mi, co, xi, d, cp, h, data.E)
    return Ki, _gii_from_conn(mi, connA, connB, data.stack.max_cp)


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_trial_mi(data, mi, co, ss, p, q, cp, h, xi, d, delta, alpha):
    """Line-search trial state in ONE program: d_try, its residual,
    |r|, and potential. When the trial is accepted (the common warm
    case: exact direction, alpha=1) these ARE the next iteration's
    state — no separate res/pot dispatch."""
    d_new = d + alpha * delta
    r = residual_mi(data, mi, co, ss, p, q, d_new, cp, h, xi)
    return d_new, r, jnp.linalg.norm(r), total_potential_mi(
        data, mi, co, ss, p, q, d_new, cp, h, xi)


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_entry_mi(data, mi, co, ss, p, q, cp, h, xi, d0):
    """Newton entry in ONE program: load-scale |r(0)| (the convergence
    reference, CLAUDE.md), r(d0), |r(d0)|, Pi(d0)."""
    r0 = residual_mi(data, mi, co, ss, p, q, jnp.zeros_like(d0), cp, h,
                     xi)
    r = residual_mi(data, mi, co, ss, p, q, d0, cp, h, xi)
    return jnp.linalg.norm(r0), r, jnp.linalg.norm(r), \
        total_potential_mi(data, mi, co, ss, p, q, d0, cp, h, xi)


class PersistentDeviceFactorMI:
    """MI counterpart of devicechol.PersistentDeviceFactor: one
    amortized on-device f64 factorization of the MI tangent, inexact
    substitution directions, self-validating jvp-IR exact solves with
    the same measured-contraction adaptive sweep policy."""

    # Opportunistic-refresh threshold on the MEASURED per-sweep IR
    # contraction. The MI path never refreshes on moderate drift (the
    # Woodbury correction rides xi staleness), so a factor pinned at a
    # bad state — e.g. the last dir-cert refactor of a COLD solve lands
    # on an unconverged mid-Newton iterate, leaving element blocks
    # ~3e-2 d-stale — survives the whole warm loop: certificates still
    # pass, but at rho ~0.26/sweep every direction costs n=6 and every
    # adjoint n=16 jvp sweeps (fresh-grade is n=2). Above this rho,
    # solve entries force ONE refactorization at the current
    # (converged-warm) state instead of paying extra sweeps EVERY
    # iteration. 0.1, not lower:
    # a FRESH factor legitimately measures rho ~0.07 when the design
    # steps are 1e-2-sized (within-solve d-motion, not factor quality
    # — measured in tests/test_pipeline_fallback.py) and refreshing on
    # that would thrash; 0.1 also kept n_for(1e-6, rho) on the <=8
    # side of the old sweep menu's 8 -> 16 jump. Round-5: raised to
    # 0.2 — the rho measured from a PASSING cert is tol-BIASED toward
    # tol^(1/n) (see devicechol.rho_refresh), which parks healthy
    # post-step factors at 0.15-0.18 and fired a refactorization on
    # the first adjoint after every accepted optimizer step; 0.2 stays
    # below the measured 0.26 pinned-bad population, and the menu's 12
    # entry now covers n_for(1e-6, 0.2) = 12 without the 16 jump.
    rho_refresh = 0.2

    def __init__(self, data, mi, co, ss, p, q, nb=256, mb=16,
                 stale_tol=5e-3, n_ir=3):
        from goldfish_jax.solver.devicechol import PersistentDeviceFactor
        from goldfish_jax.solver.blocked_cholesky import DeviceCholesky

        self.args = (data, mi, co, ss)
        self.p, self.q = p, q
        self.data = data
        self.dc = DeviceCholesky(nb=nb, mb=mb)
        self.stale_tol = stale_tol
        self.n_ir = n_ir
        self.rho_est = PersistentDeviceFactor._RHO0
        self._ref = None
        self.n_factor = 0
        self.last_ratio = 0.0
        self.nonconverged = False
        self.refactor_log = []
        self.cert_log = []   # (tag, n_ir, ratio) per IR attempt
        # Woodbury seam-correction state (see the kernel block above):
        # compact seam dof subspace + per-refactor basis + per-solve V
        self._M = None        # padded seam-subspace size
        self._urows = None    # (M,) global dofs, -1 padding
        self._Uoh = None      # (M, N) one-hot selector
        self._Ki_ref = None   # interface Hessians at factor state
        self._gii_ref = None
        self._W = None        # K_ref^-1 U^T
        self._G = None        # U W
        self._V = None        # current applied correction (N, M)
        self._prep_key = None

    # shared measured-contraction IR policy (devicechol)
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor \
        as _P
    _RHO0, _MAX_SWEEPS, _N_MENU = _P._RHO0, _P._MAX_SWEEPS, _P._N_MENU
    _n_for, _rho, finish_ir = _P._n_for, _P._rho, _P.finish_ir
    _rho_meas = _P._rho_meas
    # staticmethod re-wrap: _P._inputs_finite is the unwrapped function
    # here, and a bare assignment would rebind it as an instance method
    # (self would arrive as the first "array")
    _inputs_finite = staticmethod(_P._inputs_finite)
    del _P

    @staticmethod
    @jax.jit
    def _drift_mi(cp, h, xi, d, cp0, h0, xi0, d0):
        """Relative state drift vs the factor reference, ONE device
        scalar (one readback per check instead of two). K_mi depends on xi
        (interface quadrature points move with it): a xi-only design
        perturbation must register as drift too, normalized by xi's
        own scale like the other fields."""
        from goldfish_jax.solver.devicechol import PersistentDeviceFactor

        drift = PersistentDeviceFactor._drift.__wrapped__(
            cp, h, d, cp0, h0, d0)
        dxi = jnp.linalg.norm(xi - xi0) / (jnp.linalg.norm(xi0) + 1e-300)
        return jnp.maximum(drift, dxi)

    def drift_scalar(self, cp, h, xi, d):
        """State drift vs the factor reference as a DEVICE scalar (no
        readback — callers batch the fetch; see devicechol counterpart).
        None when no factor exists yet."""
        if self._ref is None:
            return None
        cp0, h0, d0, xi0 = self._ref
        return self._drift_mi(cp, h, xi, d, cp0, h0, xi0, d0)

    def ensure(self, cp, h, xi, d, force=False, stale_tol=None, why=""):
        """See devicechol.PersistentDeviceFactor.ensure — same loose-
        tol contract for certificate-protected call sites."""
        drift = -1.0
        if self._ref is not None and not force:
            drift = float(self.drift_scalar(cp, h, xi, d))
            tol = self.stale_tol if stale_tol is None else stale_tol
            if drift <= tol:
                return False
        data, mi, co, ss = self.args
        K = _jit_K_mi(data, mi, co, ss, self.p, self.q, cp, h, xi, d)
        self.dc.factor(K)
        self._ref = (cp, h, d, xi)
        self.n_factor += 1
        self.rho_est = self._RHO0
        self.refactor_log.append((why or "drift", drift))
        self._wb_snapshot(cp, h, xi, d, K.dtype)
        return True

    def _wb_snapshot(self, cp, h, xi, d, dtype):
        """Rebuild the Woodbury reference at the fresh factor's state:
        seam dof subspace (DILATED by one CP index in each parametric
        direction so single-span knot crossings of seam points stay
        inside U), K_ref^-1 basis, zero correction."""
        import numpy as np

        data, mi, co, ss = self.args
        Ki, gii = _jit_Ki_gii(data, mi, co, ss, cp, h, xi, d,
                              p=self.p, q=self.q)
        g_host = np.asarray(gii).reshape(-1)
        free = np.asarray(data.free).reshape(-1)
        ur = np.unique(g_host)
        # dilate: include the +-1 CP-index neighborhood (u and v) of
        # every support CP — conn shifts by n_v per u-span crossing
        # and by 1 per v-span crossing
        Cc = int(data.stack.max_cp)
        nv = np.asarray(ss.n_v)
        base, comp = ur // 3, ur % 3
        p_, c_ = base // Cc, base % Cc
        nvp = nv[p_]
        cand = [ur]
        for du in (-1, 0, 1):
            for dv in (-1, 0, 1):
                if du == 0 and dv == 0:
                    continue
                cn = c_ + du * nvp + dv
                ok = (cn >= 0) & (cn < Cc)
                cand.append((((p_ * Cc + cn) * 3 + comp)[ok]))
        ur = np.unique(np.concatenate(cand))
        ur = ur[free[ur] > 0.5]
        m = len(ur)
        if self._M is None or m > self._M:
            self._M = max(256, -(-m // 128) * 128)
        urows = np.full(self._M, -1, dtype=np.int64)
        urows[:m] = ur
        N = free.shape[0]
        Uoh = np.zeros((self._M, N))
        Uoh[np.arange(m), ur] = 1.0
        self._urows = jnp.asarray(urows).astype(gii.dtype)
        self._Uoh = jnp.asarray(Uoh, dtype=dtype)
        self._Ki_ref, self._gii_ref = Ki, gii
        self._W, self._G = _wb_basis(self.dc._L, self.dc._invs,
                                     self.dc._dscale, self._Uoh,
                                     nb=self.dc.nb)
        self._V = jnp.zeros((N, self._M), dtype=dtype)
        self._prep_key = None

    def prepare_async(self, cp, h, xi, d):
        """Dispatch the per-solve Woodbury seam update with NO readback
        (callers batch the `same` fetch with their other scalars):
        returns (V, same_dev, key) to hand to finish_prepare, or None
        when the cached V is already current / no factor exists."""
        key = (cp, xi)
        if (self._prep_key is not None
                and key[0] is self._prep_key[0]
                and key[1] is self._prep_key[1]) or self._ref is None:
            return None
        data, mi, co, ss = self.args
        V, same = _wb_prep(data, mi, co, ss, self._Ki_ref,
                           self._gii_ref, self._urows, self._W,
                           self._G, cp, h, xi, d, p=self.p, q=self.q)
        return V, same, key

    def finish_prepare(self, pend, same, cp, h, xi, d):
        """Commit a prepare_async dispatch given the fetched `same`
        flag. False = a seam point crossed a knot span (its support
        escaped the U subspace) and the factor was rebuilt at the
        current state instead (rare)."""
        V, _, key = pend
        if not same:
            self.ensure(cp, h, xi, d, force=True, why="conn-escape")
            self._prep_key = key
            return False
        self._V = V
        self._prep_key = key
        return True

    def prepare(self, cp, h, xi, d):
        """Per-solve Woodbury update: make the preconditioner track the
        CURRENT seam position (xi staleness is what breaks IR against
        the persistent factor — measured rho O(0.3-1) along the warm
        Newton direction vs ~1e-3 for cp/d staleness). Identity-keyed
        cache holding STRONG references (bare id() can be reused after
        GC and spuriously match a new iterate): a stale V only degrades
        the preconditioner (certificates still guarantee accuracy),
        never correctness."""
        pend = self.prepare_async(cp, h, xi, d)
        if pend is None:
            return
        self.finish_prepare(pend, bool(pend[1]), cp, h, xi, d)

    def direction(self, r):
        return self.dc.solve(r)

    def newton_direction(self, cp, h, xi, d, r, tol=1e-3):
        """Fused IR-exact Newton direction, certificate-validated with
        the measured-contraction policy; returns (delta, slope).
        tol=1e-3 is inexact-Newton forcing — the line search and the
        next residual measure actual progress, only adjoints need the
        1e-6 grade."""
        data, mi, co, ss = self.args
        rho_entry = self.rho_est
        refactored = False
        for attempt in range(5):
            n_ir = self._n_for(tol, self.rho_est)
            delta, ratio, slope = _jit_dir_mi_wb(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, r,
                p=self.p, q=self.q, nb=self.dc.nb, n_ir=n_ir)
            self.last_ratio = float(ratio)
            self.cert_log.append(("dir", n_ir, self.last_ratio))
            if not math.isfinite(self.last_ratio):
                # see devicechol.PersistentDeviceFactor.newton_direction
                if not self._inputs_finite(r, d):
                    self.rho_est = rho_entry
                    return delta, float("nan")
                if refactored:
                    return delta, float("nan")
            if self.last_ratio <= tol:
                self.rho_est = max(self._rho(n_ir), self._RHO0)
                break
            self.rho_est = self._rho(n_ir)
            if not refactored and (self.rho_est > 0.5 or attempt >= 3
                                   or n_ir >= self._MAX_SWEEPS):
                self.ensure(cp, h, xi, d, force=True, why="dir-cert")
                refactored = True
        return delta, float(slope)

    def dir_async(self, cp, h, xi, d, r, tol=1e-3):
        """ONE fused IR-direction dispatch with NO readback: returns
        (delta, ratio_dev, slope_dev, n_used). The caller batch-fetches
        ratio/slope with its trial scalars, then finish_ir(n, ratio,
        tol) — False means fall back to the self-validating
        newton_direction."""
        data, mi, co, ss = self.args
        n_ir = self._n_for(tol, self.rho_est)
        delta, ratio, slope = _jit_dir_mi_wb(
            data, mi, co, ss, self.dc._L, self.dc._invs,
            self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, r,
            p=self.p, q=self.q, nb=self.dc.nb, n_ir=n_ir)
        return delta, ratio, slope, n_ir

    def ir_solve_async(self, cp, h, xi, d, b, x0=None, tol=1e-6,
                       V=None):
        """ONE (seeded) jvp-IR dispatch with NO readback: returns
        (x, ratio_dev, n_used); see devicechol counterpart — the caller
        validates via finish_ir and falls back to exact_solve. `V`
        (optional) overrides the committed Woodbury correction with a
        SPECULATED one from prepare_async (the adjoint pipeline solves
        against the current-xi seam correction before the `same` flag
        has been fetched — a wrong V only fails the certificate)."""
        data, mi, co, ss = self.args
        V = self._V if V is None else V
        if x0 is not None:
            n = self._n_for(tol, self.rho_est, seeded=True)
            x, ratio = _jvp_ir_solve_mi_wb_seeded(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, V, cp, h, xi, d, b,
                x0, p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
        else:
            n = self._n_for(tol, self.rho_est)
            x, ratio = _jvp_ir_solve_mi_wb(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, V, cp, h, xi, d, b,
                p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
        return x, ratio, n

    def preload(self, menu=None):
        """MI counterpart of devicechol.PersistentDeviceFactor.preload:
        force the first-in-process XLA program LOAD of every sweep-menu
        variant of the WB-corrected IR kernels (direction / unseeded /
        seeded) against the current factor, so that no variant
        compiles or first loads inside a timed region. Untimed call after
        the first
        factorization; policy state untouched; one batched readback."""
        if self._ref is None:
            raise RuntimeError("preload needs a factor: call ensure()")
        cp, h, d, xi = self._ref
        data, mi, co, ss = self.args
        b = jnp.asarray(data.free, dtype=cp.dtype)
        outs = []
        for n in (self._N_MENU if menu is None else menu):
            _, r1, _ = _jit_dir_mi_wb(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, b,
                p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
            _, r2 = _jvp_ir_solve_mi_wb(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, b,
                p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
            _, r3 = _jvp_ir_solve_mi_wb_seeded(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, b,
                b * 0.0, p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
            outs += [r1, r2, r3]
        jax.device_get(outs)

    def exact_solve(self, cp, h, xi, d, b, n_ir=None, tol=1e-6,
                    x0=None):
        data, mi, co, ss = self.args
        if x0 is not None:
            n = self._n_for(tol, self.rho_est, seeded=True)
            x, ratio = _jvp_ir_solve_mi_wb_seeded(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, b,
                x0, p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
            r = float(ratio)
            self.cert_log.append(("exact-x0", n, r))
            if r <= tol:
                self.last_ratio = r
                # see devicechol.PersistentDeviceFactor.exact_solve:
                # without this update rho_est stays cold-pessimistic
                # and every seeded solve over-sweeps
                self.rho_est = max(self._rho(n), self._RHO0)
                return x
            # bad seed or stale factor: fall through unseeded
        rho_entry = self.rho_est
        refactored = False
        for attempt in range(5):
            n = self._n_for(tol, self.rho_est) if n_ir is None else n_ir
            x, ratio = _jvp_ir_solve_mi_wb(
                data, mi, co, ss, self.dc._L, self.dc._invs,
                self.dc._dscale, self._Uoh, self._V, cp, h, xi, d, b,
                p=self.p, q=self.q, nb=self.dc.nb, n_ir=n)
            self.last_ratio = float(ratio)
            self.cert_log.append(("exact", n, self.last_ratio))
            if not math.isfinite(self.last_ratio):
                # see devicechol.PersistentDeviceFactor.exact_solve
                if not self._inputs_finite(b, d):
                    self.rho_est = rho_entry
                    return x
                if refactored:
                    break
            if self.last_ratio <= tol:
                self.rho_est = max(self._rho(n), self._RHO0)
                return x
            self.rho_est = self._rho(n)
            n_ir = None  # retries re-size from the measured rho
            if not refactored and (self.rho_est > 0.5 or attempt >= 3
                                   or n >= self._MAX_SWEEPS):
                self.ensure(cp, h, xi, d, force=True, why="exact-cert")
                refactored = True
        # same visibility contract as PersistentDeviceFactor.exact_solve
        self.nonconverged = True
        import warnings

        warnings.warn(
            "PersistentDeviceFactorMI.exact_solve: IR certificate did "
            f"not contract (ratio {self.last_ratio:.3e} > tol {tol:.1e})"
            " even after a fresh factorization — the returned solve may "
            "be inaccurate.", RuntimeWarning, stacklevel=2)
        return x


def newton_solve_mi_host(data, mi, co, ss, p, q, cp, h, xi, d0,
                         rtol=1e-10, atol=1e-14, max_it=30, verbose=False,
                         device_fac=None, shared=None):
    """Host-driven MI Newton for the mixed path: python composition of
    small jitted programs + ONE amortized on-device blocked Cholesky
    (the persistent-factor flow mirrors
    solver/implicit.newton_solve_host).

    `shared` (optional dict) amortizes across SOLVES of a warm
    optimizer loop: "r_ref" caches the load-scale reference |r(0)|
    (an extra full residual program per solve otherwise, while a
    per-iteration design step moves it ~0.1%; refreshed every 32
    solves so the drift cannot compound over a long optimization)."""
    from goldfish_jax.utils.evtrace import trace

    trace("mi_newton.enter")
    if device_fac is None:
        device_fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)

    # ENTRY PIPELINE (every sequential float() readback stalls the
    # host loop): dispatch the entry residual/potential,
    # the factor drift check, and the Woodbury seam update back-to-back
    # and fetch all their scalars in ONE batched readback. Only the
    # same individually-validated programs run — speculation can only
    # waste device work (when the factor turns out grossly stale).
    r_ref_ = None
    if (shared is not None and "r_ref" in shared
            and shared.get("r_ref_age", 0) < 32):
        r_ref = shared["r_ref"]
        shared["r_ref_age"] = shared.get("r_ref_age", 0) + 1
        r, rn_, Pi_ = _jit_res_pot_mi(data, mi, co, ss, p, q, cp, h,
                                      xi, d0)
    else:
        r_ref_, r, rn_, Pi_ = _jit_entry_mi(data, mi, co, ss, p, q, cp,
                                            h, xi, d0)
    drift_ = device_fac.drift_scalar(cp, h, xi, d0)
    pend = device_fac.prepare_async(cp, h, xi, d0) \
        if drift_ is not None else None
    fetch = [rn_, Pi_, r_ref_, drift_, pend[1] if pend else None]
    vals = jax.device_get(tuple(x for x in fetch if x is not None))
    vals = iter(vals)
    rn = float(next(vals))
    Pi0 = float(next(vals))
    if r_ref_ is not None:
        r_ref = float(next(vals))
        if shared is not None:
            shared["r_ref"] = r_ref
            shared["r_ref_age"] = 0
    drift = float(next(vals)) if drift_ is not None else None
    same = bool(next(vals)) if pend is not None else None
    r_ref = max(max(r_ref, rn * 1e-6), 1e-300)
    eps = float(jnp.finfo(d0.dtype).eps)
    trace("mi_newton.entry_readback", rn=rn,
          drift=-1.0 if drift is None else drift)

    d = d0
    stall = 0
    pinned = 0
    it = 0
    refactored_on_stall = False
    # MI directions are IR-EXACT by default: the moving-seam penalty
    # terms make substitution-only directions from a design-stale
    # factor frequently non-descent, and each failed line search burns
    # ~30 potential-eval dispatches before the old
    # policy refactored. One fused jvp-IR direction
    # is the exact Newton direction at the current state —
    # quadratic convergence, alpha = 1 accepted, no refactor (the IR
    # certificate self-refactors only when the factor is truly too
    # stale to precondition). The entry drift check is LOOSE (0.2):
    # it preempts only gross staleness (a cold transient); warm
    # optimizer steps (~1e-3 drift) ride the certificate instead of
    # paying a ~3x-solve-cost refactor every solve. prepare() then
    # refreshes the Woodbury seam correction at the CURRENT xi (xi
    # staleness is the one kind the certificate policy cannot ride:
    # measured IR rho O(0.3-1) along the warm Newton direction).
    # commit the pipelined entry: factor fresh when absent or grossly
    # stale, else adopt the speculated Woodbury seam update
    if drift is None:
        device_fac.ensure(cp, h, xi, d, stale_tol=0.2, why="mi-entry")
        device_fac.prepare(cp, h, xi, d)
    elif drift > 0.2:
        device_fac.ensure(cp, h, xi, d, force=True, why="mi-entry")
        device_fac.prepare(cp, h, xi, d)
    elif (device_fac.rho_est > device_fac.rho_refresh
          and drift > device_fac.stale_tol):
        # the factor is persistently mediocre (measured contraction,
        # not a drift heuristic — see rho_refresh): refresh it HERE,
        # at a converged-warm iterate, rather than paying 3x the jvp
        # sweeps on every direction/adjoint of this and future solves.
        # Also fires at optimizer trial entries — suppressing it there
        # made every trial direction pay MAX_SWEEPS programs
        # (devicechol._rho_entry_refresh docstring, round-4 pegasus
        # measurement)
        device_fac.ensure(cp, h, xi, d, force=True, why="mi-entry-rho")
        device_fac.prepare(cp, h, xi, d)
    elif pend is not None:
        device_fac.finish_prepare(pend, same, cp, h, xi, d)
    while (it < max_it and rn > atol and rn > rtol * r_ref):
        # DIRECTION+TRIAL PIPELINE: dispatch the fused IR direction
        # (certificate + Armijo slope) and the alpha=1 trial
        # back-to-back, then fetch all four scalars in one batched
        # readback — the common warm case (certificate passes, alpha=1
        # accepted) pays ONE readback per Newton iteration.
        # tol=1e-3 is inexact-Newton forcing — with 3 IR sweeps the
        # certificate is ratio ~ rho^3, so a mildly stale factor
        # (rho ~ 0.1) passes at 1e-3 but refactors at the adjoint-grade
        # 1e-6; the line search / next residual measure actual progress
        pre_trial = None
        delta, ratio_, slope_, n_used = device_fac.dir_async(
            cp, h, xi, d, r, tol=1e-3)
        d_try, r_try, rn_try_, Pi_try_ = _jit_trial_mi(
            data, mi, co, ss, p, q, cp, h, xi, d, delta, 1.0)
        ratio, slope, rn_try, Pi_try = (
            float(x) for x in jax.device_get(
                (ratio_, slope_, rn_try_, Pi_try_)))
        trace("mi_newton.dir_readback", it=it, n_ir=n_used, ratio=ratio,
              rn_try=rn_try)
        if device_fac.finish_ir(n_used, ratio, tol=1e-3,
                                tag="dir-pipe"):
            pre_trial = (d_try, r_try, rn_try_, rn_try, Pi_try)
        else:
            # certificate failed (stale factor): the self-validating
            # direction loop re-sizes sweeps / refactors as needed
            delta, slope = device_fac.newton_direction(cp, h, xi, d, r,
                                                       tol=1e-3)
        # see solver/implicit.newton_solve_host: "done" also requires
        # residual stagnation, not just a sub-resolution slope. The
        # 64x-eps margin matters: at |slope| ~ a few eps*|Pi| the
        # Armijo comparison is a coin flip on roundoff noise — a
        # razor-thin threshold let the line search thrash to alpha ~
        # 1e-4 chasing unresolvable energy differences at the
        # residual floor (observed on hardware, warm MI solves).
        slope_tiny = abs(slope) <= 64.0 * eps * abs(Pi0) + 1e-300
        # each trial is ONE fused dispatch producing the full candidate
        # state (d_try, r, |r|, Pi); on acceptance (the common warm
        # case: exact direction, alpha=1) it IS the next iteration's
        # state — no separate res/pot program afterwards
        alpha = 1.0
        ls_fail = False
        rn_try = rn_try if pre_trial is not None else None
        if not math.isfinite(slope):
            # non-finite direction (overflowing jvp at a wild trial
            # point): no alpha fixes NaN*alpha — skip the futile trial
            # dispatches and go straight to the stall refactor (see
            # solver/implicit.newton_solve_host)
            ls_fail = True
            d_try, r_try, rn_try, Pi_try = d, r, rn, Pi0
        # floor-basin bisection cap (see implicit.newton_solve_host):
        # deep in the basin an unacceptable alpha=1 step is roundoff,
        # not a direction problem — 8 bisections bound the trial burn
        n_bisect = 30 if rn > 1e-2 * r_ref else 8
        for j in range(0 if ls_fail else (1 if slope_tiny else n_bisect)):
            if j == 0 and pre_trial is not None:
                d_try, r_try, rn_try_, rn_try, Pi_try = pre_trial
            else:
                d_try, r_try, rn_try_, Pi_try_ = _jit_trial_mi(
                    data, mi, co, ss, p, q, cp, h, xi, d, delta, alpha)
                Pi_try = float(Pi_try_)
                rn_try = None
            if slope_tiny or Pi_try <= (Pi0 + 1e-4 * alpha * slope
                                        + 16 * eps * abs(Pi0)):
                break
            alpha *= 0.5
        else:
            ls_fail = True
        if rn_try is None:
            rn_try = float(rn_try_)
        if ls_fail and rn <= 1e-2 * r_ref and math.isfinite(slope):
            # exhausted IN the basin with a finite certificate-grade
            # direction: this is the residual floor — stop, don't
            # refactor (see implicit.newton_solve_host, round 5)
            break
        if ls_fail and not refactored_on_stall:
            device_fac.ensure(cp, h, xi, d, force=True)
            refactored_on_stall = True
            continue
        if not ls_fail:
            refactored_on_stall = False  # re-arm (see implicit.py)
        if slope_tiny and rn_try >= rn:
            # the sub-resolution full step WORSENED |r|: the step was
            # noise — keep the better current iterate and stop
            break
        rn_prev = rn
        d = d_try
        r = r_try
        rn = rn_try
        Pi_new = Pi_try
        it += 1
        if verbose:
            print(f"  newton(mi,host) it {it}: |r|={rn:.3e} alpha={alpha:g}")
        res_stalled = rn > 0.5 * rn_prev
        # residual PINNED at its floor: see implicit.newton_solve_host
        # — two consecutive accepted iterations with <2% |r| reduction
        # mark the achievable floor above rtol*r_ref; stop instead of
        # burning max_it on no-op steps (pegasus SLSQP episode). Gated
        # to the Newton basin so cold-transient |r| growth under the
        # energy line search is not counted.
        if rn <= 1e-2 * r_ref and rn > 0.98 * rn_prev:
            pinned += 1
            if pinned >= 2:
                break
        else:
            pinned = 0
        if slope_tiny and res_stalled:
            break
        if (Pi_new >= Pi0 - 64 * eps * abs(Pi0)) and res_stalled:
            stall += 1
            if stall >= 3:
                break
        else:
            stall = 0
        Pi0 = Pi_new
    trace("mi_newton.exit", its=it, rn=rn)
    return d, it, rn


@partial(jax.jit, static_argnames=("p", "q"))
def _jit_res_vjp_mi(data, mi, co, ss, p, q, d, cp, h, xi, lam):
    _, vjp = jax.vjp(
        lambda cp_, h_, xi_: residual_mi(
            data, mi, co, ss, p, q, d, cp_, h_, xi_), cp, h, xi)
    return vjp(-lam)


@partial(jax.jit, static_argnames=("p", "q"))
def _adjoint_solve_mi_direct(data, mi, co, ss, p, q, d, cp, h, xi, g):
    # refined against the exact tangent (see implicit._direct_adjoint_lam)
    K = assemble_K_mi(data, mi, co, ss, p, q, d, cp, h, xi)

    def matvec(x):
        v = x.reshape(g.shape) * data.free
        mv = jax.jvp(lambda dd: residual_mi(data, mi, co, ss, p, q, dd,
                                            cp, h, xi), (d,), (v,))[1]
        return (mv * data.free).reshape(-1)

    lam = refined_solve(K, (g * data.free).reshape(-1), matvec)
    lam = lam.reshape(g.shape) * data.free
    return _jit_res_vjp_mi.__wrapped__(data, mi, co, ss, p, q, d, cp, h,
                                       xi, lam)


def adjoint_solve_mi(data, mi, co, ss, p, q, d, cp, h, xi, g,
                     device_fac=None, lam_ws=None):
    """MI adjoint; on the mixed path composed from small programs + the
    amortized persistent device factor with self-validating jvp-IR
    exact solves; on the direct path one jitted f64 LU solve. `lam_ws`
    (optional SecantWarmStart) seeds the IR solve with the
    extrapolated previous adjoint — one fewer jvp sweep when good, a
    certificate-guarded fallback when not."""
    from goldfish_jax.solver.linalg import mode as _mode
    from goldfish_jax.utils.evtrace import trace

    if _mode() == "mixed":
        trace("mi_adjoint.enter")
        fac = device_fac if device_fac is not None \
            else PersistentDeviceFactorMI(data, mi, co, ss, p, q)
        b = g * data.free
        key = x0 = None
        if lam_ws is not None:
            key = jnp.concatenate([cp.ravel(), h.ravel(), xi.ravel(),
                                   g.ravel()])
            x0 = lam_ws.predict(key, None)
        if fac._ref is not None:
            # ADJOINT PIPELINE (see implicit._pipelined_device_adjoint):
            # queue drift check + Woodbury seam update + (seeded) jvp-IR
            # solve against the SPECULATED correction + free-mask + the
            # residual vjp back-to-back; fetch drift/same/ratio in ONE
            # batched readback. Exactness rests only on the in-program
            # certificate — a failed certificate discards the
            # speculated vjp and falls back to the self-validating
            # exact_solve.
            drift_ = fac.drift_scalar(cp, h, xi, d)
            pend = fac.prepare_async(cp, h, xi, d)
            V_spec = pend[0] if pend is not None else None
            x, ratio_, n = fac.ir_solve_async(cp, h, xi, d, b, x0=x0,
                                              V=V_spec)
            lam = x * data.free
            out = _jit_res_vjp_mi(data, mi, co, ss, p, q, d, cp, h, xi,
                                  lam)
            fetch = [drift_, ratio_, pend[1] if pend else None]
            vals = iter(jax.device_get(
                tuple(v for v in fetch if v is not None)))
            drift = float(next(vals))
            ratio = float(next(vals))
            same = bool(next(vals)) if pend is not None else True
            trace("mi_adjoint.pipe_readback", n_ir=n, ratio=ratio,
                  drift=drift)
            ok = fac.finish_ir(n, ratio,
                               tag="exact-x0-pipe" if x0 is not None
                               else "exact-pipe")
            if ok:
                # certificate passed → the solve is exact no matter how
                # good the speculated preconditioner was; commit the
                # seam state (finish_prepare refactors on a seam-
                # support escape so FUTURE solves precondition well)
                if pend is not None:
                    fac.finish_prepare(pend, same, cp, h, xi, d)
                if lam_ws is not None:
                    lam_ws.update(key, lam)
                trace("mi_adjoint.exit", path="pipe")
                return out
            # speculation lost: commit the seam state (refactors on a
            # seam-support escape), refactor on gross staleness OR a
            # measured-mediocre factor (rho_refresh), then revalidate
            # through the self-validating slow path
            if pend is not None:
                fac.finish_prepare(pend, same, cp, h, xi, d)
            if (pend is None or same) and (
                    drift > 0.2 or (fac.rho_est > fac.rho_refresh
                                    and drift > fac.stale_tol)):
                fac.ensure(cp, h, xi, d, force=True, why="mi-adjoint")
                fac.prepare(cp, h, xi, d)
            elif math.isfinite(ratio):
                # MARGINAL certificate miss: seed the revalidating
                # solve with the near-answer — a short top-up instead
                # of a full unseeded redo (see
                # implicit._pipelined_device_adjoint, round 5)
                lam = fac.exact_solve(cp, h, xi, d, b, x0=x) * data.free
                if lam_ws is not None:
                    lam_ws.update(key, lam)
                trace("mi_adjoint.exit", path="topup")
                return _jit_res_vjp_mi(data, mi, co, ss, p, q, d, cp,
                                       h, xi, lam)
        else:
            fac.ensure(cp, h, xi, d, why="mi-adjoint")
            fac.prepare(cp, h, xi, d)
        lam = fac.exact_solve(cp, h, xi, d, b) * data.free
        if lam_ws is not None:
            lam_ws.update(key, lam)
        trace("mi_adjoint.exit", path="slow")
        return _jit_res_vjp_mi(data, mi, co, ss, p, q, d, cp, h, xi, lam)
    return _adjoint_solve_mi_direct(data, mi, co, ss, p, q, d, cp, h,
                                    xi, g)


def build_solve_fn_mi(data, mi, co, ss, p, q, rtol=1e-10, atol=1e-14,
                      max_it=30):
    """Differentiable solve(cp, h, xi, d0) -> d; the adjoint vjps through
    the residual deliver dR/dcp, dR/dh AND dR/dxi (the reference's
    hardest hand-derived matrix, GOLDFISH/nonmatching_opt.py:1042-1341)
    automatically. On the mixed path compose eagerly (see
    solver/implicit.build_solve_fn)."""

    from goldfish_jax.solver.linalg import mode as _mode

    # one persistent device factor shared by forward Newton AND adjoint
    # (amortized across optimizer iterations; solver/devicechol.py)
    pdf = None
    lam_ws = None
    if _mode() == "mixed":
        from goldfish_jax.opt.warmstart import SecantWarmStart

        pdf = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
        lam_ws = SecantWarmStart()
    floor_hint = [atol]
    shared = {}

    @jax.custom_vjp
    def solve(cp, h, xi, d0):
        if _mode() == "mixed":
            d, its, rn = newton_solve_mi_host(
                data, mi, co, ss, p, q, cp, h, xi, d0, rtol=rtol,
                atol=max(atol, floor_hint[0]), max_it=max_it,
                device_fac=pdf, shared=shared)
            if its < max_it:
                floor_hint[0] = max(atol, 1.5 * rn)
            return d
        d, _, _ = newton_solve_mi(data, mi, co, ss, p, q, cp, h, xi, d0,
                                  rtol=rtol, atol=atol, max_it=max_it)
        return d

    def fwd(cp, h, xi, d0):
        d = solve(cp, h, xi, d0)
        return d, (d, cp, h, xi)

    def bwd(resids, g):
        d, cp, h, xi = resids
        dcp, dh, dxi = adjoint_solve_mi(data, mi, co, ss, p, q, d, cp, h,
                                        xi, g, device_fac=pdf,
                                        lam_ws=lam_ws)
        return dcp, dh, dxi, jnp.zeros_like(d)

    solve.defvjp(fwd, bwd)
    # expose the persistent factor (prewarm / diagnostics from drivers)
    solve.device_factor = pdf
    return solve


class MINonMatchingSystem(NonMatchingSystem):
    """Facade: shape optimization with intersections that move with the
    design (reference: NonMatchingOpt.create_diff_intersections +
    CPIGA2Xi + DispMintImOpeartion)."""

    def __init__(self, surfs, E, nu, h_th, specs, n_pts_list=None,
                 penalty_coefficient: float = 1.0e3, nq=None, dtype=None):
        super().__init__(surfs, E, nu, h_th, specs=None, nq=nq, dtype=dtype)
        self.c2x = CPIGA2Xi(surfs, specs, n_pts_list=n_pts_list)
        self.mi = self.c2x.mi
        self.ss = self.c2x.ss
        self.pdeg, self.qdeg = self.c2x.p, self.c2x.q
        self.co = build_mi_coupling(surfs, self.mi, penalty_coefficient,
                                    dtype=self.dtype)

    def build_forward(self, rtol=1e-10, max_it=30):
        """Returns solve_forward(cp, h, d0, xi0=None) -> (d, xi),
        differentiable. Passing the previous iteration's xi as `xi0`
        warm-starts the CP->xi Newton solve (1-2 iterations instead of
        a cold solve per optimizer step)."""
        solve_d = build_solve_fn_mi(self.data, self.mi, self.co, self.ss,
                                    self.pdeg, self.qdeg, rtol=rtol,
                                    max_it=max_it)
        c2x = self.c2x

        def forward(cp, h, d0, xi0=None):
            xi = c2x.solve(cp, xi0)
            d = solve_d(cp, h, xi, d0)
            return d, xi

        return forward

    def solve_nonlinear(self, cp=None, h=None, d0=None, rtol=1e-10,
                        atol=0.0, max_it=30, verbose=False):
        cp = self.cp if cp is None else cp
        h = self.h_init if h is None else h
        d = self.zero_displacement() if d0 is None else d0
        from goldfish_jax.solver.linalg import mode as _mode

        xi = self.c2x.solve(cp)
        solver = newton_solve_mi_host if _mode() == "mixed" \
            else newton_solve_mi
        d, it, rn = solver(
            self.data, self.mi, self.co, self.ss, self.pdeg, self.qdeg,
            cp, h, xi, d, rtol=rtol, atol=atol, max_it=max_it)
        if verbose:
            print(f"  newton(mi): {int(it)} its, |r| = {float(rn):.3e}")
        return d
