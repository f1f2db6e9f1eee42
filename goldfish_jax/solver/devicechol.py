"""Mixed-path f64 direct solver: blocked Cholesky + device IR.

The linear solver of the mixed path (the MUMPS role, reference:
GOLDFISH/utils/opt_utils.py:156-209), for hardware without an f64
factorization; the direct path factors natively instead:

  1. exact dense f64 tangent on device (matmul assembly, validated
     bit-accurate vs the host oracle at bench scale);
  2. blocked f64 Cholesky (solver/blocked_cholesky.py);
  3. fused triangular solves + iterative-refinement sweeps; the
     refinement matvec is either the assembled K or the EXACT
     matrix-free jvp through the residual (also validated bit-accurate),
     so an exact solve never requires a fresh assembly.

A factor that is 1e-3 design-stale refines to the ~2e-6 emulation
floor in 2 sweeps, 1e-2-stale in 4 — so ONE factorization amortizes
across many optimizer iterations (`PersistentDeviceFactor`); only the
refinement matvec must be fresh.
"""

from __future__ import annotations

import os
from functools import partial

import jax
import jax.numpy as jnp

from goldfish_jax.solver.blocks import TangentBlocks
from goldfish_jax.solver.system import SystemData, tangent_matvec
from goldfish_jax.solver.blocked_cholesky import (
    DeviceCholesky,
    _chol_substitute,
)

__all__ = ["enabled", "dense64_from_blocks", "DeviceDirectSolver",
           "PersistentDeviceFactor"]


def enabled() -> bool:
    return os.environ.get("GOLDFISH_DEVICE_CHOL", "1") != "0"


@jax.jit
def dense64_from_blocks(data: SystemData, blocks: TangentBlocks):
    """Exact dense f64 K from the Hessian blocks (emulated-f64 scatter;
    validated bit-accurate against the host assembly at bench scale —
    unlike a hi/lo two-f32 scatter, whose RUNNING-SUM rounding under
    overlapping adds leaves ~eps_f32 errors that break IR at
    cond ~1e12)."""
    from goldfish_jax.solver.system import (
        _interface_global_dofs,
        element_global_dofs,
    )

    stack = data.stack
    P, C = stack.n_patches, stack.max_cp
    N = P * C * 3
    K = jnp.zeros((N, N), dtype=blocks.Ke.dtype)
    gi = element_global_dofs(stack)
    K = K.at[gi[..., :, None], gi[..., None, :]].add(blocks.Ke)
    if blocks.Ki is not None:
        gii = _interface_global_dofs(data.ifs, C)
        K = K.at[gii[..., :, None], gii[..., None, :]].add(blocks.Ki)
    free = data.free.reshape(-1)
    K = K * free[:, None] * free[None, :]
    K = K + jnp.diag(1.0 - free)
    return K


@jax.jit
def _dense_matvec(K, x):
    return K @ x


class DeviceDirectSolver:
    """factor(data, blocks) then solve(b) with fused device IR."""

    def __init__(self, nb: int = 256, mb: int = 16, tol: float = 1e-10,
                 max_ir: int = 3):
        self.dc = DeviceCholesky(nb=nb, mb=mb)
        self.tol = tol
        self.max_ir = max_ir
        self._K = None

    def factor(self, data: SystemData, blocks: TangentBlocks):
        return self.factor_from_K(dense64_from_blocks(data, blocks))

    def factor_from_K(self, K):
        self._K = K
        self.dc.factor(K)
        return self

    def update_K(self, K):
        """Refresh the IR matrix WITHOUT refactoring: sweeps then
        refine against the newer tangent. With the FUSED
        substitution+IR program and an exact refinement matvec, stale
        factors refine fine (dh/h = 1e-3 reaches the ~2e-6 floor in 2
        sweeps, 1e-2 in 4) — the convergence certificate /
        refactor logic in PersistentDeviceFactor handles the rest."""
        self._K = K
        return self

    def solve(self, b, n_ir=None):
        """Substitution + fixed IR sweeps, fused into ONE device
        program (the one-shot emulated-f64 residual is ~5e-5 and each
        sweep multiplies it down deterministically)."""
        n_ir = self.max_ir if n_ir is None else n_ir
        if n_ir == 0:
            return self.dc.solve(b)
        return self.dc.solve_ir(self._K, b, n_ir=n_ir)


@partial(jax.jit, static_argnames=("nb", "n_ir"))
def _jvp_ir_solve(data: SystemData, L, invs, dscale, cp, h, d, b,
                  nb: int, n_ir: int):
    """Substitution + n_ir refinement sweeps whose matvec is the EXACT
    matrix-free tangent (jvp through the residual at d) — one program.
    Solves K(d) x = b with NO dense assembly even when (L, invs) came
    from a stale tangent. Returns (x, ratio): ratio = |last
    correction| / |x| is the in-program convergence certificate (the
    IR contraction factor; ~1 means the factor is too stale and the
    caller must refactor — thin-shell tangents change O(1) under
    d-drifts of only ~1e-2 relative, round-2 finding)."""

    N = dscale.shape[0]
    Np = L.shape[0]

    def subst(r):
        rn = dscale * r.reshape(-1)
        if Np != N:
            rn = jnp.concatenate(
                [rn, jnp.zeros(Np - N, dtype=rn.dtype)])
        y = _chol_substitute(L, invs, rn, nb)
        return (dscale * y[:N]).reshape(b.shape)

    x = subst(b)

    def sweep(_, carry):
        x, dx_prev, _ = carry
        r = (b - tangent_matvec(data, d, cp, h, x)) * data.free
        dx = subst(r)
        return x + dx, jnp.linalg.norm(dx), dx_prev

    x, last_dx, prev_dx = jax.lax.fori_loop(
        0, n_ir, sweep, (x, jnp.linalg.norm(x), jnp.linalg.norm(x)))
    ratio = last_dx / (jnp.linalg.norm(x) + 1e-300)
    # UNBIASED per-sweep contraction |dx_n|/|dx_{n-1}|: ratio^(1/n) is
    # tol-biased (n is sized so ratio lands just under tol, so the
    # root reads ~tol^(1/n) whatever the factor quality — round-5
    # policy finding); rho_last measures the factor itself
    rho_last = last_dx / (prev_dx + 1e-300)
    return x, ratio, rho_last


@partial(jax.jit, static_argnames=("nb", "n_ir"))
def _jvp_ir_solve_seeded(data: SystemData, L, invs, dscale, cp, h, d,
                         b, x0, nb: int, n_ir: int):
    """`_jvp_ir_solve` seeded with an initial guess x0 (e.g. the
    secant-extrapolated adjoint of the previous optimizer iteration):
    skips the substitution-from-b and needs one fewer sweep for the
    same certificate, because the entry error is already small. A bad
    seed only fails the certificate (the caller falls back to the
    unseeded program) — it cannot corrupt the result."""
    N = dscale.shape[0]
    Np = L.shape[0]

    def subst(r):
        rn = dscale * r.reshape(-1)
        if Np != N:
            rn = jnp.concatenate(
                [rn, jnp.zeros(Np - N, dtype=rn.dtype)])
        y = _chol_substitute(L, invs, rn, nb)
        return (dscale * y[:N]).reshape(b.shape)

    def sweep(_, carry):
        x, dx_last, _ = carry
        r = (b - tangent_matvec(data, d, cp, h, x)) * data.free
        dx = subst(r)
        return x + dx, jnp.linalg.norm(dx), dx_last

    x, last_dx, prev_dx = jax.lax.fori_loop(
        0, n_ir, sweep, (x0, jnp.linalg.norm(x0), jnp.linalg.norm(x0)))
    ratio = last_dx / (jnp.linalg.norm(x) + 1e-300)
    rho_last = last_dx / (prev_dx + 1e-300)
    return x, ratio, rho_last


@partial(jax.jit, static_argnames=("nb",))
def _subst_dir(data: SystemData, L, invs, dscale, r, nb: int):
    """Substitution-only Newton direction + Armijo slope in ONE device
    program (the direction + free-mask + slope sequence otherwise costs
    three readbacks per iteration)."""
    N = dscale.shape[0]
    Np = L.shape[0]
    rn = dscale * (-r).reshape(-1)
    if Np != N:
        rn = jnp.concatenate([rn, jnp.zeros(Np - N, dtype=rn.dtype)])
    y = _chol_substitute(L, invs, rn, nb)
    delta = (dscale * y[:N]).reshape(r.shape) * data.free
    return delta, jnp.sum(r * delta)


@partial(jax.jit, static_argnames=("nb", "n_ir"))
def _jvp_ir_dir(data: SystemData, L, invs, dscale, cp, h, d, r,
                nb: int, n_ir: int):
    """IR-exact Newton direction: jvp-IR solve + certificate +
    free-mask + Armijo slope, one program (see _jvp_ir_solve)."""
    x, ratio, rho_last = _jvp_ir_solve.__wrapped__(
        data, L, invs, dscale, cp, h, d, -r, nb=nb, n_ir=n_ir)
    delta = x * data.free
    return delta, ratio, jnp.sum(r * delta), rho_last


class PersistentDeviceFactor:
    """ONE on-device f64 factorization amortized across Newton AND
    optimizer iterations (the round-2 production path).

    - `direction(r)`: substitution-only solve against the stored factor
      — an inexact Newton direction (relative error ~ staleness), safe
      under the energy line search.
    - `exact_solve(cp, h, d, b)`: fused substitution + jvp-matvec IR —
      exact to the ~2e-6 emulation floor regardless of factor
      staleness up to ~1e-2.
    - `ensure(cp, h, d)`: refactors only when the state drifted more
      than `stale_tol` (relative, combined cp/h/d drift) since the last
      factorization.
    """

    def __init__(self, data: SystemData, nb: int = 256, mb: int = 16,
                 stale_tol: float = 5e-3, n_ir: int = 3):
        self.data = data
        self.dc = DeviceCholesky(nb=nb, mb=mb)
        self.stale_tol = stale_tol
        self.n_ir = n_ir
        self.rho_est = self._RHO0  # measured per-sweep IR contraction
        self._ref = None         # (cp, h, d) at factor time
        self.n_factor = 0
        self.last_ratio = 0.0    # certificate of the last exact_solve
        self.nonconverged = False  # any exact_solve ever failed cert?
        self.refactor_log = []   # (why, drift_or_rho) per factorization
        self.cert_log = []       # (tag, n_ir, ratio) per IR attempt

    @staticmethod
    @jax.jit
    def _drift(cp, h, d, cp0, h0, d0):
        """Relative state drift since the factorization. Each field is
        normalized by ITS OWN scale — displacements in particular must
        NOT be normalized by the geometry norm: a cold solve moves d
        from 0 to O(1e-2) while |cp| is O(1), which is a tiny 'drift'
        by geometry standards but changes the tangent completely (the
        round-2 drive stalled exactly this way). The tiny floor on the
        d-scale makes any first step from d0 = 0 register as full
        drift, so cold solves refactor like classic Newton."""
        dcp = jnp.linalg.norm(cp - cp0) / (jnp.linalg.norm(cp0) + 1e-300)
        dh = jnp.linalg.norm(h - h0) / (jnp.linalg.norm(h0) + 1e-300)
        d_scale = jnp.linalg.norm(d0) + 1e-6 * jnp.linalg.norm(cp0) \
            + 1e-300
        dd = jnp.linalg.norm(d - d0) / d_scale
        return jnp.maximum(jnp.maximum(dcp, dh), dd)

    def ensure(self, cp, h, d, force=False, stale_tol=None, why=""):
        """Refactor if stale; returns True when a factorization ran.

        `stale_tol` overrides the instance threshold for THIS check:
        call sites whose solves are certificate-protected (jvp-IR
        directions / exact_solve) pass a LOOSE tol (~0.2) so only a
        grossly stale factor (a cold transient) refactors preemptively
        — the IR certificate already self-refactors when sweeps fail,
        and a drift-triggered refactor costs ~3x an IR solve."""
        drift = -1.0
        if self._ref is not None and not force:
            drift = float(self._drift(cp, h, d, *self._ref))
            tol = self.stale_tol if stale_tol is None else stale_tol
            if drift <= tol:
                return False
        from goldfish_jax.solver.implicit import _jit_assemble_K
        from goldfish_jax.utils.evtrace import enabled as _tr, trace

        import time as _time
        t0 = _time.perf_counter()
        if _tr:
            # sub-stage attribution (queue-wait vs assemble vs ladder):
            # the syncs exist only under tracing
            jax.device_get(jnp.asarray(d).ravel()[0])
            t_q = _time.perf_counter()
        K = _jit_assemble_K(self.data, cp, h, d)
        if _tr:
            jax.device_get(K[0, 0])
            t_asm = _time.perf_counter()
        self.dc.factor(K)
        if _tr:
            # force completion so the traced dt is the real wall
            jax.device_get(self.dc._L[0, 0])
            t1 = _time.perf_counter()
            trace("factor", why=why or "drift", drift=drift,
                  dt=t1 - t0, queue=t_q - t0, asm=t_asm - t_q,
                  ladder=t1 - t_asm)
        self._ref = (cp, h, d)
        self.n_factor += 1
        self.rho_est = self._RHO0
        self.refactor_log.append((why or "drift", drift))
        return True

    def drift_scalar(self, cp, h, d):
        """State drift vs the factor reference as a DEVICE scalar (no
        readback — callers batch the fetch with their other scalars so
        the drift check, the direction, and the trial dispatch
        back-to-back instead of paying one readback each;
        see newton_solve_host). None when no factor exists yet."""
        if self._ref is None:
            return None
        return self._drift(cp, h, d, *self._ref)

    def direction(self, r):
        """Inexact-Newton direction: substitution only (1 dispatch)."""
        return self.dc.solve(r)

    def direction_slope(self, r):
        """Fused substitution direction (free-masked) + Armijo slope
        for -r; one dispatch (see _subst_dir)."""
        return _subst_dir(self.data, self.dc._L, self.dc._invs,
                          self.dc._dscale, r, nb=self.dc.nb)

    # --- adaptive IR policy -------------------------------------------
    # ratio ~ rho^n_ir with rho the per-sweep IR contraction (set by
    # factor staleness).  The policy MEASURES rho from each certificate
    # and sizes the next solve's sweep count to hit its tol — instead
    # of refactoring (~3x the cost of an IR solve) whenever a fixed
    # sweep count missed.  Refactor only for a genuinely stale factor
    # (rho > 0.5: sweeps barely contract) or when retries exhaust.
    _RHO0 = 1e-3        # optimistic initial estimate (fresh factor)
    _MAX_SWEEPS = 16
    # measured-contraction refresh threshold (ported from
    # PersistentDeviceFactorMI after the pegasus SLSQP episode): a
    # factor pinned at a BAD state
    # (e.g. a stall refactor landing on an unconverged mid-Newton
    # iterate) keeps PASSING direction certificates forever at
    # rho ~ 0.26-0.6 — no drift heuristic fires, and every direction
    # and adjoint silently pays a MAX_SWEEPS program (measured 4.5 s
    # vs 1.2 s at pegasus scale). Round-5 recalibration 0.1 -> 0.22:
    # the rho measured from a PASSING direction cert is tol-BIASED
    # (n_for sizes n so ratio lands just under tol: a pass at 9.5e-4
    # with n=4 reads rho 0.18 whatever the factor's quality), and a
    # healthy one-optimizer-step-stale factor at pegasus scale
    # genuinely measures rho 0.15-0.18 (12-sweep certs at 1.7e-10
    # confirm) — with 0.1, EVERY first adjoint after an accepted step
    # refactored for nothing. 0.22 splits the measured populations:
    # healthy-stale 0.07-0.18 rides (n<=12, preloaded); pinned-bad
    # 0.26-0.6 refreshes.
    rho_refresh = 0.22
    # every distinct n_ir is a SEPARATE XLA program with its own
    # compile: quantize the sweep
    # count to a small menu so the policy can ever request at most 8
    # programs per kernel instead of any of 1..16. The 12 entry is the
    # round-5 fix for the round-4 verdict's 8->16 jump: every n_for in
    # 9..15 used to round up to the 16-sweep program, which dominated
    # the refactor-recovery iteration (evtrace attribution) — 9..12
    # now map to 12 (-25% sweeps on the recovery path).
    _N_MENU = (1, 2, 3, 4, 6, 8, 12, 16)

    def _n_for(self, tol, rho, seeded=False):
        import math

        # a non-finite rho (NaN certificate from a diverged solve at a
        # wild optimizer trial point) must read as "fully stale", not
        # crash: NaN slips through min/max (NaN comparisons are False)
        # and math.ceil(NaN) raises — observed at pegasus scale in an
        # SLSQP line search
        if not math.isfinite(rho):
            rho = 0.9
        rho = min(max(rho, 1e-4), 0.9)
        n = math.ceil(math.log(tol) / math.log(rho)) + 1
        if seeded:
            # a good seed's entry error is already small: one fewer
            # sweep reaches the same certificate (measured round 3)
            n -= 1
        n = min(max(n, 1), self._MAX_SWEEPS)
        return next(m for m in self._N_MENU if m >= n)

    @staticmethod
    def _inputs_finite(*arrays):
        """ONE batched readback: are all inputs finite? A non-finite
        certificate with non-finite INPUTS (a diverged optimizer trial
        point fed b = NaN gradient seed, or a d that never converged)
        is not a solver failure — no sweep count or refactorization can
        help, and refactoring AT the garbage state would poison the
        factor for the next healthy evaluation. Only checked on the
        (rare) non-finite-certificate path: zero cost when healthy."""
        ok = jnp.asarray(True)
        for a in arrays:
            ok = ok & jnp.isfinite(a).all()
        return bool(jax.device_get(ok))

    def _rho(self, n_ir):
        """Per-sweep contraction measured from the last certificate."""
        import math

        if not math.isfinite(self.last_ratio):
            # NaN/inf certificate = the solve produced garbage (e.g. a
            # diverged forward state poisoned the matvec): report the
            # factor as fully stale so the retry loop refactors NOW
            # instead of propagating NaN into rho_est -> _n_for crash
            return 0.9
        if self.last_ratio <= 0.0:
            return 1e-4
        return self.last_ratio ** (1.0 / n_ir)

    def _rho_meas(self, n_ir, rho_last=None):
        """Contraction estimate: min(LAST-SWEEP ratio |dx_n|/|dx_{n-1}|,
        ratio^(1/n)). Each is wrong in one regime: ratio^(1/n) is
        tol-BIASED high (n is sized so ratio lands just under tol, so
        the root reads ~tol^(1/n) for any factor quality — round-5
        pegasus policy finding); rho_last is NOISE once the solve hits
        the roundoff floor (corrections stop contracting — a fresh
        factor measured rho_last 0.39 at a 1e-15 certificate). The min
        is right in both regimes."""
        import math

        base = self._rho(n_ir)
        if rho_last is not None and math.isfinite(rho_last) \
                and rho_last > 0.0:
            return min(max(min(float(rho_last), base), 1e-4), 0.9)
        return base

    def _rho_entry_refresh(self, cp, h, d):
        """Unpin a persistently mediocre factor on MEASURED contraction
        (see `rho_refresh`): when the estimate is mediocre AND the
        state has drifted since factorization, refresh at the current
        (presumed healthy) state rather than keep over-sweeping. Zero
        cost when healthy — the drift/finiteness readbacks only happen
        once rho_est is already above rho_refresh. Never refactors at
        a non-finite state (that would poison the factor for the next
        healthy evaluation — the SLSQP wild-trial lesson).

        NOT suppressed inside optimizer trials (a round-4 experiment
        measured on pegasus-91 hardware): a trial-entry state is
        coherent — warm d from the previous accepted iterate + the
        trial (cp, h) — so refreshing there is safe, and SUPPRESSING
        the refresh re-created the bad-state-pinned-factor cost with
        the opposite sign: a mediocre incumbent (rho ~0.6) rode
        MAX_SWEEPS direction programs through every line-search trial
        (SLSQP 137.5 s/it vs ~34 with the refresh active)."""
        if self._ref is None or self.rho_est <= self.rho_refresh:
            return
        drift = float(self._drift(cp, h, d, *self._ref))
        if drift > self.stale_tol and self._inputs_finite(cp, h, d):
            self.ensure(cp, h, d, force=True, why="rho-refresh")

    def newton_direction(self, cp, h, d, r, tol=1e-3):
        """Fused IR-exact Newton direction, certificate-validated;
        returns (delta, slope). tol=1e-3 is inexact-Newton forcing —
        the line search and the next residual measure actual progress,
        only adjoints need the 1e-6 grade (see
        system_mi.PersistentDeviceFactorMI)."""
        import math

        self._rho_entry_refresh(cp, h, d)
        rho_entry = self.rho_est
        refactored = False
        for attempt in range(5):
            n_ir = self._n_for(tol, self.rho_est)
            delta, ratio, slope, rho_last_ = _jvp_ir_dir(
                self.data, self.dc._L, self.dc._invs, self.dc._dscale,
                cp, h, d, r, nb=self.dc.nb, n_ir=n_ir)
            self.last_ratio = float(ratio)
            rho_last = float(rho_last_)
            self.cert_log.append(("dir", n_ir, self.last_ratio))
            from goldfish_jax.utils.evtrace import trace
            trace("dir_cert", attempt=attempt, n_ir=n_ir,
                  ratio=self.last_ratio)
            if not math.isfinite(self.last_ratio):
                if not self._inputs_finite(r, d):
                    # garbage in: return the (non-finite) direction —
                    # the caller's line search rejects it — keeping the
                    # pre-episode contraction estimate and the factor
                    self.rho_est = rho_entry
                    return delta, float("nan")
                if refactored:
                    # fresh factor + finite inputs still non-finite:
                    # the jvp matvec overflows at this state — more
                    # sweeps re-overflow, give up visibly
                    return delta, float("nan")
            if self.last_ratio <= tol or (
                    attempt >= 1 and self.last_ratio <= 10.0 * tol):
                # nudge the estimate toward the measurement so later
                # solves stop over-sweeping once the factor freshens.
                # NEAR-MISS acceptance on retries (round-5 pegasus
                # evtrace): a re-sized attempt landing within 10x of
                # the forcing tolerance is still a perfectly good
                # inexact-Newton direction (forcing eta ~ 1e-2 bounds
                # the linear rate; the line search and the next |r|
                # measure real progress) — rejecting it paid a 3.3 s
                # refactorization + redo for zero convergence benefit.
                # Adjoint solves keep their strict 1e-6 gate; only the
                # direction grade relaxes.
                self.rho_est = max(self._rho_meas(n_ir, rho_last),
                                   self._RHO0)
                break
            self.rho_est = self._rho_meas(n_ir, rho_last)
            if not refactored and (self.rho_est > 0.5 or attempt >= 3
                                   or n_ir >= self._MAX_SWEEPS):
                self.ensure(cp, h, d, force=True, why="dir-cert")
                refactored = True
        return delta, float(slope)

    def preload(self, menu=None, dir_menu=None):
        """Force the first-in-process XLA program LOAD of every
        sweep-menu variant of the three IR kernels (direction /
        unseeded / seeded solve) against the current factor.

        A variant first hit inside a timed region shows up as an
        outlier with zero refactorizations and healthy certificates
        (its compile or first load). Call once, untimed, after the
        first factorization. The rhs is arbitrary (program identity
        depends only on shapes + n_ir); policy state (rho_est,
        last_ratio, cert_log) is untouched. All variants are
        dispatched back-to-back and synchronized with ONE batched
        readback."""
        if self._ref is None:
            raise RuntimeError("preload needs a factor: call ensure()")
        cp, h, d = self._ref
        b = jnp.asarray(self.data.free, dtype=cp.dtype)
        menu = self._N_MENU if menu is None else menu
        # dir_menu: extra sweep counts to load for the DIRECTION kernel
        # only (the recovery path's 12-sweep program is dir-only; the
        # solve kernels at those n are unused warm, and every resident
        # program adds device-program-cache eviction pressure — the
        # round-5 pegasus finding)
        dir_menu = menu if dir_menu is None else dir_menu
        outs = []
        for n in sorted(set(menu) | set(dir_menu)):
            _, r1, _, _ = _jvp_ir_dir(
                self.data, self.dc._L, self.dc._invs, self.dc._dscale,
                cp, h, d, b, nb=self.dc.nb, n_ir=n)
            outs.append(r1)
            if n in menu:
                _, r2, _ = _jvp_ir_solve(
                    self.data, self.dc._L, self.dc._invs,
                    self.dc._dscale, cp, h, d, b, nb=self.dc.nb, n_ir=n)
                _, r3, _ = _jvp_ir_solve_seeded(
                    self.data, self.dc._L, self.dc._invs,
                    self.dc._dscale, cp, h, d, b, b * 0.0,
                    nb=self.dc.nb, n_ir=n)
                outs += [r2, r3]
        jax.device_get(outs)

    def ir_solve_async_dir(self, cp, h, d, b, tol=1e-6):
        """Adjoint-grade solve VIA THE DIRECTION KERNEL (K x = b as
        `_jvp_ir_dir(r=-b)`; identical math, slope discarded). At
        production scale the once-per-iteration seeded/unseeded solve
        programs can be evicted from a device program cache and
        re-load on EVERY jac, while the dir kernel — exercised every
        Newton iteration of every fun — stays resident. The secant
        seed is intentionally dropped on this path: one extra sweep on
        a resident program beats a reload. Returns (x, ratio_dev,
        n) like ir_solve_async; certificate semantics unchanged."""
        self._rho_entry_refresh(cp, h, d)
        n = self._n_for(tol, self.rho_est)
        x, ratio, _, rho_last = _jvp_ir_dir(
            self.data, self.dc._L, self.dc._invs, self.dc._dscale,
            cp, h, d, -b, nb=self.dc.nb, n_ir=n)
        return x, ratio, n, rho_last

    def ir_solve_async(self, cp, h, d, b, x0=None, tol=1e-6):
        """ONE jvp-IR dispatch with NO readback: returns (x, ratio_dev,
        n_used). The caller fetches `ratio_dev` batched with its other
        scalars (and may dispatch downstream work on `x` speculatively
        — e.g. the adjoint vjp), then calls `finish_ir(n_used, ratio)`:
        True = certificate passed, the solve is exact; False = fall
        back to the self-validating `exact_solve`. Exactness never
        rests on the speculation — only wasted device work does."""
        self._rho_entry_refresh(cp, h, d)
        if x0 is not None:
            n = self._n_for(tol, self.rho_est, seeded=True)
            x, ratio, rho_last = _jvp_ir_solve_seeded(
                self.data, self.dc._L, self.dc._invs, self.dc._dscale,
                cp, h, d, b, x0, nb=self.dc.nb, n_ir=n)
        else:
            n = self._n_for(tol, self.rho_est)
            x, ratio, rho_last = _jvp_ir_solve(
                self.data, self.dc._L, self.dc._invs, self.dc._dscale,
                cp, h, d, b, nb=self.dc.nb, n_ir=n)
        return x, ratio, n, rho_last

    def finish_ir(self, n, ratio, tol=1e-6, tag="exact-pipe",
                  rho_last=None):
        """Certificate bookkeeping for an `ir_solve_async` dispatch
        (same rho_est update rules as exact_solve)."""
        import math

        self.last_ratio = float(ratio)
        self.cert_log.append((tag, n, self.last_ratio))
        if self.last_ratio <= tol:
            self.rho_est = max(self._rho_meas(n, rho_last), self._RHO0)
            return True
        if not math.isfinite(self.last_ratio):
            # do NOT fold a non-finite certificate into rho_est here:
            # the fallback exact_solve triages it (garbage inputs →
            # bail without refactor; finite inputs → refactor) — a
            # premature rho_est=0.9 would make its first attempt burn
            # a MAX_SWEEPS program on what is usually a NaN trial point
            return False
        self.rho_est = self._rho_meas(n, rho_last)
        return False

    def exact_solve(self, cp, h, d, b, n_ir=None, tol=1e-6, x0=None):
        """K(d) x = b via jvp-matvec IR, SELF-VALIDATING: if the
        in-program convergence certificate says the sweeps did not
        contract to `tol` (factor too stale for IR), grow the sweep
        count from the measured contraction or refactor at the current
        state and redo. If the certificate STILL fails after a fresh
        factor, the failure is made visible (warning + `nonconverged`
        flag) rather than silently propagating an inaccurate solve
        into adjoint gradients.

        `x0` (optional): warm seed for the solution (the previous
        optimizer iteration's adjoint, secant-extrapolated). A good
        seed passes the certificate with one fewer sweep; a bad seed
        fails it and the solve falls back to the unseeded program —
        exactness never depends on seed quality."""
        self._rho_entry_refresh(cp, h, d)
        if x0 is not None:
            n = self._n_for(tol, self.rho_est, seeded=True)
            x, ratio, rho_last = _jvp_ir_solve_seeded(
                self.data, self.dc._L, self.dc._invs, self.dc._dscale,
                cp, h, d, b, x0, nb=self.dc.nb, n_ir=n)
            r = float(ratio)
            self.cert_log.append(("exact-x0", n, r))
            if r <= tol:
                self.last_ratio = r
                # ratio^(1/n) folds the seed error into the contraction
                # estimate; it may UNDERestimate rho for an excellent
                # seed, but the certificate-retry loop bounds the
                # damage and without this update rho_est stays stuck at
                # its cold pessimistic value and every seeded solve
                # over-sweeps (measured: n=6 for certs at 1e-15)
                self.rho_est = max(self._rho_meas(n, float(rho_last)),
                                   self._RHO0)
                return x
            # bad seed or stale factor: fall through unseeded
        import math

        rho_entry = self.rho_est
        refactored = False
        for attempt in range(5):
            n = self._n_for(tol, self.rho_est) if n_ir is None else n_ir
            x, ratio, rho_last_ = _jvp_ir_solve(
                self.data, self.dc._L, self.dc._invs, self.dc._dscale,
                cp, h, d, b, nb=self.dc.nb, n_ir=n)
            self.last_ratio = float(ratio)
            rho_last_u = float(rho_last_)
            self.cert_log.append(("exact", n, self.last_ratio))
            from goldfish_jax.utils.evtrace import trace
            trace("exact_cert", attempt=attempt, n_ir=n,
                  ratio=self.last_ratio)
            if not math.isfinite(self.last_ratio):
                if not self._inputs_finite(b, d):
                    # garbage in (diverged trial point): return the
                    # non-finite solve — visible to the caller, whose
                    # line search / optimizer backtracks — WITHOUT
                    # refactoring at this state (that would poison the
                    # factor for the next healthy evaluation) and with
                    # the pre-episode contraction estimate intact
                    self.rho_est = rho_entry
                    return x
                if refactored:
                    break  # fresh factor + finite inputs: overflow —
                    # give up through the visible-warning path below
            if self.last_ratio <= tol:
                self.rho_est = max(self._rho_meas(n, rho_last_u),
                                   self._RHO0)
                return x
            self.rho_est = self._rho_meas(n, rho_last_u)
            n_ir = None  # retries re-size from the measured rho
            if not refactored and (self.rho_est > 0.5 or attempt >= 3
                                   or n >= self._MAX_SWEEPS):
                self.ensure(cp, h, d, force=True, why="exact-cert")
                refactored = True
        self.nonconverged = True
        import warnings

        warnings.warn(
            "PersistentDeviceFactor.exact_solve: IR certificate did not "
            f"contract (last correction ratio {self.last_ratio:.3e} > "
            f"tol {tol:.1e}) even after a fresh factorization — the "
            "returned solve (and any gradient built on it) may be "
            "inaccurate.", RuntimeWarning, stacklevel=2)
        return x