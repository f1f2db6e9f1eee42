"""Differentiable implicit displacement solve (the adjoint engine).

JAX replacement for the reference's implicit-operation machinery
(reference: GOLDFISH/operations/disp_imop.py — `solve_nonlinear` Newton,
`linearize` caching dRIGAduIGA / dRIGAdCPIGA / dRIGAdh_th, and the
MUMPS-backed `solve_linear_fwd/rev`): the whole apparatus collapses into
ONE `jax.custom_vjp`-wrapped function

    d = solve_displacement(cp, h)

whose backward pass is the implicit-function-theorem adjoint

    K(d*) lam = dJ/dd,     dJ/dp -= lam^T dR/dp

with K the exact (symmetric) tangent from `assemble_K` and dR/dp
obtained by `jax.vjp` through the residual — no hand-derived partial
matrices anywhere. Composes with `jax.grad` on any downstream objective,
so `jax.grad(lambda h: J(solve(cp, h), cp, h))` is the entire adjoint
pipeline of the reference SURVEY.md section 3.1 gradient pass.
"""

from __future__ import annotations

import math
from functools import partial

import jax
import jax.numpy as jnp

from goldfish_jax.solver.linalg import (
    factor,
    factor_solve,
    linear_solve,
    mode,
    refined_solve,
)
from goldfish_jax.solver.system import (
    SystemData,
    assemble_K,
    residual,
    scale_loads,
    tangent_matvec,
    total_potential,
)

__all__ = ["newton_solve", "newton_solve_host", "continuation_solve",
           "adjoint_solve", "build_solve_fn", "build_field_solve_fn"]


def continuation_solve(data: SystemData, cp, h, d0, n_steps=5, rtol=1e-10,
                       atol=1e-14, max_it=30, freeze_K=False):
    """Load-stepped Newton: ramp all external loads in n_steps
    increments, warm-starting each level — the robust path for contact
    and post-buckling-adjacent problems.

    Returns (d, its_last, rn_last)."""
    d = d0
    for k in range(1, n_steps + 1):
        data_s = scale_loads(data, k / n_steps)
        d, it, rn = newton_solve(data_s, cp, h, d, rtol=rtol, atol=atol,
                                 max_it=max_it, freeze_K=freeze_K)
    return d, it, rn


@partial(jax.jit, static_argnames=("max_it", "freeze_K"))
def newton_solve(data: SystemData, cp, h, d0, rtol=1e-10, atol=1e-14,
                 max_it=30, freeze_K=False):
    """Fully-jitted damped-Newton solve for the displacement field.

    Dense-direct linear solves (small/medium systems; the matrix-free
    Krylov path lives in solver/krylov.py). Runs a `lax.while_loop`
    so the whole solve is one XLA computation: no host round-trips per
    iteration, unlike the reference's PETSc-driven loop
    (PENGoLINS `solve_nonlinear_nonmatching_problem`).

    Because the conservative system derives from a single potential Pi,
    globalization is an Armijo backtracking line search on Pi itself —
    a guaranteed-descent strategy the reference's plain Newton loop
    lacks (a full step on a tip-loaded shell can overshoot the energy
    basin; NaN trial energies simply keep backtracking).

    Convergence: relative/absolute residual tolerance, OR energy
    stagnation — when the predicted decrease |r . delta| drops below
    machine precision relative to Pi, the solve has hit the noise floor
    of the linear algebra (cond(K) * eps) and further iterations are
    meaningless in the working dtype.

    Returns (d, iterations, final |r|).
    """
    # Convergence reference: the ZERO-displacement residual (the load
    # scale), NOT |r(d0)| — otherwise a warm-started solve (optimizer
    # iterations hand in the previous solution) can never satisfy a
    # relative tolerance and burns max_it doing nothing.
    r_ref = jnp.linalg.norm(residual(data, jnp.zeros_like(d0), cp, h))
    r0n = jnp.linalg.norm(residual(data, d0, cp, h))
    r_ref = jnp.maximum(jnp.maximum(r_ref, r0n * 1e-6), 1e-300)
    eps = jnp.finfo(d0.dtype).eps

    # Newton directions go through linear_solve: native f64 LU on the
    # direct path, GMRES-IR (f32 LU preconditioner + f64 Krylov on the
    # explicit tangent) on the mixed one. A raw f32 factorization
    # direction is NOT viable: at cond(K) ~ 1e10-1e12 its forward error
    # is O(cond * eps_f32) >> 1 — the "direction" is noise, the energy
    # line search stalls, and the solve silently returns garbage.
    #
    # freeze_K: assemble/factor the tangent ONCE at d0 and reuse it for
    # every iteration (modified Newton). Hessian assembly dominates the
    # cost; for warm-started solves inside an optimization loop the
    # frozen tangent costs one extra (cheap) iteration at most. The
    # energy line search keeps the frozen direction globally safe.
    #
    # 'mixed' uses the BLOCK operator path (solver/blocks.py): exact
    # f64 matvecs from unassembled Hessian blocks + f32 dense LU
    # preconditioner, with no dense f64 scatter.
    mixed = mode() == "mixed"
    if mixed:
        from goldfish_jax.solver.blocks import (
            block_gmres_solve,
            compute_blocks,
        )

        if freeze_K:
            blocks0 = compute_blocks(data, d0, cp, h)

            def direction(d, r):
                return block_gmres_solve(data, blocks0, -r)
        else:
            def direction(d, r):
                blocks = compute_blocks(data, d, cp, h)
                return block_gmres_solve(data, blocks, -r)
    elif freeze_K:
        fac0 = factor(assemble_K(data, d0, cp, h))

        def direction(d, r):
            return factor_solve(fac0, -r.reshape(-1)).reshape(r.shape)
    else:
        def direction(d, r):
            K = assemble_K(data, d, cp, h)
            return linear_solve(K, -r.reshape(-1)).reshape(r.shape)

    def cond(state):
        d, it, rnorm, done, best, stall, pinned = state
        return (it < max_it) & (~done) & (rnorm > atol) & (rnorm > rtol * r_ref)

    def body(state):
        d, it, rn_prev, _, best, stall, pinned = state
        r = residual(data, d, cp, h)
        delta = direction(d, r) * data.free

        Pi0 = total_potential(data, d, cp, h)
        slope = jnp.sum(r * delta)  # descent: < 0 for SPD K
        # Predicted decrease below the dtype's energy resolution: the
        # Armijo test is pure roundoff noise there — take the plain
        # full Newton step (quadratic endgame polish). On STIFF systems
        # this happens while the residual can still collapse by orders
        # of magnitude (slope ~ |r|^2/stiffness underflows the energy
        # resolution long before |r| floors), so "done" additionally
        # requires the residual to have stopped contracting.
        slope_tiny = jnp.abs(slope) <= 4.0 * eps * jnp.abs(Pi0) + 1e-300

        def ls_cond(s):
            alpha, j = s
            Pi_try = total_potential(data, d + alpha * delta, cp, h)
            ok = Pi_try <= Pi0 + 1e-4 * alpha * slope + 16 * eps * jnp.abs(Pi0)
            return jnp.logical_not(ok) & (j < 30) & jnp.logical_not(slope_tiny)

        def ls_body(s):
            return s[0] * 0.5, s[1] + 1

        alpha, _ = jax.lax.while_loop(
            ls_cond, ls_body, (jnp.asarray(1.0, dtype=d0.dtype), jnp.int32(0)))
        d = d + alpha * delta
        rnew = jnp.linalg.norm(residual(data, d, cp, h))
        res_stalled = rnew > 0.5 * rn_prev
        done = slope_tiny & res_stalled
        # Stagnation guard: inexact (f32) directions can floor the
        # residual above rtol while the line search keeps accepting
        # sub-resolution steps. Count a stall only when BOTH the energy
        # decrease is below resolution AND the residual stopped
        # contracting — energy alone floors early on stiff systems
        # while Newton is still converging quadratically.
        Pi_new = total_potential(data, d, cp, h)
        no_progress = (Pi_new >= Pi0 - 64 * eps * jnp.abs(Pi0)) \
            & res_stalled
        stall = jnp.where(no_progress, stall + 1, jnp.int32(0))
        best = jnp.minimum(best, rnew)
        done = done | (stall >= 3)
        # residual PINNED at its achievable floor (see
        # newton_solve_host): two consecutive iterations inside the
        # Newton basin with <2% |r| reduction cannot reach rtol within
        # max_it — stop instead of burning iterations on no-op steps.
        # Basin-gated so cold-transient |r| growth under the energy
        # line search is not counted.
        pinned = jnp.where((rnew <= 1e-2 * r_ref)
                           & (rnew > 0.98 * rn_prev),
                           pinned + 1, jnp.int32(0))
        done = done | (pinned >= 2)
        return d, it + 1, rnew, done, best, stall, pinned

    d, it, rn, *_ = jax.lax.while_loop(
        cond, body,
        (d0, jnp.int32(0), r0n, jnp.asarray(False), r0n, jnp.int32(0),
         jnp.int32(0)))
    return d, it, rn


@jax.jit
def _jit_residual(data: SystemData, cp, h, d):
    return residual(data, d, cp, h)


@jax.jit
def _jit_res_pot(data: SystemData, cp, h, d):
    """residual + |r| + potential in ONE program (one readback per
    Newton iteration instead of three)."""
    r = residual(data, d, cp, h)
    return r, jnp.linalg.norm(r), total_potential(data, d, cp, h)


@jax.jit
def _jit_potential(data: SystemData, cp, h, d):
    return total_potential(data, d, cp, h)


@jax.jit
def _jit_entry(data: SystemData, cp, h, d0):
    """Newton entry in ONE program: load-scale |r(0)| (the convergence
    reference, CLAUDE.md), r(d0), |r(d0)|, Pi(d0)."""
    r0 = residual(data, jnp.zeros_like(d0), cp, h)
    r = residual(data, d0, cp, h)
    return jnp.linalg.norm(r0), r, jnp.linalg.norm(r), \
        total_potential(data, d0, cp, h)


@jax.jit
def _jit_trial(data: SystemData, cp, h, d, delta, alpha):
    """Line-search trial state in ONE program: d_try, its residual,
    |r|, and potential. When the trial is accepted (the common warm
    case: alpha=1) these ARE the next iteration's state — no separate
    res/pot dispatch (see system_mi._jit_trial_mi)."""
    d_new = d + alpha * delta
    r = residual(data, d_new, cp, h)
    return d_new, r, jnp.linalg.norm(r), \
        total_potential(data, d_new, cp, h)


@jax.jit
def _jit_blocks(data: SystemData, cp, h, d):
    from goldfish_jax.solver.blocks import compute_blocks

    return compute_blocks(data, d, cp, h)


@jax.jit
def _jit_block_solve(data: SystemData, blocks, b):
    from goldfish_jax.solver.blocks import block_gmres_solve

    return block_gmres_solve(data, blocks, b)


@jax.jit
def _jit_assemble_K(data: SystemData, cp, h, d):
    return assemble_K(data, d, cp, h)


def newton_solve_host(data: SystemData, cp, h, d0, rtol=1e-10, atol=1e-14,
                      max_it=30, verbose=False, host_fac=None,
                      device_fac=None, shared=None):
    """Host-driven damped Newton (the mixed path): python composition
    of SMALL jitted programs around a persistent factor whose refresh
    policy needs host decisions. Same convergence semantics as
    `newton_solve`.

    Device path (round 2): ONE persistent blocked-f64-Cholesky factor
    (devicechol.PersistentDeviceFactor) serves every iteration as an
    inexact-Newton preconditioner (substitution-only directions, the
    energy line search guarantees descent); the factor refreshes only
    when the state drifts past its staleness tolerance or when
    convergence stalls. This replaces the round-1
    refactor-every-iteration scheme (a 1e-3-stale factor still refines
    to the floor)."""
    # `shared` (optional dict) amortizes across SOLVES of a warm
    # optimizer loop: "r_ref" caches the load-scale reference |r(0)|
    # (an extra full residual program per solve otherwise, while a
    # per-iteration design step moves it ~0.1%). Refresh every 32
    # solves: the per-step drift is small but compounds over a long
    # optimization (pressure/areal loads scale with surface area)
    from goldfish_jax.utils.evtrace import trace

    trace("newton.enter")
    if (shared is not None and "r_ref" in shared
            and shared.get("r_ref_age", 0) < 32):
        r_ref = shared["r_ref"]
        shared["r_ref_age"] = shared.get("r_ref_age", 0) + 1
        r, rn_, Pi = _jit_res_pot(data, cp, h, d0)
        rn, Pi0 = (float(x) for x in jax.device_get((rn_, Pi)))
    else:
        r_ref_, r, rn_, Pi = _jit_entry(data, cp, h, d0)
        r_ref, rn, Pi0 = (float(x) for x in
                          jax.device_get((r_ref_, rn_, Pi)))
        if shared is not None:
            shared["r_ref"] = r_ref
            shared["r_ref_age"] = 0
    trace("newton.entry_readback", rn=rn)
    r_ref = max(max(r_ref, rn * 1e-6), 1e-300)
    eps = float(jnp.finfo(d0.dtype).eps)

    from goldfish_jax.solver import devicechol, hostsolve

    device_direct = devicechol.enabled()
    host_direct = (not device_direct) and hostsolve.enabled()
    if host_direct and host_fac is None:
        host_fac = hostsolve.PersistentHostFactor(data)
    if device_direct and device_fac is None:
        device_fac = devicechol.PersistentDeviceFactor(data)

    d = d0
    stall = 0
    pinned = 0
    it = 0
    refactored_on_stall = False
    use_ir = False
    while (it < max_it and rn > atol and rn > rtol * r_ref):
        pre_trial = None
        if device_direct:
            if use_ir:
                # exact Newton via the fused jvp-IR direction against
                # the (possibly stale) factor: replaces the refactor-
                # on-slow-contraction heuristic — one IR direction
                # costs ~1/3 of an assemble+factor and converges
                # quadratically (see newton_solve_mi_host)
                delta, slope = device_fac.newton_direction(cp, h, d, r,
                                                           tol=1e-3)
            else:
                # SPECULATIVE PIPELINE (every sequential float()
                # readback stalls the host loop): queue the drift
                # check, the substitution direction, and the alpha=1
                # trial back-to-back, then fetch all four scalars in ONE
                # batched readback; a stale factor merely wastes the
                # speculated direction+trial (rare on warm paths).
                if device_fac._ref is None:
                    device_fac.ensure(cp, h, d)
                drift_ = device_fac.drift_scalar(cp, h, d)
                delta, slope_ = device_fac.direction_slope(r)
                d_try, r_try, rn_try_, Pi_try_ = _jit_trial(
                    data, cp, h, d, delta, 1.0)
                drift, slope, rn_try, Pi_try = (
                    float(x) for x in jax.device_get(
                        (drift_, slope_, rn_try_, Pi_try_)))
                trace("newton.spec_readback", it=it, drift=drift,
                      rn_try=rn_try)
                if drift > 0.2:
                    # GROSSLY stale (cold transient): refresh the
                    # factor at the current state and redo
                    # direction + trial
                    device_fac.ensure(cp, h, d, force=True, why="drift")
                    delta, slope_ = device_fac.direction_slope(r)
                    d_try, r_try, rn_try_, Pi_try_ = _jit_trial(
                        data, cp, h, d, delta, 1.0)
                    slope, rn_try, Pi_try = (
                        float(x) for x in jax.device_get(
                            (slope_, rn_try_, Pi_try_)))
                elif drift > device_fac.stale_tol:
                    # moderately design-stale (an optimizer-sized
                    # step): ride the CERTIFICATE instead of
                    # refactoring — the fused jvp-IR direction is the
                    # exact Newton direction against the incumbent
                    # factor at ~1/3 the cost of an assemble+factor,
                    # and stale factors refine fine (the MI-path
                    # policy). An eager refactor here made every
                    # line-search trial and every accepted step of a
                    # pegasus SLSQP run pay a refactorization
                    # (n_refactor=8 in 3 iterations).
                    use_ir = True
                    delta, slope = device_fac.newton_direction(
                        cp, h, d, r, tol=1e-3)
                    d_try, r_try, rn_try_, Pi_try_ = _jit_trial(
                        data, cp, h, d, delta, 1.0)
                    rn_try, Pi_try = (
                        float(x) for x in jax.device_get(
                            (rn_try_, Pi_try_)))
                pre_trial = (d_try, r_try, rn_try_, rn_try, Pi_try)
        elif host_direct:
            blocks = _jit_blocks(data, cp, h, d)
            # host f64 LU fallback (amortized via exact-residual IR)
            delta = host_fac.solve(blocks, -r) * data.free
            slope = float(jnp.sum(r * delta))
        else:
            blocks = _jit_blocks(data, cp, h, d)
            delta = _jit_block_solve(data, blocks, -r) * data.free
            slope = float(jnp.sum(r * delta))
        # see newton_solve: slope underflows the energy resolution on
        # stiff systems while |r| is still contracting — "done" also
        # requires residual stagnation. 64x-eps margin: at |slope| ~ a
        # few eps*|Pi| the Armijo comparison is a coin flip on
        # roundoff noise and the line search thrashes to alpha ~ 1e-4
        # chasing unresolvable energy differences (see system_mi)
        slope_tiny = abs(slope) <= 64.0 * eps * abs(Pi0) + 1e-300

        # each trial is ONE fused dispatch producing the full candidate
        # state (d_try, r, |r|, Pi); on acceptance (the common warm
        # case: alpha=1) it IS the next iteration's state
        alpha = 1.0
        ls_fail = False
        rn_try = None
        if not math.isfinite(slope):
            # non-finite direction (the jvp overflowed at a wild trial
            # point): NO alpha fixes NaN*alpha — skip the 30 futile
            # trial dispatches and go straight to the stall refactor
            ls_fail = True
            d_try, r_try, rn_try, Pi_try = d, r, rn, Pi0
        # Floor-basin bisection cap (round-5 pegasus evtrace): deep in
        # the Newton basin (rn ~100x below load scale) an energy line
        # search that cannot accept alpha=1 is chasing roundoff — the
        # observed collapse bisected to alpha ~ 1e-5 over ~17 trial
        # dispatches per iteration with |r| moving <1%, ~2 s/iteration
        # at pegasus scale. 8 bisections (alpha_min ~ 4e-3) is plenty
        # for any genuine basin step; cold solves (rn near load scale)
        # keep the full 30.
        n_bisect = 30 if rn > 1e-2 * r_ref else 8
        for j in range(0 if ls_fail else (1 if slope_tiny else n_bisect)):
            if j == 0 and pre_trial is not None:
                # the alpha=1 trial was dispatched (and its scalars
                # fetched) inside the speculative pipeline above
                d_try, r_try, rn_try_, rn_try, Pi_try = pre_trial
            else:
                d_try, r_try, rn_try_, Pi_try_ = _jit_trial(
                    data, cp, h, d, delta, alpha)
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
            # line search exhausted IN the Newton basin with a finite
            # (typically certificate-validated) direction: the energy
            # cannot resolve further progress — this is the residual
            # floor, not a stale factor. Refactoring here burned ~3.3 s
            # per occurrence at pegasus scale for zero |r| gain.
            break
        if ls_fail and device_direct and not refactored_on_stall:
            # stale direction not a descent direction: refresh the
            # factor at the current state and retry this iteration
            device_fac.ensure(cp, h, d, force=True)
            refactored_on_stall = True
            continue
        if not ls_fail:
            # re-arm the stall refactor: a later line-search failure at
            # a NEW iterate deserves its own fresh-factor retry (the
            # one-shot latch wasted a max_it slot on a 0.5^30 no-op)
            refactored_on_stall = False
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
            print(f"  newton(host) it {it}: |r|={rn:.3e} alpha={alpha:g}")
        trace("newton.iter_accept", it=it, rn=rn, alpha=alpha,
              use_ir=int(use_ir))
        res_stalled = rn > 0.5 * rn_prev
        # residual PINNED at its achievable floor above rtol*r_ref:
        # certificate-validated Newton either contracts |r|
        # geometrically or is done — two consecutive ACCEPTED
        # iterations with <2% reduction cannot reach rtol within
        # max_it either (0.98^30 ~ 0.55). Without this stop, one
        # pegasus SLSQP evaluation burned 13 iterations with
        # bit-identical direction certificates at the floor. The
        # energy-based stall counter below misses it when Pi wiggles by
        # more than 64*eps*|Pi| of roundoff per no-op step. Gated to the Newton
        # basin (rn well below the load scale): COLD solves descend
        # the energy through transients where |r| legitimately rises
        # (SVK non-convexity) and must not be counted as pinned.
        if rn <= 1e-2 * r_ref and rn > 0.98 * rn_prev:
            pinned += 1
            if pinned >= 2:
                break
        else:
            pinned = 0
        # slow linear contraction = the frozen tangent is too stale
        # (thin-shell K changes O(1) under small d-drifts): switch to
        # exact jvp-IR directions rather than crawling or refactoring
        if device_direct and rn > 0.25 * rn_prev and rn > rtol * r_ref:
            use_ir = True
        if slope_tiny and res_stalled:
            break
        # stall only when BOTH energy and residual stopped improving
        if (Pi_new >= Pi0 - 64 * eps * abs(Pi0)) and res_stalled:
            stall += 1
            if stall >= 3:
                break
        else:
            stall = 0
        Pi0 = Pi_new
    trace("newton.exit", its=it, rn=rn)
    return d, it, rn


@jax.jit
def _jit_residual_vjp(data: SystemData, d, cp, h, lam):
    _, vjp = jax.vjp(lambda cp_, h_: residual(data, d, cp_, h_), cp, h)
    return vjp(-lam)


def _direct_adjoint_lam(data: SystemData, d, cp, h, g):
    """K(d*) lam = g on the free dofs (symmetric: adjoint == tangent),
    refined against the exact tangent so that the answer does not
    depend on the assembled matrix's rounding."""
    K = assemble_K(data, d, cp, h)
    lam = refined_solve(
        K, (g * data.free).reshape(-1),
        lambda x: tangent_matvec(data, d, cp, h,
                                 x.reshape(g.shape)).reshape(-1))
    return lam.reshape(g.shape) * data.free


@jax.jit
def _adjoint_solve_direct(data: SystemData, d, cp, h, g):
    lam = _direct_adjoint_lam(data, d, cp, h, g)
    return _jit_residual_vjp.__wrapped__(data, d, cp, h, lam)


def _pipelined_device_adjoint(data: SystemData, fac, cp, h, d, g,
                              vjp_fn, lam_ws=None, key=None):
    """Adjoint gradients on the persistent device factor with a dispatch
    PIPELINE: queue drift check + (seeded) jvp-IR solve + free-mask +
    the residual vjp back-to-back, then fetch the drift and the IR
    certificate in ONE batched readback — instead of three sequential
    readbacks of the ensure / exact_solve / vjp composition. Exactness
    still rests ONLY on the
    in-program certificate: a failed certificate discards the
    speculated vjp and falls back to the self-validating exact_solve
    (which refactors / re-sizes sweeps as needed)."""
    from goldfish_jax.utils.evtrace import enabled as _tr, trace

    trace("adjoint.enter")
    if _tr:
        # separate the COTANGENT chain (the eager AD of everything
        # outside this custom_vjp, queued before g materializes) from
        # the solve in the trace timeline — tracing-only sync
        jax.device_get(jnp.ravel(g)[0])
        trace("adjoint.g_sync")
    b = g * data.free
    x0 = None
    if lam_ws is not None and key is not None:
        x0 = lam_ws.predict(key, None)
    if fac._ref is not None:
        drift_ = fac.drift_scalar(cp, h, d)
        if _tr:
            jax.device_get(drift_)
            trace("adjoint.drift_sync")
        # dir-kernel solve (resident in the Newton loop's working set);
        # the seeded kernels re-loaded ~17 s per jac at pegasus scale
        # (see ir_solve_async_dir). x0 still seeds the exact_solve
        # fallback below.
        x, ratio_, n, rho_last_ = fac.ir_solve_async_dir(cp, h, d, b)
        lam = x * data.free
        if _tr:
            # tracing mode SERIALIZES the pipe to attribute the wall:
            # solve first, then the vjp — production keeps the
            # speculative single-readback pipeline below
            drift, ratio, rho_last = (float(v) for v in
                                      jax.device_get((drift_, ratio_,
                                                      rho_last_)))
            trace("adjoint.solve_done", n_ir=n, ratio=ratio)
            out = vjp_fn(lam)
            jax.device_get(jnp.ravel(out[0])[0])
            trace("adjoint.vjp_done")
        else:
            out = vjp_fn(lam)  # speculative: wasted only on cert failure
            drift, ratio, rho_last = (float(v) for v in
                                      jax.device_get((drift_, ratio_,
                                                      rho_last_)))
        trace("adjoint.pipe_readback", n_ir=n, ratio=ratio, drift=drift)
        if fac.finish_ir(n, ratio, tag="dir-pipe", rho_last=rho_last):
            if lam_ws is not None:
                lam_ws.update(key, lam)
            trace("adjoint.exit", path="pipe")
            return out
        # certificate failed (stale factor or bad seed): preemptively
        # refactor when grossly stale, then the slow path revalidates
        if drift > 0.2:
            fac.ensure(cp, h, d, force=True, why="adjoint-drift")
        import math as _math
        if _math.isfinite(ratio):
            # MARGINAL miss (finite certificate, e.g. 1.3e-6 vs 1e-6):
            # the speculated solve is a near-answer — seed the
            # revalidating solve with it so the fallback is a 1-2-sweep
            # top-up instead of a full unseeded redo (evtrace round-5
            # attribution: the unseeded fallback cost a whole extra IR
            # program per marginal miss). A bad seed only fails the
            # seeded certificate and exact_solve re-runs unseeded —
            # exactness never depends on the seed.
            lam = fac.exact_solve(cp, h, d, b, x0=x) * data.free
            if lam_ws is not None:
                lam_ws.update(key, lam)
            trace("adjoint.exit", path="topup")
            return vjp_fn(lam)
    else:
        fac.ensure(cp, h, d, why="adjoint")
    lam = fac.exact_solve(cp, h, d, b) * data.free
    if lam_ws is not None:
        lam_ws.update(key, lam)
    trace("adjoint.exit", path="slow")
    return vjp_fn(lam)


def adjoint_solve(data: SystemData, d, cp, h, g, host_fac=None,
                  device_fac=None, lam_ws=None):
    """Implicit-function adjoint: K lam = g, then (dcp, dh) = -lam^T
    dR/d(cp, h). The direct path is one jitted program; the mixed path
    runs the stages as separate small programs around its persistent
    factor.

    Device path: the persistent factor's jvp-matvec IR solves K(d*)
    lam = g EXACTLY (to the emulation floor) without assembling a
    fresh tangent — the refinement matvec is the matrix-free exact
    jvp, only the preconditioning substitutions use the (possibly
    stale) factor."""
    if mode() == "mixed":
        from goldfish_jax.solver import devicechol, hostsolve

        if devicechol.enabled():
            fac = device_fac if device_fac is not None \
                else devicechol.PersistentDeviceFactor(data)
            key = None
            if lam_ws is not None:
                # seed with the secant-extrapolated previous adjoint
                # (key = everything lam depends on); a bad seed only
                # fails the certificate and falls back unseeded
                key = jnp.concatenate([cp.ravel(), h.ravel(),
                                       g.ravel()])
            return _pipelined_device_adjoint(
                data, fac, cp, h, d, g,
                vjp_fn=lambda lam: _jit_residual_vjp(data, d, cp, h,
                                                     lam),
                lam_ws=lam_ws, key=key)
        blocks = _jit_blocks(data, cp, h, d)
        if hostsolve.enabled():
            fac = host_fac if host_fac is not None \
                else hostsolve.PersistentHostFactor(data)
            lam = fac.solve(blocks, g * data.free) * data.free
        else:
            lam = _jit_block_solve(data, blocks, g * data.free) * data.free
        return _jit_residual_vjp(data, d, cp, h, lam)
    return _adjoint_solve_direct(data, d, cp, h, g)


def build_solve_fn(data: SystemData, rtol=1e-10, atol=1e-14, max_it=30,
                   freeze_K=False):
    """Return a differentiable `solve(cp, h, d0) -> d`.

    `data` (BCs, quadrature tables, loads) is non-differentiable —
    design variables reach the physics only through `cp` and `h`,
    exactly the design surface of the reference (CP_IGA per field +
    thickness; reference: GOLDFISH/om_comps/disp_states_comp.py:30-50).

    On the direct path the returned function traces: wrap it, or its
    callers, in jax.jit to run a whole optimization iteration as one
    program. The mixed path composes host loops and must stay eager.
    """

    # persistent factors shared by forward and adjoint (mixed path): the
    # factorization amortizes across Newton AND optimizer iterations;
    # IR against the fresh (matrix-free) tangent keeps every adjoint
    # solve exact (solver/devicechol.py / hostsolve.py)
    from goldfish_jax.solver import devicechol, hostsolve

    pdf = None
    phf = None
    lam_ws = None
    if mode() == "mixed":
        if devicechol.enabled():
            from goldfish_jax.opt.warmstart import SecantWarmStart

            pdf = devicechol.PersistentDeviceFactor(data)
            lam_ws = SecantWarmStart()
        elif hostsolve.enabled():
            phf = hostsolve.PersistentHostFactor(data)
    # adaptive floor hint: warm-started solves stop as soon as they
    # reach the residual floor the previous solve achieved (the
    # emulated-f64 floor sits far above rtol*r_ref; without the hint
    # every warm solve burns one extra assemble+factor detecting it)
    floor_hint = [atol]
    shared = {}

    @jax.custom_vjp
    def solve(cp, h, d0):
        if mode() == "mixed":
            # host-loop forward around the persistent factor
            d, its, rn = newton_solve_host(data, cp, h, d0, rtol=rtol,
                                           atol=max(atol, floor_hint[0]),
                                           max_it=max_it, host_fac=phf,
                                           device_fac=pdf, shared=shared)
            if its < max_it:  # converged/floored, not max_it-truncated
                floor_hint[0] = max(atol, 1.5 * rn)
            return d
        d, _, _ = newton_solve(data, cp, h, d0, rtol=rtol, atol=atol,
                               max_it=max_it, freeze_K=freeze_K)
        return d

    def fwd(cp, h, d0):
        d = solve(cp, h, d0)
        return d, (d, cp, h)

    def bwd(res, g):
        d, cp, h = res
        dcp, dh = adjoint_solve(data, d, cp, h, g, host_fac=phf,
                                device_fac=pdf, lam_ws=lam_ws)
        return dcp, dh, jnp.zeros_like(d)

    solve.defvjp(fwd, bwd)
    # expose the persistent factors (prewarm / diagnostics from drivers)
    solve.device_factor = pdf
    solve.host_factor = phf
    return solve


def build_solve_fn_dataarg(rtol=1e-10, atol=1e-14, max_it=30):
    """Differentiable `solve(data, cp, h, d0) -> d` with the system
    pytree as a jit ARGUMENT rather than a closure constant.

    Required for REAL multi-process `jax.distributed` execution: a jit
    closure may not capture arrays that span non-addressable devices
    ("Closing over jax.Array that spans non-addressable devices is not
    allowed"), and the patch-sharded SystemData leaves of a global mesh
    are exactly such arrays — discovered by the 2-process test
    (tests/test_multichip.py). `build_solve_fn` (closure form) remains
    the single-process API.

    The adjoint is the same implicit-function adjoint as
    `build_solve_fn` (symmetric tangent, reference role:
    GOLDfish/om_comps/disp_states_comp.py:30-50); `data` receives zero
    cotangents (non-differentiable by design — the design surface is
    (cp, h))."""

    @jax.custom_vjp
    def solve(data, cp, h, d0):
        d, _, _ = newton_solve(data, cp, h, d0, rtol=rtol, atol=atol,
                               max_it=max_it)
        return d

    def fwd(data, cp, h, d0):
        d = solve(data, cp, h, d0)
        return d, (data, d, cp, h)

    def bwd(res, g):
        data, d, cp, h = res
        lam = _direct_adjoint_lam(data, d, cp, h, g)
        _, vjp = jax.vjp(lambda cp_, h_: residual(data, d, cp_, h_),
                         cp, h)
        dcp, dh = vjp(-lam)
        zero_data = jax.tree_util.tree_map(
            lambda x: None if x is None else jnp.zeros_like(x), data)
        return zero_data, dcp, dh, jnp.zeros_like(d)

    solve.defvjp(fwd, bwd)
    return solve


def build_field_solve_fn(data: SystemData, rtol=1e-9, atol=1e-14,
                         max_it=30):
    """Differentiable `solve(cp, h, f_field, d0) -> d` with the
    DISTRIBUTED FORCE FIELD as an explicit adjoint input (the
    aero-pressure coupling surface; reference: dRIGAdPaero +
    update_Paero, GOLDFISH/nonmatching_opt.py:1582-1665). dJ/df comes
    out of the same implicit adjoint as dJ/d(cp, h) — the coupled
    aeroelastic loop (CADDEE role) differentiates through this.

    Same path handling as build_solve_fn: host-composed Newton +
    persistent device factor on the mixed path, jitted while_loop
    Newton on the direct one.
    """
    from goldfish_jax.solver import devicechol, hostsolve

    pdf = None
    phf = None
    lam_ws = None
    if mode() == "mixed":
        if devicechol.enabled():
            from goldfish_jax.opt.warmstart import SecantWarmStart

            pdf = devicechol.PersistentDeviceFactor(data)
            lam_ws = SecantWarmStart()
        elif hostsolve.enabled():
            phf = hostsolve.PersistentHostFactor(data)
    floor_hint = [atol]

    @jax.custom_vjp
    def solve(cp, h, f, d0):
        data_f = data._replace(f_field=f)
        if mode() == "mixed":
            d, its, rn = newton_solve_host(
                data_f, cp, h, d0, rtol=rtol,
                atol=max(atol, floor_hint[0]), max_it=max_it,
                host_fac=phf, device_fac=pdf)
            if its < max_it:
                floor_hint[0] = max(atol, 1.5 * rn)
            return d
        d, _, _ = newton_solve(data_f, cp, h, d0, rtol=rtol, atol=atol,
                               max_it=max_it)
        return d

    def fwd(cp, h, f, d0):
        d = solve(cp, h, f, d0)
        return d, (d, cp, h, f)

    def bwd(res, g):
        d, cp, h, f = res
        data_f = data._replace(f_field=f)

        def vjp_fn(lam):
            _, vjp = jax.vjp(
                lambda c, hh, ff: residual(data._replace(f_field=ff),
                                           d, c, hh), cp, h, f)
            return vjp(-lam)

        if mode() == "mixed" and pdf is not None:
            # pdf's jvp matvec uses `data` WITHOUT f_field — correct:
            # a dead areal field is linear in d, so the tangent K is
            # identical; only dR/df in vjp_fn needs data_f
            key = None
            if lam_ws is not None:
                key = jnp.concatenate([cp.ravel(), h.ravel(),
                                       f.ravel(), g.ravel()])
            dc, dh, df = _pipelined_device_adjoint(
                data, pdf, cp, h, d, g, vjp_fn, lam_ws=lam_ws, key=key)
        else:
            dc, dh, df = vjp_fn(_direct_adjoint_lam(data_f, d, cp, h, g))
        return dc, dh, df, jnp.zeros_like(d)

    solve.defvjp(fwd, bwd)
    solve.device_factor = pdf
    solve.host_factor = phf
    return solve
