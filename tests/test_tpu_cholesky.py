"""Matmul-only blocked f64 Cholesky of the mixed path (run on the CPU):
correctness vs LAPACK on synthetic and real shell tangents, and the
full DeviceDirectSolver with IR."""

import jax.numpy as jnp
import numpy as np

from goldfish_jax.models import plate
from goldfish_jax.solver.blocks import compute_blocks
from goldfish_jax.solver.devicechol import (
    DeviceDirectSolver,
    dense64_from_blocks,
)
from goldfish_jax.solver.system import assemble_K
from goldfish_jax.solver.blocked_cholesky import DeviceCholesky


def test_blocked_cholesky_wide_spectrum():
    rng = np.random.default_rng(0)
    N = 600
    Q, _ = np.linalg.qr(rng.normal(size=(N, N)))
    K = (Q * np.logspace(-10, 0, N)) @ Q.T
    K = 0.5 * (K + K.T)
    b = rng.normal(size=N)
    dc = DeviceCholesky(nb=64).factor(jnp.asarray(K))
    x = np.asarray(dc.solve(jnp.asarray(b)))
    res = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert res < 1e-6, res


def test_device_direct_solver_on_shell_tangent():
    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    blocks = compute_blocks(sys.data, d0, sys.cp, sys.h_init)
    K64 = dense64_from_blocks(sys.data, blocks)
    K_ref = assemble_K(sys.data, d0, sys.cp, sys.h_init)
    assert float(jnp.max(jnp.abs(K64 - K_ref))) < 1e-12 * float(
        jnp.max(jnp.abs(K_ref)))

    rng = np.random.default_rng(1)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * sys.data.free
    dds = DeviceDirectSolver(nb=128).factor(sys.data, blocks)
    x = dds.solve(b)
    Kx = (K_ref @ x.reshape(-1)).reshape(x.shape)
    # cond ~1e10 tangent: IR floor ~cond * eps64
    res = float(jnp.linalg.norm(Kx - b) / jnp.linalg.norm(b))
    assert res < 1e-7, res


def test_padding_path():
    rng = np.random.default_rng(2)
    N = 150  # not a multiple of nb=64 -> exercises padding
    A = rng.normal(size=(N, N))
    K = A @ A.T + N * np.eye(N)
    b = rng.normal(size=N)
    dc = DeviceCholesky(nb=64).factor(jnp.asarray(K))
    x = np.asarray(dc.solve(jnp.asarray(b)))
    res = np.linalg.norm(K @ x - b) / np.linalg.norm(b)
    assert res < 1e-10, res


def test_persistent_factor_seeded_exact_solve():
    """exact_solve(x0=...): a good seed (previous adjoint) passes the
    certificate with one fewer sweep; a garbage seed falls back to the
    unseeded program and still returns the exact solution."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor

    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    fac = PersistentDeviceFactor(sys.data, nb=128)
    fac.ensure(sys.cp, sys.h_init, d0)

    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * sys.data.free
    x_ref = fac.exact_solve(sys.cp, sys.h_init, d0, b)

    # good seed: exact solution + 1e-3 relative noise
    noise = jnp.asarray(rng.normal(size=np.asarray(d0).shape))
    x0 = x_ref + 1e-3 * jnp.linalg.norm(x_ref) / jnp.linalg.norm(noise) \
        * noise * sys.data.free
    n_cert = len(fac.cert_log)
    x_seeded = fac.exact_solve(sys.cp, sys.h_init, d0, b, x0=x0)
    assert fac.cert_log[n_cert][0] == "exact-x0"
    rel = float(jnp.linalg.norm(x_seeded - x_ref)
                / jnp.linalg.norm(x_ref))
    assert rel < 1e-6, rel

    # garbage seed: certificate rejects it, unseeded fallback solves
    x_bad = fac.exact_solve(sys.cp, sys.h_init, d0, b,
                            x0=1e6 * noise * sys.data.free)
    rel = float(jnp.linalg.norm(x_bad - x_ref) / jnp.linalg.norm(x_ref))
    assert rel < 1e-6, rel
    assert not fac.nonconverged


def test_preload_loads_variants_without_policy_side_effects():
    """preload() force-loads the sweep-menu program variants (each a
    separate program — compiled or first loaded OUTSIDE timed
    regions) and must leave the adaptive-IR policy state (rho_est,
    last_ratio, cert_log, refactor count) untouched so it cannot bias
    a subsequent solve's sweep choices."""
    import pytest

    from goldfish_jax.solver.devicechol import PersistentDeviceFactor

    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    fac = PersistentDeviceFactor(sys.data, nb=128)
    with pytest.raises(RuntimeError):
        fac.preload()  # no factor yet
    fac.ensure(sys.cp, sys.h_init, d0)

    state0 = (fac.rho_est, fac.last_ratio, len(fac.cert_log),
              fac.n_factor, fac.nonconverged)
    fac.preload(menu=(1, 2))  # subset: keep the CPU test cheap
    assert (fac.rho_est, fac.last_ratio, len(fac.cert_log),
            fac.n_factor, fac.nonconverged) == state0

    # the factor still solves exactly afterwards
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) \
        * sys.data.free
    x = fac.exact_solve(sys.cp, sys.h_init, d0, b)
    assert fac.last_ratio <= 1e-6 and not fac.nonconverged
    assert np.isfinite(np.asarray(x)).all()


def test_ir_sweep_menu_quantization():
    """The adaptive IR policy only ever requests sweep counts from
    _N_MENU (each distinct count is a separate one-time-compiled XLA
    program); seeded solves discount one sweep
    BEFORE quantization so they stay on-menu too."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor as P

    menu = P._N_MENU
    assert menu == tuple(sorted(menu)) and menu[-1] == P._MAX_SWEEPS

    class Dummy:
        _RHO0, _MAX_SWEEPS, _N_MENU = P._RHO0, P._MAX_SWEEPS, P._N_MENU
    dummy = Dummy()
    for tol in (1e-3, 1e-6, 1e-10):
        for rho in (1e-4, 1e-3, 1e-2, 0.1, 0.3, 0.5, 0.7, 0.9, 2.0):
            n = P._n_for(dummy, tol, rho)
            ns = P._n_for(dummy, tol, rho, seeded=True)
            assert n in menu and ns in menu, (tol, rho, n, ns)
            assert ns <= n
    # fresh-factor fast path stays minimal; stale factor hits the cap
    assert P._n_for(dummy, 1e-6, P._RHO0) <= 3
    assert P._n_for(dummy, 1e-6, 0.9) == P._MAX_SWEEPS

    # the MI variant shares the same menu (module import only; the
    # class body aliases the policy methods)
    from goldfish_jax.solver.system_mi import PersistentDeviceFactorMI
    assert PersistentDeviceFactorMI._N_MENU == menu


def test_ir_policy_nan_certificate_is_fully_stale():
    """A non-finite IR certificate (diverged solve at a wild optimizer
    trial point) must read as a fully-stale factor, not poison rho_est:
    NaN slips through min/max (NaN comparisons are False) and
    math.ceil(NaN) raises — observed crashing the pegasus-91 SLSQP run
    inside an adjoint exact_solve."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor as P

    class Dummy:
        _RHO0, _MAX_SWEEPS, _N_MENU = P._RHO0, P._MAX_SWEEPS, P._N_MENU
        last_ratio = float("nan")

    dummy = Dummy()
    # NaN certificate -> fully stale (forces the refactor branch)
    assert P._rho(dummy, 4) == 0.9
    dummy.last_ratio = float("inf")
    assert P._rho(dummy, 2) == 0.9
    # exact certificate stays on the optimistic floor
    dummy.last_ratio = 0.0
    assert P._rho(dummy, 2) == 1e-4
    # NaN rho estimate must still yield an on-menu sweep count
    for rho in (float("nan"), float("inf"), float("-inf")):
        n = P._n_for(dummy, 1e-8, rho)
        assert n in P._N_MENU
        assert n == P._MAX_SWEEPS  # pessimistic, not crashed


def test_nonfinite_inputs_do_not_refactor_or_poison_policy():
    """A non-finite rhs/state (a diverged optimizer trial point) must
    not make exact_solve refactor at the garbage state, burn retry
    attempts up to MAX_SWEEPS programs, or poison rho_est — the NaN
    goes back to the caller, whose line search / optimizer backtracks
    (the pegasus-91 SLSQP episode, round 3: each wild line-search point
    cost a wasted refactorization plus first-in-process loads of
    16-sweep programs, tripling the measured s/iteration)."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor

    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    fac = PersistentDeviceFactor(sys.data, nb=128)
    fac.ensure(sys.cp, sys.h_init, d0)
    rng = np.random.default_rng(4)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * sys.data.free
    x_ref = fac.exact_solve(sys.cp, sys.h_init, d0, b)
    rho_before = fac.rho_est
    nf_before = fac.n_factor
    ncert = len(fac.cert_log)

    x_nan = fac.exact_solve(sys.cp, sys.h_init, d0, b * jnp.nan)
    assert not bool(jnp.isfinite(x_nan).all())
    assert fac.n_factor == nf_before        # no refactor at garbage
    assert fac.rho_est == rho_before        # policy not poisoned
    assert len(fac.cert_log) == ncert + 1   # ONE attempt, no retries
    assert not fac.nonconverged

    # newton_direction: same episode through a NaN residual
    _, slope = fac.newton_direction(sys.cp, sys.h_init, d0, b * jnp.nan)
    assert np.isnan(slope)
    assert fac.n_factor == nf_before
    assert fac.rho_est == rho_before

    # the untouched factor still solves exactly afterwards
    x2 = fac.exact_solve(sys.cp, sys.h_init, d0, b)
    rel = float(jnp.linalg.norm(x2 - x_ref) / jnp.linalg.norm(x_ref))
    assert rel < 1e-6, rel


def test_finish_ir_nonfinite_certificate_defers_policy():
    """finish_ir must NOT fold a non-finite certificate into rho_est:
    the fallback exact_solve triages the episode (garbage inputs ->
    bail; finite inputs -> refactor), and a premature rho_est=0.9 would
    make its first attempt dispatch a MAX_SWEEPS program on what is
    usually just a NaN trial point."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor as P

    class Dummy:
        _RHO0, _MAX_SWEEPS, _N_MENU = P._RHO0, P._MAX_SWEEPS, P._N_MENU
        _rho = P._rho
        _rho_meas = P._rho_meas
        last_ratio = 0.0
        rho_est = 1e-3

        def __init__(self):
            self.cert_log = []

    d = Dummy()
    assert P.finish_ir(d, 4, float("nan")) is False
    assert d.rho_est == 1e-3  # untouched: exact_solve triages next
    assert P.finish_ir(d, 4, 1e-9) is True  # healthy path unchanged


def test_rho_entry_refresh_unpins_mediocre_factor():
    """A factor whose MEASURED contraction is mediocre (rho_est >
    rho_refresh — e.g. a stall refactor landed on an unconverged
    mid-Newton iterate) keeps PASSING certificates forever while every
    direction/adjoint pays a MAX_SWEEPS program. The entry refresh
    (ported from PersistentDeviceFactorMI after the pegasus SLSQP
    episode) refactors at the next
    solve entry once the state has drifted — and ONLY then: no drift
    (just refreshed, genuinely hard system) or a non-finite state must
    not refactor."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor

    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    fac = PersistentDeviceFactor(sys.data, nb=128)
    fac.ensure(sys.cp, sys.h_init, d0)
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * sys.data.free

    # healthy estimate + drifted state: the certificate rides the
    # staleness (round-2 measured behavior), no refactor
    h2 = sys.h_init * 1.01
    n_fac = fac.n_factor
    fac.exact_solve(sys.cp, h2, d0, b)
    assert fac.n_factor == n_fac, fac.refactor_log

    # mediocre estimate + drift: the entry refresh refactors FIRST
    fac.rho_est = 0.6
    h3 = sys.h_init * 1.02
    fac.exact_solve(sys.cp, h3, d0, b)
    assert fac.n_factor == n_fac + 1
    assert fac.refactor_log[-1][0] == "rho-refresh"
    assert fac.rho_est < 0.1  # re-measured on the fresh factor

    # mediocre estimate but NO drift (just refreshed): no refactor loop
    fac.rho_est = 0.6
    n_fac = fac.n_factor
    fac.exact_solve(sys.cp, h3, d0, b)
    assert fac.n_factor == n_fac

    # non-finite state: never refresh there (poisons the factor for
    # the next healthy evaluation)
    fac.rho_est = 0.6
    n_log = len(fac.refactor_log)
    fac.newton_direction(sys.cp, h3, d0 + jnp.nan, b)
    assert all(why != "rho-refresh"
               for why, _ in fac.refactor_log[n_log:])


def test_newton_host_rides_ir_at_optimizer_step_drift():
    """An optimizer-sized design step (drift between stale_tol and the
    0.2 gross threshold) must NOT refactor the persistent factor: the
    host Newton loop switches to certificate-validated jvp-IR
    directions against the incumbent factor (the MI-path policy; the
    round-3 eager drift-refactor made every pegasus SLSQP trial and
    accepted step pay a factorization — n_refactor=8 in nit=3).
    Gross drift still refactors."""
    from goldfish_jax.solver.devicechol import PersistentDeviceFactor
    from goldfish_jax.solver.implicit import newton_solve_host

    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    fac = PersistentDeviceFactor(sys.data, nb=128)
    d1, it1, rn1 = newton_solve_host(
        sys.data, sys.cp, sys.h_init, d0, rtol=1e-9, max_it=20,
        device_fac=fac)
    assert rn1 < 1e-5

    # moderate (optimizer-step) thickness change, warm-started: NO
    # eager drift-refactor — any refactorization must come from the
    # MEASURED-contraction policies (rho-refresh / dir-cert / a failed
    # line search), which on this h^3-sensitive toy may legitimately
    # fire when the d-response to the step makes the incumbent factor
    # unable to precondition. (The round-3 code logged ('drift', ~1e-2)
    # refactors at every such entry.)
    h2 = sys.h_init * 1.02
    n_log = len(fac.refactor_log)
    d2, it2, rn2 = newton_solve_host(
        sys.data, sys.cp, h2, d1, rtol=1e-9, max_it=20, device_fac=fac)
    eager = [e for e in fac.refactor_log[n_log:]
             if e[0] == "drift" and 0.0 < e[1] <= 0.2]
    assert not eager, fac.refactor_log[n_log:]
    # solution parity vs a fresh-factor solve of the same system
    d_ref, _, _ = newton_solve_host(
        sys.data, sys.cp, h2, d0, rtol=1e-9, max_it=20)
    err = float(jnp.linalg.norm(d2 - d_ref)
                / (jnp.linalg.norm(d_ref) + 1e-300))
    assert err < 1e-6, err

    # gross drift (cold-transient scale): the entry refactor fires
    h3 = sys.h_init * 1.5
    n_fac = fac.n_factor
    d3, _, rn3 = newton_solve_host(
        sys.data, sys.cp, h3, d2, rtol=1e-9, max_it=20, device_fac=fac)
    assert fac.n_factor > n_fac
    assert any(why == "drift" for why, _ in fac.refactor_log[1:])


def test_newton_host_stops_at_residual_floor():
    """With rtol below the achievable residual floor, the host Newton
    loop must stop within a couple of iterations of the floor instead
    of burning max_it on no-op steps (one pegasus SLSQP evaluation
    burned 13 such iterations, bit-identical direction
    certificates)."""
    from goldfish_jax.solver.implicit import newton_solve_host

    sys = plate.build(num_el=3, p=2, num_patches=3)
    d0 = sys.zero_displacement()
    d_ref, it_ref, rn_ref = newton_solve_host(
        sys.data, sys.cp, sys.h_init, d0, rtol=1e-10, max_it=30)
    assert rn_ref < 1e-5  # sanity: converged (absolute |r| at this
    # scale; rtol is relative to the load-scale reference |r(0)|)

    d, it, rn = newton_solve_host(
        sys.data, sys.cp, sys.h_init, d0, rtol=0.0, atol=0.0, max_it=30)
    # stops at the floor: a handful of extra iterations at most
    assert it <= it_ref + 5, (it, it_ref)
    # and the returned state is still (at least) as converged
    assert rn <= 10 * max(rn_ref, 1e-16), (rn, rn_ref)
