"""Speculative dispatch pipelines (round 3): the warm solver paths
dispatch drift check + direction/IR solve + downstream work
back-to-back and fetch one batched readback — SPECULATING that the
persistent factor is fresh enough. Exactness must rest only on the
in-program convergence certificate, never on the speculation. These
tests pin the failure branches with deliberately stale factors:
gradients must match the dense-direct oracle bit-for-certificate, and
the cert/refactor logs must show the speculation actually failed (so
the tests are not vacuous).

Role (reference): the adjoint solves the reference delegates to
PETSc/MUMPS, GOLDFISH/utils/opt_utils.py:156-209 — exactness there is
a direct factorization property; here it is the IR certificate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.models import plate, tbeam
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver import devicechol, linalg
from goldfish_jax.solver.implicit import (
    _adjoint_solve_direct,
    adjoint_solve,
    newton_solve_host,
)
from goldfish_jax.solver.system_mi import (
    MINonMatchingSystem,
    PersistentDeviceFactorMI,
    _adjoint_solve_mi_direct,
    adjoint_solve_mi,
    newton_solve_mi_host,
)


@pytest.fixture
def mixed_mode():
    linalg.set_mode("mixed")
    yield
    linalg.set_mode(None)


def _rel(a, b):
    a = np.concatenate([np.ravel(np.asarray(x)) for x in a])
    b = np.concatenate([np.ravel(np.asarray(x)) for x in b])
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


@pytest.mark.slow  # large-scale fallback pin (80-175 s)
def test_adjoint_pipeline_stale_factor_falls_back(mixed_mode):
    """adjoint_solve speculates the vjp against the pipelined IR
    solution; with a grossly stale factor the certificate must FAIL
    and the fallback must still deliver the oracle gradient."""
    sys = plate.build(num_el=3, p=2, num_patches=3)
    data, cp, h0 = sys.data, sys.cp, sys.h_init
    fac = devicechol.PersistentDeviceFactor(data)
    d0, _, _ = newton_solve_host(data, cp, h0, sys.zero_displacement(),
                                 rtol=1e-10, device_fac=fac)

    # converged state at a GROSSLY different design (bending ~ h^3:
    # K is ~8x off), solved with a throwaway factor so `fac` stays
    # pinned at (cp, h0, d0)
    h1 = h0 * 2.0
    d1, _, _ = newton_solve_host(data, cp, h1, sys.zero_displacement(),
                                 rtol=1e-10,
                                 device_fac=devicechol.
                                 PersistentDeviceFactor(data))
    fac.ensure(cp, h0, d0, force=True)

    rng = np.random.default_rng(3)
    g = jnp.asarray(rng.normal(size=np.asarray(d1).shape)) * data.free
    n_cert = len(fac.cert_log)
    got = adjoint_solve(data, d1, cp, h1, g, device_fac=fac)
    want = _adjoint_solve_direct(data, d1, cp, h1, g)
    assert _rel(got, want) < 1e-8, _rel(got, want)

    # not vacuous: the speculated pipeline attempt must have failed its
    # certificate before the fallback succeeded (round-5: the non-MI
    # pipe runs on the DIRECTION kernel, tag "dir-pipe")
    new = fac.cert_log[n_cert:]
    assert new and new[0][0] == "dir-pipe" and new[0][2] > 1e-6, new
    assert new[-1][2] <= 1e-6, new


def test_adjoint_pipeline_warm_hit(mixed_mode):
    """The warm fast path: certificate passes in the single pipelined
    dispatch and the result equals the oracle."""
    sys = plate.build(num_el=3, p=2, num_patches=3)
    data, cp, h0 = sys.data, sys.cp, sys.h_init
    fac = devicechol.PersistentDeviceFactor(data)
    d0, _, _ = newton_solve_host(data, cp, h0, sys.zero_displacement(),
                                 rtol=1e-10, device_fac=fac)
    # the Newton solve leaves the factor pinned at an EARLIER iterate
    # (K(d) moves substantially from d=0 to equilibrium on this plate)
    # — refresh at the converged state so the pipeline attempt is
    # genuinely warm
    fac.ensure(cp, h0, d0, force=True)
    rng = np.random.default_rng(4)
    g = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * data.free
    n_cert = len(fac.cert_log)
    got = adjoint_solve(data, d0, cp, h0, g, device_fac=fac)
    want = _adjoint_solve_direct(data, d0, cp, h0, g)
    assert _rel(got, want) < 1e-8, _rel(got, want)
    new = fac.cert_log[n_cert:]
    assert len(new) == 1 and new[0][0] == "dir-pipe" \
        and new[0][2] <= 1e-6, new


def test_newton_pipeline_stale_factor_refactors(mixed_mode):
    """newton_solve_host speculates direction+trial against the current
    factor; past stale_tol the pipelined drift check must force a
    refactor and the solve must still converge to the oracle state."""
    sys = plate.build(num_el=3, p=2, num_patches=3)
    data, cp, h0 = sys.data, sys.cp, sys.h_init
    fac = devicechol.PersistentDeviceFactor(data)
    d0, _, _ = newton_solve_host(data, cp, h0, sys.zero_displacement(),
                                 rtol=1e-10, device_fac=fac)
    h1 = h0 * 2.0
    n_ref = len(fac.refactor_log)
    d1, its, rn = newton_solve_host(data, cp, h1,
                                    sys.zero_displacement(),
                                    rtol=1e-10, device_fac=fac)
    assert any(w == "drift" for w, _ in fac.refactor_log[n_ref:]), \
        fac.refactor_log[n_ref:]
    d1_ref, _, _ = newton_solve_host(
        data, cp, h1, sys.zero_displacement(), rtol=1e-10,
        device_fac=devicechol.PersistentDeviceFactor(data))
    assert _rel((d1,), (d1_ref,)) < 1e-8


def _mi_tbeam(num_el=4, p=3, n_pts=10):
    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = tbeam.create_surf(pts1, max((num_el + 1) // 2, 1),
                             num_el + 1, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=n_pts - 1)]
    sys = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU,
                              tbeam.H_TH, specs=specs,
                              n_pts_list=[n_pts])
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys


@pytest.mark.slow  # large-scale fallback pin (80-175 s)
def test_mi_adjoint_pipeline_stale_factor_falls_back(mixed_mode):
    """adjoint_solve_mi speculates the vjp against the pipelined IR
    solve (with a SPECULATED Woodbury seam correction); a grossly
    stale factor must fail the certificate and fall back to the
    self-validating exact_solve — gradient still equals the dense
    oracle."""
    sys = _mi_tbeam()
    data, mi, co, ss = sys.data, sys.mi, sys.co, sys.ss
    p, q = sys.pdeg, sys.qdeg
    h0 = sys.h_init
    cp = sys.cp
    xi = sys.c2x.solve(cp)
    fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    d0, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, cp, h0, xi,
                                    sys.zero_displacement(),
                                    rtol=1e-9, device_fac=fac)

    h1 = h0 * 2.0
    d1, _, _ = newton_solve_mi_host(
        data, mi, co, ss, p, q, cp, h1, xi, sys.zero_displacement(),
        rtol=1e-9,
        device_fac=PersistentDeviceFactorMI(data, mi, co, ss, p, q))
    fac.ensure(cp, h0, xi, d0, force=True)
    fac.prepare(cp, h0, xi, d0)

    rng = np.random.default_rng(5)
    g = jnp.asarray(rng.normal(size=np.asarray(d1).shape)) * data.free
    n_cert = len(fac.cert_log)
    got = adjoint_solve_mi(data, mi, co, ss, p, q, d1, cp, h1, xi, g,
                           device_fac=fac)
    want = _adjoint_solve_mi_direct(data, mi, co, ss, p, q, d1, cp, h1,
                                    xi, g)
    assert _rel(got, want) < 1e-8, _rel(got, want)
    new = fac.cert_log[n_cert:]
    assert new and new[0][0] == "exact-pipe" and new[0][2] > 1e-6, new
    assert new[-1][2] <= 1e-6, new


def test_mi_rho_refresh_unpins_mediocre_factor(mixed_mode):
    """The round-3 MI bench regression: a factor pinned at a bad state
    (e.g. the last dir-cert refactor of a COLD solve lands on an
    unconverged mid-Newton iterate) passes every certificate at
    rho ~0.26/sweep forever — no drift heuristic fires, and every
    direction/adjoint pays 3x the jvp sweeps. The rho-aware entry
    refresh must spend ONE refactorization at the next warm entry and
    restore fresh-grade contraction (n=6 certs ~3e-4 before, n=2
    certs ~1e-7..1e-11 after)."""
    sys = _mi_tbeam()
    data, mi, co, ss = sys.data, sys.mi, sys.co, sys.ss
    p, q = sys.pdeg, sys.qdeg
    h0, cp = sys.h_init, sys.cp
    xi = sys.c2x.solve(cp)
    fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    d0, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, cp, h0, xi,
                                    sys.zero_displacement(),
                                    rtol=1e-9, device_fac=fac)
    # pin the factor at a mid-Newton-grade iterate (~3e-2 d-stale, the
    # drift observed in such a warm loop — BELOW the 0.2 gross-
    # staleness branch) and seed rho_est with the measured-mediocre
    # value the warm loop's finish_ir would have left (the policy keys
    # on MEASURED contraction, not a drift heuristic)
    fac.ensure(cp, h0, xi, 0.97 * d0, force=True, why="test-pin")
    fac.prepare(cp, h0, xi, 0.97 * d0)
    fac.rho_est = 0.26

    m = sys.metas[1]
    cp1 = cp.at[1, : m.n_cp, 0].add(1e-2)  # drift > stale_tol, << 0.2
    xi1 = sys.c2x.solve(cp1, xi)
    n_ref = len(fac.refactor_log)
    d1, _, rn1 = newton_solve_mi_host(data, mi, co, ss, p, q, cp1, h0,
                                      xi1, d0, rtol=1e-9,
                                      device_fac=fac)
    whys = [w for w, _ in fac.refactor_log[n_ref:]]
    assert whys == ["mi-entry-rho"], fac.refactor_log[n_ref:]
    assert rn1 < 1e-6
    # fresh-grade contraction restored: the next warm solve must ride
    # the refreshed factor with NO further refactorizations
    assert fac.rho_est < fac.rho_refresh, fac.rho_est
    cp2 = cp.at[1, : m.n_cp, 0].add(1.1e-2)
    xi2 = sys.c2x.solve(cp2, xi1)
    n_ref = len(fac.refactor_log)
    d2, _, rn2 = newton_solve_mi_host(data, mi, co, ss, p, q, cp2, h0,
                                      xi2, d1, rtol=1e-9,
                                      device_fac=fac)
    assert fac.refactor_log[n_ref:] == [], fac.refactor_log[n_ref:]
    assert rn2 < 1e-6


def test_mi_adjoint_pipeline_warm_hit(mixed_mode):
    """MI warm fast path: one pipelined dispatch, certificate passes,
    oracle-exact output."""
    sys = _mi_tbeam()
    data, mi, co, ss = sys.data, sys.mi, sys.co, sys.ss
    p, q = sys.pdeg, sys.qdeg
    h0, cp = sys.h_init, sys.cp
    xi = sys.c2x.solve(cp)
    fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    d0, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, cp, h0, xi,
                                    sys.zero_displacement(),
                                    rtol=1e-9, device_fac=fac)
    rng = np.random.default_rng(6)
    g = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * data.free
    n_cert = len(fac.cert_log)
    got = adjoint_solve_mi(data, mi, co, ss, p, q, d0, cp, h0, xi, g,
                           device_fac=fac)
    want = _adjoint_solve_mi_direct(data, mi, co, ss, p, q, d0, cp, h0,
                                    xi, g)
    assert _rel(got, want) < 1e-8, _rel(got, want)
    new = fac.cert_log[n_cert:]
    assert len(new) == 1 and new[0][0] == "exact-pipe" \
        and new[0][2] <= 1e-6, new


def test_mi_nonfinite_inputs_do_not_refactor_or_poison_policy(mixed_mode):
    """MI variant of the devicechol NaN triage (see the blocked-Cholesky
    tests): a non-finite rhs through the MI
    persistent factor must not refactor at the garbage state, burn
    retry attempts, or poison rho_est — and the untouched factor must
    still solve exactly afterwards."""
    sys = _mi_tbeam()
    data, mi, co, ss = sys.data, sys.mi, sys.co, sys.ss
    p, q = sys.pdeg, sys.qdeg
    h0, cp = sys.h_init, sys.cp
    xi = sys.c2x.solve(cp)
    fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    d0, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, cp, h0, xi,
                                    sys.zero_displacement(),
                                    rtol=1e-9, device_fac=fac)
    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * data.free
    x_ref = fac.exact_solve(cp, h0, xi, d0, b)
    rho_before, nf_before = fac.rho_est, fac.n_factor
    ncert = len(fac.cert_log)

    x_nan = fac.exact_solve(cp, h0, xi, d0, b * jnp.nan)
    assert not bool(jnp.isfinite(x_nan).all())
    assert fac.n_factor == nf_before        # no refactor at garbage
    assert fac.rho_est == rho_before        # policy not poisoned
    assert len(fac.cert_log) == ncert + 1   # ONE attempt, no retries

    _, slope = fac.newton_direction(cp, h0, xi, d0, b * jnp.nan)
    assert np.isnan(slope)
    assert fac.n_factor == nf_before
    assert fac.rho_est == rho_before

    x2 = fac.exact_solve(cp, h0, xi, d0, b)
    rel = _rel(x2, x_ref)
    assert rel < 1e-6, rel
