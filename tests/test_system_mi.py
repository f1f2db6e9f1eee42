"""Moving-intersection system: physics consistency with the static
path + FULL-CHAIN shape-gradient parity (CP -> xi -> d -> J), the
rebuild's answer to the reference's entire shape_opt_mint machinery
(SURVEY.md section 3.2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.models import tbeam
from goldfish_jax.physics import kl_shell
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver.system_mi import MINonMatchingSystem


def _mi_tbeam(num_el=4, p=3, n_pts=17):
    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = tbeam.create_surf(pts1, max((num_el + 1) // 2, 1), num_el + 1, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=n_pts - 1)]
    sys = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU, tbeam.H_TH,
                              specs=specs, n_pts_list=[n_pts])
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys


@pytest.fixture(scope="module")
def mi_sys():
    return _mi_tbeam()


def test_mi_matches_static_coupling(mi_sys):
    """At the reference configuration the MI solve must agree with the
    fixed-intersection solve (different interface quadrature -> small
    tolerance)."""
    static = tbeam.build(num_el=4, p=3)
    d_static = static.solve_nonlinear(rtol=1e-11)
    u_static = static.evaluate_displacement(d_static, 0, [1.0, 1.0])

    d_mi = mi_sys.solve_nonlinear(rtol=1e-11)
    u_mi = mi_sys.evaluate_displacement(d_mi, 0, [1.0, 1.0])
    assert abs(u_mi[2] - u_static[2]) / abs(u_static[2]) < 2e-2, (
        u_mi[2], u_static[2])


def test_full_chain_shape_gradient(mi_sys):
    """d/d(amp) of strain energy where amp bends the web, moving the
    intersection: AD through BOTH implicit solves vs central FD."""
    sys = mi_sys
    forward = sys.build_forward(rtol=1e-11, max_it=25)
    d0 = sys.zero_displacement()
    m = sys.metas[1]
    gv = sys.surfs[1].greville_points(1)
    bend = jnp.asarray(np.tile(np.sin(np.pi * gv)[None, :],
                               (m.n_u, 1)).ravel())

    def J(amp):
        cp = sys.cp.at[1, : m.n_cp, 0].add(amp * bend)
        d, xi = forward(cp, sys.h_init, d0)
        return kl_shell.internal_energy(sys.stack, d, cp, sys.h_init,
                                        sys.E, sys.nu)

    amp0 = jnp.asarray(0.05)
    g = jax.grad(J)(amp0)
    eps = 1e-5
    fd = (J(amp0 + eps) - J(amp0 - eps)) / (2 * eps)
    assert abs(float(g - fd)) / abs(float(fd)) < 1e-5, (float(g), float(fd))


def _mi_cross(num_el=3, p=2, n_pts_list=(5, 9)):
    """Flange + TWO webs at different chord positions: two intersections
    with UNEQUAL point counts, so the shorter one's xi rows are padded
    (the advisor's round-1 NaN repro: padded points replicate the last
    real point -> zero neighbor-difference tangent -> _unit(0) NaN)."""
    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[-w2 / 2, 0, 0], [-w2 / 2, 0, -tbeam.DEPTH],
            [-w2 / 2, tbeam.LENGTH, 0], [-w2 / 2, tbeam.LENGTH, -tbeam.DEPTH]]
    pts2 = [[w2 / 2, 0, 0], [w2 / 2, 0, -tbeam.DEPTH],
            [w2 / 2, tbeam.LENGTH, 0], [w2 / 2, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, num_el, num_el, p)
    srf1 = tbeam.create_surf(pts1, max(num_el // 2, 1), num_el, p)
    srf2 = tbeam.create_surf(pts2, max(num_el // 2, 1), num_el + 1, p)
    specs = [
        InterfaceSpec(pair=(0, 1),
                      xi_ends_A=np.array([[0.25, 0.0], [0.25, 1.0]]),
                      xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                      n_mortar_el=n_pts_list[0] - 1),
        InterfaceSpec(pair=(0, 2),
                      xi_ends_A=np.array([[0.75, 0.0], [0.75, 1.0]]),
                      xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                      n_mortar_el=n_pts_list[1] - 1),
    ]
    sys = MINonMatchingSystem([srf0, srf1, srf2], tbeam.E, tbeam.NU,
                              tbeam.H_TH, specs=specs,
                              n_pts_list=list(n_pts_list))
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_side_bc(2, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys


def test_heterogeneous_npts_finite():
    """Unequal n_pts across intersections: energy/residual/solve must be
    finite (round-1 advisor high-severity finding)."""
    from goldfish_jax.solver.system_mi import residual_mi, total_potential_mi

    sys = _mi_cross()
    xi = sys.c2x.solve(sys.cp)
    assert bool(jnp.all(jnp.isfinite(xi)))
    d0 = sys.zero_displacement()
    Pi = total_potential_mi(sys.data, sys.mi, sys.co, sys.ss, sys.pdeg,
                            sys.qdeg, d0, sys.cp, sys.h_init, xi)
    assert bool(jnp.isfinite(Pi)), float(Pi)
    r = residual_mi(sys.data, sys.mi, sys.co, sys.ss, sys.pdeg, sys.qdeg,
                    d0, sys.cp, sys.h_init, xi)
    assert bool(jnp.all(jnp.isfinite(r)))
    d = sys.solve_nonlinear(rtol=1e-10)
    assert bool(jnp.all(jnp.isfinite(d)))
    u = sys.evaluate_displacement(d, 0, [1.0, 1.0])
    assert bool(jnp.all(jnp.isfinite(u))) and abs(float(u[2])) > 0.0


def test_heterogeneous_npts_gradient():
    """Full-chain gradient with padded intersections stays FD-exact."""
    sys = _mi_cross()
    forward = sys.build_forward(rtol=1e-11, max_it=25)
    d0 = sys.zero_displacement()
    m = sys.metas[1]
    gv = sys.surfs[1].greville_points(1)
    bend = jnp.asarray(np.tile(np.sin(np.pi * gv)[None, :],
                               (m.n_u, 1)).ravel())

    def J(amp):
        cp = sys.cp.at[1, : m.n_cp, 0].add(amp * bend)
        d, xi = forward(cp, sys.h_init, d0)
        return kl_shell.internal_energy(sys.stack, d, cp, sys.h_init,
                                        sys.E, sys.nu)

    amp0 = jnp.asarray(0.03)
    g = jax.grad(J)(amp0)
    eps = 1e-5
    fd = (J(amp0 + eps) - J(amp0 - eps)) / (2 * eps)
    assert abs(float(g - fd)) / abs(float(fd)) < 1e-5, (float(g), float(fd))


def test_edge_to_edge_intersections_tube():
    """Co-tangent edge-to-edge seams (4-patch cylinder): the raw 3D
    coincidence Jacobian is RANK-2 per point; the edge-constraint
    bookkeeping (both edge coordinates pinned + along-curve projection)
    must make the xi solve regular — and the full chain must stay
    FD-differentiable (reference edge machinery,
    GOLDFISH/cpiga2xi.py:231-302)."""
    from goldfish_jax.models import tube

    base = tube.build(num_el=2, p=2, pressure=2.0e4)
    sys = MINonMatchingSystem(base.surfs, tube.E, tube.NU, tube.H_TH,
                              specs=base.specs,
                              n_pts_list=[7] * len(base.specs))
    for k in range(4):
        sys.add_side_bc(k, direction=0, side=0, n_layers=2)
    sys.set_pressure([2.0e4] * 4)
    assert bool(jnp.all(sys.mi.both_edges > 0.5))

    # ovalized control points: the previously-singular configuration
    cp1 = sys.cp.at[..., 0].multiply(1.05).at[..., 1].multiply(0.96)
    xi = sys.c2x.solve(cp1)
    assert bool(jnp.all(jnp.isfinite(xi)))
    rn = sys.c2x.residual_norm(cp1, xi)
    assert float(rn) < 1e-9, float(rn)

    # full-chain gradient through the edge-to-edge xi solve
    forward = sys.build_forward(rtol=1e-10, max_it=25)
    d0 = sys.zero_displacement()

    def J(s):
        cp = sys.cp.at[..., 0].multiply(1.0 + s)
        d, _ = forward(cp, sys.h_init, d0)
        return kl_shell.internal_energy(sys.stack, d, cp, sys.h_init,
                                        sys.E, sys.nu)

    s0 = jnp.asarray(0.02)
    g = jax.grad(J)(s0)
    eps = 1e-5
    fd = (J(s0 + eps) - J(s0 - eps)) / (2 * eps)
    assert abs(float(g - fd)) / abs(float(fd)) < 1e-5, (float(g),
                                                        float(fd))


@pytest.mark.slow  # large-scale MI policy pin (150-220 s)
def test_woodbury_seam_correction():
    """The xi-staleness killer (round-3 hardware finding): after one
    optimizer-sized design step the persistent factor's IR contraction
    collapses along the Newton direction (rho O(0.3-1)) because the
    seam quadrature moved. The Woodbury correction (prepare()) must
    restore certificate-grade contraction WITHOUT refactoring, and the
    corrected exact_solve must match a direct solve."""
    from goldfish_jax.solver.system_mi import (
        PersistentDeviceFactorMI,
        _jit_res_pot_mi,
        _jvp_ir_solve_mi,
        _jvp_ir_solve_mi_wb,
        assemble_K_mi,
        newton_solve_mi_host,
    )

    sys = _mi_tbeam(num_el=6, p=3, n_pts=9)
    data, mi, co, ss = sys.data, sys.mi, sys.co, sys.ss
    p, q = sys.pdeg, sys.qdeg
    h = sys.h_init
    m = sys.metas[1]
    gv = sys.surfs[1].greville_points(1)
    bend = jnp.asarray(np.tile(np.sin(np.pi * gv)[None, :],
                               (m.n_u, 1)).ravel())

    def make_cp(amp):
        return sys.cp.at[1, : m.n_cp, 0].add(amp * bend)

    cp0 = make_cp(0.05)
    xi0 = sys.c2x.solve(cp0)
    fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    d0, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, cp0, h,
                                    xi0, sys.zero_displacement(),
                                    rtol=1e-9, device_fac=fac)
    fac.ensure(cp0, h, xi0, d0, force=True)

    # one bench-sized design step; solve, then RE-PIN the factor (and
    # its Woodbury reference) at the OLD state to make it stale
    cp1 = make_cp(0.05 * 1.01)
    xi1 = sys.c2x.solve(cp1, xi0)
    d1, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, cp1, h,
                                    xi1, d0, rtol=1e-9, device_fac=fac)
    fac.ensure(cp0, h, xi0, d0, force=True)

    r1, _, _ = _jit_res_pot_mi(data, mi, co, ss, p, q, cp1, h, xi1, d1)
    b = -r1
    _, ratio_plain = _jvp_ir_solve_mi(
        data, mi, co, ss, fac.dc._L, fac.dc._invs, fac.dc._dscale,
        cp1, h, xi1, d1, b, p=p, q=q, nb=fac.dc.nb, n_ir=2)

    nf = fac.n_factor
    fac.prepare(cp1, h, xi1, d1)
    assert fac.n_factor == nf, "prepare must not refactor here"
    x_wb, ratio_wb = _jvp_ir_solve_mi_wb(
        data, mi, co, ss, fac.dc._L, fac.dc._invs, fac.dc._dscale,
        fac._Uoh, fac._V, cp1, h, xi1, d1, b,
        p=p, q=q, nb=fac.dc.nb, n_ir=2)
    # correction restores certificate-grade contraction on the stale
    # factor and beats the uncorrected solve by orders of magnitude
    assert float(ratio_wb) < 1e-4, float(ratio_wb)
    assert float(ratio_wb) < 1e-2 * float(ratio_plain), (
        float(ratio_wb), float(ratio_plain))

    # corrected exact_solve agrees with a direct dense solve
    lam_wb = fac.exact_solve(cp1, h, xi1, d1, b)
    K1 = assemble_K_mi(data, mi, co, ss, p, q, d1, cp1, h, xi1)
    lam_ref = jnp.linalg.solve(K1, b.reshape(-1)).reshape(b.shape)
    rel = float(jnp.linalg.norm(lam_wb - lam_ref)
                / (jnp.linalg.norm(lam_ref) + 1e-300))
    assert rel < 1e-8, rel


@pytest.mark.slow  # large-scale MI policy pin (150-220 s)
def test_mi_preload_no_policy_side_effects(mi_sys):
    """PersistentDeviceFactorMI.preload() force-loads the WB-IR
    sweep-menu program variants (compiled or first loaded outside timed
    regions) without touching the adaptive-IR policy state, and the
    factor still solves exactly afterwards."""
    import pytest

    from goldfish_jax.solver.system_mi import (
        PersistentDeviceFactorMI,
        newton_solve_mi_host,
    )

    sys = mi_sys
    data, mi, co, ss = sys.data, sys.mi, sys.co, sys.ss
    p, q = sys.pdeg, sys.qdeg
    fac = PersistentDeviceFactorMI(data, mi, co, ss, p, q)
    with pytest.raises(RuntimeError):
        fac.preload()  # no factor yet
    xi0 = sys.c2x.solve(sys.cp)
    d0, _, _ = newton_solve_mi_host(data, mi, co, ss, p, q, sys.cp,
                                    sys.h_init, xi0,
                                    sys.zero_displacement(),
                                    rtol=1e-9, device_fac=fac)
    fac.ensure(sys.cp, sys.h_init, xi0, d0, force=True)

    state0 = (fac.rho_est, fac.last_ratio, len(fac.cert_log),
              fac.n_factor, fac.nonconverged)
    fac.preload(menu=(1, 2))  # subset: keep the CPU test cheap
    assert (fac.rho_est, fac.last_ratio, len(fac.cert_log),
            fac.n_factor, fac.nonconverged) == state0

    rng = np.random.default_rng(7)
    b = jnp.asarray(rng.normal(size=np.asarray(d0).shape)) * data.free
    x = fac.exact_solve(sys.cp, sys.h_init, xi0, d0, b)
    assert fac.last_ratio <= 1e-6 and not fac.nonconverged
    assert np.isfinite(np.asarray(x)).all()
