"""End-to-end thickness optimization (the reference's headline
demo path: demos_om/thickness_opt/plate/plate_var_th_opt_wint.py):
minimize internal energy s.t. constant material volume, thickness
parametrized by an FFD block with align constraints. Expect material to
migrate toward the clamped root."""

import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.design.constraints import align_operator
from goldfish_jax.design.pipeline import ThicknessFFD
from goldfish_jax.models import plate
from goldfish_jax.opt.problem import OptProblem
from goldfish_jax.physics import kl_shell
from goldfish_jax.solver.implicit import build_solve_fn


@pytest.fixture(scope="module")
def plate_sys():
    return plate.build(num_el=3, p=2, num_patches=3)


def test_edge_load_deflection(plate_sys):
    sys = plate_sys
    d = sys.solve_nonlinear()
    u = sys.evaluate_displacement(d, 2, [1.0, 0.5])
    assert u[2] < 0.0  # downward load -> downward tip deflection
    # small-deflection regime sanity: |w| under plate thickness scale
    assert abs(u[2]) < 0.2


def test_thickness_ffd_map(plate_sys):
    sys = plate_sys
    th = ThicknessFFD(sys, num_els=(2, 1, 1), p=(2, 1, 1))
    h = th(jnp.asarray(th.init_h_ffd(plate.H_TH)))
    # partition of unity: constant design reproduces constant thickness
    mask = np.asarray(sys.stack.cp_mask)
    err = np.abs((np.asarray(h) - plate.H_TH) * mask).max()
    assert err < 1e-12


def test_plate_thickness_optimization(plate_sys):
    sys = plate_sys
    th = ThicknessFFD(sys, num_els=(2, 1, 1), p=(2, 1, 1))
    solve = build_solve_fn(sys.data, rtol=1e-11, max_it=20)
    cp = sys.cp
    h_ffd0 = th.init_h_ffd(plate.H_TH)
    V0 = float(sys.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys.stack, d, cp, h, sys.E, sys.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys.stack, cp, th(dvs["h_ffd"]))

    # uniform across width (y) and through z: thickness varies in x only
    Aall = jnp.asarray(align_operator(th.shape, axis=(1, 2)))

    prob = OptProblem()
    prob.add_design_var("h_ffd", h_ffd0, lower=plate.H_TH / 20,
                        upper=plate.H_TH * 20, scaler=1e2)
    prob.set_objective(obj, scaler=1e-1, state0=sys.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("align", lambda dvs: Aall @ dvs["h_ffd"],
                        equals=np.zeros(Aall.shape[0]))
    res = prob.run_slsqp(maxiter=20, tol=1e-12)

    J0, _ = obj({"h_ffd": jnp.asarray(h_ffd0)}, sys.zero_displacement())
    Jop, _ = obj({"h_ffd": jnp.asarray(res.x["h_ffd"])},
                 sys.zero_displacement())
    assert float(Jop) < 0.7 * float(J0), (float(Jop), float(J0))
    # volume preserved
    Vop = float(vol({"h_ffd": jnp.asarray(res.x["h_ffd"])}))
    assert abs(Vop - V0) / V0 < 1e-4
    # thicker at the clamped root than at the loaded tip
    h_op = np.asarray(th(jnp.asarray(res.x["h_ffd"])))
    root = h_op[0][np.asarray(sys.stack.cp_mask[0]) > 0].max()
    tip = h_op[2][np.asarray(sys.stack.cp_mask[2]) > 0].min()
    assert root > tip


def test_patch_constant_thickness_map(plate_sys):
    """PatchConstantThickness: one dof per patch broadcast to every
    real CP of that patch, zero on padding (the reference's HthMap
    block-of-ones, GOLDFISH/om_comps/ffd_comps/hth_map_comp.py:48-56)."""
    import jax

    from goldfish_jax.design.pipeline import PatchConstantThickness

    sys = plate_sys
    th = PatchConstantThickness(sys)
    v = jnp.asarray([0.01, 0.02, 0.03])
    h = th(v)
    assert h.shape == sys.h_init.shape
    for i, m in enumerate(sys.metas):
        assert np.allclose(np.asarray(h[i, : m.n_cp]), float(v[i]))
        assert np.allclose(np.asarray(h[i, m.n_cp:]), 0.0)
    # init_h broadcasts a scalar and copies a per-patch vector
    assert np.allclose(th.init_h(0.05), 0.05)
    assert np.allclose(th.init_h([1.0, 2.0, 3.0]), [1.0, 2.0, 3.0])
    # the map is linear: exact jacobian-vector identity
    g = jax.grad(lambda vv: jnp.sum(th(vv) ** 2))(v)
    expect = np.asarray([2 * float(v[i]) * m.n_cp
                         for i, m in enumerate(sys.metas)])
    assert np.allclose(np.asarray(g), expect)
