"""Objective library: aggregation accuracy + differentiability
(reference analogue: operations/max_vmstress_exop.py __main__ checks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.models import plate
from goldfish_jax.physics import kl_shell, objectives
from goldfish_jax.solver.implicit import build_solve_fn


@pytest.fixture(scope="module")
def solved_plate():
    sys = plate.build(num_el=3, p=2, num_patches=3)
    d = sys.solve_nonlinear(rtol=1e-12)
    return sys, d


def test_compliance_clapeyron(solved_plate):
    sys, d = solved_plate
    W = float(objectives.internal_energy(sys.data, d, sys.cp, sys.h_init))
    C = float(objectives.compliance(sys.data, d, sys.cp, sys.h_init))
    # linear regime: compliance ~ 2 * strain energy (Clapeyron)
    assert abs(C - 2 * W) / C < 0.02, (C, 2 * W)


@pytest.mark.parametrize("method", ["KS", "pnorm", "induced power"])
def test_max_vm_aggregation_close_to_true_max(solved_plate, method):
    sys, d = solved_plate
    s = kl_shell.qp_stress_vm(sys.stack, d, sys.cp, sys.h_init,
                              sys.E, sys.nu, through="top")
    wq = np.asarray(sys.stack.wq)
    true_max = float(np.max(np.where(wq > 0, np.asarray(s), 0.0)))
    agg = float(objectives.max_vm_stress(sys.data, d, sys.cp, sys.h_init,
                                         rho=200.0, method=method))
    assert abs(agg - true_max) / true_max < 0.25, (method, agg, true_max)


def test_max_vm_gradient_parity(solved_plate):
    sys, _ = solved_plate
    solve = build_solve_fn(sys.data, rtol=1e-11, max_it=25)
    d0 = sys.zero_displacement()
    cp = sys.cp

    # freeze the normalization constants so FD and AD see the same
    # functional (the reference recomputes m per linearize the same way)
    d_star = solve(cp, sys.h_init, d0)
    s = kl_shell.qp_stress_vm(sys.stack, d_star, cp, sys.h_init,
                              sys.E, sys.nu, through="top")
    m = float(np.max(np.where(np.asarray(sys.stack.wq) > 0,
                              np.asarray(s), 0.0)))

    # KS rho is DIMENSIONAL (1/stress), reference semantics
    # (max_vmstress_exop.KS_symexp): pick rho so rho*m ~ 50
    rho = 50.0 / m

    def J(h):
        d = solve(cp, h, d0)
        return objectives.max_vm_stress(sys.data, d, cp, h, rho=rho,
                                        method="KS", m=m)

    g = jax.grad(J)(sys.h_init)
    rng = np.random.default_rng(3)
    v = jnp.asarray(rng.normal(size=sys.h_init.shape)
                    * np.asarray(sys.stack.cp_mask))
    eps = 1e-6
    fd = (J(sys.h_init + eps * v) - J(sys.h_init - eps * v)) / (2 * eps)
    ad = jnp.sum(g * v)
    assert abs(float(ad - fd)) / abs(float(fd)) < 1e-5, (float(ad), float(fd))


def test_compliance_includes_f_field():
    """compliance() must include the areal-field (aero-coupling) work
    term — round-1 verdict: it was silently dropped. Clapeyron check
    with ONLY an f_field load: C ~ 2 W_int in the linear regime."""
    sys = plate.build(num_el=3, p=2, num_patches=2)
    # strip the default load, apply a distributed CP coefficient field
    sys.f_areal = None
    sys.edge_load_entries = []
    sys.point_load_entries = []
    sys._data = None
    f = np.zeros((sys.num_splines, sys.stack.max_cp, 3))
    f[:, :, 2] = 1.0e-2
    sys.set_areal_field(f)
    d = sys.solve_nonlinear(rtol=1e-12)
    W = float(objectives.internal_energy(sys.data, d, sys.cp, sys.h_init))
    C = float(objectives.compliance(sys.data, d, sys.cp, sys.h_init))
    assert C != 0.0
    assert abs(C - 2 * W) / abs(C) < 0.02, (C, 2 * W)


def test_vmstress_field_operation(solved_plate):
    """Per-qp von Mises FIELD operation (reference
    csdl_models/vmstress_model.py role): values match qp_stress_vm and
    the dense Jacobian FD-verifies."""
    from goldfish_jax.design.pipeline import CPLayout
    from goldfish_jax.operations.exops import VMStressExOperation

    sys, d = solved_plate
    op = VMStressExOperation(sys, through="top")
    lay = CPLayout(sys.metas, sys.stack.max_cp)
    cp_f = np.asarray(lay.to_flat(sys.cp)).ravel()
    h_f = np.asarray(lay.to_flat(sys.h_init[..., None])).ravel()
    d_f = np.asarray(lay.to_flat(d)).ravel()

    s_vec = op.compute(cp_f, h_f, d_f)
    s_full = np.asarray(kl_shell.qp_stress_vm(
        sys.stack, d, sys.cp, sys.h_init, sys.E, sys.nu,
        through="top")).reshape(-1)
    keep = np.asarray(sys.stack.wq).reshape(-1) > 0
    assert np.allclose(s_vec, s_full[keep])
    assert s_vec.size == keep.sum()

    _, _, Ju = op.jacobians(cp_f, h_f, d_f)
    rng = np.random.default_rng(3)
    v = rng.normal(size=d_f.size)
    # step scaled to the displacement magnitude: the stress field is
    # strongly nonlinear in d at this load level (FD truncation decays
    # as eps^2: measured 1e-2 at eps_rel=1e-4, 1.1e-4 at 1e-5)
    eps = 1e-5 * np.linalg.norm(d_f) / np.linalg.norm(v)
    fd = (op.compute(cp_f, h_f, d_f + eps * v)
          - op.compute(cp_f, h_f, d_f - eps * v)) / (2 * eps)
    an = Ju @ v
    assert np.linalg.norm(an - fd) / np.linalg.norm(fd) < 1e-3


def test_cp_regu_energy():
    """Per-patch CP-smoothness regularization (the reference eVTOL
    int_energy_regu term): zero at the initial design, positive and
    growing for wiggly CP perturbations, exact AD gradient."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from goldfish_jax.models import tbeam
    from goldfish_jax.physics.objectives import (
        cp_regu_energy,
        internal_energy_regu,
    )

    sys = tbeam.build(num_el=4, p=3)
    data = sys.data
    cp0 = sys.cp

    r0 = cp_regu_energy(data, cp0, cp0, regu_para=1.0)
    assert float(jnp.sum(jnp.abs(r0))) == 0.0

    # gradient-only penalty: a rigid CP shift costs nothing, a ramp
    # costs something, and the form is exactly quadratic in amplitude
    m = sys.metas[0]
    gv = np.asarray(sys.surfs[0].greville_points(1))
    ramp = np.tile(gv[None, :], (m.n_u, 1)).ravel()
    amp = 1e-3
    cp_shift = cp0.at[0, : m.n_cp, 2].add(amp)
    cp_r1 = cp0.at[0, : m.n_cp, 2].add(amp * jnp.asarray(ramp))
    cp_r2 = cp0.at[0, : m.n_cp, 2].add(2 * amp * jnp.asarray(ramp))
    r_shift = float(jnp.sum(cp_regu_energy(data, cp_shift, cp0, 1.0)))
    r1 = float(jnp.sum(cp_regu_energy(data, cp_r1, cp0, 1.0)))
    r2 = float(jnp.sum(cp_regu_energy(data, cp_r2, cp0, 1.0)))
    assert r_shift < 1e-12 * r1
    assert r1 > 0
    assert abs(r2 - 4.0 * r1) / r1 < 1e-10
    cp_s = cp_r1

    # AD gradient of W_int + regu wrt cp vs central FD
    d = sys.solve_nonlinear(rtol=1e-10)
    f = lambda cp: internal_energy_regu(data, d, cp, sys.h_init, cp0,
                                        regu_para=1e3)
    g = jax.grad(f)(cp_s)
    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=np.asarray(cp0).shape)
                    * np.asarray(sys.stack.cp_mask)[..., None])
    eps = 1e-6
    fd = (f(cp_s + eps * v) - f(cp_s - eps * v)) / (2 * eps)
    ad = float(jnp.sum(g * v))
    assert abs(ad - float(fd)) / abs(float(fd)) < 1e-6


def test_int_energy_regu_exop_and_comp():
    """IntEnergyReguExOperation + the OM comp: value consistency and
    FD-verified partials through the om(_shim) graph."""
    import numpy as np

    try:
        import openmdao.api as om
    except ModuleNotFoundError:
        from goldfish_jax.om_shim import api as om

    from goldfish_jax.models import tbeam
    from goldfish_jax.om_comps.components import IntEnergyReguComp

    sys = tbeam.build(num_el=3, p=2)
    comp = IntEnergyReguComp(nonmatching_sys=sys,
                             op_kwargs=dict(regu_para=1e3))
    comp.init_parameters()
    model = om.Group()
    model.add_subsystem("regu", comp)
    prob = om.Problem(model=model)
    prob.setup()
    d = sys.solve_nonlinear(rtol=1e-10)
    lay = comp.op.layout
    prob["regu.displacements"] = np.array(
        lay.to_flat(d), copy=True).ravel()
    # perturb cp so the regu term is active
    cp = np.array(lay.to_flat(sys.cp), copy=True)
    cp[:, 2] += 1e-3 * np.sin(np.linspace(0, 9, cp.shape[0]))
    prob["regu.CP_IGA"] = cp.ravel()
    prob.run_model()
    val = float(prob["regu.w_int_regu"])
    assert np.isfinite(val) and val > 0
    report = prob.check_partials(step=1e-7)
    for comp_name, pairs in report.items():
        for key, entry in pairs.items():
            if np.linalg.norm(entry["J_fd"]) < 1e-12:
                continue
            assert entry["rel error"] < 5e-5, (comp_name, key,
                                               entry["rel error"])
