"""Framework-agnostic operation protocol: the manual adjoint pipeline
through DispImOperation must reproduce jax.grad through the implicit
solve (this is exactly how OpenMDAO/CSDL drive the build; reference:
GOLDFISH/om_comps/disp_states_comp.py __main__ check_partials)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.models import tbeam
from goldfish_jax.operations import DispImOperation, IntEnergyExOperation
from goldfish_jax.physics import kl_shell
from goldfish_jax.solver.implicit import build_solve_fn


@pytest.fixture(scope="module")
def ops():
    sys = tbeam.build(num_el=4, p=2)
    return sys, DispImOperation(sys, rtol=1e-12), IntEnergyExOperation(sys)


def test_solve_and_residual(ops):
    sys, disp_op, _ = ops
    cp = np.asarray(disp_op.layout.to_flat(sys.cp)).ravel()
    h = np.asarray(disp_op.layout.to_flat(sys.h_init[..., None])).ravel()
    d = disp_op.solve_nonlinear(cp, h)
    r = disp_op.apply_nonlinear(cp, h, d)
    r0 = disp_op.apply_nonlinear(cp, h, np.zeros_like(d))
    assert np.linalg.norm(r) < 1e-7 * np.linalg.norm(r0)


def test_manual_adjoint_matches_jax_grad(ops):
    sys, disp_op, energy_op = ops
    lay = disp_op.layout
    cp = np.asarray(lay.to_flat(sys.cp)).ravel()
    h = np.asarray(lay.to_flat(sys.h_init[..., None])).ravel()

    # --- protocol path (what OpenMDAO's reverse mode executes)
    d = disp_op.solve_nonlinear(cp, h)
    disp_op.linearize(cp, h, d)
    _, dJdh_partial, dJdd = energy_op.gradients(cp, h, d)
    lam = disp_op.solve_linear_rev(dJdd)
    _, h_bar, _ = disp_op.apply_linear_rev(lam)
    dJdh_protocol = dJdh_partial - h_bar

    # --- jax.grad through the custom_vjp solve
    solve = build_solve_fn(sys.data, rtol=1e-12, max_it=25)

    def J(h_pad):
        dd = solve(sys.cp, h_pad, sys.zero_displacement())
        return kl_shell.internal_energy(sys.stack, dd, sys.cp, h_pad,
                                        sys.E, sys.nu)

    g_pad = jax.grad(J)(sys.h_init)
    dJdh_jax = np.asarray(lay.to_flat(g_pad[..., None])).ravel()

    num = np.linalg.norm(dJdh_protocol - dJdh_jax)
    den = np.linalg.norm(dJdh_jax)
    assert num / den < 1e-6, num / den
