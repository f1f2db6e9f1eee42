"""MI operation protocol + xi edge constraints."""

import numpy as np
import pytest

from goldfish_jax.geometry.cpiga2xi import xi_edge_constraints
from goldfish_jax.operations.disp_mi_imop import (
    CPIGA2XiImOperation,
    DispMintImOperation,
)
from tests.test_system_mi import _mi_tbeam


@pytest.fixture(scope="module")
def mi_ops():
    sys = _mi_tbeam(num_el=3, p=2, n_pts=9)
    return sys, CPIGA2XiImOperation(sys), DispMintImOperation(sys, rtol=1e-11)


def test_cpiga2xi_operation(mi_ops):
    sys, xi_op, _ = mi_ops
    cp_flat = np.asarray(xi_op.layout.to_flat(sys.cp)).ravel()
    xi = xi_op.solve_nonlinear(cp_flat)
    r = xi_op.apply_nonlinear(cp_flat, xi)
    assert np.linalg.norm(r) < 1e-9
    # vjp runs and is nonzero for a generic cotangent
    g = np.random.default_rng(0).normal(size=xi.shape)
    dcp = xi_op.vjp(cp_flat, xi, g)
    assert np.isfinite(dcp).all() and np.abs(dcp).max() > 0


def test_disp_mi_operation(mi_ops):
    sys, xi_op, disp_op = mi_ops
    lay = disp_op.layout
    cp_flat = np.asarray(lay.to_flat(sys.cp)).ravel()
    h_flat = np.asarray(lay.to_flat(sys.h_init[..., None])).ravel()
    xi = xi_op.solve_nonlinear(cp_flat)
    d = disp_op.solve_nonlinear(cp_flat, h_flat, xi)
    r = disp_op.apply_nonlinear(cp_flat, h_flat, xi, d)
    r0 = disp_op.apply_nonlinear(cp_flat, h_flat, xi, np.zeros_like(d))
    assert np.linalg.norm(r) < 1e-7 * np.linalg.norm(r0)
    disp_op.linearize(cp_flat, h_flat, xi, d)
    cp_b, h_b, xi_b = disp_op.solve_linear_rev_and_accumulate(
        np.random.default_rng(1).normal(size=d.shape))
    for a in (cp_b, h_b, xi_b):
        assert np.isfinite(a).all()
    assert np.abs(xi_b).max() > 0  # dR/dxi coupling alive


def test_xi_edge_constraints_tbeam(mi_ops):
    sys, _, _ = mi_ops
    dofs, vals = xi_edge_constraints(sys.mi)
    # the T-beam web-side curve runs along u_B = 0 -> one pinned
    # coordinate per point
    n = int(sys.mi.n_pts[0])
    assert len(dofs) == n
    assert np.allclose(vals, 0.0)
    xi0 = np.asarray(sys.mi.xi0).ravel()
    assert np.allclose(xi0[dofs], vals)
