"""CURVED intersection curves end to end: tracing (preprocessing),
polyline-carrying InterfaceSpecs, the MI pipeline on a curved seam, and
full-chain gradient parity — the round-1 verdict's missing capability
(reference: demos_om/shape_opt_mint/T-beam/T_beam_2patch_shopt_mi_curved
.py, GOLDFISH/cpiga2xi.py:43-57 intersections_para_coords)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.geometry.preprocessing import Preprocessor
from goldfish_jax.models import tbeam
from goldfish_jax.physics import kl_shell
from goldfish_jax.solver.system_mi import MINonMatchingSystem

AMP = 0.06  # web sweep amplitude (chord units)


def _curved_tbeam_surfs(num_el=4, p=3):
    """Flat flange + SINUSOIDALLY SWEPT web crossing it transversally:
    the intersection is a curved parametric curve on the flange and an
    interior (non-edge) line on the web."""
    w2 = tbeam.WIDTH / 2
    zs_top = 0.25 * tbeam.DEPTH
    flange = tbeam.create_surf(
        [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
         [w2, tbeam.LENGTH, 0]], num_el, num_el, p)
    web = tbeam.create_surf(
        [[0, 0, zs_top], [0, 0, -tbeam.DEPTH],
         [0, tbeam.LENGTH, zs_top], [0, tbeam.LENGTH, -tbeam.DEPTH]],
        max(num_el // 2, 1), num_el + 1, p)
    # bend the web chordwise: x(v) ~ AMP * sin(pi v)
    ctrl = web.control.copy()
    gv = web.greville_points(1)
    bend = AMP * np.sin(np.pi * gv)
    w = ctrl[..., 3:4]
    ctrl[..., 0:1] = ctrl[..., 0:1] + bend[None, :, None] * w
    from goldfish_jax.geometry.nurbs import NURBS

    web_curved = NURBS(web.knots, ctrl)
    return flange, web_curved


@pytest.fixture(scope="module")
def curved_pre():
    flange, web = _curved_tbeam_surfs()
    pre = Preprocessor([flange, web]).compute_intersections(
        rtol=2e-4, mortar_refine=2)
    return pre, flange, web


def test_traced_curve_is_curved_and_coincident(curved_pre):
    pre, flange, web = curved_pre
    assert pre.num_intersections == 1
    xiA, xiB = pre.intersections_para_coords[0]
    assert xiA.shape[0] >= 5
    # physical coincidence of the traced polylines
    from goldfish_jax.geometry.preprocessing import _eval_many

    XA = _eval_many(flange, xiA, nd=0)[(0, 0)]
    XB = _eval_many(web, xiB, nd=0)[(0, 0)]
    assert np.max(np.linalg.norm(XA - XB, axis=-1)) < 1e-8
    # the curve is genuinely CURVED in A's parameter space: deviation
    # of interior points from the chord ~ AMP / WIDTH
    chord = np.linspace(xiA[0], xiA[-1], xiA.shape[0])
    dev = np.max(np.abs(xiA - chord))
    assert dev > 0.3 * AMP / tbeam.WIDTH, dev
    # and it follows the sine: x-parameter ~ 0.5 + AMP sin(pi v)/WIDTH
    u_expect = 0.5 + AMP * np.sin(np.pi * xiA[:, 1]) / tbeam.WIDTH
    assert np.max(np.abs(xiA[:, 0] - u_expect)) < 0.02


def _curved_mi_system(curved_pre, n_pts=11):
    pre, flange, web = curved_pre
    specs = pre.interface_specs()
    sys = MINonMatchingSystem([flange, web], tbeam.E, tbeam.NU,
                              tbeam.H_TH, specs=specs,
                              n_pts_list=[n_pts])
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys


def test_curved_mi_solves(curved_pre):
    sys = _curved_mi_system(curved_pre)
    xi = sys.c2x.solve(sys.cp)
    assert bool(jnp.all(jnp.isfinite(xi)))
    # the xi solve keeps the curve curved (not collapsed to the chord)
    xiA = np.asarray(xi).reshape(-1, 2, 2)[:, 0, :]
    u_expect = 0.5 + AMP * np.sin(np.pi * xiA[:, 1]) / tbeam.WIDTH
    assert np.max(np.abs(xiA[:, 0] - u_expect)) < 0.02
    d = sys.solve_nonlinear(rtol=1e-10)
    assert bool(jnp.all(jnp.isfinite(d)))
    u = sys.evaluate_displacement(d, 0, [1.0, 1.0])
    assert abs(float(u[2])) > 1e-8


def test_curved_full_chain_gradient(curved_pre):
    """CP -> xi -> d -> J through the CURVED seam vs central FD."""
    sys = _curved_mi_system(curved_pre)
    forward = sys.build_forward(rtol=1e-11, max_it=25)
    d0 = sys.zero_displacement()
    m = sys.metas[1]
    gv = sys.surfs[1].greville_points(1)
    bend = jnp.asarray(np.tile(np.cos(np.pi * gv)[None, :],
                               (m.n_u, 1)).ravel())

    def J(amp):
        cp = sys.cp.at[1, : m.n_cp, 0].add(amp * bend)
        d, xi = forward(cp, sys.h_init, d0)
        return kl_shell.internal_energy(sys.stack, d, cp, sys.h_init,
                                        sys.E, sys.nu)

    amp0 = jnp.asarray(0.01)
    g = jax.grad(J)(amp0)
    eps = 1e-5
    fd = (J(amp0 + eps) - J(amp0 - eps)) / (2 * eps)
    assert abs(float(g - fd)) / abs(float(fd)) < 1e-5, (float(g),
                                                        float(fd))
