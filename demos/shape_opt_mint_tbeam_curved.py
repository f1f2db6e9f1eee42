#!/usr/bin/env python
"""T-beam shape optimization with a CURVED moving intersection.

The counterpart of the reference's curved MI demo
(/root/reference/demos_om/shape_opt_mint/T-beam/
T_beam_2patch_shopt_mi_curved.py): a sinusoidally swept web crosses a
flat flange transversally; the intersection is a genuinely CURVED
parametric polyline, traced by the preprocessor (marching Newton), fed
through polyline InterfaceSpecs, and re-solved (CP -> xi) at every
design step. Design: the web's sweep amplitude field; objective W_int.

Usage: python demos/shape_opt_mint_tbeam_curved.py [--maxiter 4]
"""

import argparse
import time

import jax.numpy as jnp
import numpy as np


def build_curved_mi(num_el=4, p=3, amp=0.06, n_pts=11):
    from goldfish_jax.geometry.nurbs import NURBS
    from goldfish_jax.geometry.preprocessing import Preprocessor
    from goldfish_jax.models import tbeam
    from goldfish_jax.solver.system_mi import MINonMatchingSystem

    w2 = tbeam.WIDTH / 2
    zs_top = 0.25 * tbeam.DEPTH
    flange = tbeam.create_surf(
        [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
         [w2, tbeam.LENGTH, 0]], num_el, num_el, p)
    web = tbeam.create_surf(
        [[0, 0, zs_top], [0, 0, -tbeam.DEPTH],
         [0, tbeam.LENGTH, zs_top], [0, tbeam.LENGTH, -tbeam.DEPTH]],
        max(num_el // 2, 1), num_el + 1, p)
    ctrl = web.control.copy()
    gv = web.greville_points(1)
    bend = amp * np.sin(np.pi * gv)
    w = ctrl[..., 3:4]
    ctrl[..., 0:1] = ctrl[..., 0:1] + bend[None, :, None] * w
    web = NURBS(web.knots, ctrl)

    pre = Preprocessor([flange, web]).compute_intersections(
        rtol=2e-4, mortar_refine=2)
    assert pre.num_intersections == 1
    specs = pre.interface_specs()
    sys = MINonMatchingSystem([flange, web], tbeam.E, tbeam.NU,
                              tbeam.H_TH, specs=specs,
                              n_pts_list=[n_pts])
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys, pre


def main(num_el=4, p=3, maxiter=4, verbose=True):
    from goldfish_jax.models import tbeam
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell

    sys_, pre = build_curved_mi(num_el=num_el, p=p)
    if verbose:
        xiA = pre.intersections_para_coords[0][0]
        chord = np.linspace(xiA[0], xiA[-1], xiA.shape[0])
        print(f"curved seam: {xiA.shape[0]} pts, max parametric "
              f"deviation from chord {np.max(np.abs(xiA - chord)):.4f}",
              flush=True)
    forward = sys_.build_forward(rtol=1e-10, max_it=25)
    d0 = sys_.zero_displacement()
    m = sys_.metas[1]
    gv = sys_.surfs[1].greville_points(1)
    modes = np.stack([np.tile(np.sin((k + 1) * np.pi * gv)[None, :],
                              (m.n_u, 1)).ravel()
                      for k in range(3)])  # 3 sweep modes

    def obj(dvs, d_prev):
        cp = sys_.cp.at[1, : m.n_cp, 0].add(
            jnp.einsum("k,kc->c", dvs["amp"], jnp.asarray(modes)))
        d, xi = forward(cp, sys_.h_init, d_prev)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                     sys_.E, sys_.nu)
        return J, d

    prob = OptProblem()
    prob.add_design_var("amp", np.zeros(3), lower=-0.1 * tbeam.WIDTH,
                        upper=0.1 * tbeam.WIDTH)
    prob.set_objective(obj, state0=d0)
    t0 = time.perf_counter()
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.6e} -> {res.fun:.6e} ({res.nit} its, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return res, sys_


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=4)
    a = ap.parse_args()
    from goldfish_jax import config

    config.use_x64(True)
    main(maxiter=a.maxiter)
