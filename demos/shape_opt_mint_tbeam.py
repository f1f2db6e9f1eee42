#!/usr/bin/env python
"""T-beam shape optimization with MOVING intersections — the
reference's hardest demo (reference: demos_om/shape_opt_mint/T-beam/
T_beam_2patch_shopt_mi.py): the web's height profile is the design; as
the web moves, the web-flange intersection migrates across the flange,
and the full gradient flows through CP -> xi -> displacement -> energy.

Design: z-offsets of the web's control rows (height profile along the
span), bounded; objective: strain energy under the tip load; constraint:
web material volume.

Usage: python demos/shape_opt_mint_tbeam.py [--maxiter 20]
"""

import argparse

import jax.numpy as jnp
import numpy as np

from goldfish_jax import config


def main(num_el=4, p=3, maxiter=15, verbose=True):
    from goldfish_jax.models import tbeam
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.physics.coupling import InterfaceSpec
    from goldfish_jax.solver.system_mi import MINonMatchingSystem

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
        n_mortar_el=2 * num_el + 2)]
    sys_ = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU,
                               tbeam.H_TH, specs=specs)
    sys_.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys_.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys_.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])

    forward = sys_.build_forward(rtol=1e-10, max_it=25)
    m1 = sys_.metas[1]
    # design: lateral (x) offsets of the web's spanwise control rows --
    # bending the web moves the intersection across the flange
    n_rows = m1.n_v
    row_of = jnp.asarray(
        np.tile(np.arange(m1.n_v)[None, :], (m1.n_u, 1)).ravel())
    # clamp the first rows (BC side) to zero offset via bounds
    cp0 = sys_.cp

    def cp_of(dvs):
        off = dvs["web_dx"][row_of]
        return cp0.at[1, : m1.n_cp, 0].add(off)

    def obj(dvs, d0):
        cp = cp_of(dvs)
        d, xi = forward(cp, sys_.h_init, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                     sys_.E, sys_.nu)
        return J, d

    prob = OptProblem()
    lb = np.full(n_rows, -0.35)
    ub = np.full(n_rows, 0.35)
    lb[0] = ub[0] = 0.0  # keep the clamped end fixed
    prob.add_design_var("web_dx", np.zeros(n_rows), lower=lb, upper=ub,
                        scaler=1.0)
    prob.set_objective(obj, scaler=1e2, state0=sys_.zero_displacement())
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)

    J0, _ = obj({"web_dx": jnp.zeros(n_rows)}, sys_.zero_displacement())
    if verbose:
        print(f"strain energy: {float(J0):.6e} -> {res.fun:.6e} "
              f"({res.nit} its, {res.message})")
    return res, float(J0), sys_


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=15)
    args = ap.parse_args()
    config.use_x64(True)
    main(maxiter=args.maxiter)
