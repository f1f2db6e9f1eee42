#!/usr/bin/env python
"""Shape optimization: plate -> arch (reference:
demos_om/shape_opt/arch + arXiv 2410.02225 case study).

A flat multi-patch plate under a downward areal load, pinned at both
ends; design = vertical positions of an FFD block's control points
(ShapeFFD, z field only); objective = internal energy (equivalently
compliance). The optimizer bows the plate into an arch, trading bending
for membrane action — strain energy drops by orders of magnitude.

Usage: python demos/shape_opt_arch.py [--maxiter 30]
"""

import argparse

import jax.numpy as jnp
import numpy as np

from goldfish_jax import config


def build(num_el=4, p=3, num_patches=3):
    from goldfish_jax.models import plate

    sys_ = plate.build(num_el=num_el, p=p, num_patches=num_patches)
    # replace the cantilever setup: pin both x-ends, uniform dead load
    sys_._free[:] = sys_.stack.cp_mask[..., None] * np.ones(3)
    sys_._data = None
    sys_.edge_load_entries = []
    sys_.add_side_bc(0, direction=0, side=0, n_layers=1)
    sys_.add_side_bc(num_patches - 1, direction=0, side=1, n_layers=1)
    sys_.set_dead_load([0.0, 0.0, -1.0e4])
    return sys_


def main(num_el=4, p=3, num_patches=3, maxiter=25, verbose=True):
    from goldfish_jax.design.pipeline import ShapeFFD
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn

    sys_ = build(num_el, p, num_patches)
    ffd = ShapeFFD(sys_, num_els=(4, 1, 1), p=(2, 1, 1),
                   lims=np.array([[0.0, 1.0], [0.0, 1.0], [-0.02, 0.3]]),
                   opt_fields=(2,))
    solve = build_solve_fn(sys_.data, rtol=1e-10, max_it=40)

    def obj(dvs, d0):
        cp = ffd(dvs["p_z"])
        d = solve(cp, sys_.h_init, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                     sys_.E, sys_.nu)
        return J, d

    p0 = ffd.init_p_ffd()
    nx, ny, nz = ffd.shape
    # pin the supported ends: first/last x-slab of the block stays put
    lb = np.full(p0.shape, -0.02)
    ub = np.full(p0.shape, 0.30)
    grid = np.arange(ffd.n_ffd)
    ix = grid % nx  # x-fastest flattening
    lb[ix == 0] = ub[ix == 0] = 0.0
    lb[ix == nx - 1] = ub[ix == nx - 1] = 0.0

    prob = OptProblem()
    prob.add_design_var("p_z", p0, lower=lb, upper=ub, scaler=10.0)
    prob.set_objective(obj, scaler=1e-1,
                       state0=sys_.zero_displacement())
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)

    J0, _ = obj({"p_z": jnp.asarray(p0)}, sys_.zero_displacement())
    if verbose:
        print(f"strain energy: {float(J0):.6e} -> {res.fun:.6e} "
              f"({res.nit} its)")
    return res, float(J0), sys_, ffd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=25)
    args = ap.parse_args()
    config.use_x64(True)
    main(maxiter=args.maxiter)
