#!/usr/bin/env python
"""Draft-tube shape optimization with MOVING INTERSECTIONS and an FFD
block (the reference's draft_tube_shape_opt_mi_wffd_4patch workflow;
reference: /root/reference/demos_om/shape_opt_mint/tube/
draft_tube_shape_opt_mi_wffd_4patch.py:606-662): a 4-patch pressurized
tube whose cross-section shape is FFD-parametrized; the four axial
seams are DIFFERENTIABLE intersections re-solved (CP -> xi) at every
design, and the full chain differentiates through both implicit solves.

Usage: python demos/draft_tube_shopt_mi_wffd.py [--num-el 3]
"""

import argparse
import time

import jax.numpy as jnp
import numpy as np


def build_mi_tube(num_el=3, p=3, pressure=2.0e4):
    from goldfish_jax.models import tube
    from goldfish_jax.physics.coupling import InterfaceSpec
    from goldfish_jax.solver.system_mi import MINonMatchingSystem

    base = tube.build(num_el=num_el, p=p, pressure=pressure)
    specs = base.specs
    n_pts = 2 * num_el + 3
    sys = MINonMatchingSystem(base.surfs, tube.E, tube.NU, tube.H_TH,
                              specs=specs,
                              n_pts_list=[n_pts] * len(specs))
    for k in range(4):
        sys.add_side_bc(k, direction=0, side=0, n_layers=2)
    sys.set_pressure([pressure] * 4)
    return sys


def main(num_el=3, p=3, maxiter=4, verbose=True):
    from goldfish_jax.design.constraints import pin_operator
    from goldfish_jax.design.pipeline import ShapeFFD
    from goldfish_jax.models import tube
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell

    sys_ = build_mi_tube(num_el=num_el, p=p)
    sh = ShapeFFD(sys_, num_els=(2, 2, 2), p=2, opt_fields=(0, 1))
    forward = sys_.build_forward(rtol=1e-9, max_it=25)
    d0 = sys_.zero_displacement()
    V0 = float(sys_.volume())

    # pin the clamped-end FFD layer (z-slab 0) so the support ring
    # cannot move — the reference's pinned-cross-section constraint
    nx, ny, nz = sh.shape
    pinned = [(i, j, 0) for i in range(nx) for j in range(ny)]
    A_pin = pin_operator(sh.shape, pinned)
    A_pin2 = np.kron(np.eye(2), A_pin)  # both optimized fields

    def obj(dvs, d_prev):
        cp = sh(dvs["p_ffd"])
        d, xi = forward(cp, sys_.h_init, d_prev)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                     sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, sh(dvs["p_ffd"]),
                               sys_.h_init)

    p0 = sh.init_p_ffd()
    # start from an OVALIZED cross-section (free-end layers squeezed):
    # the optimizer must round the pressurized tube back out, moving
    # the four seams through the CP -> xi solve at every step
    n = sh.n_ffd
    nx, ny, _ = sh.shape
    k_of_dof = np.arange(n) // (nx * ny)     # x-fastest dof order
    free_z = (k_of_dof > 0).astype(float)
    p_start = p0.copy()
    p_start[:n] *= 1.0 + 0.08 * free_z        # stretch x
    p_start[n:] *= 1.0 - 0.07 * free_z        # squeeze y
    prob = OptProblem()
    prob.add_design_var("p_ffd", p_start, lower=p0 - 0.3 * tube.RADIUS,
                        upper=p0 + 0.3 * tube.RADIUS)
    prob.set_objective(obj, state0=d0)
    prob.add_constraint("pin", lambda dvs: jnp.asarray(A_pin2)
                        @ dvs["p_ffd"], equals=np.asarray(A_pin2 @ p0))

    t0 = time.perf_counter()
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} ({res.nit} its, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return res, sys_, sh


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=4)
    a = ap.parse_args()
    from goldfish_jax import config

    config.use_x64(True)
    main(num_el=a.num_el, maxiter=a.maxiter)
