#!/usr/bin/env python
"""Variable-thickness plate optimization — the reference's headline
thickness demo (reference: demos_om/thickness_opt/plate/
plate_var_th_opt_wint.py) on this JAX stack.

Geometry: the reference's own 6-patch IGS plate when mounted
(non-matching cubic strips), else the built-in plate model. Minimize
internal energy s.t. constant volume; thickness parametrized by an FFD
block, aligned across width; SLSQP driver; checkpoint + VTK output.

Usage: python demos/thickness_opt_plate.py [--num-el 4] [--maxiter 30]
"""

import argparse
import os

import jax.numpy as jnp
import numpy as np

from goldfish_jax import config

REF_IGS = ("/root/reference/demos_csdl_alpha/thickness_opt/geometry/"
           "plate_geometry.igs")


def build_system(num_el):
    from goldfish_jax.geometry.preprocessing import Preprocessor
    from goldfish_jax.solver.system import NonMatchingSystem

    if os.path.exists(REF_IGS):
        from goldfish_jax.geometry.igs_io import read_igs_file

        surfs = read_igs_file(REF_IGS)
        pre = Preprocessor(surfs).compute_intersections(
            rtol=1e-4, mortar_refine=2)
        sys_ = NonMatchingSystem(surfs, 68e9, 0.35, 1e-2,
                                 specs=pre.interface_specs())
        sys_.add_side_bc(0, direction=1, side=0, n_layers=2)
        sys_.add_edge_load(len(surfs) - 1, direction=1, side=1,
                           force=[0.0, 0.0, -100.0])
        return sys_
    from goldfish_jax.models import plate

    return plate.build(num_el=num_el, p=3, num_patches=4)


def main(num_el=4, maxiter=30, results="./results/plate_thopt",
         verbose=True):
    from goldfish_jax.design.constraints import align_operator
    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn
    from goldfish_jax.utils.checkpoint import Checkpointer
    from goldfish_jax.utils.vtk_io import SurfaceWriter

    sys_ = build_system(num_el)
    h0_val = float(np.asarray(sys_.h_init).max())
    th = ThicknessFFD(sys_, num_els=(4, 1, 1), p=(3, 1, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-10, max_it=30)
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    A = jnp.asarray(align_operator(th.shape, axis=(1, 2)))

    prob = OptProblem()
    prob.add_design_var("h_ffd", th.init_h_ffd(h0_val),
                        lower=h0_val / 20, upper=h0_val * 50, scaler=1e2)
    prob.set_objective(obj, scaler=1e1, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("align", lambda dvs: A @ dvs["h_ffd"],
                        equals=np.zeros(A.shape[0]))
    Checkpointer(os.path.join(results, "opt_state.npz")).attach(prob)
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)

    h_op = th(jnp.asarray(res.x["h_ffd"]))
    d_op = solve(cp, h_op, sys_.zero_displacement())
    SurfaceWriter(sys_, save_path=results).save(d=np.asarray(d_op),
                                                h=np.asarray(h_op),
                                                tag="final")
    if verbose:
        print(f"J: {res.history[0] if res.history else float('nan'):.4e}"
              f" -> {res.fun:.4e}  ({res.nit} its, {res.message})")
    return res, sys_, th


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=4)
    ap.add_argument("--maxiter", type=int, default=30)
    ap.add_argument("--x64", action="store_true", default=True)
    args = ap.parse_args()
    if args.x64:
        config.use_x64(True)
    main(num_el=args.num_el, maxiter=args.maxiter)
