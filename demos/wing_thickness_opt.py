#!/usr/bin/env python
"""Flagship workflow: thickness optimization of the 20-patch wing.

The production counterpart of bench.py's per-iteration workload
(BASELINE.md governing metric) run as a complete driver: FFD-
parametrized skin thickness, strain-energy objective, constant-volume
constraint, SLSQP, checkpoint/resume, VTK snapshots, per-stage
profiling. The analogue of the reference's pegasus/plate thickness
drivers (demos_om/thickness_opt/*).

Usage: python demos/wing_thickness_opt.py [--num-el 6] [--maxiter 20]
"""

import argparse
import os

import jax.numpy as jnp
import numpy as np

from goldfish_jax import config


def main(num_el=6, p=3, maxiter=20, results="./results/wing_thopt",
         verbose=True):
    from goldfish_jax.design.constraints import align_operator
    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.models import wing
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn
    from goldfish_jax.utils.checkpoint import Checkpointer, resume_run
    from goldfish_jax.utils.profiling import profiler
    from goldfish_jax.utils.vtk_io import SurfaceWriter

    sys_ = wing.build(num_el=num_el, p=p)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    A = jnp.asarray(align_operator(th.shape, axis=2))  # uniform through z

    prob = OptProblem()
    prob.add_design_var("h_ffd", th.init_h_ffd(wing.H_TH),
                        lower=wing.H_TH / 10, upper=wing.H_TH * 10,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("align", lambda dvs: A @ dvs["h_ffd"],
                        equals=np.zeros(A.shape[0]))
    # process-death-safe entry: a killed/crashed run re-invoked with the
    # same results dir resumes from the last accepted iterate (design +
    # warm-start displacement), utils/checkpoint.resume_run
    ck = Checkpointer(os.path.join(results, "opt_state.npz"))
    with profiler.stage("slsqp_total"):
        res, _ = resume_run(prob, ck, maxiter=maxiter, tol=1e-12,
                            verbose=verbose)

    h_op = th(jnp.asarray(res.x["h_ffd"]))
    d_op = solve(cp, h_op, sys_.zero_displacement())
    SurfaceWriter(sys_, save_path=results).save(
        d=np.asarray(d_op), h=np.asarray(h_op), tag="final")
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} "
              f"({res.nit} SLSQP its, {res.message})")
        print(profiler.summary())
    return res, sys_, th


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=6)
    ap.add_argument("--maxiter", type=int, default=20)
    args = ap.parse_args()
    config.use_x64(True)
    main(num_el=args.num_el, maxiter=args.maxiter)
