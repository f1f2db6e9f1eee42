#!/usr/bin/env python
"""Pegasus-class FULL-SCALE thickness optimization: 91 coupled patches.

The counterpart of the reference's largest problem
(/root/reference/demos_om/thickness_opt/pegasus/pegasus_var_th_opt_wint
.py:203-206 — 18 sections x 4 surfaces + ribs, run on MPI/PETSc). Here
the forward solve and the adjoint are fully MATRIX-FREE
(solver/krylov.build_solve_fn_krylov: Newton-Krylov with the colored
multiplicative pair-Schwarz preconditioner + GMRES-IR adjoint) — no
dense (N, N) tangent is materialized at any point, so memory scales
with the patch count, not its square.

Design: per-patch skin thickness through a spanwise thickness FFD;
objective W_int; constant-volume equality constraint; SLSQP.

Usage: python demos/pegasus_thickness_opt.py [--sections 18]
       [--num-el 3] [--maxiter 5]
"""

import argparse
import time

import jax.numpy as jnp
import numpy as np


def main(n_sections=18, num_el=3, p=3, maxiter=5, verbose=True,
         checkpoint=None, const_th=False):
    from goldfish_jax.design.pipeline import (
        PatchConstantThickness,
        ThicknessFFD,
    )
    from goldfish_jax.models import boxwing
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.krylov import build_solve_fn_krylov

    t0 = time.perf_counter()
    sys_ = boxwing.build(n_sections=n_sections, num_el=num_el, p=p)
    n_patches = sys_.num_splines
    n_dofs = sum(m.n_cp for m in sys_.metas) * 3
    if verbose:
        print(f"pegasus-class: {n_patches} patches, {len(sys_.specs)} "
              f"intersections, {n_dofs} dofs "
              f"(build {time.perf_counter() - t0:.1f}s)", flush=True)

    if const_th:
        # one thickness dof per patch (the reference's
        # pegasus_const_th_opt_wint.py HthMap parametrization)
        th = PatchConstantThickness(sys_)
        h_init = th.init_h(boxwing.H_TH)
    else:
        th = ThicknessFFD(sys_, num_els=(1, 6, 1), p=(1, 2, 1))
        h_init = th.init_h_ffd(boxwing.H_TH)
    solve = build_solve_fn_krylov(sys_.data, rtol=1e-8, cg_rtol=1e-8)
    cp = sys_.cp
    V0 = float(sys_.volume())

    # the energy and volume are jitted; the thickness map h_of runs
    # eagerly inside the optimizer's callables
    import jax

    _jit_energy = jax.jit(kl_shell.internal_energy)
    _jit_volume = jax.jit(kl_shell.volume)

    def h_of(h_dv):
        return th(h_dv)

    def obj(dvs, d0):
        h = h_of(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = _jit_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return _jit_volume(sys_.stack, cp, h_of(dvs["h_ffd"]))

    prob = OptProblem()
    prob.add_design_var("h_ffd", h_init,
                        lower=boxwing.H_TH / 5, upper=boxwing.H_TH * 5,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)

    # compile every optimizer callable before the timed run, so the
    # reported s/it holds no compilation (OptProblem.preflight)
    prob.preflight()

    t1 = time.perf_counter()
    if checkpoint is not None:
        # multi-hour full-scale runs must survive process death:
        # resume from the last accepted
        # iterate on re-invocation
        from goldfish_jax.utils.checkpoint import Checkpointer, resume_run

        res, _ = resume_run(prob, Checkpointer(checkpoint),
                            maxiter=maxiter, tol=1e-12, verbose=verbose)
    else:
        res = prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    wall = time.perf_counter() - t1
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} ({res.nit} SLSQP its, "
              f"{wall:.1f}s wall, {wall / max(res.nit, 1):.1f}s/it)",
              flush=True)
    return res, sys_, th, wall


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", type=int, default=18)
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--p", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=5)
    ap.add_argument("--checkpoint", type=str, default=None,
                    help="npz path for process-death-safe resume")
    ap.add_argument("--const-th", action="store_true",
                    help="one thickness dof per patch (the reference's "
                         "pegasus_const_th_opt_wint.py parametrization)")
    a = ap.parse_args()
    main(n_sections=a.sections, num_el=a.num_el, p=a.p,
         maxiter=a.maxiter, checkpoint=a.checkpoint, const_th=a.const_th)
