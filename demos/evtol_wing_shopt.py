#!/usr/bin/env python
"""eVTOL-class wing: multi-surface skins + spars + ribs, IGS import
path, SHAPE + THICKNESS optimization with rib-planarity (the reference
rspar/srib align role) and constant-volume constraints.

Counterpart of the reference's eVTOL drivers
(/root/reference/demos_om/shape_opt/eVTOL/
evtol_wing_shape_thickness_opt_wint.py and shape_opt_mint/eVTOL/
custom_comps/evtol_rspar_srib_align_comp.py). The reference's own .igs
input is NOT checked into its repo (create_geom_evtol.py points at a
missing file), so the equivalent config is built here, EXPORTED to
IGES, RE-IMPORTED (exercising the CAD path), and its intersections are
discovered by the preprocessor — the full reference prologue
(SURVEY.md section 3.3) without OCC.

Usage: python demos/evtol_wing_shopt.py [--sections 3] [--num-el 3]
"""

import argparse
import os
import tempfile
import time

import jax.numpy as jnp
import numpy as np


def build_system(n_sections=3, num_el=3, p=3, verbose=True):
    """IGS round-trip + intersection discovery + system assembly."""
    from goldfish_jax.geometry.igs_io import read_igs_file, write_igs_file
    from goldfish_jax.geometry.preprocessing import Preprocessor
    from goldfish_jax.models import boxwing
    from goldfish_jax.solver.system import NonMatchingSystem

    base = boxwing.build(n_sections=n_sections, num_el=num_el, p=p)
    igs = os.path.join(tempfile.gettempdir(), "evtol_wing.igs")
    write_igs_file(igs, base.surfs)
    surfs = read_igs_file(igs)
    if verbose:
        print(f"IGS round-trip: {len(surfs)} surfaces", flush=True)

    t0 = time.perf_counter()
    pre = Preprocessor(surfs).compute_intersections(rtol=2e-4,
                                                    mortar_refine=2)
    if verbose:
        print(f"preprocessor: {pre.num_intersections} intersections "
              f"({time.perf_counter() - t0:.1f}s)", flush=True)
    specs = pre.interface_specs()

    sys_ = NonMatchingSystem(surfs, boxwing.E, boxwing.NU, boxwing.H_TH,
                             specs=specs)
    # clamp the root rib; pressure on the upper skins
    sys_.add_side_bc(base.ids["rib0"], direction=1, side=0, n_layers=1)
    p_vec = np.zeros(sys_.num_splines)
    for k in range(n_sections):
        p_vec[base.ids[f"up{k}"]] = boxwing.PRESSURE
    sys_.set_pressure(p_vec)
    return sys_, base, pre


def main(n_sections=3, num_el=3, p=3, maxiter=5, verbose=True):
    from goldfish_jax.design.pipeline import ShapeFFD, ThicknessFFD
    from goldfish_jax.models import boxwing
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn

    sys_, base, pre = build_system(n_sections, num_el, p,
                                   verbose=verbose)
    cp0 = sys_.cp
    sh = ShapeFFD(sys_, num_els=(2, max(n_sections, 2), 2), p=2,
                  opt_fields=(2,))
    th = ThicknessFFD(sys_, num_els=(1, max(n_sections, 2), 1),
                      p=(1, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-8, max_it=30)
    V0 = float(sys_.volume())

    # rib-planarity rows (the reference's srib align comps): every
    # rib's surface-CP y-coordinates move together => differences of
    # their FFD-mapped y's are fixed. With opt_fields=(2,) (z only)
    # the y planes cannot move, so the analogous SHAPE constraint here
    # keeps each rib's z-extent consistent between its two skins: tie
    # the FFD z-dofs of coincident (x, y) columns.
    from goldfish_jax.design.constraints import align_operator

    A_align = align_operator(sh.shape, axis=2)  # z-columns move together

    def obj(dvs, d0):
        cp = sh(dvs["p_ffd"])
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                     sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, sh(dvs["p_ffd"]),
                               th(dvs["h_ffd"]))

    def align(dvs):
        return jnp.asarray(A_align) @ dvs["p_ffd"]

    p0 = sh.init_p_ffd()
    prob = OptProblem()
    span = float(np.max(np.abs(p0))) + 1.0
    prob.add_design_var("p_ffd", p0, lower=p0 - 0.2 * span,
                        upper=p0 + 0.2 * span)
    prob.add_design_var("h_ffd", th.init_h_ffd(boxwing.H_TH),
                        lower=boxwing.H_TH / 5, upper=boxwing.H_TH * 5,
                        scaler=1e2)
    prob.set_objective(obj, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("rib_align", align,
                        equals=np.asarray(A_align @ p0))

    t0 = time.perf_counter()
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)
    if verbose:
        J0 = res.history[0] if res.history else float("nan")
        print(f"W_int: {J0:.5e} -> {res.fun:.5e} ({res.nit} its, "
              f"{time.perf_counter() - t0:.1f}s)", flush=True)
    return res, sys_, sh, th


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--sections", type=int, default=3)
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=5)
    a = ap.parse_args()
    main(n_sections=a.sections, num_el=a.num_el, maxiter=a.maxiter)
