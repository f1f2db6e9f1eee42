#!/usr/bin/env python
"""Thickness optimization of a plate with a circular hole under
in-plane tension — a TRIMMED-surface demo (no reference counterpart:
the reference analyzes untrimmed patches only and delegates trimmed
CAD faces to OpenCASCADE; role anchor: the thickness demo family at
demos_om/thickness_opt/plate/plate_var_th_opt_wint.py).

The hole is an IGES-style parameter-space trim loop honored by
finite-cell quadrature masking (geometry/trim.py). In-plane tension
concentrates stress at the hole (Kirsch factor 3 at the rim in the
infinite-plate limit); minimizing strain energy at fixed material
volume thickens the hole band and thins the far field.

Usage: python demos/plate_hole_thickness_opt.py [--num-el 8]
       [--maxiter 20]
"""

import argparse
import os

import numpy as np

from goldfish_jax import config  # noqa: F401  (x64 / backend setup)


def build_system(num_el=8, r_hole=0.25, trim_subdiv=4):
    from goldfish_jax.geometry.cadkit import bilinear
    from goldfish_jax.solver.system import NonMatchingSystem

    s = bilinear([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0])
    s = s.elevate(0, 2).elevate(1, 2)
    rr = np.linspace(0, 1, num_el + 1)[1:-1]
    s = s.refine(0, rr).refine(1, rr)
    t = np.linspace(0, 2 * np.pi, 512, endpoint=False)
    hole = np.stack([0.5 + r_hole * np.cos(t),
                     0.5 + r_hole * np.sin(t)], axis=-1)
    sys_ = NonMatchingSystem([s], 1e7, 0.3, 1e-2,
                             trims=[(None, [hole])],
                             trim_subdiv=trim_subdiv)
    # 2 layers: one layer leaves the rigid rotation about the clamped
    # edge as an exact zero-energy mode (K singular at d=0)
    sys_.add_side_bc(0, direction=0, side=0, n_layers=2)
    sys_.add_edge_load(0, direction=0, side=1, force=[20.0, 0.0, 0.0])
    return sys_, hole


def main(num_el=8, maxiter=20, results="./results/plate_hole_thopt",
         verbose=True, r_hole=0.25):
    import jax.numpy as jnp

    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn
    from goldfish_jax.utils.vtk_io import SurfaceWriter

    sys_, hole = build_system(num_el, r_hole=r_hole)
    h0_val = float(np.asarray(sys_.h_init).max())
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=1e-10, max_it=30)
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h,
                                     sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    prob = OptProblem()
    prob.add_design_var("h_ffd", th.init_h_ffd(h0_val),
                        lower=h0_val / 10, upper=h0_val * 10,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1e2,
                       state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-12, verbose=verbose)

    h_op = th(jnp.asarray(res.x["h_ffd"]))
    d_op = solve(cp, h_op, sys_.zero_displacement())

    # thickness at the hole rim vs the far corners (evaluated at CPs
    # via greville abscissae of the FFD map is overkill — report the
    # coefficient field masked near/far from the hole center)
    lay_xy = np.asarray(sys_.cp)[0, :, :2]
    rdist = np.linalg.norm(lay_xy - 0.5, axis=-1)
    h_cp = np.asarray(h_op)[0]
    near = float(h_cp[rdist < 1.6 * r_hole].mean())
    far = float(h_cp[rdist > 2.8 * r_hole].mean())
    if verbose:
        print(f"J0={res.history[0]:.6e} J*={res.fun:.6e}")
        print(f"mean thickness near hole {near:.4e} vs far {far:.4e} "
              f"(ratio {near / far:.2f})")
    if results:
        os.makedirs(results, exist_ok=True)
        SurfaceWriter(sys_, save_path=results).save(
            d=np.asarray(d_op), h=np.asarray(h_cp)[None], tag="final")
    return res, sys_, th, (near, far)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=8)
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--results", default="./results/plate_hole_thopt")
    a = ap.parse_args()
    main(num_el=a.num_el, maxiter=a.maxiter, results=a.results)
