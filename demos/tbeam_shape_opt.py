#!/usr/bin/env python
"""Fixed-intersection T-beam SHAPE optimization (FFD, x field).

Counterpart of the reference driver
/root/reference/demos_om/shape_opt/T-beam/T_beam_shape_opt_wint.py:
a 2-patch T-beam whose web starts OFF-CENTER (the reference loads
"init_Tbeam_geom_moved.igs"), loaded by follower pressure on the
flange; design variables are the x-coordinates of an FFD block's
control points (opt_field=[0], ffd_block_num_el=[3,1,2] at :240-241 of
the tube twin, :263-265 here); constraints are the reference's FFD pin
rows (x-faces + clamped-edge face, `set_shopt_pin_CPFFD` at :339-340),
first-difference regularization rows (`set_shopt_regu_CPFFD` at :341),
and constant volume; objective is internal energy. The optimizer
migrates the web back toward the flange center, where the stiffening
is most effective.

Usage: python demos/tbeam_shape_opt.py [--maxiter 20]
"""

import argparse

import jax.numpy as jnp
import numpy as np

from goldfish_jax import config

E = 1.0e12
NU = 0.0
H_TH = 0.1
LENGTH = 20.0
WIDTH = 2.0
DEPTH = 2.0
PRESSURE = 1.0


def build(num_el=6, p=3, x_web=0.4):
    """T-beam with the web seam at x = x_web (off-center for x_web != 0;
    the flange is linearly parametrized in x so the seam sits at
    u = (x_web + W/2) / W)."""
    from goldfish_jax.models.tbeam import create_surf
    from goldfish_jax.physics.coupling import InterfaceSpec
    from goldfish_jax.solver.system import NonMatchingSystem

    w2 = WIDTH / 2.0
    pts0 = [[-w2, 0.0, 0.0], [w2, 0.0, 0.0],
            [-w2, LENGTH, 0.0], [w2, LENGTH, 0.0]]
    pts1 = [[x_web, 0.0, 0.0], [x_web, 0.0, -DEPTH],
            [x_web, LENGTH, 0.0], [x_web, LENGTH, -DEPTH]]
    srf0 = create_surf(pts0, max(num_el // 2, 2), num_el, p)
    srf1 = create_surf(pts1, max((num_el + 1) // 2, 2), num_el + 1, p)
    u_seam = (x_web + w2) / WIDTH
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[u_seam, 0.0], [u_seam, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=2 * (num_el + 1),
    )]
    sys_ = NonMatchingSystem([srf0, srf1], E, NU, H_TH, specs=specs)
    # clamp y = 0 end of both patches (reference spline_bc0: direction
    # 1 side 0, all fields)
    sys_.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys_.add_side_bc(1, direction=1, side=0, n_layers=1)
    # follower pressure on the flange (reference:
    # sqrt(det(a)/det(A)) * a2 source term, T_beam_shape_opt_wint.py:316)
    sys_.set_pressure([-PRESSURE, 0.0])
    return sys_


def main(num_el=6, p=3, maxiter=20, x_web=0.4, verbose=True):
    from goldfish_jax.design.constraints import pin_operator, regu_operator
    from goldfish_jax.design.pipeline import ShapeFFD
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn

    sys_ = build(num_el, p, x_web)
    w2 = WIDTH / 2.0
    # FFD block bounding the beam, reference ffd_block_num_el=[3,1,2]
    ffd = ShapeFFD(sys_, num_els=(3, 1, 2), p=(3, 1, 2),
                   lims=np.array([[-w2 - 1e-3, w2 + 1e-3],
                                  [0.0, LENGTH],
                                  [-DEPTH - 1e-3, 1e-3]]),
                   opt_fields=(0,))
    nx, ny, nz = ffd.shape
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=40)

    def obj(dvs, d0):
        cp = ffd(dvs["p_x"])
        d = solve(cp, sys_.h_init, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                     sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, ffd(dvs["p_x"]), sys_.h_init)

    # pin rows: x-faces of the block (i = 0, nx-1) keep the flange
    # edges at x = +-1; clamped-edge face (j = 0) keeps the support
    pinned = [(i, j, k) for i in (0, nx - 1)
              for j in range(ny) for k in range(nz)]
    pinned += [(i, 0, k) for i in range(1, nx - 1) for k in range(nz)]
    P = pin_operator(ffd.shape, pinned)
    # regu rows: x spacing stays monotone (no block folding)
    D = regu_operator(ffd.shape, axis=0)

    p0 = ffd.init_p_ffd()
    V0 = float(vol({"p_x": jnp.asarray(p0)}))
    prob = OptProblem()
    prob.add_design_var("p_x", p0, lower=p0 - 0.8, upper=p0 + 0.8)
    prob.set_objective(obj, scaler=1e2, state0=sys_.zero_displacement())
    prob.add_constraint("pin", lambda dvs: jnp.asarray(P) @ dvs["p_x"],
                        equals=np.asarray(P @ p0))
    prob.add_constraint("regu", lambda dvs: jnp.asarray(D) @ dvs["p_x"],
                        lower=1e-2)
    prob.add_constraint("volume", vol, equals=V0, scaler=1.0 / V0)
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)

    J0, _ = obj({"p_x": jnp.asarray(p0)}, sys_.zero_displacement())
    # where did the web end up? (its CPs all share one x value per
    # y-column; take the seam average)
    cp_opt = ffd(jnp.asarray(res.x["p_x"]))
    n_cp1 = sys_.metas[1].n_cp
    web_x = float(jnp.mean(cp_opt[1].reshape(-1, 3)[:n_cp1, 0]))
    if verbose:
        print(f"W_int: {float(J0):.6e} -> {res.fun:.6e} "
              f"({res.nit} its); web x: {x_web:.3f} -> {web_x:.3f}")
    return res, float(J0), web_x, sys_, ffd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=20)
    ap.add_argument("--num-el", type=int, default=6)
    args = ap.parse_args()
    config.use_x64(True)
    main(num_el=args.num_el, maxiter=args.maxiter)
