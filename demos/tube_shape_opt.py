#!/usr/bin/env python
"""Fixed-intersection tube SHAPE optimization (FFD, x+y fields).

Counterpart of the reference driver
/root/reference/demos_om/shape_opt/tube/tube_shape_opt_wint.py:
a 4-patch tube under internal follower pressure
(sqrt(det(a)/det(A)) * a2 source term at :316-317), design variables =
x and y coordinates of an FFD block's control points
(opt_field=[0,1], ffd_block_num_el=[2,2,1] at :239-240), FFD pin +
first-difference regularization constraints, internal-energy
objective. Here the tube starts SQUASHED into an ellipse (exact
rational geometry — affine scaling of the circle's homogeneous CPs);
pressurizing an elliptical tube bends the wall, so the optimizer
rounds the cross-section back toward the membrane-dominated circle.

Usage: python demos/tube_shape_opt.py [--maxiter 15]
"""

import argparse

import jax.numpy as jnp
import numpy as np

from goldfish_jax import config

SCALE_X, SCALE_Y = 1.30, 0.72


def build(num_el=4, p=3, pressure=2.0e4):
    """models.tube geometry, cross-section scaled to an ellipse."""
    from goldfish_jax.geometry.nurbs import NURBS
    from goldfish_jax.models import tube
    from goldfish_jax.physics.coupling import InterfaceSpec
    from goldfish_jax.solver.system import NonMatchingSystem

    base = tube.build(num_el=num_el, p=p)
    surfs = []
    for s in base.surfs:
        c = s.control.copy()
        c[..., 0] *= SCALE_X  # homogeneous wx scales the point x
        c[..., 1] *= SCALE_Y
        surfs.append(NURBS(s.knots, c))
    specs = [InterfaceSpec(
        pair=(k, (k + 1) % 4),
        xi_ends_A=np.array([[0.0, 1.0], [1.0, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [1.0, 0.0]]),
        n_mortar_el=2 * num_el + 2) for k in range(4)]
    sys_ = NonMatchingSystem(surfs, tube.E, tube.NU, tube.H_TH,
                             specs=specs)
    for k in range(4):
        sys_.add_side_bc(k, direction=0, side=0, n_layers=2)
    sys_.set_pressure([pressure] * 4)
    return sys_


def main(num_el=4, p=3, maxiter=15, verbose=True):
    from goldfish_jax.design.constraints import pin_operator, regu_operator
    from goldfish_jax.design.pipeline import ShapeFFD
    from goldfish_jax.models import tube
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn

    sys_ = build(num_el, p)
    R = tube.RADIUS
    a, b = SCALE_X * R, SCALE_Y * R
    m = 1.05 * max(a, b)
    ffd = ShapeFFD(sys_, num_els=(2, 2, 1), p=(3, 3, 1),
                   lims=np.array([[-m, m], [-m, m],
                                  [-1e-3, tube.LENGTH + 1e-3]]),
                   opt_fields=(0, 1))
    nx, ny, nz = ffd.shape
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=40)

    def obj(dvs, d0):
        cp = ffd(dvs["p_xy"])
        d = solve(cp, sys_.h_init, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, sys_.h_init,
                                     sys_.E, sys_.nu)
        return J, d

    # pin the clamped-end (k = 0) z-slab in both fields so the support
    # geometry stays put (reference set_shopt_pin_CPFFD role)
    pinned = [(i, j, 0) for i in range(nx) for j in range(ny)]
    P1 = pin_operator(ffd.shape, pinned)
    P = np.block([[P1, np.zeros_like(P1)], [np.zeros_like(P1), P1]])
    # regu: x spacing monotone along the block's x axis, y along y
    Dx = regu_operator(ffd.shape, axis=0)
    Dy = regu_operator(ffd.shape, axis=1)
    D = np.block([[Dx, np.zeros_like(Dx)], [np.zeros_like(Dy), Dy]])

    p0 = ffd.init_p_ffd()
    prob = OptProblem()
    prob.add_design_var("p_xy", p0, lower=p0 - 0.45 * R,
                        upper=p0 + 0.45 * R)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("pin", lambda dvs: jnp.asarray(P) @ dvs["p_xy"],
                        equals=np.asarray(P @ p0))
    prob.add_constraint("regu", lambda dvs: jnp.asarray(D) @ dvs["p_xy"],
                        lower=1e-3)
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-14, verbose=verbose)

    J0, _ = obj({"p_xy": jnp.asarray(p0)}, sys_.zero_displacement())
    # roundness of the free-end cross-section before/after
    cp_opt = ffd(jnp.asarray(res.x["p_xy"]))

    def roundness(cp):
        from goldfish_jax.ops.bspline import rational_basis_2d

        pts = []
        for k in range(4):
            s = sys_.surfs[k]
            pd, qd = s.degree
            conn, tab = rational_basis_2d(
                s.knots[0], s.knots[1], pd, qd, s.weights,
                np.array([[1.0, 0.5]]), nd=0)
            pts.append(tab[(0, 0)][0]
                       @ np.asarray(cp[k]).reshape(-1, 3)[conn[0]])
        r = np.linalg.norm(np.asarray(pts)[:, :2], axis=1)
        return float(r.max() / r.min())

    if verbose:
        print(f"W_int: {float(J0):.6e} -> {res.fun:.6e} ({res.nit} its); "
              f"axis ratio: {a / b:.3f} -> "
              f"{roundness(cp_opt):.3f}")
    return res, float(J0), sys_, ffd


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--maxiter", type=int, default=15)
    ap.add_argument("--num-el", type=int, default=4)
    args = ap.parse_args()
    config.use_x64(True)
    main(num_el=args.num_el, maxiter=args.maxiter)
