#!/usr/bin/env python
"""Aeroelastic coupling demo (reference analogue:
demos_csdl_alpha/ex_caddee/kl_shell_aeroelastic_coupling.py, which
couples a VLM solver to the shell through CADDEE/CSDL; SURVEY.md
section 3.5).

Here the aero solver is a differentiable toy strip-theory model: local
lift q * 2*pi * alpha_eff, where alpha_eff = alpha0 - local twist of
the DEFORMED wing (spanwise slope of u_z at each control point via a
constant Greville evaluation operator). The aeroelastic equilibrium is
a fixed-point loop

    f_k = aero(d_k);   d_{k+1} = solve(cp, h, f_k)

unrolled a few iterations — fully differentiable end to end, so
d(strain energy)/d(thickness) through the COUPLED system is one
jax.grad call (the reference needs the CSDL graph + its hand-built
dRIGAdPaero for this, reference: GOLDFISH/nonmatching_opt.py:1582-1665).

Usage: python demos/aeroelastic_wing.py
"""

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax import config


def greville_dy_operator(system):
    """Constant per-patch operators: d_z coefficients -> d(u_z)/dv at
    the Greville points (one row per CP): (P, C, C) padded."""
    from goldfish_jax.ops.bspline import rational_basis_2d

    P, C = system.stack.n_patches, system.stack.max_cp
    G = np.zeros((P, C, C))
    for ip, m in enumerate(system.metas):
        s = m.surf
        gu = s.greville_points(0)
        gv = s.greville_points(1)
        pts = np.stack(np.meshgrid(gu, gv, indexing="ij"), -1).reshape(-1, 2)
        conn, tab = rational_basis_2d(
            s.knots[0], s.knots[1], *s.degree, s.weights, pts, nd=1)
        for k in range(pts.shape[0]):
            G[ip, k, conn[k]] = tab[(0, 1)][k]  # spanwise (v) derivative
    return jnp.asarray(G)


def build_field_solve(system, rtol=1e-9, max_it=25):
    """Differentiable solve(cp, h, f_field, d0) with the distributed
    load field as an explicit adjoint input (dJ/df by AD)."""
    from goldfish_jax.solver.implicit import newton_solve
    from goldfish_jax.solver.linalg import linear_solve
    from goldfish_jax.solver.system import assemble_K, residual

    base = system.data

    @jax.custom_vjp
    def solve(cp, h, f, d0):
        data_f = base._replace(f_field=f)
        d, _, _ = newton_solve(data_f, cp, h, d0, rtol=rtol, max_it=max_it)
        return d

    def fwd(cp, h, f, d0):
        d = solve(cp, h, f, d0)
        return d, (cp, h, f, d)

    def bwd(res, g):
        cp, h, f, d = res
        data_f = base._replace(f_field=f)
        K = assemble_K(data_f, d, cp, h)
        lam = linear_solve(K, (g * base.free).reshape(-1)).reshape(g.shape)
        lam = lam * base.free
        _, vjp = jax.vjp(
            lambda c, hh, ff: residual(base._replace(f_field=ff), d, c, hh),
            cp, h, f)
        dc, dh, df = vjp(-lam)
        return dc, dh, df, jnp.zeros_like(d)

    solve.defvjp(fwd, bwd)
    return solve


def main(num_el=3, p=3, n_chord=4, n_span=5, n_fp=4, q_dyn=30.0,
         alpha0=0.08, verbose=True):
    from goldfish_jax.models import wing
    from goldfish_jax.physics import kl_shell

    sys_ = wing.build(n_chord=n_chord, n_span=n_span, num_el=num_el, p=p,
                      load_scale=0.0)
    solve = build_field_solve(sys_)
    G = greville_dy_operator(sys_)
    cp = sys_.cp

    def aero(d):
        twist = jnp.einsum("pij,pj->pi", G, d[..., 2]) / wing.HALF_SPAN
        alpha_eff = alpha0 - twist
        lift = q_dyn * 2.0 * jnp.pi * alpha_eff
        f = jnp.zeros_like(d)
        return f.at[..., 2].set(lift * sys_.stack.cp_mask)

    def coupled(h, d0):
        d = d0
        for _ in range(n_fp):
            d = solve(cp, h, aero(d), d)
        return d

    d0 = sys_.zero_displacement()

    def J(h):
        d = coupled(h, d0)
        Wi = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return Wi, d

    (J0, d), gh = jax.value_and_grad(J, has_aux=True)(sys_.h_init)
    tip = sys_.evaluate_displacement(d, sys_.num_splines - 1, [0.5, 1.0])
    if verbose:
        print(f"aeroelastic equilibrium: tip u_z = {float(tip[2]):.5f} m, "
              f"W_int = {float(J0):.5e}")
        print(f"|d W_int / d h| (coupled adjoint): "
              f"{float(jnp.linalg.norm(gh)):.4e}")
    return float(J0), np.asarray(tip), gh, sys_


if __name__ == "__main__":
    argparse.ArgumentParser().parse_args()
    config.use_x64(True)
    main()
