#!/usr/bin/env python
"""Aeroelastic wing with a REAL vortex-lattice aero solver, coupled
through the shell's distributed-force adjoint input.

The in-repo counterpart of the reference's VortexAD-coupled CADDEE
example (reference: demos_csdl_alpha/ex_caddee/
kl_shell_aeroelastic_coupling.py:99-195): the VLM lattice rides the
DEFORMED shell midsurface, panel forces feed back through
`build_field_solve_fn`'s f_field input, the coupled state is converged
by fixed-point iteration, and ONE jax.grad delivers the COUPLED
fluid-structure design gradient dJ/d(thickness) through both solvers
(aero AIC solve + shell Newton solve) — verified against central FD.

Run: python demos/vlm_aeroelastic_wing.py
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.design.pipeline import CPLayout
from goldfish_jax.models import wing
from goldfish_jax.physics import kl_shell
from goldfish_jax.physics.vlm import (
    build_lattice_param,
    forces_to_cp_field,
    lattice_points,
    solve_panel_forces,
)
from goldfish_jax.solver.implicit import build_field_solve_fn


def build_coupled(n_chord=2, n_span=3, num_el=3, p=3, mc=6, ns=10,
                  alpha=0.06, q_dyn=40.0, n_fp=4, rtol=1e-9):
    """Returns (J_of_h, sys, h0): J_of_h(h) -> (W_int, (d, lift)) runs
    the coupled aeroelastic fixed point and is differentiable."""
    from goldfish_jax.ops.bspline_jax import make_surf_set

    sys_ = wing.build(n_chord=n_chord, n_span=n_span, num_el=num_el,
                      p=p, load_scale=0.0)
    ss, (pd, qd) = make_surf_set(sys_.surfs)
    lay = CPLayout(sys_.metas, sys_.stack.max_cp)

    # global parametric location of every flat CP (for the panel->CP
    # force-density sampling): patch (i, j) covers
    # [i/nc, (i+1)/nc] x [j/ns, (j+1)/ns] (models/wing.build layout)
    cp_uv = []
    for j in range(n_span):
        for i in range(n_chord):
            s = sys_.surfs[j * n_chord + i]
            gu = np.asarray(s.greville_points(0))
            gv = np.asarray(s.greville_points(1))
            U = (i + gu[:, None]) / n_chord + 0 * gv[None, :]
            V = (j + gv[None, :]) / n_span + 0 * gu[:, None]
            cp_uv.append(np.stack([U.ravel(), V.ravel()], -1))
    cp_uv = np.concatenate(cp_uv, axis=0)
    lat = build_lattice_param(n_chord, n_span, mc, ns, cp_uv=cp_uv)

    solve = build_field_solve_fn(sys_.data, rtol=rtol, max_it=30)
    cp = sys_.cp

    # dynamic pressure scaling: solve_panel_forces uses V_inf = 1,
    # rho = 2 q_dyn so that 0.5 rho V^2 = q_dyn
    rho = 2.0 * q_dyn

    def aero_field(d):
        corners = lattice_points(ss, pd, qd, lat, cp, d)
        F, aux = solve_panel_forces(corners, jnp.asarray(alpha),
                                    V_inf=1.0, rho=rho)
        f = forces_to_cp_field(lat, F, aux["area"], lay.to_padded)
        return f * sys_.stack.cp_mask[..., None], aux["lift"]

    def J_of_h(h, d0):
        d = d0
        lift = jnp.zeros(())
        for _ in range(n_fp):
            f, lift = aero_field(d)
            d = solve(cp, h, f, d)
        Wi = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E,
                                      sys_.nu)
        return Wi, (d, lift)

    return J_of_h, sys_, sys_.h_init


def main(n_chord=2, n_span=3, num_el=3, p=3, mc=6, ns=10, n_fp=4,
         check_fd=True, verbose=True):
    J_of_h, sys_, h0 = build_coupled(n_chord=n_chord, n_span=n_span,
                                     num_el=num_el, p=p, mc=mc, ns=ns,
                                     n_fp=n_fp)
    d0 = sys_.zero_displacement()
    (J, (d, lift)), gh = jax.value_and_grad(
        J_of_h, has_aux=True)(h0, d0)
    tip = sys_.evaluate_displacement(d, sys_.num_splines - 1, [0.5, 1.0])
    if verbose:
        print(f"coupled aeroelastic: lift = {float(lift):.3f} N, "
              f"tip u_z = {float(tip[2]):.5f} m, W_int = {float(J):.5e}")
        print(f"|dW_int/dh| (coupled adjoint through VLM + shell): "
              f"{float(jnp.linalg.norm(gh)):.4e}")

    rel = None
    if check_fd:
        rng = np.random.default_rng(0)
        v = jnp.asarray(rng.normal(size=np.asarray(h0).shape)
                        * np.asarray(sys_.stack.cp_mask))
        eps = 1e-6
        Jp, _ = J_of_h(h0 + eps * v, d0)
        Jm, _ = J_of_h(h0 - eps * v, d0)
        fd = float((Jp - Jm) / (2 * eps))
        ad = float(jnp.sum(gh * v))
        rel = abs(ad - fd) / max(abs(fd), 1e-300)
        if verbose:
            print(f"coupled dJ/dh vs FD: ad={ad:.8e} fd={fd:.8e} "
                  f"rel={rel:.2e}")
        assert rel < 1e-5, rel
    return float(J), float(lift), np.asarray(tip), gh, rel, sys_


if __name__ == "__main__":
    argparse.ArgumentParser().parse_args()
    from goldfish_jax import config

    config.use_x64(True)
    main()
