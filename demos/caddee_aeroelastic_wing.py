#!/usr/bin/env python
"""CADDEE-structured aeroelastic wing: knot/CP lists + intersection
cache in, coupled aero-structural equilibrium + adjoint out.

Mirror of the reference's CADDEE path (reference:
/root/reference/demos_csdl_alpha/ex_caddee/kl_shell_group.py:65-195 +
kl_shell_aeroelastic_coupling.py): the aircraft framework hands
`KLShellModel` raw knot vectors, control-point grids, a bc list and a
`wing_int_data.npz`-format intersection cache; a VLM-like aero model
feeds distributed forces; fixed-point coupling closes, and the COUPLED
adjoint dJ/dh differentiates through solver AND aero.

Usage: python demos/caddee_aeroelastic_wing.py
"""

import argparse
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np


def build_knot_cp_lists(n_sections=3, num_el=3, p=3):
    """The CADDEE-side artifacts: per-surface knot vectors and CP
    grids (here generated from the boxwing model; the reference gets
    them from CADDEE's c172 STEP refit, which is not shipped in its
    repo)."""
    from goldfish_jax.models import boxwing

    base = boxwing.build(n_sections=n_sections, num_el=num_el, p=p)
    knot_list = [[np.asarray(k) for k in s.knots] for s in base.surfs]
    cp_list = [np.asarray(s.control) for s in base.surfs]  # homogeneous
    bc_list = [[base.ids["rib0"], 1, 0]]
    upper = [base.ids[f"up{k}"] for k in range(n_sections)]
    return knot_list, cp_list, bc_list, upper


def main(n_sections=3, num_el=3, p=3, n_fp=4, q_dyn=2.0e2,
         alpha0=0.05, verbose=True):
    from goldfish_jax.caddee import KLShellModel
    from goldfish_jax.models import boxwing

    knot_list, cp_list, bc_list, upper = build_knot_cp_lists(
        n_sections, num_el, p)

    # intersection cache round-trip (the wing_int_data.npz role)
    from goldfish_jax.geometry.preprocessing import Preprocessor
    from goldfish_jax.geometry.nurbs import NURBS

    surfs = [NURBS(k, c) for k, c in zip(knot_list, cp_list)]
    cache = os.path.join(tempfile.gettempdir(), "boxwing_int_data.npz")
    Preprocessor(surfs).compute_intersections(
        rtol=2e-4, mortar_refine=2).save_intersections_data(cache)

    model = KLShellModel(knot_list, cp_list, bc_list, int_data=cache,
                         E=boxwing.E, nu=boxwing.NU, h_th=boxwing.H_TH)
    if verbose:
        print(f"KLShellModel: {model.num_surfs} surfaces, "
              f"{model.preprocessor.num_intersections} intersections",
              flush=True)

    sys_ = model.system
    solve = model.field_solver()
    cp = sys_.cp
    mask_up = np.zeros((sys_.num_splines, 1, 1))
    mask_up[upper] = 1.0
    mask_up = jnp.asarray(mask_up * np.asarray(
        sys_.stack.cp_mask)[:, :, None])

    def aero(d):
        """Toy VLM stand-in: local incidence from the z-displacement
        field tilts the lift on the upper skins (differentiable)."""
        twist = d[..., 2:3] / boxwing.HALF_SPAN
        lift = q_dyn * 2.0 * jnp.pi * (alpha0 - twist)
        return (lift * mask_up) * jnp.array([0.0, 0.0, 1.0])

    d0 = sys_.zero_displacement()

    def coupled(h, d_start):
        d = d_start
        for _ in range(n_fp):
            d = solve(cp, h, aero(d), d)
        return d

    def J(h):
        d = coupled(h, d0)
        return model.internal_energy(d, h), d

    (J0, d), gh = jax.value_and_grad(J, has_aux=True)(sys_.h_init)
    tip = sys_.evaluate_displacement(d, upper[-1], [0.5, 1.0])
    if verbose:
        print(f"aeroelastic equilibrium: tip u_z = {float(tip[2]):.6f} "
              f"m, W_int = {float(J0):.5e}", flush=True)
        print(f"|d W_int / d h| (coupled adjoint): "
              f"{float(jnp.linalg.norm(gh)):.4e}", flush=True)
    return float(J0), np.asarray(tip), gh, model


if __name__ == "__main__":
    argparse.ArgumentParser().parse_args()
    from goldfish_jax import config

    config.use_x64(True)
    main()
