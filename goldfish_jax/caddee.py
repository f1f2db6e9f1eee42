"""CADDEE-structured aeroelastic shell interface.

Mirror of the reference's `KLShellModel` entry surface (reference:
/root/reference/demos_csdl_alpha/ex_caddee/kl_shell_group.py:65-195):
the aircraft-MDO framework hands over RAW knot vectors + control-point
grids (as refit by CADDEE from the CAD geometry), a boundary-condition
list, and a precomputed intersection-data cache (`wing_int_data.npz`,
the name1..name6 npz layout this build's Preprocessor reads/writes
natively), and gets back a shell model whose `evaluate` maps
distributed aerodynamic forces + thickness to displacements — fully
differentiable, so the coupled aeroelastic adjoint closes through it.
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.geometry.preprocessing import Preprocessor
from goldfish_jax.solver.system import NonMatchingSystem

__all__ = ["KLShellModel"]


class KLShellModel:
    """knot/CP lists + intersection cache -> differentiable shell solve.

    Parameters
    ----------
    knot_list : list of (knots_u, knots_v) tuples/lists
    cp_list : list of (n_u, n_v, 3|4) control grids (homogeneous
        weights appended as 1 when absent — CADDEE refits B-splines)
    bc_list : [[surf, direction, side], ...] clamped edges (reference
        kl_shell_group.py bc_list convention)
    int_data : path to a name1..name6 npz intersection cache (the
        reference's wing_int_data.npz format), or None to compute
        intersections here.
    """

    def __init__(self, knot_list, cp_list, bc_list=(), int_data=None,
                 E=70e9, nu=0.33, h_th=3e-3,
                 penalty_coefficient=1.0e3, rtol_int=2e-4):
        surfs = []
        for knots, cp in zip(knot_list, cp_list):
            cp = np.asarray(cp, dtype=np.float64)
            if cp.shape[-1] == 3:
                w = np.ones(cp.shape[:-1] + (1,))
                cp = np.concatenate([cp, w], axis=-1)
            else:  # homogeneous already
                pass
            surfs.append(NURBS([np.asarray(k, dtype=np.float64)
                                for k in knots], cp))
        self.surfs = surfs

        self.preprocessor = Preprocessor(surfs)
        if int_data is not None:
            self.preprocessor.load_intersections_data(int_data)
        else:
            self.preprocessor.compute_intersections(rtol=rtol_int,
                                                    mortar_refine=2)
        specs = self.preprocessor.interface_specs()

        self.system = NonMatchingSystem(
            surfs, E, nu, h_th, specs=specs,
            penalty_coefficient=penalty_coefficient)
        for (i, direction, side) in bc_list:
            self.system.add_side_bc(int(i), direction=int(direction),
                                    side=int(side), n_layers=2)
        self._solve = None
        self._E = E
        self._nu = nu

    @property
    def num_surfs(self):
        return len(self.surfs)

    def solver(self, rtol=1e-9, max_it=30):
        if self._solve is None:
            from goldfish_jax.solver.implicit import build_solve_fn

            self._solve = build_solve_fn(self.system.data, rtol=rtol,
                                         max_it=max_it)
        return self._solve

    def field_solver(self, rtol=1e-9, max_it=30):
        """Differentiable solve(cp, h, f_field, d0) -> d with the
        distributed force field as an explicit adjoint input — the
        coupled aeroelastic loop differentiates straight through it
        (reference evaluate() + DispStatesModel role)."""
        if getattr(self, "_field_solve", None) is None:
            from goldfish_jax.solver.implicit import build_field_solve_fn

            self._field_solve = build_field_solve_fn(
                self.system.data, rtol=rtol, max_it=max_it)
        return self._field_solve

    def evaluate(self, shell_forces, h_th=None, d0=None):
        """Displacements under distributed shell forces.

        shell_forces: (P, C, 3) CP-coefficient force field (the
        VLM-mapped loads; reference evaluate() consumes CG1 force
        functions the same way) — differentiable input.
        h_th: (P, C) thickness coefficients (defaults to the
        constructor value). Returns d (P, C, 3); differentiable in
        both inputs via the implicit adjoint.
        """
        import jax.numpy as jnp

        sys_ = self.system
        solve = self.field_solver()
        h = sys_.h_init if h_th is None else h_th
        d0 = sys_.zero_displacement() if d0 is None else d0
        return solve(sys_.cp, h,
                     jnp.asarray(shell_forces, dtype=sys_.dtype), d0)

    def internal_energy(self, d, h_th=None):
        from goldfish_jax.physics import kl_shell

        sys_ = self.system
        h = sys_.h_init if h_th is None else h_th
        return kl_shell.internal_energy(sys_.stack, d, sys_.cp, h,
                                        sys_.E, sys_.nu)
