"""Kirchhoff-Love shell physics validation against exact solutions.

Each test isolates one mechanical mode:
  - cantilever plate       -> flat bending (Euler-Bernoulli)
  - plate twist patch test -> kappa_12 term (exact KL solution w = a*x*y)
  - curved arch cantilever -> bending on curved rational geometry
  - pressurized cylinder   -> membrane term (exact energy + equilibrium)
"""

import numpy as np
import pytest

from goldfish_jax.geometry.cadkit import bilinear, circle, line, ruled
from goldfish_jax.geometry.patch_stack import side_dofs
from goldfish_jax.solver.system import NonMatchingSystem


def test_cantilever_plate_bending():
    Lx, Ly = 10.0, 1.0
    E, nu, h, q = 1e7, 0.0, 0.1, 1e-3
    srf = ruled(line([0, 0, 0], [0, Ly, 0]), line([Lx, 0, 0], [Lx, Ly, 0]))
    srf = srf.elevate(0, 2).elevate(1, 2)
    srf = srf.refine(0, np.linspace(0, 1, 5)[1:-1])
    srf = srf.refine(1, np.linspace(0, 1, 17)[1:-1])
    sys = NonMatchingSystem([srf], E, nu, h)
    sys.add_side_bc(0, direction=1, side=0, n_layers=2)
    sys.set_dead_load([0, 0, -q])
    d = sys.solve_nonlinear()
    w_tip = sys.evaluate_displacement(d, 0, [0.5, 1.0])[2]
    D = E * h**3 / 12
    w_exact = -q * Lx**4 / (8 * D)
    assert abs(w_tip - w_exact) / abs(w_exact) < 1e-4


def test_plate_twist_patch():
    """w = a*x*y is exact in the cubic space -> must match to round-off."""
    E, nu, h = 1e7, 0.0, 0.1
    s = bilinear([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0])
    s = s.elevate(0, 2).elevate(1, 2)
    s = s.refine(0, np.linspace(0, 1, 5)[1:-1]).refine(1, np.linspace(0, 1, 5)[1:-1])
    sys = NonMatchingSystem([s], E, nu, h)
    m = sys.metas[0]
    sys.add_zero_dofs(0, side_dofs(m.n_u, m.n_v, 0, 0, 1), fields=(2,))
    sys.add_zero_dofs(0, side_dofs(m.n_u, m.n_v, 1, 0, 1), fields=(2,))
    sys.add_zero_dofs(0, np.arange(m.n_cp), fields=(0, 1))
    P = 1e-4
    sys.add_point_load(0, [1.0, 1.0], [0, 0, P])
    d = sys.solve_nonlinear()
    w = sys.evaluate_displacement(d, 0, [1.0, 1.0])[2]
    D = E * h**3 / 12 / (1 - nu**2)
    w_exact = P / (2 * D * (1 - nu))
    assert abs(w - w_exact) / w_exact < 1e-6


def test_curved_arch_bending():
    """Quarter-circle cantilever strip vs Castigliano curved-beam."""
    R, b, h, E = 10.0, 1.0, 0.05, 1e7
    c0 = circle(center=[0, 0, 0], radius=R, angle=(0, np.pi / 2))
    c1 = circle(center=[0, 0, b], radius=R, angle=(0, np.pi / 2))
    s = ruled(c0, c1).elevate(0, 1).elevate(1, 2)
    s = s.refine(0, np.linspace(0, 1, 33)[1:-1]).refine(1, np.linspace(0, 1, 3)[1:-1])
    sys = NonMatchingSystem([s], E, 0.0, h)
    sys.add_side_bc(0, direction=0, side=0, n_layers=2)
    F = -1e-3
    sys.add_point_load(0, [1.0, 0.5], [F, 0.0, 0.0])
    d = sys.solve_nonlinear()
    ux = sys.evaluate_displacement(d, 0, [1.0, 0.5])[0]
    EI = E * b * h**3 / 12
    dx_exact = (3 * np.pi / 4 - 2) * F * R**3 / EI
    assert abs(ux - dx_exact) / abs(dx_exact) < 5e-3


def test_membrane_cylinder_energy():
    """Exact radial-expansion mode of a pressurized cylinder:
    internal energy and 1-D equilibrium must match analytic values."""
    import jax
    import jax.numpy as jnp

    from goldfish_jax.physics.kl_shell import internal_energy, surface_fields

    R, Lz, h, E = 10.0, 2.0, 0.05, 1e7
    p_in = 1.0e-2
    c0 = circle(center=[0, 0, 0], radius=R, angle=(0, 2 * np.pi))
    c1 = circle(center=[0, 0, Lz], radius=R, angle=(0, 2 * np.pi))
    s = ruled(c0, c1).elevate(0, 1).elevate(1, 2)
    s = s.refine(0, np.setdiff1d(np.linspace(0, 1, 17)[1:-1], [0.25, 0.5, 0.75]))
    sys = NonMatchingSystem([s], E, 0.0, h)
    stack, cp, hc = sys.stack, sys.cp, sys.h_init

    def dead_pressure_work(d):
        X = surface_fields(stack, cp)
        u = surface_fields(stack, d)
        n = jnp.cross(X["du"], X["dv"])
        return p_in * jnp.sum(jnp.sum(n * u["v"], -1) * stack.wq)

    def potential(d):
        return internal_energy(stack, d, cp, hc, sys.E, sys.nu) \
            - dead_pressure_work(d)

    w = p_in * R**2 / (E * h)
    cpn = np.asarray(cp)
    d_ex = np.zeros_like(cpn)
    d_ex[..., 0] = w / R * cpn[..., 0]
    d_ex[..., 1] = w / R * cpn[..., 1]
    d_ex = jnp.asarray(d_ex)

    Wi = float(internal_energy(stack, d_ex, cp, hc, sys.E, sys.nu))
    Wi_exact = np.pi * p_in * w * R * Lz
    assert abs(Wi - Wi_exact) / Wi_exact < 1e-4  # (SVK quadratic ~ w/R)

    # equilibrium along the radial mode: dPi/dt = 0 at t = 1
    g = jax.grad(lambda t: potential(t * d_ex))
    t_star = float(g(0.0) / (g(0.0) - g(1.0)))
    assert abs(t_star - 1.0) < 1e-4


def test_two_patch_plate_coupling_patch_test():
    """Two coplanar plate patches penalty-coupled must reproduce the
    single-plate cantilever (displacement-continuity patch test)."""
    from goldfish_jax.physics.coupling import InterfaceSpec

    E, nu, h, q = 1e7, 0.0, 0.1, 1e-5
    Lx, Ly = 10.0, 1.0

    def plate(x0, x1, nel_u, nel_v):
        srf = ruled(line([x0, 0, 0], [x0, Ly, 0]), line([x1, 0, 0], [x1, Ly, 0]))
        srf = srf.elevate(0, 2).elevate(1, 2)
        srf = srf.refine(0, np.linspace(0, 1, nel_u + 1)[1:-1])
        srf = srf.refine(1, np.linspace(0, 1, nel_v + 1)[1:-1])
        return srf

    s0 = plate(0.0, 5.0, 3, 8)
    s1 = plate(5.0, 10.0, 2, 11)  # non-matching discretization
    spec = InterfaceSpec(pair=(0, 1),
                         xi_ends_A=np.array([[0.0, 1.0], [1.0, 1.0]]),
                         xi_ends_B=np.array([[0.0, 0.0], [1.0, 0.0]]),
                         n_mortar_el=24)
    sys = NonMatchingSystem([s0, s1], E, nu, h, specs=[spec])
    sys.add_side_bc(0, direction=1, side=0, n_layers=2)
    sys.set_dead_load([0, 0, -q])
    d = sys.solve_nonlinear()
    w_tip = sys.evaluate_displacement(d, 1, [0.5, 1.0])[2]
    D = E * h**3 / 12
    w_exact = -q * Lx**4 / (8 * D)
    assert abs(w_tip - w_exact) / abs(w_exact) < 5e-3


def test_jet_hessians_match_dense_ad():
    """Jet-formulated element/interface Hessians must equal the dense
    vmapped-jax.hessian oracle (the round-1 implementation)."""
    import jax.numpy as jnp

    from goldfish_jax.models import tbeam
    from goldfish_jax.physics.coupling import (
        _interface_hessians_ref,
        interface_hessians,
    )
    from goldfish_jax.physics.kl_shell import (
        _element_hessians_ref,
        element_hessians,
    )

    sys = tbeam.build(num_el=3, p=3)
    rng = np.random.default_rng(0)
    d = jnp.asarray(rng.normal(size=np.asarray(sys.cp).shape)) * 1e-3
    Ke = element_hessians(sys.stack, d, sys.cp, sys.h_init, sys.E, sys.nu)
    Ke_ref = _element_hessians_ref(sys.stack, d, sys.cp, sys.h_init,
                                   sys.E, sys.nu)
    scale = float(jnp.max(jnp.abs(Ke_ref)))
    assert float(jnp.max(jnp.abs(Ke - Ke_ref))) < 1e-10 * scale

    ifs = sys.data.ifs
    Ki = interface_hessians(ifs, d, sys.cp, sys.h_init, sys.E)
    Ki_ref = _interface_hessians_ref(ifs, d, sys.cp, sys.h_init, sys.E)
    scale_i = float(jnp.max(jnp.abs(Ki_ref)))
    assert float(jnp.max(jnp.abs(Ki - Ki_ref))) < 1e-10 * scale_i


def test_matmul_assembly_matches_scatter():
    """Matmul-based assemble_K must equal the scatter oracle."""
    import jax.numpy as jnp

    from goldfish_jax.models import tbeam
    from goldfish_jax.solver.system import _assemble_K_scatter, assemble_K

    sys = tbeam.build(num_el=3, p=3)
    rng = np.random.default_rng(1)
    d = jnp.asarray(rng.normal(size=np.asarray(sys.cp).shape)) * 1e-3
    K1 = assemble_K(sys.data, d, sys.cp, sys.h_init)
    K0 = _assemble_K_scatter(sys.data, d, sys.cp, sys.h_init)
    scale = float(jnp.max(jnp.abs(K0)))
    assert float(jnp.max(jnp.abs(K1 - K0))) < 1e-11 * scale
