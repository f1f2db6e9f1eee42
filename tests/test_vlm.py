"""Vortex-lattice aero solver (physics/vlm.py) + the coupled
aeroelastic loop (the reference's VortexAD role, reference:
demos_csdl_alpha/ex_caddee/kl_shell_aeroelastic_coupling.py:99-195)."""

import jax.numpy as jnp
import numpy as np
import pytest


def _flat_halfwing(Mc=8, Ns=16, half_span=4.0, chord=1.0):
    x = np.linspace(0, chord, Mc + 1)
    y = np.linspace(0, half_span, Ns + 1)
    X, Y = np.meshgrid(x, y, indexing="ij")
    return jnp.asarray(np.stack([X, Y, np.zeros_like(X)], -1))


def test_vlm_lift_slope_vs_helmbold():
    """Rectangular AR-8 wing: CL_alpha within 10% of the Helmbold
    finite-wing estimate 2 pi AR / (2 + sqrt(AR^2 + 4))."""
    from goldfish_jax.physics.vlm import solve_panel_forces

    corners = _flat_halfwing()
    alpha = 0.05
    F, aux = solve_panel_forces(corners, jnp.asarray(alpha), V_inf=1.0,
                                rho=1.0)
    L = 2 * float(aux["lift"])
    S = 2 * 4.0 * 1.0
    CLa = L / (0.5 * S) / alpha
    AR = 8.0
    helmbold = 2 * np.pi * AR / (2 + np.sqrt(AR ** 2 + 4))
    assert abs(CLa - helmbold) / helmbold < 0.10, (CLa, helmbold)


def test_vlm_lift_scales_linearly_and_points_up():
    from goldfish_jax.physics.vlm import solve_panel_forces

    corners = _flat_halfwing(Mc=4, Ns=8)
    _, a1 = solve_panel_forces(corners, jnp.asarray(0.03))
    _, a2 = solve_panel_forces(corners, jnp.asarray(0.06))
    L1, L2 = float(a1["lift"]), float(a2["lift"])
    assert L1 > 0
    assert abs(L2 / L1 - 2.0) < 0.05   # small-alpha linearity


def test_vlm_gradient_wrt_geometry():
    """d(lift)/d(corner z) by AD vs FD: the surface-coupling path the
    aeroelastic adjoint runs through."""
    import jax

    from goldfish_jax.physics.vlm import solve_panel_forces

    corners = _flat_halfwing(Mc=4, Ns=6)

    def lift(dz):
        c = corners.at[..., 2].add(dz)
        _, aux = solve_panel_forces(c, jnp.asarray(0.05))
        return aux["lift"]

    rng = np.random.default_rng(0)
    v = jnp.asarray(rng.normal(size=corners.shape[:-1]))
    dz0 = jnp.zeros(corners.shape[:-1])
    g = jax.grad(lift)(dz0)
    eps = 1e-6
    fd = float((lift(dz0 + eps * v) - lift(dz0 - eps * v)) / (2 * eps))
    ad = float(jnp.sum(g * v))
    assert abs(ad - fd) / abs(fd) < 1e-7


@pytest.mark.slow
def test_coupled_vlm_aeroelastic_adjoint():
    """Full coupled loop: deformed-surface lattice -> VLM -> f_field ->
    shell solve, fixed point; coupled dJ/dh FD-verified (the demo
    asserts rel < 1e-5 internally)."""
    from demos.vlm_aeroelastic_wing import main

    J, lift, tip, gh, rel, sys_ = main(num_el=2, p=2, mc=5, ns=8,
                                       n_fp=3, verbose=False)
    assert np.isfinite(J) and J > 0
    assert lift > 0 and float(tip[2]) > 0   # lift bends the wing up
    assert rel < 1e-5
