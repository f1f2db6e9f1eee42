"""Adjoint gradient parity: jax.grad through the implicit solve vs
central finite differences (the rebuild's analogue of the reference's
prob.check_partials + dRIGAdCPIGA_FD oracles, reference:
GOLDFISH/nonmatching_opt.py:975-990, om_comps __main__ blocks)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from goldfish_jax.models import tbeam
from goldfish_jax.physics import kl_shell
from goldfish_jax.solver.implicit import build_solve_fn, newton_solve
from goldfish_jax.solver.system import residual


@pytest.fixture(scope="module")
def tb():
    sys = tbeam.build(num_el=4, p=2)
    solve = build_solve_fn(sys.data, rtol=1e-12, max_it=20)
    return sys, solve


def central_fd(f, x, v, eps):
    return (f(x + eps * v) - f(x - eps * v)) / (2 * eps)


def test_newton_converges(tb):
    sys, _ = tb
    d, it, rn = newton_solve(sys.data, sys.cp, sys.h_init,
                             sys.zero_displacement(), rtol=1e-12)
    assert int(it) < 20
    r0 = np.linalg.norm(np.asarray(
        residual(sys.data, sys.zero_displacement(), sys.cp, sys.h_init)))
    # cond(K) ~ 3e9 puts the f64 noise floor near 1e-9 relative
    assert float(rn) < 1e-8 * r0
    # tip displaces in +z under +z load
    u_tip = sys.evaluate_displacement(d, 0, [1.0, 1.0])
    assert u_tip[2] > 0.0


def test_grad_wrt_thickness(tb):
    sys, solve = tb
    d0 = sys.zero_displacement()
    cp = sys.cp

    def J(h):
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys.stack, d, cp, h, sys.E, sys.nu)

    g = jax.grad(J)(sys.h_init)
    rng = np.random.default_rng(0)
    v = rng.normal(size=sys.h_init.shape) * np.asarray(sys.stack.cp_mask)
    v = jnp.asarray(v)
    fd = central_fd(J, sys.h_init, v, 1e-5)
    ad = jnp.sum(g * v)
    assert abs(float(ad - fd)) / abs(float(fd)) < 1e-6


def test_grad_wrt_control_points(tb):
    sys, solve = tb
    d0 = sys.zero_displacement()
    h = sys.h_init

    def J(cp):
        d = solve(cp, h, d0)
        return kl_shell.internal_energy(sys.stack, d, cp, h, sys.E, sys.nu)

    g = jax.grad(J)(sys.cp)
    rng = np.random.default_rng(1)
    v = rng.normal(size=sys.cp.shape) * np.asarray(sys.stack.cp_mask)[..., None]
    v = jnp.asarray(v) * 1e-1
    fd = central_fd(J, sys.cp, v, 1e-5)
    ad = jnp.sum(g * v)
    assert abs(float(ad - fd)) / abs(float(fd)) < 1e-6


def test_grad_volume_wrt_cp_and_h(tb):
    sys, _ = tb

    def V(cp, h):
        return kl_shell.volume(sys.stack, cp, h)

    gcp, gh = jax.grad(V, argnums=(0, 1))(sys.cp, sys.h_init)
    rng = np.random.default_rng(2)
    vc = jnp.asarray(rng.normal(size=sys.cp.shape)
                     * np.asarray(sys.stack.cp_mask)[..., None])
    vh = jnp.asarray(rng.normal(size=sys.h_init.shape)
                     * np.asarray(sys.stack.cp_mask))
    fd = central_fd(lambda cp: V(cp, sys.h_init), sys.cp, vc, 1e-6)
    assert abs(float(jnp.sum(gcp * vc) - fd)) / abs(float(fd)) < 1e-7
    fd = central_fd(lambda h: V(sys.cp, h), sys.h_init, vh, 1e-6)
    assert abs(float(jnp.sum(gh * vh) - fd)) / abs(float(fd)) < 1e-7


def test_adjoint_with_follower_pressure():
    """FOLLOWER pressure contributes a d-dependent load stiffness that
    the tangent (hence the adjoint) must include — omitting it cost a
    silent 1.5% gradient error on pressurized models (round-2 fix).
    dJ/dh vs central FD on a pressurized tube."""
    from goldfish_jax.models import tube

    sys = tube.build(num_el=2, p=2, pressure=2.0e4)
    solve = build_solve_fn(sys.data, rtol=1e-11, max_it=30)
    d0 = sys.zero_displacement()
    rng = np.random.default_rng(7)
    v = jnp.asarray(rng.normal(size=np.asarray(sys.h_init).shape)
                    * np.asarray(sys.stack.cp_mask))

    def J(h):
        d = solve(sys.cp, h, d0)
        return kl_shell.internal_energy(sys.stack, d, sys.cp, h,
                                        sys.E, sys.nu)

    g = jax.grad(J)(sys.h_init)
    eps = 1e-6
    fd = (J(sys.h_init + eps * v) - J(sys.h_init - eps * v)) / (2 * eps)
    ad = float(jnp.sum(g * v))
    assert abs(ad - float(fd)) / abs(float(fd)) < 1e-6, (ad, float(fd))
