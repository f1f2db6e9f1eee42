"""OptProblem.run_slsqp evaluation semantics (round-3 fixes):

- the per-iteration callback must not pay a FULL extra
  objective+gradient evaluation (it memoizes against the line-search
  evaluation at the same accepted point);
- line-search TRIAL evaluations must be FORWARD-ONLY: fun and jac are
  handed to scipy as separate callables (a combined jac=True callback
  goes through scipy's MemoizeJac, which computes the gradient — a
  full adjoint solve — at every trial point);
- a diverged trial evaluation (non-finite new_state) must not poison
  the warm-start state for every subsequent evaluation.

Role reference: the reference drives scipy/pyoptsparse through
OpenMDAO drivers (GOLDFISH/demos_om/thickness_opt/plate_var_th_opt_
wint.py:330-361); state warm-starting across evaluations is this
build's addition."""

import jax
import jax.numpy as jnp
import numpy as np

from goldfish_jax.opt.problem import OptProblem


def test_run_slsqp_callback_is_memoized():
    calls = {"n": 0}

    def bump():
        calls["n"] += 1

    def obj(dvs, state):
        jax.debug.callback(bump)
        x = dvs["x"]
        return jnp.sum((x - 1.0) ** 2), state

    prob = OptProblem()
    prob.add_design_var("x", jnp.asarray([4.0, -3.0]))
    prob.set_objective(obj, state0=jnp.asarray(0.0))
    res = prob.run_slsqp(maxiter=6, tol=1e-12, verbose=True)
    assert res.fun < 1e-10
    # history came from the callback; each entry must have been served
    # from the memo (<= one real forward per fun eval + one per jac
    # eval: scipy's own line-search/gradient evals, but NO callback
    # duplicates)
    assert len(res.history) >= 1
    assert calls["n"] <= res.nfev + res.njev + 1, (calls, res)


def test_run_slsqp_trials_are_forward_only():
    """The backward pass (the adjoint solve in production) must run
    ONLY for scipy's gradient requests, never inside line-search trial
    evaluations — pinned with a custom_vjp whose bwd bumps a counter."""
    n_bwd = {"n": 0}

    def bump_bwd():
        n_bwd["n"] += 1

    @jax.custom_vjp
    def f(x):
        return jnp.sum((x - 1.0) ** 2)

    def f_fwd(x):
        return f(x), x

    def f_bwd(x, g):
        jax.debug.callback(bump_bwd)
        return (2.0 * g * (x - 1.0),)

    f.defvjp(f_fwd, f_bwd)

    def obj(dvs, state):
        return f(dvs["x"]), state

    prob = OptProblem()
    prob.add_design_var("x", jnp.asarray([4.0, -3.0, 2.5]))
    prob.set_objective(obj, state0=jnp.asarray(0.0))
    res = prob.run_slsqp(maxiter=8, tol=1e-12)
    assert res.fun < 1e-10
    assert res.nfev >= res.njev  # sanity: scipy counted both
    # every backward execution corresponds to a scipy gradient request
    # (plus at most one warm-up); trial evals ran forward-only
    assert n_bwd["n"] <= res.njev + 1, (n_bwd, res)


def test_run_slsqp_state_guard_survives_diverged_trial():
    """new_state = 0.5*state + (NaN when x strays): without the commit
    guard the first wild evaluation poisons every later warm start."""

    def obj(dvs, state):
        x = dvs["x"]
        bad = jnp.where(x[0] > 10.0, jnp.nan, 1.0)
        return jnp.sum((x - 1.0) ** 2), 0.5 * state + bad

    prob = OptProblem()
    prob.add_design_var("x", jnp.asarray([20.0]))  # starts in the bad zone
    prob.set_objective(obj, state0=jnp.asarray(1.0))
    res = prob.run_slsqp(maxiter=20, tol=1e-12)
    assert res.fun < 1e-8
    assert bool(jnp.isfinite(prob.state_box[0]))
