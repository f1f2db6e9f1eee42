"""Host-side optimization driver: SLSQP over jitted JAX callbacks.

The rebuild's replacement for the OpenMDAO Group + ScipyOptimizeDriver
pattern every reference demo uses (reference:
demos_om/thickness_opt/plate/plate_var_th_opt_wint.py:338-364): design
variables, constraints and the objective are plain JAX functions of a
dict of design arrays; this driver flattens/scales them, jits
value-and-grad / jacobian evaluations (one XLA computation per
optimizer callback — the whole forward solve + adjoint runs on device),
and hands scipy SLSQP the host-side numbers. Optimizers stay host-side
by design (SURVEY.md section 2.4, OpenMDAO row).

Warm starting: the objective may thread an arbitrary non-differentiated
state pytree (typically the previous displacement solution) through
successive evaluations — the analogue of the reference keeping
`spline_funcs` between iterations.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
from scipy.optimize import minimize

from goldfish_jax.solver.linalg import jit_for_path
from goldfish_jax.utils.retry import retry_transient

__all__ = ["OptProblem", "OptResult"]


@dataclass
class _DesignVar:
    name: str
    init: np.ndarray
    lower: float | np.ndarray | None
    upper: float | np.ndarray | None
    scaler: float


@dataclass
class _Constraint:
    name: str
    fn: Callable
    equals: np.ndarray | None
    lower: np.ndarray | None
    upper: np.ndarray | None
    scaler: float


@dataclass
class OptResult:
    x: dict
    fun: float
    nit: int
    success: bool
    message: str
    history: list = field(default_factory=list)
    nfev: int = -1   # objective (forward-only) evaluations
    njev: int = -1   # gradient (adjoint) evaluations


class OptProblem:
    """Declarative optimization problem over named design arrays."""

    def __init__(self):
        self._dvs: list[_DesignVar] = []
        self._cons: list[_Constraint] = []
        self._obj = None
        self._obj_scaler = 1.0
        self._state0 = None
        self.state_box = [None]
        self.iter_callback = None
        self._callables = None

    # ------------------------------------------------------------ setup
    def add_design_var(self, name, init, lower=None, upper=None,
                       scaler=1.0):
        self._callables = None
        self._dvs.append(_DesignVar(
            name, np.asarray(init, dtype=np.float64), lower, upper,
            float(scaler)))

    def set_objective(self, fn, scaler=1.0, state0=None):
        """fn(dvs: dict) -> scalar, or fn(dvs, state) -> (scalar, state)
        when `state0` is given (state is threaded, not differentiated).

        The live threaded state is held in `self.state_box` (a one-item
        mutable list) so checkpointing (utils/checkpoint.resume_run)
        can snapshot/rehydrate the warm start across process deaths."""
        self._callables = None
        self._obj = fn
        self._obj_scaler = float(scaler)
        self._state0 = state0
        self.state_box = [state0]

    def add_constraint(self, name, fn, equals=None, lower=None, upper=None,
                       scaler=1.0):
        """fn(dvs: dict) -> vector (or scalar)."""
        self._callables = None
        to = lambda v: None if v is None else np.atleast_1d(
            np.asarray(v, dtype=np.float64))
        self._cons.append(_Constraint(name, fn, to(equals), to(lower),
                                      to(upper), float(scaler)))

    # ------------------------------------------------------- flattening
    def _pack_info(self):
        sizes = [v.init.size for v in self._dvs]
        offs = np.cumsum([0] + sizes)
        return offs, int(offs[-1])

    def _unflatten(self, x):
        offs, _ = self._pack_info()
        out = {}
        for v, o0, o1 in zip(self._dvs, offs[:-1], offs[1:]):
            out[v.name] = jnp.reshape(x[o0:o1], v.init.shape) / v.scaler
        return out

    def _x0(self):
        return np.concatenate(
            [v.scaler * v.init.ravel() for v in self._dvs])

    def _bounds(self):
        bs = []
        for v in self._dvs:
            lo = -np.inf if v.lower is None else v.lower
            hi = np.inf if v.upper is None else v.upper
            lo = np.broadcast_to(np.asarray(lo, dtype=np.float64) * v.scaler,
                                 (v.init.size,))
            hi = np.broadcast_to(np.asarray(hi, dtype=np.float64) * v.scaler,
                                 (v.init.size,))
            bs.append(np.stack([lo, hi], axis=1))
        return np.concatenate(bs, axis=0)

    # ------------------------------------------------------------- run
    def run(self, optimizer="SLSQP", maxiter=100, tol=1e-9,
            verbose=False, opt_settings=None):
        """Pluggable optimizer front end (the reference's SNOPT/SLSQP
        switch, reference: demos_om/thickness_opt/plate/
        plate_var_th_opt_wint.py:342-361): 'SLSQP' (scipy, built in),
        'SNOPT'/'IPOPT'/... via pyoptsparse when installed."""
        if optimizer.upper() == "SLSQP":
            return self.run_slsqp(maxiter=maxiter, tol=tol,
                                  verbose=verbose)
        return self._run_pyoptsparse(optimizer, maxiter=maxiter,
                                     tol=tol, verbose=verbose,
                                     opt_settings=opt_settings or {})

    @staticmethod
    def _import_pyoptsparse():
        """Real pyoptsparse when installed, else the in-repo
        API-subset shim (goldfish_jax/pyoptsparse_shim.py) — the same
        gating move as om_comps/components.py:29 for OpenMDAO."""
        try:
            import pyoptsparse
            return pyoptsparse
        except ModuleNotFoundError:
            from goldfish_jax import pyoptsparse_shim
            return pyoptsparse_shim

    def _run_pyoptsparse(self, optimizer, maxiter, tol, verbose,
                         opt_settings):
        """pyOptSparse driver (SNOPT et al.); runs on the real package
        when installed, else on the executable in-repo API shim
        (pyoptsparse_shim.py) so this path is exercised either way.

        Sensitivities are ANALYTIC: the same jax.value_and_grad /
        jacrev adjoint totals the SLSQP path uses, handed to
        pyOptSparse as a `sens` callback — at KL-shell conditioning FD
        totals are both inaccurate and O(n_dv) solves per iteration.
        pyOptSparse sees the SCALED design space (value = scaler*init,
        like run_slsqp), matching `_unflatten`'s descaling."""
        import numpy as np
        pyoptsparse = self._import_pyoptsparse()

        names = [dv.name for dv in self._dvs]
        offs, _ = self._pack_info()
        slices = {dv.name: slice(int(o0), int(o1))
                  for dv, o0, o1 in zip(self._dvs, offs[:-1], offs[1:])}
        state_box = self.state_box

        def _flat(xdict):
            return jnp.concatenate([jnp.asarray(xdict[n]).ravel()
                                    for n in names])

        def objfun(xdict):
            dvs = self._unflatten(_flat(xdict))
            if self._state0 is not None:
                J, new_state = self._obj(dvs, state_box[0])
                # commit the warm-start state only when finite — a
                # diverged trial must not poison later evaluations
                # (same guard as run_slsqp)
                if bool(jax.device_get(jnp.isfinite(new_state).all())):
                    state_box[0] = new_state
            else:
                J = self._obj(dvs)
            funcs = {"obj": float(self._obj_scaler * J)}
            for c in self._cons:
                funcs[c.name] = np.asarray(
                    c.scaler * jnp.atleast_1d(c.fn(dvs)))
            return funcs, False

        objfun = retry_transient(objfun)

        if self._state0 is not None:
            def raw(x, state):
                J, new_state = self._obj(self._unflatten(x), state)
                return self._obj_scaler * J, new_state

            vg_obj = jax.value_and_grad(raw, has_aux=True)
        else:
            vg_obj = jax.value_and_grad(
                lambda x: self._obj_scaler * self._obj(
                    self._unflatten(x)))
        con_jacs = {
            c.name: jax.jacrev(
                lambda x, c=c: c.scaler * jnp.atleast_1d(
                    c.fn(self._unflatten(x))))
            for c in self._cons}

        n_sens = [0]

        def sens(xdict, funcs):
            x = _flat(xdict)
            if self._state0 is not None:
                (_, new_state), g = vg_obj(x, state_box[0])
                if bool(jax.device_get(jnp.isfinite(new_state).all())):
                    state_box[0] = new_state
            else:
                _, g = vg_obj(x)
            g = np.asarray(g, dtype=np.float64)
            out = {"obj": {n: g[slices[n]] for n in names}}
            for c in self._cons:
                Jc = np.asarray(con_jacs[c.name](x), dtype=np.float64)
                out[c.name] = {n: Jc[:, slices[n]] for n in names}
            # pyOptSparse calls sens once per accepted major iteration —
            # the analogue of run_slsqp's per-iteration callback hook
            # (problem.py cb), so checkpointing (utils/checkpoint) fires
            # on this path too. Same convention as run_slsqp: the
            # callback sees the SCALED objective. The FIRST sens call is
            # the start-point gradient (SNOPT and the shim's scipy
            # engines both evaluate it before any step is accepted) —
            # skip it so the persisted 'iter' counter matches accepted
            # iterations and resume_run's remaining budget is exact.
            n_sens[0] += 1
            if self.iter_callback is not None and n_sens[0] > 1:
                self.iter_callback(self._unflatten(x),
                                   float(np.asarray(funcs["obj"]).ravel()[0]))
            return out, False

        sens = retry_transient(sens)

        prob = pyoptsparse.Optimization("goldfish_jax", objfun)
        sc = lambda v, s: None if v is None else np.asarray(v) * s
        for dv in self._dvs:
            prob.addVarGroup(dv.name, int(np.asarray(dv.init).size),
                             value=dv.scaler * np.asarray(dv.init),
                             lower=sc(dv.lower, dv.scaler),
                             upper=sc(dv.upper, dv.scaler))
        prob.addObj("obj")
        for c in self._cons:
            n = int(np.atleast_1d(np.asarray(
                c.fn(self._unflatten(self._x0())))).size)
            kw = {}
            if c.equals is not None:
                kw = dict(lower=c.scaler * c.equals,
                          upper=c.scaler * c.equals)
            else:
                if c.lower is not None:
                    kw["lower"] = c.scaler * c.lower
                if c.upper is not None:
                    kw["upper"] = c.scaler * c.upper
            prob.addConGroup(c.name, n, **kw)
        opt_cls = getattr(pyoptsparse, optimizer.upper())
        # run()'s generic maxiter/tol, translated to each wrapper's own
        # option names; explicit opt_settings win.
        generic = {
            "SNOPT": {"Major iterations limit": int(maxiter),
                      "Major optimality tolerance": float(tol)},
            "IPOPT": {"max_iter": int(maxiter), "tol": float(tol)},
            "SLSQP": {"MAXIT": int(maxiter), "ACC": float(tol)},
            "PSQP": {"MIT": int(maxiter), "TOLG": float(tol)},
        }.get(optimizer.upper(), {})
        opt = opt_cls(options={**generic, **dict(opt_settings)})
        sol = opt(prob, sens=sens)
        x = jnp.concatenate([jnp.asarray(sol.xStar[n]).ravel()
                             for n in names])
        xdict = {k: np.asarray(v)
                 for k, v in self._unflatten(x).items()}
        # descale like run_slsqp (res.fun / self._obj_scaler): callers
        # must see the same objective value whichever driver ran
        return OptResult(x=xdict,
                         fun=float(np.asarray(sol.fStar).ravel()[0])
                         / self._obj_scaler,
                         nit=int(getattr(sol, "nIter", -1)),
                         success=bool(getattr(sol, "success", True)),
                         message=str(sol.optInform),
                         history=[])

    def preflight(self):
        """Untimed first evaluation of EVERY optimizer callable at x0:
        the forward-only objective, the gradient pair, and each
        constraint value/jacobian, so that a later `run_slsqp` (which
        reuses the same callables) compiles nothing. A warm-up that only
        exercises value_and_grad misses the forward-only and constraint
        programs. Also settles the warm-start state at x0."""
        fun, jac, cons = self._build_callables()
        x0 = self._x0()
        # fun BEFORE jac: jac seeds the fun memo, so the reverse order
        # never executes (or compiles) the forward-only callable
        fun(x0)
        jac(x0)
        for c in cons:
            c["fun"](x0)
            c["jac"](x0)

    def run_slsqp(self, maxiter=100, tol=1e-9, verbose=False):
        fun, jac, cons = self._build_callables()

        history = []

        def cb(x):
            J = fun(x)
            history.append(J)
            if verbose:
                print(f"  slsqp iter {len(history)}: J = {J:.6e}")
            if self.iter_callback is not None:
                self.iter_callback(self._unflatten(jnp.asarray(x)), J)

        res = minimize(
            fun, self._x0(), jac=jac, method="SLSQP",
            bounds=self._bounds(), constraints=cons, callback=cb,
            options=dict(maxiter=maxiter, ftol=tol, disp=verbose))

        xdict = {k: np.asarray(v) for k, v in
                 self._unflatten(jnp.asarray(res.x)).items()}
        return OptResult(x=xdict, fun=float(res.fun) / self._obj_scaler,
                         nit=int(res.nit), success=bool(res.success),
                         message=str(res.message), history=history,
                         nfev=int(getattr(res, "nfev", -1)),
                         njev=int(getattr(res, "njev", -1)))

    def _build_callables(self):
        """(fun, jac, constraints) with single-entry memos — the scipy
        SLSQP surface. Built once per problem definition and shared by
        preflight and run_slsqp, so their compiled programs are too."""
        if self._callables is None:
            self._callables = self._make_callables()
        return self._callables

    def _make_callables(self):
        assert self._obj is not None, "set_objective first"
        has_state = self._state0 is not None
        state_box = self.state_box

        # SEPARATE fun and jac callables (NOT a combined jac=True
        # callback): scipy wraps a combined callback in MemoizeJac,
        # which computes the GRADIENT at every fun(x) call — so every
        # SLSQP line-search TRIAL point paid a full adjoint solve + vjp
        # (~2 s each at pegasus scale, plus persistent-factor churn at
        # wild trial states) for a number it never uses. With the
        # split, trials pay forward-only; the gradient runs only where
        # scipy asks for it (accepted iterates), where the forward
        # re-entry inside value_and_grad is warm (the Newton loop exits
        # at its entry convergence check).
        if has_state:
            def raw(x, state):
                dvs = self._unflatten(x)
                J, new_state = self._obj(dvs, state)
                return self._obj_scaler * J, new_state

            f_fwd = jit_for_path(raw)
            vg = jit_for_path(jax.value_and_grad(raw, has_aux=True))

            def f_fun(x):
                J, new_state = f_fwd(jnp.asarray(x), state_box[0])
                # ONE batched readback (each separate float()/asarray
                # is its own device-to-host sync), and the
                # warm-start state commits ONLY when finite: a diverged
                # line-search trial must not poison every subsequent
                # evaluation's warm start with NaN
                ok_ = jnp.isfinite(new_state).all()
                Jv, ok = jax.device_get((J, ok_))
                if bool(ok):
                    state_box[0] = new_state
                return float(Jv)

            def f_jac(x):
                (J, new_state), g = vg(jnp.asarray(x), state_box[0])
                ok_ = jnp.isfinite(new_state).all()
                Jv, gv, ok = jax.device_get((J, g, ok_))
                if bool(ok):
                    state_box[0] = new_state
                return float(Jv), np.asarray(gv, dtype=np.float64)
        else:
            def raw(x):
                return self._obj_scaler * self._obj(self._unflatten(x))

            f_fwd = jit_for_path(raw)
            vg = jit_for_path(jax.value_and_grad(raw))

            def f_fun(x):
                return float(jax.device_get(f_fwd(jnp.asarray(x))))

            def f_jac(x):
                J, g = vg(jnp.asarray(x))
                Jv, gv = jax.device_get((J, g))
                return float(Jv), np.asarray(gv, dtype=np.float64)

        # survive transient device failures (worker restarts): the
        # evaluations are pure (state commits only on success), so
        # a retry is an exact re-run (utils/retry.py)
        f_fun = retry_transient(f_fun)
        f_jac = retry_transient(f_jac)

        # per-eval stage attribution (GOLDFISH_TRACE_EVAL=1, round-5
        # verdict item 1: the pegasus per-evaluation gaps)
        from goldfish_jax.utils import evtrace

        if evtrace.enabled:
            _f_fun, _f_jac = f_fun, f_jac

            def f_fun(x):
                with evtrace.span("opt.fun"):
                    return _f_fun(x)

            def f_jac(x):
                with evtrace.span("opt.jac"):
                    return _f_jac(x)

        # single-entry memos: scipy's ScalarFunction caches the last x
        # on ITS side, but the per-iteration callback below calls the
        # objective directly — without this memo every SLSQP iteration
        # paid one FULL extra objective evaluation (a forward solve)
        # just to print/record J, and scipy's next-iteration fun(x) at
        # the same accepted point paid yet another. A jac evaluation
        # also yields J, so it seeds the fun memo.
        _memo_f = {}
        _memo_g = {}

        def fun(x):
            key = np.asarray(x, dtype=np.float64).tobytes()
            if _memo_f.get("k") != key:
                _memo_f["k"], _memo_f["v"] = key, f_fun(x)
            return _memo_f["v"]

        def jac(x):
            key = np.asarray(x, dtype=np.float64).tobytes()
            if _memo_g.get("k") != key:
                Jv, gv = f_jac(x)
                _memo_g["k"], _memo_g["v"] = key, gv
                _memo_f["k"], _memo_f["v"] = key, Jv
            return _memo_g["v"]

        cons = []
        for c in self._cons:
            _cfn = jit_for_path(lambda x, c=c: c.scaler * jnp.atleast_1d(
                c.fn(self._unflatten(x))))
            _cjac = jit_for_path(jax.jacrev(
                lambda x, c=c: c.scaler * jnp.atleast_1d(
                    c.fn(self._unflatten(x)))))
            # the retry must wrap the device->HOST readback too: a
            # device failure surfaces at the blocking transfer
            # (np.asarray), not at the dispatch
            from goldfish_jax.utils import evtrace as _ev

            def _traced(f, tag, name=c.name):
                if not _ev.enabled:
                    return f

                def g(x):
                    with _ev.span(tag, con=name):
                        return f(x)
                return g

            cfn = retry_transient(_traced(
                lambda x, f=_cfn: np.asarray(f(jnp.asarray(x))),
                "opt.con"))
            cjac = retry_transient(_traced(
                lambda x, f=_cjac: np.asarray(f(jnp.asarray(x))),
                "opt.conjac"))
            if c.equals is not None:
                t = c.scaler * c.equals
                cons.append(dict(
                    type="eq",
                    fun=lambda x, cfn=cfn, t=t: cfn(x) - t,
                    jac=lambda x, cjac=cjac: cjac(x)))
            if c.lower is not None:
                t = c.scaler * c.lower
                cons.append(dict(
                    type="ineq",
                    fun=lambda x, cfn=cfn, t=t: cfn(x) - t,
                    jac=lambda x, cjac=cjac: cjac(x)))
            if c.upper is not None:
                t = c.scaler * c.upper
                cons.append(dict(
                    type="ineq",
                    fun=lambda x, cfn=cfn, t=t: t - cfn(x),
                    jac=lambda x, cjac=cjac: -cjac(x)))

        return fun, jac, cons
