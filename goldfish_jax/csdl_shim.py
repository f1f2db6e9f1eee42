"""Executable csdl_alpha-compatible runtime (API subset).

The mirror of `om_shim.py` for the CSDL adapter layer: csdl_alpha is
not installed in this image, so this module implements the exact API
subset `csdl_models/models.py` and the reference's csdl demos use
(reference: demos_csdl_alpha/thickness_opt/plate_const_th_opt_wint.py:
196-250 — Recorder/Variable/VariableGroup/matvec, custom operations,
PySimulator.check_totals, modopt CSDLAlphaProblem+SLSQP;
GOLDFISH/csdl_models/disp_states_model.py:107-177 — the
CustomImplicitOperation hook protocol), so the CSDL layer EXECUTES in
CI instead of being syntax-checked.

Semantics pinned to the reference implementations:

- `compute_jacvec_product` (rev) ACCUMULATES into `d_inputs` — the
  reference op layer does `d_inputs_array_list[i][:] += ...`
  (reference: GOLDFISH/operations/disp_imop.py:115-127); the runtime
  pre-seeds declared inputs with zeros so `+=` is well-defined, and a
  model that merely assigns still works for single-consumer graphs but
  is flagged by tests/test_csdl_adapters.py's multi-consumer check.
- Implicit total-derivative convention (OpenMDAO-equivalent): for
  R(u, x) = 0, du/dx = -K^{-1} dR/dx. The runtime applies the minus
  sign when composing `apply_inverse_jacobian` with
  `compute_jacvec_product`, matching how OpenMDAO drives the same
  hooks (reference: om_comps/disp_states_comp.py:81-144).

Everything is eager numpy at the graph boundary; the heavy lifting
stays inside the jitted operations layer (goldfish_jax/operations/*).
"""

from __future__ import annotations

import numpy as np

__all__ = ["Recorder", "Variable", "VariableGroup", "matvec",
           "check_parameter", "CustomExplicitOperation", "experimental",
           "verify_derivatives_inline", "CSDLAlphaProblem", "SLSQP"]

_ACTIVE: list["Recorder"] = []


def _recorder() -> "Recorder":
    if not _ACTIVE:
        # implicit default recorder (inline), so bare evaluate() works
        Recorder(inline=True).start()
    return _ACTIVE[-1]


class Recorder:
    """Records the operation graph; inline=True executes eagerly
    (reference usage: csdl.Recorder(inline=True), plate demo :196)."""

    def __init__(self, inline: bool = True):
        self.inline = inline
        self.nodes: list[_Node] = []
        self.variables: list[Variable] = []

    def start(self):
        _ACTIVE.append(self)
        return self

    def stop(self):
        if _ACTIVE and _ACTIVE[-1] is self:
            _ACTIVE.pop()

    # ---- execution engine
    def run(self):
        for node in self.nodes:
            node.execute()

    def design_variables(self):
        return [v for v in self.variables if v._design is not None]

    def constraints(self):
        return [v for v in self.variables if v._constraint is not None]

    def objective(self):
        objs = [v for v in self.variables if v._objective is not None]
        return objs[0] if objs else None


class Variable:
    """Graph variable; `.value` is a numpy array (inline mode keeps it
    current)."""

    def __init__(self, value=None, name=None, shape=None):
        if value is not None:
            self.value = np.atleast_1d(np.asarray(value, dtype=np.float64))
        else:
            self.value = np.zeros(shape, dtype=np.float64)
        self.shape = self.value.shape
        self.name = name
        self.names = [name] if name else []
        self.node: _Node | None = None   # producing node (None = indep)
        self._design = None
        self._constraint = None
        self._objective = None
        _recorder().variables.append(self)

    def add_name(self, name):
        self.names.append(name)
        if self.name is None:
            self.name = name

    @property
    def size(self):
        return self.value.size

    def set_value(self, v):
        self.value = np.asarray(v, dtype=np.float64).reshape(self.shape)

    def set_as_design_variable(self, lower=None, upper=None, scaler=None):
        self._design = dict(lower=lower, upper=upper,
                            scaler=1.0 if scaler is None else float(scaler))

    def set_as_constraint(self, lower=None, upper=None, equals=None,
                          scaler=None):
        self._constraint = dict(
            lower=lower, upper=upper, equals=equals,
            scaler=1.0 if scaler is None else float(scaler))

    def set_as_objective(self, scaler=None):
        self._objective = dict(
            scaler=1.0 if scaler is None else float(scaler))


class VariableGroup:
    """Attribute bag (csdl.VariableGroup)."""


def check_parameter(*args, **kwargs):
    return None


class _Node:
    """One recorded operation: kind in {'matvec', 'explicit',
    'implicit'}; executes / propagates jvp (fwd) / vjp (rev)."""

    def __init__(self, kind, inputs, outputs, op=None, A=None):
        self.kind = kind
        self.inputs = dict(inputs)    # local name -> Variable
        self.outputs = dict(outputs)  # local name -> Variable
        self.op = op
        self.A = A
        for v in self.outputs.values():
            v.node = self
        rec = _recorder()
        rec.nodes.append(self)
        if rec.inline:
            self.execute()

    # ------------------------------------------------------------ fwd
    def _in_vals(self):
        return {k: np.array(v.value, copy=True)
                for k, v in self.inputs.items()}

    def _out_vals(self):
        return {k: np.array(v.value, copy=True)
                for k, v in self.outputs.items()}

    def execute(self):
        if self.kind == "matvec":
            x = next(iter(self.inputs.values()))
            y = next(iter(self.outputs.values()))
            y.set_value(self.A @ x.value)
            return
        ins = self._in_vals()
        outs = self._out_vals()   # implicit: previous value = warm start
        if self.kind == "explicit":
            self.op.compute(ins, outs)
        else:
            self.op.solve_residual_equations(ins, outs)
        for k, v in self.outputs.items():
            v.set_value(np.asarray(outs[k]))

    # ------------------------------------------------------- tangents
    def jvp(self, dx: dict):
        """dict localname->tangent for (a subset of) inputs ->
        dict localname->tangent for outputs."""
        if self.kind == "matvec":
            (kx,) = self.inputs.keys()
            (ky,) = self.outputs.keys()
            t = dx.get(kx)
            return {ky: self.A @ t if t is not None
                    else np.zeros(self.outputs[ky].shape)}
        ins = self._in_vals()
        outs = self._out_vals()
        if self.kind == "explicit":
            derivs = {}
            self.op.compute_derivatives(ins, outs, derivs)
            dy = {}
            for ko, vo in self.outputs.items():
                acc = np.zeros(vo.value.size)
                for ki in self.inputs:
                    t = dx.get(ki)
                    if t is not None and (ko, ki) in derivs:
                        acc = acc + np.asarray(derivs[ko, ki]) @ t.ravel()
                dy[ko] = acc.reshape(vo.shape)
            return dy
        # implicit: du = -K^{-1} (dR/dx dx)
        d_inputs = {k: np.asarray(t, dtype=np.float64)
                    for k, t in dx.items() if t is not None}
        d_residuals = {}
        self.op.compute_jacvec_product(ins, outs, d_inputs, {},
                                       d_residuals, "fwd")
        d_outputs = {}
        self.op.apply_inverse_jacobian(ins, outs, d_outputs,
                                       d_residuals, "fwd")
        return {k: -np.asarray(v).reshape(self.outputs[k].shape)
                for k, v in d_outputs.items()}

    def vjp(self, ybar: dict):
        """dict localname->cotangent for outputs -> dict
        localname->cotangent contribution for inputs."""
        if self.kind == "matvec":
            (kx,) = self.inputs.keys()
            (ky,) = self.outputs.keys()
            yb = ybar.get(ky)
            if yb is None:
                return {}
            return {kx: self.A.T @ yb}
        ins = self._in_vals()
        outs = self._out_vals()
        if self.kind == "explicit":
            derivs = {}
            self.op.compute_derivatives(ins, outs, derivs)
            xbar = {}
            for ko in self.outputs:
                yb = ybar.get(ko)
                if yb is None:
                    continue
                for ki, vi in self.inputs.items():
                    if (ko, ki) in derivs:
                        contrib = np.asarray(derivs[ko, ki]).T @ yb.ravel()
                        xbar[ki] = xbar.get(
                            ki, np.zeros(vi.value.size)) + contrib
            return xbar
        # implicit adjoint: K^T lam = ybar; xbar = -(dR/dx)^T lam
        d_outputs = {k: np.asarray(v, dtype=np.float64)
                     for k, v in ybar.items() if v is not None}
        if not d_outputs:
            return {}
        d_residuals = {}
        self.op.apply_inverse_jacobian(ins, outs, d_outputs,
                                       d_residuals, "rev")
        seed = {k: -np.asarray(v) for k, v in d_residuals.items()}
        # pre-seed ALL declared inputs with zeros: the reference op
        # layer ACCUMULATES (+=) into them (disp_imop.py:115-127)
        d_inputs = {k: np.zeros(v.value.size)
                    for k, v in self.inputs.items()}
        self.op.compute_jacvec_product(ins, outs, d_inputs, {},
                                       seed, "rev")
        return {k: np.asarray(v) for k, v in d_inputs.items()}


# ---------------------------------------------------------------- ops
def matvec(A, x):
    """y = A @ x (reference: csdl.matvec in cpffd2surf_model.py etc.)."""
    Amat = A.value if isinstance(A, Variable) else np.asarray(A)
    y = Variable(shape=(Amat.shape[0],))
    _Node("matvec", {"x": x}, {"y": y}, A=np.asarray(Amat))
    return y


def _wrap_evaluate(cls):
    """Wrap a subclass's `evaluate` so the operation node is recorded
    (and inline-executed) when the user's evaluate returns."""
    fn = cls.__dict__.get("evaluate")
    if fn is None or getattr(fn, "_csdl_wrapped", False):
        return

    def evaluate(self, *args, **kwargs):
        self._cur_inputs = {}
        self._cur_outputs = {}
        ret = fn(self, *args, **kwargs)
        _Node(self._node_kind, self._cur_inputs, self._cur_outputs,
              op=self)
        return ret

    evaluate._csdl_wrapped = True
    cls.evaluate = evaluate


class _CustomOperationBase:
    _node_kind = "explicit"

    def __init__(self):
        self._cur_inputs = {}
        self._cur_outputs = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        _wrap_evaluate(cls)

    def declare_input(self, name, var):
        assert isinstance(var, Variable), (
            f"declare_input({name!r}) expects a csdl Variable")
        self._cur_inputs[name] = var

    def create_output(self, name, shape):
        v = Variable(shape=shape, name=name)
        self._cur_outputs[name] = v
        return v

    def declare_derivative_parameters(self, *args, **kwargs):
        return None


class CustomExplicitOperation(_CustomOperationBase):
    """Subclass provides compute(inputs, outputs) and
    compute_derivatives(inputs, outputs, derivatives)."""

    _node_kind = "explicit"


class _CustomImplicitOperation(_CustomOperationBase):
    """Subclass provides solve_residual_equations / compute_residual /
    compute_jacvec_product / apply_inverse_jacobian (reference hook
    set: GOLDFISH/csdl_models/disp_states_model.py:107-177)."""

    _node_kind = "implicit"


# ------------------------------------------------------------- totals
def _toposorted_reachable(rec, ofs):
    """Nodes that can influence `ofs`, in recorded (topological)
    order."""
    needed = set()
    frontier = [v for v in ofs]
    seen = set()
    while frontier:
        v = frontier.pop()
        if id(v) in seen or v.node is None:
            seen.add(id(v))
            continue
        seen.add(id(v))
        needed.add(id(v.node))
        frontier.extend(v.node.inputs.values())
    return [n for n in rec.nodes if id(n) in needed]


def compute_totals(rec, ofs, wrts, mode=None):
    """dict {(of, wrt): J (of.size, wrt.size)} by graph sweeps.

    mode 'fwd' seeds wrt columns, 'rev' seeds of rows; default picks
    the cheaper direction (sum of sizes), like OpenMDAO's auto mode."""
    nodes = _toposorted_reachable(rec, ofs)
    n_wrt = sum(v.size for v in wrts)
    n_of = sum(v.size for v in ofs)
    if mode is None:
        mode = "fwd" if n_wrt <= n_of else "rev"
    J = {(of, wrt): np.zeros((of.size, wrt.size))
         for of in ofs for wrt in wrts}
    if mode == "fwd":
        for wrt in wrts:
            for j in range(wrt.size):
                tang = {id(wrt): np.zeros(wrt.size)}
                tang[id(wrt)][j] = 1.0
                for node in nodes:
                    dx = {k: tang.get(id(v), None)
                          for k, v in node.inputs.items()}
                    if all(t is None for t in dx.values()):
                        continue
                    dy = node.jvp(dx)
                    for k, v in node.outputs.items():
                        if k in dy:
                            tang[id(v)] = tang.get(
                                id(v), np.zeros(v.size)) + dy[k].ravel()
                for of in ofs:
                    t = tang.get(id(of))
                    if t is not None:
                        J[of, wrt][:, j] = t
    else:
        for of in ofs:
            for i in range(of.size):
                cot = {id(of): np.zeros(of.size)}
                cot[id(of)][i] = 1.0
                for node in reversed(nodes):
                    yb = {k: cot.get(id(v), None)
                          for k, v in node.outputs.items()}
                    if all(t is None for t in yb.values()):
                        continue
                    xb = node.vjp({k: v for k, v in yb.items()
                                   if v is not None})
                    for k, v in node.inputs.items():
                        if k in xb:
                            cot[id(v)] = cot.get(
                                id(v), np.zeros(v.size)) + xb[k].ravel()
                for wrt in wrts:
                    c = cot.get(id(wrt))
                    if c is not None:
                        J[of, wrt][i, :] = c
    return J


class PySimulator:
    """csdl.experimental.PySimulator over the recorded graph
    (reference usage: plate_const_th_opt_wint.py:222-246)."""

    def __init__(self, recorder):
        self.recorder = recorder

    def run(self):
        self.recorder.run()

    def compute_totals(self, ofs, wrts, mode=None):
        self.run()
        return compute_totals(self.recorder, list(ofs), list(wrts),
                              mode=mode)

    def check_totals(self, ofs, wrts, step_size=1e-6,
                     raise_on_error=False, compact_print=True,
                     mode=None):
        """Graph totals vs central FD over the indep wrts. Returns
        {(of, wrt): {'J_an', 'J_fd', 'rel error', 'abs error'}}."""
        ofs = list(ofs)
        wrts = list(wrts)
        Jan = self.compute_totals(ofs, wrts, mode=mode)
        report = {}
        for wrt in wrts:
            assert wrt.node is None, \
                "check_totals wrt must be an independent Variable"
            Jfd = {of: np.zeros((of.size, wrt.size)) for of in ofs}
            base = np.array(wrt.value, copy=True)
            for j in range(wrt.size):
                for sgn in (+1.0, -1.0):
                    pert = np.array(base, copy=True).ravel()
                    pert[j] += sgn * step_size
                    wrt.set_value(pert.reshape(base.shape))
                    self.run()
                    for of in ofs:
                        Jfd[of][:, j] += sgn * of.value.ravel() / (
                            2.0 * step_size)
            wrt.set_value(base)
            self.run()
            for of in ofs:
                A, F = Jan[of, wrt], Jfd[of]
                abs_err = float(np.linalg.norm(A - F))
                denom = float(np.linalg.norm(F))
                rel = abs_err / denom if denom > 0 else abs_err
                report[of, wrt] = {"J_an": A, "J_fd": F,
                                   "abs error": abs_err,
                                   "rel error": rel}
                if compact_print:
                    o = of.name or "of"
                    w = wrt.name or "wrt"
                    print(f"check_totals d({o})/d({w}): rel "
                          f"{rel:.3e} abs {abs_err:.3e}")
                if raise_on_error and rel > 1e-4:
                    raise ValueError(
                        f"total derivative check failed: {rel:.3e}")
        return report


def verify_derivatives_inline(ofs, wrts, step_size=1e-6,
                              raise_on_error=False):
    """Reference helper name (csdl_alpha.src.operations.derivative
    .utils.verify_derivatives_inline, used at
    disp_states_model.py:226-229)."""
    sim = PySimulator(_recorder())
    return sim.check_totals(ofs, wrts, step_size=step_size,
                            raise_on_error=raise_on_error)


class _Experimental:
    CustomImplicitOperation = _CustomImplicitOperation
    PySimulator = PySimulator


experimental = _Experimental()


# ----------------------------------------------------- modopt facade
class CSDLAlphaProblem:
    """Minimal modopt.CSDLAlphaProblem stand-in (reference driver:
    plate_const_th_opt_wint.py:234-236)."""

    def __init__(self, problem_name, simulator):
        self.name = problem_name
        self.sim = simulator


class SLSQP:
    """Minimal modopt.SLSQP stand-in driving scipy over the recorded
    graph's design variables / objective / constraints."""

    def __init__(self, prob, solver_options=None, **kw):
        self.prob = prob
        self.options = dict(solver_options or {})
        self.result = None

    def solve(self):
        from scipy.optimize import minimize

        sim = self.prob.sim
        rec = sim.recorder
        dvs = rec.design_variables()
        obj = rec.objective()
        cons = rec.constraints()
        assert obj is not None, "no variable set_as_objective"
        sizes = [v.size for v in dvs]
        offs = np.cumsum([0] + sizes)
        obj_scaler = obj._objective["scaler"]

        # Internal design-variable normalization (modopt role): SLSQP
        # starts from an identity Hessian, so grossly mismatched x and
        # gradient scales (x ~ 1e-2, |g| ~ 1e4 on the plate demo) put
        # it on a knife-edge where 1e-9 gradient noise decides between
        # convergence and a spurious zero-step exit. Optimize
        # z = x / x_ref. Per group, x_ref honors (in order): the
        # user's set_as_design_variable scaler (x_ref = 1/scaler), the
        # |x0| magnitude, the bound magnitude (zero-initialized dvs:
        # |x0| = 0 must NOT freeze the group at x_ref = eps), else 1.
        def group_ref(v):
            sc = v._design.get("scaler", 1.0)
            if sc is not None and sc != 1.0:
                return 1.0 / float(sc)
            mag = float(np.abs(v.value).max())
            if mag > 1e-12:
                return mag
            bmag = max((float(np.max(np.abs(np.asarray(b))))
                        for b in (v._design.get("lower"),
                                  v._design.get("upper"))
                        if b is not None), default=0.0)
            return bmag if bmag > 1e-12 else 1.0

        x_ref = np.concatenate([
            np.full(v.size, group_ref(v)) for v in dvs])

        def set_x(z):
            x = np.asarray(z) * x_ref
            for v, o0, o1 in zip(dvs, offs[:-1], offs[1:]):
                v.set_value(x[o0:o1].reshape(v.shape))

        def f(z):
            set_x(z)
            sim.run()
            return obj_scaler * float(obj.value)

        def g(z):
            set_x(z)
            J = sim.compute_totals([obj], dvs, mode="rev")
            return obj_scaler * np.concatenate(
                [J[obj, v].ravel() for v in dvs]) * x_ref

        scipy_cons = []
        for c in cons:
            sc = c._constraint["scaler"]

            def cval(x, c=c, sc=sc):
                set_x(x)
                sim.run()
                return sc * c.value.ravel()

            def cjac(x, c=c, sc=sc):
                set_x(x)
                J = sim.compute_totals([c], dvs)
                return sc * np.concatenate(
                    [J[c, v] for v in dvs], axis=1) * x_ref[None, :]

            lo, hi, eq = (c._constraint[k]
                          for k in ("lower", "upper", "equals"))
            if eq is not None or (
                    lo is not None and hi is not None
                    and np.all(np.asarray(lo) == np.asarray(hi))):
                t = eq if eq is not None else lo
                scipy_cons.append(dict(
                    type="eq",
                    fun=lambda x, f_=cval, t=t, sc=sc: f_(x) - sc * np.atleast_1d(t),
                    jac=lambda x, j_=cjac: j_(x)))
            else:
                if lo is not None:
                    scipy_cons.append(dict(
                        type="ineq",
                        fun=lambda x, f_=cval, t=lo, sc=sc: f_(x) - sc * np.atleast_1d(t),
                        jac=lambda x, j_=cjac: j_(x)))
                if hi is not None:
                    scipy_cons.append(dict(
                        type="ineq",
                        fun=lambda x, f_=cval, t=hi, sc=sc: sc * np.atleast_1d(t) - f_(x),
                        jac=lambda x, j_=cjac: -j_(x)))

        bounds = []
        for v, o0 in zip(dvs, offs[:-1]):
            lo = v._design["lower"]
            hi = v._design["upper"]
            lo = np.broadcast_to(
                -np.inf if lo is None else np.asarray(lo), (v.size,))
            hi = np.broadcast_to(
                np.inf if hi is None else np.asarray(hi), (v.size,))
            ref = x_ref[o0:o0 + v.size]
            bounds.extend(zip(lo / ref, hi / ref))

        x0 = np.concatenate([v.value.ravel() for v in dvs]) / x_ref
        res = minimize(
            f, x0, jac=g, method="SLSQP", bounds=bounds,
            constraints=scipy_cons,
            options={"maxiter": self.options.get("maxiter", 100),
                     "ftol": self.options.get("ftol", 1e-9),
                     "disp": self.options.get("disp", False)})
        set_x(res.x)
        sim.run()
        self.result = res
        return res

    def print_results(self):
        r = self.result
        if r is not None:
            print(f"SLSQP: success={r.success} nit={r.nit} "
                  f"J={r.fun:.6e} ({r.message})")
