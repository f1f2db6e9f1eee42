"""Adversarial om_shim semantics pins (round-2 verdict weak #4).

The executed-adapter claim rests on om_shim implementing OpenMDAO's
documented conventions, not merely being self-consistent with the
comps it runs. Each test here drives the shim with HAND-COMPUTED
graphs whose totals/optima are known analytically, pinned to the
OpenMDAO behaviors the reference relies on:

- implicit total-derivative convention du/dx = -(dR/du)^{-1} dR/dx
  through solve_linear(rev) + apply_linear(rev)
  (reference: GOLDFISH/om_comps/disp_states_comp.py:81-144);
- rev-mode ACCUMULATION of d_inputs across residual variables and of
  bars across fan-out connections (the reference op layer's `+=`,
  GOLDFISH/operations/disp_imop.py:115-127);
- driver scaler conventions: scaler multiplies the DRIVER'S view of a
  variable (x_driver = scaler * x_phys, bounds scaled identically),
  and the physical optimum is invariant under any scaler choice;
- compute_totals/check_totals return UNSCALED model-variable
  derivatives (driver scaling never leaks in).

If openmdao itself is installed the same tests run against it, making
the suite a conformance check in both directions.
"""

import numpy as np
import pytest

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_jax.om_shim import api as om


class _ImplicitScale(om.ImplicitComponent):
    """R(u; a, b) = 3u - a - 2b  ->  u = (a + 2b)/3."""

    def setup(self):
        self.add_input("a", shape=2)
        self.add_input("b", shape=2)
        self.add_output("u", shape=2)

    def apply_nonlinear(self, inputs, outputs, residuals):
        residuals["u"] = 3 * outputs["u"] - inputs["a"] - 2 * inputs["b"]

    def solve_nonlinear(self, inputs, outputs):
        outputs["u"] = (inputs["a"] + 2 * inputs["b"]) / 3.0

    def linearize(self, inputs, outputs, partials):
        pass

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "rev":
            rb = d_residuals["u"]
            if "a" in d_inputs:
                d_inputs["a"] += -rb
            if "b" in d_inputs:
                d_inputs["b"] += -2.0 * rb
            if "u" in d_outputs:
                d_outputs["u"] += 3.0 * rb
        else:
            r = np.zeros_like(outputs["u"])
            if "u" in d_outputs:
                r += 3.0 * d_outputs["u"]
            if "a" in d_inputs:
                r += -d_inputs["a"]
            if "b" in d_inputs:
                r += -2.0 * d_inputs["b"]
            d_residuals["u"] += r

    def solve_linear(self, d_outputs, d_residuals, mode):
        if mode == "rev":
            d_residuals["u"] = d_outputs["u"] / 3.0
        else:
            d_outputs["u"] = d_residuals["u"] / 3.0


class _Square(om.ExplicitComponent):
    """y = x^2."""

    def setup(self):
        self.add_input("x", shape=2)
        self.add_output("y", shape=2)
        self.declare_partials("y", "x")

    def compute(self, inputs, outputs):
        outputs["y"] = inputs["x"] ** 2

    def compute_partials(self, inputs, partials):
        partials["y", "x"] = np.diag(2.0 * inputs["x"])


def _diamond_problem(x0=(1.5, -2.0)):
    """x -> y = x^2; u solves 3u - x - 2y = 0: the input reaches the
    implicit comp along TWO paths, so totals are only right if bars
    accumulate. du/dx = (1 + 4x)/3 diag."""
    model = om.Group()
    ivc = om.IndepVarComp()
    ivc.add_output("x", val=np.asarray(x0))
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("sq", _Square())
    model.add_subsystem("imp", _ImplicitScale())
    model.connect("ivc.x", "sq.x")
    model.connect("ivc.x", "imp.a")
    model.connect("sq.y", "imp.b")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    return prob


def test_implicit_diamond_totals_exact():
    prob = _diamond_problem()
    x = np.asarray(prob["ivc.x"])
    # forward value: u = (x + 2x^2)/3
    assert np.allclose(np.asarray(prob["imp.u"]),
                       (x + 2 * x ** 2) / 3.0, atol=1e-14)
    totals = prob.compute_totals(of=["imp.u"], wrt=["ivc.x"])
    J = np.asarray(totals[("imp.u", "ivc.x")])
    want = np.diag((1.0 + 4.0 * x) / 3.0)
    assert np.allclose(J, want, atol=1e-12), (J, want)


class _TwoResidual(om.ImplicitComponent):
    """Coupled pair sharing one input:
       R1 = 2u - v - a ;  R2 = -u + 2v - 3a
       -> u = (2a + 3a)/3 = 5a/3... solve: [2,-1;-1,2][u,v] = [a,3a]
       u = (2a + 3a)/3 = 5a/3? inverse = 1/3[[2,1],[1,2]]:
       u = (2a + 3a)/3 = 5a/3, v = (a + 6a)/3 = 7a/3."""

    def setup(self):
        self.add_input("a", shape=1)
        self.add_output("u", shape=1)
        self.add_output("v", shape=1)

    def apply_nonlinear(self, inputs, outputs, residuals):
        residuals["u"] = 2 * outputs["u"] - outputs["v"] - inputs["a"]
        residuals["v"] = -outputs["u"] + 2 * outputs["v"] - 3 * inputs["a"]

    def solve_nonlinear(self, inputs, outputs):
        a = inputs["a"]
        outputs["u"] = 5.0 * a / 3.0
        outputs["v"] = 7.0 * a / 3.0

    def linearize(self, inputs, outputs, partials):
        pass

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "rev":
            # BOTH residual vars push into the SAME input: must +=
            if "a" in d_inputs:
                d_inputs["a"] += -d_residuals["u"]
                d_inputs["a"] += -3.0 * d_residuals["v"]
            if "u" in d_outputs:
                d_outputs["u"] += 2 * d_residuals["u"] - d_residuals["v"]
            if "v" in d_outputs:
                d_outputs["v"] += -d_residuals["u"] + 2 * d_residuals["v"]
        else:
            du = d_outputs.get("u", 0.0)
            dv = d_outputs.get("v", 0.0)
            da = d_inputs.get("a", 0.0)
            d_residuals["u"] += 2 * du - dv - da
            d_residuals["v"] += -du + 2 * dv - 3 * da

    def solve_linear(self, d_outputs, d_residuals, mode):
        A = np.array([[2.0, -1.0], [-1.0, 2.0]])
        if mode == "rev":
            rhs = np.array([float(d_outputs["u"]),
                            float(d_outputs["v"])])
            psi = np.linalg.solve(A.T, rhs)
            d_residuals["u"] = np.array([psi[0]])
            d_residuals["v"] = np.array([psi[1]])
        else:
            rhs = np.array([float(d_residuals["u"]),
                            float(d_residuals["v"])])
            s = np.linalg.solve(A, rhs)
            d_outputs["u"] = np.array([s[0]])
            d_outputs["v"] = np.array([s[1]])


def test_multi_residual_accumulation():
    """du/da = 5/3, dv/da = 7/3 — wrong if d_inputs contributions from
    the two residual variables overwrite instead of accumulating."""
    model = om.Group()
    ivc = om.IndepVarComp()
    ivc.add_output("a", val=np.array([2.0]))
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("imp", _TwoResidual())
    model.connect("ivc.a", "imp.a")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    totals = prob.compute_totals(of=["imp.u", "imp.v"], wrt=["ivc.a"])
    assert np.allclose(totals[("imp.u", "ivc.a")], 5.0 / 3.0, atol=1e-13)
    assert np.allclose(totals[("imp.v", "ivc.a")], 7.0 / 3.0, atol=1e-13)


def test_totals_are_unscaled_by_driver_declarations():
    """OpenMDAO: compute_totals/check_totals report MODEL derivatives;
    design-var/objective scalers affect only the driver's view."""
    prob = _diamond_problem()
    prob.model.add_design_var("ivc.x", scaler=37.0)
    prob.model.add_objective("imp.u", scaler=11.0)
    x = np.asarray(prob["ivc.x"])
    totals = prob.compute_totals(of=["imp.u"], wrt=["ivc.x"])
    J = np.asarray(totals[("imp.u", "ivc.x")])
    want = np.diag((1.0 + 4.0 * x) / 3.0)   # unscaled, same as before
    assert np.allclose(J, want, atol=1e-12)


class _Quad(om.ExplicitComponent):
    """f = (x0 - 1)^2 + (x1 - 2.5)^2 ; g = x0 - 2 x1 (for eq cons)."""

    def setup(self):
        self.add_input("x", shape=2)
        self.add_output("f")
        self.add_output("g")
        self.declare_partials("f", "x")
        self.declare_partials("g", "x")

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["f"] = (x[0] - 1) ** 2 + (x[1] - 2.5) ** 2
        outputs["g"] = x[0] - 2 * x[1]

    def compute_partials(self, inputs, partials):
        x = inputs["x"]
        partials["f", "x"] = np.array([[2 * (x[0] - 1),
                                        2 * (x[1] - 2.5)]])
        partials["g", "x"] = np.array([[1.0, -2.0]])


@pytest.mark.parametrize("dv_scaler,obj_scaler,con_scaler",
                         [(1.0, 1.0, 1.0), (100.0, 1e-2, 7.0),
                          (0.03, 50.0, 0.2)])
def test_driver_scaler_invariance(dv_scaler, obj_scaler, con_scaler):
    """Known constrained optimum (x* = [1.8, 0.9]: minimize
    (x0-1)^2 + (x1-2.5)^2 s.t. x0 = 2 x1 — substitute to get
    10 x1 = 9): the PHYSICAL optimum must not depend on the declared
    scalers (OM semantics: driver-view scaling only)."""
    model = om.Group()
    ivc = om.IndepVarComp()
    ivc.add_output("x", val=np.array([2.0, 0.0]))
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("quad", _Quad())
    model.connect("ivc.x", "quad.x")
    model.add_design_var("ivc.x", lower=0.0, upper=10.0,
                         scaler=dv_scaler)
    model.add_objective("quad.f", scaler=obj_scaler)
    model.add_constraint("quad.g", equals=0.0, scaler=con_scaler)
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-10
    prob.driver.options["disp"] = False
    prob.setup()
    prob.run_model()
    prob.run_driver()
    x = np.asarray(prob["ivc.x"])
    assert np.allclose(x, [1.8, 0.9], atol=1e-4), x


def test_check_partials_catches_wrong_partial():
    """check_partials must actually flag an intentionally wrong
    Jacobian (guards against a vacuously-green verifier)."""

    class Bad(om.ExplicitComponent):
        def setup(self):
            self.add_input("x", shape=2)
            self.add_output("y", shape=2)
            self.declare_partials("y", "x")

        def compute(self, inputs, outputs):
            outputs["y"] = 3.0 * inputs["x"]

        def compute_partials(self, inputs, partials):
            partials["y", "x"] = 2.0 * np.eye(2)   # WRONG (should be 3)

    model = om.Group()
    ivc = om.IndepVarComp()
    ivc.add_output("x", val=np.array([1.0, 2.0]))
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("bad", Bad())
    model.connect("ivc.x", "bad.x")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    report = prob.check_partials(compact_print=False, step=1e-7)
    entry = report["bad"][("y", "x")]
    assert entry["rel error"] > 0.2, entry


# ---------------------------------------------------------------------
# round-4 tier: COO-sparse declare_partials + pyOptSparseDriver facade
# (the reference's sparse custom comps and SNOPT driver blocks,
# reference: demos_om/shape_opt_mint/tube/custom_comps/xi_cons_comp.py
# :27-40 and tube_shopt_mi_4patch_wffd.py:434-443)
# ---------------------------------------------------------------------
class _CooConstComp(om.ExplicitComponent):
    """XiConsComp pattern: constant partials declared as COO
    (val=data, rows=..., cols=...)."""

    def setup(self):
        self.add_input("x", shape=6)
        self.add_output("y", shape=2)
        # y0 = 3*x[1], y1 = 5*x[4] - 2*x[0]
        self.declare_partials("y", "x",
                              val=np.array([3.0, 5.0, -2.0]),
                              rows=np.array([0, 1, 1]),
                              cols=np.array([1, 4, 0]))

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["y"] = np.array([3 * x[1], 5 * x[4] - 2 * x[0]])


class _CooDataComp(om.ExplicitComponent):
    """State-dependent COO partials: compute_partials assigns ONLY the
    flat nonzero-data vector against the declared pattern (OpenMDAO
    sparse-partials semantics)."""

    def setup(self):
        self.add_input("x", shape=3)
        self.add_output("y", shape=2)
        # y0 = x0*x1, y1 = x2^2 ; pattern: (0,0),(0,1),(1,2)
        self.declare_partials("y", "x", rows=np.array([0, 0, 1]),
                              cols=np.array([0, 1, 2]))

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["y"] = np.array([x[0] * x[1], x[2] ** 2])

    def compute_partials(self, inputs, partials):
        x = inputs["x"]
        partials["y", "x"] = np.array([x[1], x[0], 2 * x[2]])


def _single_comp_problem(comp, n_in, x0):
    ivc = om.IndepVarComp()
    ivc.add_output("x", shape=n_in, val=x0)
    model = om.Group()
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("c", comp)
    model.connect("ivc.x", "c.x")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    return prob


def test_coo_constant_partials_totals():
    x0 = np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0])
    prob = _single_comp_problem(_CooConstComp(), 6, x0)
    np.testing.assert_allclose(np.asarray(prob["c.y"]), [6.0, 23.0])
    T = prob.compute_totals(["c.y"], ["ivc.x"])[("c.y", "ivc.x")]
    expect = np.zeros((2, 6))
    expect[0, 1] = 3.0
    expect[1, 4] = 5.0
    expect[1, 0] = -2.0
    np.testing.assert_allclose(np.asarray(T), expect)


def test_coo_data_vector_partials():
    x0 = np.array([2.0, 3.0, 4.0])
    prob = _single_comp_problem(_CooDataComp(), 3, x0)
    T = prob.compute_totals(["c.y"], ["ivc.x"])[("c.y", "ivc.x")]
    expect = np.array([[3.0, 2.0, 0.0], [0.0, 0.0, 8.0]])
    np.testing.assert_allclose(np.asarray(T), expect)
    # and check_totals agrees with FD
    rep = prob.check_totals(of=["c.y"], wrt=["ivc.x"])
    err = rep[("c.y", "ivc.x")]["rel error"]
    err = err if np.isscalar(err) else getattr(err, "forward", err)
    assert float(err) < 1e-6


class _CooDupComp(om.ExplicitComponent):
    """Duplicate (row, col) coordinates in a COO pattern ACCUMULATE
    (OpenMDAO assembles partials through scipy.sparse.coo_matrix,
    which sums duplicates — advisor finding, round 4)."""

    def setup(self):
        self.add_input("x", shape=2)
        self.add_output("y", shape=1)
        # y = 3*x0 + 4*x0 + 2*x1 = 7*x0 + 2*x1, with (0,0) declared twice
        self.declare_partials("y", "x",
                              val=np.array([3.0, 4.0, 2.0]),
                              rows=np.array([0, 0, 0]),
                              cols=np.array([0, 0, 1]))

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["y"] = np.array([7 * x[0] + 2 * x[1]])


class _CooFullNnzComp(om.ExplicitComponent):
    """A declared COO pattern whose nnz equals n_of*n_wrt must STILL be
    scattered through rows/cols (the declared pattern wins over any
    dense C-order reading of the data vector — advisor finding, r4).
    Pattern deliberately permuted vs C order."""

    def setup(self):
        self.add_input("x", shape=2)
        self.add_output("y", shape=2)
        # J = [[dy0/dx0, dy0/dx1], [dy1/dx0, dy1/dx1]]
        # y0 = x0*x1, y1 = x0 + x1^2; data listed in a NON-C order
        self.declare_partials("y", "x",
                              rows=np.array([1, 0, 1, 0]),
                              cols=np.array([1, 0, 0, 1]))

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["y"] = np.array([x[0] * x[1], x[0] + x[1] ** 2])

    def compute_partials(self, inputs, partials):
        x = inputs["x"]
        # data in the declared (permuted) coordinate order
        partials["y", "x"] = np.array([2 * x[1], x[1], 1.0, x[0]])


def test_coo_duplicate_coordinates_accumulate():
    x0 = np.array([1.0, 1.0])
    prob = _single_comp_problem(_CooDupComp(), 2, x0)
    T = prob.compute_totals(["c.y"], ["ivc.x"])[("c.y", "ivc.x")]
    np.testing.assert_allclose(np.asarray(T), [[7.0, 2.0]])


def test_coo_full_nnz_pattern_wins_over_dense_heuristic():
    x0 = np.array([2.0, 3.0])
    prob = _single_comp_problem(_CooFullNnzComp(), 2, x0)
    T = prob.compute_totals(["c.y"], ["ivc.x"])[("c.y", "ivc.x")]
    np.testing.assert_allclose(np.asarray(T),
                               [[3.0, 2.0], [1.0, 6.0]])


class _QpGroup(om.Group):
    """min (x0-1)^2 + (x1-2)^2  s.t. x0+x1 <= 2  -> x* = (0.5, 1.5)."""

    def setup(self):
        ivc = om.IndepVarComp()
        ivc.add_output("x", shape=2, val=np.zeros(2))
        self.add_subsystem("ivc", ivc)

        class Obj(om.ExplicitComponent):
            def setup(self):
                self.add_input("x", shape=2)
                self.add_output("f")
                self.add_output("g")
                self.declare_partials("f", "x")
                self.declare_partials("g", "x",
                                      val=np.ones((1, 2)))

            def compute(self, inputs, outputs):
                x = inputs["x"]
                outputs["f"] = (x[0] - 1) ** 2 + (x[1] - 2) ** 2
                outputs["g"] = x.sum()

            def compute_partials(self, inputs, partials):
                x = inputs["x"]
                partials["f", "x"] = np.array(
                    [[2 * (x[0] - 1), 2 * (x[1] - 2)]])

        self.add_subsystem("obj", Obj())
        self.connect("ivc.x", "obj.x")
        self.add_design_var("ivc.x", lower=-3.0, upper=3.0)
        self.add_constraint("obj.g", upper=2.0)
        self.add_objective("obj.f")


def test_pyoptsparse_driver_facade_reference_block():
    """The reference's SNOPT driver block (tube_shopt_mi_4patch_wffd
    .py:434-443) runs unchanged on the shim: om.pyOptSparseDriver with
    pyoptsparse-style opt_settings converges the QP."""
    prob = om.Problem(model=_QpGroup())
    prob.driver = om.pyOptSparseDriver()
    prob.driver.options["optimizer"] = "SNOPT"
    prob.driver.opt_settings["Major feasibility tolerance"] = 1e-6
    prob.driver.opt_settings["Major optimality tolerance"] = 1e-10
    prob.driver.opt_settings["Major iterations limit"] = 500
    prob.driver.options["print_results"] = False
    prob.setup()
    failed = prob.run_driver()
    assert not failed
    np.testing.assert_allclose(np.asarray(prob["ivc.x"]), [0.5, 1.5],
                               atol=1e-6)


def test_pyoptsparse_driver_iteration_limit_honored():
    """'Major iterations limit' must actually cap the engine (the
    option-name translation, not a decorative dict)."""
    prob = om.Problem(model=_QpGroup())
    prob.driver = om.pyOptSparseDriver()
    prob.driver.opt_settings["Major iterations limit"] = 1
    prob.setup()
    failed = prob.run_driver()
    assert failed  # 1 iteration cannot converge from (0, 0)


def test_run_driver_returns_fail_flag():
    """OpenMDAO convention: run_driver returns the FAILED flag (False
    on success)."""
    prob = om.Problem(model=_QpGroup())
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["maxiter"] = 500
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["disp"] = False
    prob.setup()
    assert prob.run_driver() is False


# ---------------------------------------------------------------------
# round-5 tier: FD partials / approx_totals / NewtonSolver plumbing /
# ref-ref0-adder scaling / src_indices connection slicing (round-4
# verdict item 6 -- behaviors the reference demos touch via real
# OpenMDAO that were not yet pinned)
# ---------------------------------------------------------------------
class _FdComp(om.ExplicitComponent):
    """declare_partials(method='fd'): the FRAMEWORK approximates the
    partial by differencing compute; any value compute_partials sets
    for an fd-declared key is IGNORED (OpenMDAO ExplicitComponent
    FD-partials fallback)."""

    def setup(self):
        self.add_input("x", shape=2)
        self.add_output("y", shape=1)
        self.declare_partials("y", "x", method="fd", form="central",
                              step=1e-6)

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["y"] = np.array([x[0] ** 2 + 3.0 * x[1]])

    def compute_partials(self, inputs, partials):
        # garbage for the fd-declared key: must be ignored
        partials["y", "x"] = np.array([[999.0, -999.0]])


def test_fd_partials_fallback():
    # at x0=(1.5, 2): dy/dx = [2*x0, 3] = [3, 3]
    x0 = np.array([1.5, 2.0])
    prob = _single_comp_problem(_FdComp(), 2, x0)
    T = prob.compute_totals(["c.y"], ["ivc.x"])[("c.y", "ivc.x")]
    np.testing.assert_allclose(np.asarray(T), [[3.0, 3.0]], rtol=1e-6)


class _ExactComp(om.ExplicitComponent):
    def setup(self):
        self.add_input("x", shape=2)
        self.add_output("y", shape=1)
        self.declare_partials("y", "x")
        self.n_cp_calls = 0

    def compute(self, inputs, outputs):
        x = inputs["x"]
        outputs["y"] = np.array([x[0] * x[1]])

    def compute_partials(self, inputs, partials):
        self.n_cp_calls += 1
        x = inputs["x"]
        partials["y", "x"] = np.array([[x[1], x[0]]])


def test_approx_totals_bypasses_component_partials():
    """Group.approx_totals('fd'): totals come from one FD sweep over
    the group run; component compute_partials is NOT consulted
    (OpenMDAO Group.approx_totals)."""
    x0 = np.array([2.0, 5.0])
    ivc = om.IndepVarComp()
    ivc.add_output("x", shape=2, val=x0)
    model = om.Group()
    model.add_subsystem("ivc", ivc)
    comp = model.add_subsystem("c", _ExactComp())
    model.connect("ivc.x", "c.x")
    model.approx_totals(method="fd", step=1e-7, form="central")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    T = prob.compute_totals(["c.y"], ["ivc.x"])[("c.y", "ivc.x")]
    np.testing.assert_allclose(np.asarray(T), [[5.0, 2.0]], rtol=1e-5)
    if hasattr(prob.model, "_subs"):   # shim-only white-box pin
        assert comp.n_cp_calls == 0


class _NewtonImplicit(om.ImplicitComponent):
    """R(u; a) = u^3 - a with ONLY apply_nonlinear/linearize/
    solve_linear: a NewtonSolver attached to the component must drive
    the residual to zero (solve_nonlinear is never defined)."""

    def setup(self):
        self.add_input("a", shape=1, val=8.0)
        self.add_output("u", shape=1, val=1.0)

    def apply_nonlinear(self, inputs, outputs, residuals):
        residuals["u"] = outputs["u"] ** 3 - inputs["a"]

    def linearize(self, inputs, outputs, partials):
        self._dRdu = 3.0 * np.asarray(outputs["u"]) ** 2

    def apply_linear(self, inputs, outputs, d_inputs, d_outputs,
                     d_residuals, mode):
        if mode == "rev":
            if "a" in d_inputs:
                d_inputs["a"] = d_inputs["a"] - np.asarray(
                    d_residuals["u"])

    def solve_linear(self, d_outputs, d_residuals, mode):
        if mode == "fwd":
            d_outputs["u"] = np.asarray(d_residuals["u"]) / self._dRdu
        else:
            d_residuals["u"] = np.asarray(d_outputs["u"]) / self._dRdu


def test_newton_solver_plumbing_on_implicit_comp():
    """Solver-option plumbing (OpenMDAO NewtonSolver options maxiter/
    rtol/atol/err_on_non_converge): attached solver drives
    apply_nonlinear to zero through linearize + solve_linear(fwd)."""
    ivc = om.IndepVarComp()
    ivc.add_output("a", shape=1, val=8.0)
    model = om.Group()
    model.add_subsystem("ivc", ivc)
    comp = model.add_subsystem("c", _NewtonImplicit())
    model.connect("ivc.a", "c.a")
    comp.nonlinear_solver = om.NewtonSolver(
        solve_subsystems=False, maxiter=50, atol=1e-12, rtol=1e-12)
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    np.testing.assert_allclose(np.asarray(prob["c.u"]), [2.0],
                               atol=1e-10)
    # adjoint totals still flow through solve_linear(rev):
    # du/da = 1/(3u^2) = 1/12
    T = prob.compute_totals(["c.u"], ["ivc.a"])[("c.u", "ivc.a")]
    np.testing.assert_allclose(np.asarray(T), [[1.0 / 12.0]],
                               rtol=1e-8)
    # maxiter is honored; err_on_non_converge raises on truncation
    comp2 = _NewtonImplicit()
    comp2.nonlinear_solver = om.NewtonSolver(
        solve_subsystems=False, maxiter=1, atol=1e-14, rtol=1e-14,
        err_on_non_converge=True)
    ivc2 = om.IndepVarComp()
    ivc2.add_output("a", shape=1, val=8.0)
    m2 = om.Group()
    m2.add_subsystem("ivc", ivc2)
    m2.add_subsystem("c", comp2)
    m2.connect("ivc.a", "c.a")
    p2 = om.Problem(model=m2)
    p2.setup()
    with pytest.raises(Exception):
        p2.run_model()


class _Parab(om.ExplicitComponent):
    def setup(self):
        self.add_input("x", shape=1)
        self.add_output("f", shape=1)
        self.declare_partials("f", "x")

    def compute(self, inputs, outputs):
        outputs["f"] = (inputs["x"] - 3.0) ** 2

    def compute_partials(self, inputs, partials):
        partials["f", "x"] = np.array([[2.0 * (inputs["x"][0] - 3.0)]])


def _parab_problem(**dv_kw):
    ivc = om.IndepVarComp()
    ivc.add_output("x", shape=1, val=0.5)
    model = om.Group()
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("c", _Parab())
    model.connect("ivc.x", "c.x")
    model.add_design_var("ivc.x", lower=-10.0, upper=10.0, **dv_kw)
    model.add_objective("c.f")
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    return prob


def test_ref_ref0_equivalent_to_scaler_adder():
    """Driver scaling conventions (openmdao determine_adder_scaler):
    ref/ref0 mean scaled = (x - ref0)/(ref - ref0) == scaler =
    1/(ref-ref0), adder = -ref0; the physical optimum is invariant;
    ref/ref0 are mutually exclusive with scaler/adder."""
    for kw in (dict(), dict(scaler=4.0), dict(adder=2.0, scaler=4.0),
               dict(ref=5.0, ref0=1.0)):
        prob = _parab_problem(**kw)
        prob.run_driver()
        np.testing.assert_allclose(np.asarray(prob["ivc.x"]), [3.0],
                                   atol=1e-6)
    with pytest.raises(ValueError):
        p = _parab_problem(ref=5.0, scaler=2.0)
        p.run_driver()


class _SumComp(om.ExplicitComponent):
    def setup(self):
        self.add_input("z", shape=3)
        self.add_output("s", shape=1)
        self.declare_partials("s", "z")

    def compute(self, inputs, outputs):
        z = inputs["z"]
        outputs["s"] = np.array([z[0] + 2.0 * z[1] + 4.0 * z[2]])

    def compute_partials(self, inputs, partials):
        partials["s", "z"] = np.array([[1.0, 2.0, 4.0]])


def test_src_indices_connection_slicing():
    """connect(..., src_indices=[...]): flat-source gather on the
    forward pass; the reverse sweep scatters the input bar back
    through the transpose with ACCUMULATION at duplicate indices
    (OpenMDAO Group.connect src_indices semantics)."""
    x0 = np.array([10.0, 20.0, 30.0, 40.0])
    ivc = om.IndepVarComp()
    ivc.add_output("x", shape=4, val=x0)
    model = om.Group()
    model.add_subsystem("ivc", ivc)
    model.add_subsystem("c", _SumComp())
    # z = x[[3, 1, 3]] -- duplicate source index 3
    model.connect("ivc.x", "c.z", src_indices=[3, 1, 3])
    prob = om.Problem(model=model)
    prob.setup()
    prob.run_model()
    # s = x3 + 2 x1 + 4 x3 = 5 x3 + 2 x1
    np.testing.assert_allclose(np.asarray(prob["c.s"]), [240.0])
    T = prob.compute_totals(["c.s"], ["ivc.x"])[("c.s", "ivc.x")]
    np.testing.assert_allclose(np.asarray(T), [[0.0, 2.0, 0.0, 5.0]])
