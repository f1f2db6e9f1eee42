#!/usr/bin/env python
"""T-beam shape optimization with MOVING INTERSECTIONS through the
OpenMDAO graph.

1:1 port of the reference driver structure
(/root/reference/demos_om/shape_opt_mint/T-beam/T_beam_2patch_shopt_mi.py
ShapeOptGroup :117-238): design CPs -> CPSurfOrderElevationComp ->
CPSurfKnotRefienmentComp -> (embed into the full flat CP vector) ->
CPIGA2XiComp (implicit CP->xi) -> DispMintStatesComp (implicit solve
with xi input) -> IntEnergyComp objective, with CPSurfPinComp and
IntXiEdgeComp equality constraints (the reference's edge-type xi
constraint rows). Runs on real OpenMDAO when installed, else on
goldfish_jax.om_shim.

Run: python demos/om_tbeam_shopt_mi.py
"""

from __future__ import annotations

import numpy as np

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_jax.om_shim import api as om

from goldfish_jax.design.cp_design import CPSurfDesign2Analysis
from goldfish_jax.design.pipeline import CPLayout
from goldfish_jax.models import tbeam
from goldfish_jax.om_comps.components import (
    CPIGA2XiComp,
    CPSurfKnotRefienmentComp,
    CPSurfOrderElevationComp,
    CPSurfPinComp,
    DispMintStatesComp,
    IntEnergyComp,
    IntXiEdgeComp,
    _LinearMapComp,
)
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver.system_mi import MINonMatchingSystem


class CPAnalysis2FullComp(_LinearMapComp):
    """Embed one optimized field's analysis CPs into the FULL flat CP
    vector (all patches x 3 fields), other entries frozen at their
    initial values (the role of the reference's cpsurf -> nonmatching
    CP bookkeeping in ShapeOptGroup)."""

    def initialize(self):
        super().initialize()
        self.options.declare("layout")      # CPLayout
        self.options.declare("cp0_flat")    # (n_flat, 3) initial CPs
        self.options.declare("surf_inds")
        self.options.declare("field", default=0)
        self.options.declare("offsets")     # per-surface flat cp offset

    def init_parameters(self):
        lay = self.options["layout"]
        cp0 = np.asarray(self.options["cp0_flat"])
        field = self.options["field"]
        offsets = self.options["offsets"]
        n_full = cp0.size
        cols = []
        offset = cp0.ravel().copy()
        for i in self.options["surf_inds"]:
            o, n = offsets[i]
            for k in range(n):
                col = np.zeros(n_full)
                col[(o + k) * 3 + field] = 1.0
                cols.append(col)
                offset[(o + k) * 3 + field] = 0.0
        self.options["A"] = np.stack(cols, axis=1)
        self.options["offset"] = offset
        super().init_parameters()


def build_mi_tbeam(num_el=4, p=3, n_pts=12):
    """2-patch T-beam with one web intersection (same construction as
    tests/test_system_mi.py)."""
    w2 = tbeam.WIDTH / 2
    pts0 = [[-w2, 0, 0], [w2, 0, 0], [-w2, tbeam.LENGTH, 0],
            [w2, tbeam.LENGTH, 0]]
    pts1 = [[0, 0, 0], [0, 0, -tbeam.DEPTH], [0, tbeam.LENGTH, 0],
            [0, tbeam.LENGTH, -tbeam.DEPTH]]
    srf0 = tbeam.create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = tbeam.create_surf(pts1, max((num_el + 1) // 2, 1),
                             num_el + 1, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=n_pts - 1)]
    sys = MINonMatchingSystem([srf0, srf1], tbeam.E, tbeam.NU,
                              tbeam.H_TH, specs=specs,
                              n_pts_list=[n_pts])
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys


class ShapeOptGroup(om.Group):
    """Reference ShapeOptGroup (T_beam_2patch_shopt_mi.py:117-238)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("design2analysis")
        self.options.declare("opt_field", default=0)

    def init_parameters(self):
        self.cpsurf_design_name = "CPS_design"
        self.cpsurf_elevated_name = "CPS_elevated"
        self.cpsurf_analysis_name = "CPS_analysis"
        self.cp_iga_name = "CP_IGA"
        self.xi_name = "int_para_coords"
        self.disp_name = "displacements"
        self.int_energy_name = "w_int"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        d2a = self.options["design2analysis"]
        field = self.options["opt_field"]
        lay = CPLayout(sys.metas, sys.stack.max_cp)

        x_design = np.concatenate(
            [d2a.init_design_cp(i, field) for i in d2a.surf_inds])
        inputs_comp = om.IndepVarComp()
        inputs_comp.add_output(self.cpsurf_design_name,
                               shape=x_design.size, val=x_design)
        self.add_subsystem("inputs_comp", inputs_comp)

        elev = CPSurfOrderElevationComp(
            design2analysis=d2a, fields=(field,),
            input_name=self.cpsurf_design_name,
            output_name=self.cpsurf_elevated_name)
        elev.init_parameters()
        self.add_subsystem("cpsurf_order_elevation_comp", elev)

        refc = CPSurfKnotRefienmentComp(
            design2analysis=d2a, fields=(field,),
            input_name=self.cpsurf_elevated_name,
            output_name=self.cpsurf_analysis_name)
        refc.init_parameters()
        self.add_subsystem("cpsurf_knot_refinement_comp", refc)

        offsets = {}
        o = 0
        for i, m in enumerate(sys.metas):
            offsets[i] = (o, m.n_cp)
            o += m.n_cp
        emb = CPAnalysis2FullComp(
            layout=lay, cp0_flat=np.asarray(lay.to_flat(sys.cp)),
            surf_inds=d2a.surf_inds, field=field, offsets=offsets,
            input_name=self.cpsurf_analysis_name,
            output_name=self.cp_iga_name)
        emb.init_parameters()
        self.add_subsystem("cp_analysis2full_comp", emb)

        c2x = CPIGA2XiComp(nonmatching_sys=sys,
                           input_cp_name=self.cp_iga_name,
                           output_xi_name=self.xi_name)
        c2x.init_parameters()
        self.add_subsystem("cpiga2xi_comp", c2x)

        disp = DispMintStatesComp(nonmatching_sys=sys,
                                  input_cp_name=self.cp_iga_name,
                                  input_xi_name=self.xi_name,
                                  output_u_name=self.disp_name,
                                  rtol=1e-11)
        disp.init_parameters()
        self.add_subsystem("disp_states_comp", disp)

        wint = IntEnergyComp(nonmatching_sys=sys,
                             input_cp_name=self.cp_iga_name,
                             input_u_name=self.disp_name,
                             output_name=self.int_energy_name)
        wint.init_parameters()
        self.add_subsystem("int_energy_comp", wint)

        # xi edge constraint (reference IntXiEdgeComp): edge-type xi
        # dofs must stay on their parametric edge
        edge = IntXiEdgeComp(nonmatching_sys=sys,
                             input_xi_name=self.xi_name,
                             output_name="int_xi_edge")
        edge.init_parameters()
        self.add_subsystem("int_xi_edge_comp", edge)

        # pin the design-grid corners of the flange so the beam cannot
        # translate (reference CPSurfPinComp role)
        nu0, nv0 = d2a.design_shapes[d2a.surf_inds[0]]
        pin = CPSurfPinComp(
            design2analysis=d2a, fields=(field,),
            pinned={d2a.surf_inds[0]: [0, (nu0 - 1) * nv0],
                    d2a.surf_inds[1]: []},
            input_name=self.cpsurf_design_name, output_name="cps_pin")
        pin.init_parameters()
        self.add_subsystem("cpsurf_pin_comp", pin)
        pin_target = pin.A @ x_design

        self.connect("inputs_comp." + self.cpsurf_design_name,
                     "cpsurf_order_elevation_comp."
                     + self.cpsurf_design_name)
        self.connect("cpsurf_order_elevation_comp."
                     + self.cpsurf_elevated_name,
                     "cpsurf_knot_refinement_comp."
                     + self.cpsurf_elevated_name)
        self.connect("cpsurf_knot_refinement_comp."
                     + self.cpsurf_analysis_name,
                     "cp_analysis2full_comp." + self.cpsurf_analysis_name)
        self.connect("cp_analysis2full_comp." + self.cp_iga_name,
                     "cpiga2xi_comp." + self.cp_iga_name)
        self.connect("cp_analysis2full_comp." + self.cp_iga_name,
                     "disp_states_comp." + self.cp_iga_name)
        self.connect("cpiga2xi_comp." + self.xi_name,
                     "disp_states_comp." + self.xi_name)
        self.connect("cp_analysis2full_comp." + self.cp_iga_name,
                     "int_energy_comp." + self.cp_iga_name)
        self.connect("disp_states_comp." + self.disp_name,
                     "int_energy_comp." + self.disp_name)
        self.connect("cpiga2xi_comp." + self.xi_name,
                     "int_xi_edge_comp." + self.xi_name)
        self.connect("inputs_comp." + self.cpsurf_design_name,
                     "cpsurf_pin_comp." + self.cpsurf_design_name)

        w2 = tbeam.WIDTH / 2
        self.add_design_var("inputs_comp." + self.cpsurf_design_name,
                            lower=-0.95 * w2, upper=0.95 * w2)
        self.add_constraint("cpsurf_pin_comp.cps_pin", equals=pin_target)
        if edge.output_shape:
            self.add_constraint("int_xi_edge_comp.int_xi_edge",
                                equals=np.zeros(edge.output_shape))
        self.add_objective("int_energy_comp." + self.int_energy_name,
                           scaler=1e1)


def build_problem(num_el=4, p=3, n_pts=12, design_nel=(1, 1), maxiter=6):
    sys = build_mi_tbeam(num_el=num_el, p=p, n_pts=n_pts)
    d2a = CPSurfDesign2Analysis(sys.surfs, design_nel=design_nel,
                                design_degree=2)
    model = ShapeOptGroup(nonmatching_sys=sys, design2analysis=d2a)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, d2a


def main():
    prob, sys, d2a = build_problem()
    prob.run_model()
    J0 = float(np.asarray(prob["int_energy_comp.w_int"]).ravel()[0])
    prob.run_driver()
    J1 = float(np.asarray(prob["int_energy_comp.w_int"]).ravel()[0])
    print(f"w_int {J0:.6e} -> {J1:.6e} ({100 * (1 - J1 / J0):.1f}% lower)")
    assert J1 < J0
    return prob


if __name__ == "__main__":
    main()
