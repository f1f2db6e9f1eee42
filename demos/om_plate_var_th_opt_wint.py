#!/usr/bin/env python
"""Variable-thickness plate optimization THROUGH THE OpenMDAO GRAPH.

1:1 port of the reference driver structure
(/root/reference/demos_om/thickness_opt/plate/plate_var_th_opt_wint.py:
338-364 and its VarThOptGroup at :40-181): IndepVarComp(h_th_ffd) ->
HthFFD2FEComp -> HthFE2IGAComp -> DispStatesComp -> IntEnergyComp /
VolumeComp objectives + HthFFDAlignComp / HthFFDReguComp linear
constraints, driven by ScipyOptimizeDriver SLSQP. Runs on real
OpenMDAO when installed, else on goldfish_jax.om_shim (same API).

Run: python demos/om_plate_var_th_opt_wint.py
"""

from __future__ import annotations

import numpy as np

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_jax.om_shim import api as om

from goldfish_jax.design.constraints import align_operator, regu_operator
from goldfish_jax.design.pipeline import ThicknessFFD
from goldfish_jax.models import plate
from goldfish_jax.om_comps.components import (
    DispStatesComp,
    HthFE2IGAComp,
    HthFFD2FEComp,
    HthFFDAlignComp,
    HthFFDReguComp,
    IntEnergyComp,
    VolumeComp,
)


class VarThOptGroup(om.Group):
    """Reference VarThOptGroup (plate_var_th_opt_wint.py:33-181)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("th_ffd")
        self.options.declare("h0", default=plate.H_TH)

    def init_parameters(self):
        self.h_th_ffd_name = "thickness_FFD"
        self.h_th_fe_name = "thickness_FE"
        self.h_th_iga_name = "thickness_IGA"
        self.disp_name = "displacements"
        self.int_energy_name = "w_int"
        self.volume_name = "volume"
        self.h_th_ffd_align_name = "thickness_FFD_align"
        self.h_th_ffd_regu_name = "thickness_FFD_regu"

        self.inputs_comp_name = "inputs_comp"
        self.h_th_ffd2fe_comp_name = "h_th_ffd2fe_comp"
        self.h_th_fe2iga_comp_name = "h_th_fe2iga_comp"
        self.disp_states_comp_name = "disp_states_comp"
        self.volume_comp_name = "volume_comp"
        self.int_energy_comp_name = "int_energy_comp"
        self.h_th_ffd_align_comp_name = "h_th_ffd_align_comp"
        self.h_th_ffd_regu_comp_name = "h_th_ffd_regu_comp"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        th = self.options["th_ffd"]
        h0 = self.options["h0"]
        n_flat = th.layout.n_flat
        init_h_ffd = th.init_h_ffd(h0)

        inputs_comp = om.IndepVarComp()
        inputs_comp.add_output(self.h_th_ffd_name, shape=th.n_ffd,
                               val=init_h_ffd)
        self.add_subsystem(self.inputs_comp_name, inputs_comp)

        self.h_th_ffd2fe_comp = HthFFD2FEComp(
            A=np.asarray(th.F), input_name=self.h_th_ffd_name,
            output_name=self.h_th_fe_name)
        self.h_th_ffd2fe_comp.init_parameters()
        self.add_subsystem(self.h_th_ffd2fe_comp_name,
                           self.h_th_ffd2fe_comp)

        self.h_th_fe2iga_comp = HthFE2IGAComp(
            size=n_flat, input_name=self.h_th_fe_name,
            output_name=self.h_th_iga_name)
        self.h_th_fe2iga_comp.init_parameters()
        self.add_subsystem(self.h_th_fe2iga_comp_name,
                           self.h_th_fe2iga_comp)

        self.disp_states_comp = DispStatesComp(
            nonmatching_sys=sys, input_h_th_name=self.h_th_iga_name,
            output_u_name=self.disp_name)
        self.disp_states_comp.init_parameters()
        self.add_subsystem(self.disp_states_comp_name,
                           self.disp_states_comp)

        self.int_energy_comp = IntEnergyComp(
            nonmatching_sys=sys, input_h_th_name=self.h_th_iga_name,
            input_u_name=self.disp_name,
            output_name=self.int_energy_name)
        self.int_energy_comp.init_parameters()
        self.add_subsystem(self.int_energy_comp_name,
                           self.int_energy_comp)

        self.volume_comp = VolumeComp(
            nonmatching_sys=sys, input_h_th_name=self.h_th_iga_name,
            output_name=self.volume_name)
        self.volume_comp.init_parameters()
        self.add_subsystem(self.volume_comp_name, self.volume_comp)
        self.vol_val = float(sys.volume())

        # FFD-grid align (x-fastest dof order, reference ijk2dof) and
        # regu constraint operators
        grid = th.shape
        A_align = align_operator(grid, axis=1)
        self.h_th_ffd_align_comp = HthFFDAlignComp(
            A=A_align, input_name=self.h_th_ffd_name,
            output_name=self.h_th_ffd_align_name)
        self.h_th_ffd_align_comp.init_parameters()
        self.add_subsystem(self.h_th_ffd_align_comp_name,
                           self.h_th_ffd_align_comp)
        self.cpffd_align_cons_val = np.zeros(A_align.shape[0])

        A_regu = regu_operator(grid, axis=0)
        self.h_th_ffd_regu_comp = HthFFDReguComp(
            A=A_regu, input_name=self.h_th_ffd_name,
            output_name=self.h_th_ffd_regu_name)
        self.h_th_ffd_regu_comp.init_parameters()
        self.add_subsystem(self.h_th_ffd_regu_comp_name,
                           self.h_th_ffd_regu_comp)
        self.cpffd_regu_cons_val = np.full(A_regu.shape[0], -5e-2 * h0)

        # connections (mirroring the reference's connect block)
        self.connect(self.inputs_comp_name + "." + self.h_th_ffd_name,
                     self.h_th_ffd2fe_comp_name + "." + self.h_th_ffd_name)
        self.connect(self.h_th_ffd2fe_comp_name + "." + self.h_th_fe_name,
                     self.h_th_fe2iga_comp_name + "." + self.h_th_fe_name)
        self.connect(self.h_th_fe2iga_comp_name + "." + self.h_th_iga_name,
                     self.disp_states_comp_name + "." + self.h_th_iga_name)
        self.connect(self.h_th_fe2iga_comp_name + "." + self.h_th_iga_name,
                     self.volume_comp_name + "." + self.h_th_iga_name)
        self.connect(self.h_th_fe2iga_comp_name + "." + self.h_th_iga_name,
                     self.int_energy_comp_name + "." + self.h_th_iga_name)
        self.connect(self.disp_states_comp_name + "." + self.disp_name,
                     self.int_energy_comp_name + "." + self.disp_name)
        self.connect(self.inputs_comp_name + "." + self.h_th_ffd_name,
                     self.h_th_ffd_align_comp_name + "."
                     + self.h_th_ffd_name)
        self.connect(self.inputs_comp_name + "." + self.h_th_ffd_name,
                     self.h_th_ffd_regu_comp_name + "."
                     + self.h_th_ffd_name)

        self.add_design_var(
            self.inputs_comp_name + "." + self.h_th_ffd_name,
            lower=0.4 * h0, upper=4.0 * h0, scaler=1e2)
        self.add_constraint(
            self.h_th_ffd_align_comp_name + "."
            + self.h_th_ffd_align_name,
            equals=self.cpffd_align_cons_val)
        self.add_constraint(
            self.h_th_ffd_regu_comp_name + "." + self.h_th_ffd_regu_name,
            lower=self.cpffd_regu_cons_val)
        self.add_constraint(
            self.volume_comp_name + "." + self.volume_name,
            equals=self.vol_val)
        self.add_objective(
            self.int_energy_comp_name + "." + self.int_energy_name,
            scaler=1e1)


def build_problem(num_el=3, p=2, num_patches=2, ffd_els=(4, 2, 1),
                  maxiter=20):
    sys = plate.build(num_el=num_el, p=p, num_patches=num_patches)
    th = ThicknessFFD(sys, num_els=ffd_els, p=(2, 1, 1))
    model = VarThOptGroup(nonmatching_sys=sys, th_ffd=th)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, th


def main():
    prob, sys, th = build_problem()
    prob.run_model()
    J0 = float(np.asarray(prob["int_energy_comp.w_int"]).ravel()[0])
    prob.run_driver()
    J1 = float(np.asarray(prob["int_energy_comp.w_int"]).ravel()[0])
    vol = float(np.asarray(prob["volume_comp.volume"]).ravel()[0])
    print(f"w_int {J0:.6e} -> {J1:.6e} ({100 * (1 - J1 / J0):.1f}% lower)"
          f"  volume {vol:.6e} (target {prob.model.vol_val:.6e})")
    assert J1 < J0
    assert abs(vol - prob.model.vol_val) / prob.model.vol_val < 1e-6
    return prob


if __name__ == "__main__":
    main()
