#!/usr/bin/env python
"""Stress-constrained variable-thickness plate sizing through the
OpenMDAO graph: minimize VOLUME subject to a KS-aggregated max von
Mises stress allowable.

The reference implements the two-level KS/p-norm max-vM aggregate as a
first-class operation (reference: GOLDFISH/operations/
max_vmstress_exop.py:167-273 `MaxvMStressExOperation` with m/alpha
normalization, and its OM wrapper max_vmstress_comp.py) but ships no
driver that optimizes UNDER it — this demo closes that: the classic
stress-constrained sizing problem

    min  volume(h)
    s.t. KS-max sigma_vM(top surface) <= sigma_allow
         align/regu regularity on the thickness FFD grid
         h in [h0/4, 4 h0]

on the penalty-coupled multi-patch plate, same FFD thickness pipeline
as demos/om_plate_var_th_opt_wint.py (IndepVarComp -> HthFFD2FEComp ->
HthFE2IGAComp -> DispStatesComp), with `MaxvMStressComp` wired as the
nonlinear inequality constraint. sigma_allow is chosen between the
initial (uniform-thickness) KS stress and the stress at the lower
bound, so the constraint is ACTIVE at the optimum: the optimizer thins
the plate until the stress allowable stops it.

Runs on real OpenMDAO when installed, else on goldfish_jax.om_shim.

Run: python demos/plate_var_th_opt_stress.py
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
    MaxvMStressComp,
    VolumeComp,
)


class StressConsThOptGroup(om.Group):
    """Volume-min / stress-constrained variant of the reference
    VarThOptGroup (plate_var_th_opt_wint.py:33-181) with
    MaxvMStressComp (max_vmstress_comp role) as the constraint."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("th_ffd")
        self.options.declare("h0", default=plate.H_TH)
        self.options.declare("sigma_allow")
        self.options.declare("ks_rho", default=100.0)

    def init_parameters(self):
        self.h_th_ffd_name = "thickness_FFD"
        self.h_th_fe_name = "thickness_FE"
        self.h_th_iga_name = "thickness_IGA"
        self.disp_name = "displacements"
        self.volume_name = "volume"
        self.stress_name = "max_vmstress"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        th = self.options["th_ffd"]
        h0 = self.options["h0"]
        n_flat = th.layout.n_flat

        inputs_comp = om.IndepVarComp()
        inputs_comp.add_output(self.h_th_ffd_name, shape=th.n_ffd,
                               val=th.init_h_ffd(h0))
        self.add_subsystem("inputs_comp", inputs_comp)

        ffd2fe = HthFFD2FEComp(A=np.asarray(th.F),
                               input_name=self.h_th_ffd_name,
                               output_name=self.h_th_fe_name)
        ffd2fe.init_parameters()
        self.add_subsystem("h_th_ffd2fe_comp", ffd2fe)

        fe2iga = HthFE2IGAComp(size=n_flat,
                               input_name=self.h_th_fe_name,
                               output_name=self.h_th_iga_name)
        fe2iga.init_parameters()
        self.add_subsystem("h_th_fe2iga_comp", fe2iga)

        disp = DispStatesComp(nonmatching_sys=sys,
                              input_h_th_name=self.h_th_iga_name,
                              output_u_name=self.disp_name)
        disp.init_parameters()
        self.add_subsystem("disp_states_comp", disp)

        vol = VolumeComp(nonmatching_sys=sys,
                         input_h_th_name=self.h_th_iga_name,
                         output_name=self.volume_name)
        vol.init_parameters()
        self.add_subsystem("volume_comp", vol)
        self.vol0 = float(sys.volume())

        stress = MaxvMStressComp(
            nonmatching_sys=sys, input_h_th_name=self.h_th_iga_name,
            input_u_name=self.disp_name, output_name=self.stress_name,
            op_kwargs=dict(rho=float(self.options["ks_rho"]),
                           method="KS", through="top"))
        stress.init_parameters()
        self.add_subsystem("max_vmstress_comp", stress)

        grid = th.shape
        A_align = align_operator(grid, axis=1)
        align = HthFFDAlignComp(A=A_align,
                                input_name=self.h_th_ffd_name,
                                output_name="thickness_FFD_align")
        align.init_parameters()
        self.add_subsystem("h_th_ffd_align_comp", align)

        A_regu = regu_operator(grid, axis=0)
        regu = HthFFDReguComp(A=A_regu, input_name=self.h_th_ffd_name,
                              output_name="thickness_FFD_regu")
        regu.init_parameters()
        self.add_subsystem("h_th_ffd_regu_comp", regu)

        self.connect("inputs_comp." + self.h_th_ffd_name,
                     "h_th_ffd2fe_comp." + self.h_th_ffd_name)
        self.connect("h_th_ffd2fe_comp." + self.h_th_fe_name,
                     "h_th_fe2iga_comp." + self.h_th_fe_name)
        self.connect("h_th_fe2iga_comp." + self.h_th_iga_name,
                     "disp_states_comp." + self.h_th_iga_name)
        self.connect("h_th_fe2iga_comp." + self.h_th_iga_name,
                     "volume_comp." + self.h_th_iga_name)
        self.connect("h_th_fe2iga_comp." + self.h_th_iga_name,
                     "max_vmstress_comp." + self.h_th_iga_name)
        self.connect("disp_states_comp." + self.disp_name,
                     "max_vmstress_comp." + self.disp_name)
        self.connect("inputs_comp." + self.h_th_ffd_name,
                     "h_th_ffd_align_comp." + self.h_th_ffd_name)
        self.connect("inputs_comp." + self.h_th_ffd_name,
                     "h_th_ffd_regu_comp." + self.h_th_ffd_name)

        sigma_allow = float(self.options["sigma_allow"])
        self.add_design_var("inputs_comp." + self.h_th_ffd_name,
                            lower=0.25 * h0, upper=4.0 * h0, scaler=1e2)
        self.add_constraint("h_th_ffd_align_comp.thickness_FFD_align",
                            equals=np.zeros(A_align.shape[0]))
        self.add_constraint("h_th_ffd_regu_comp.thickness_FFD_regu",
                            lower=np.full(A_regu.shape[0], -5e-2 * h0))
        # the governing nonlinear constraint: KS max-vM <= allowable.
        # OM semantics: `upper` is in UNSCALED model units; the scaler
        # only normalizes the DRIVER'S view to O(1)
        # (tests/test_om_shim_semantics.py pins this convention)
        self.add_constraint("max_vmstress_comp." + self.stress_name,
                            upper=sigma_allow, scaler=1.0 / sigma_allow)
        self.add_objective("volume_comp." + self.volume_name,
                           scaler=1.0 / self.vol0)


def build_problem(num_el=3, p=2, num_patches=2, ffd_els=(4, 2, 1),
                  maxiter=30, sigma_factor=1.6, ks_rho=100.0):
    """sigma_allow = sigma_factor * KS-stress(h0): >1 so the plate can
    thin (saving volume) until the growing stress hits the allowable."""
    sys = plate.build(num_el=num_el, p=p, num_patches=num_patches)
    th = ThicknessFFD(sys, num_els=ffd_els, p=(2, 1, 1))

    # evaluate the initial KS stress to place the allowable
    from goldfish_jax.operations.exops import MaxvMStressExOperation

    d = sys.solve_nonlinear(rtol=1e-10, max_it=30)
    lay = th.layout
    op = MaxvMStressExOperation(sys, rho=ks_rho, through="top")
    sigma0 = float(op.compute(
        np.asarray(lay.to_flat(sys.cp)).ravel(),
        np.asarray(lay.to_flat(sys.h_init[..., None])).ravel(),
        np.asarray(lay.to_flat(d)).ravel()))
    sigma_allow = sigma_factor * sigma0

    model = StressConsThOptGroup(nonmatching_sys=sys, th_ffd=th,
                                 sigma_allow=sigma_allow, ks_rho=ks_rho)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-10
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, th, sigma_allow, sigma0


def main(num_el=3, maxiter=30):
    prob, sys, th, sigma_allow, sigma0 = build_problem(
        num_el=num_el, maxiter=maxiter)
    prob.run_model()
    V0 = float(np.asarray(prob["volume_comp.volume"]).ravel()[0])
    prob.run_driver()
    V1 = float(np.asarray(prob["volume_comp.volume"]).ravel()[0])
    s1 = float(np.asarray(
        prob["max_vmstress_comp.max_vmstress"]).ravel()[0])
    print(f"volume {V0:.6e} -> {V1:.6e} ({100 * (1 - V1 / V0):.1f}% "
          f"lighter), KS stress {sigma0:.4e} -> {s1:.4e} "
          f"(allowable {sigma_allow:.4e})")
    assert V1 < V0                      # the plate got lighter
    assert s1 <= 1.02 * sigma_allow     # feasible (2% KS slack)
    # the stress constraint is ACTIVE at the optimum (it is what stops
    # further thinning — within 5% of the allowable)
    assert s1 >= 0.95 * sigma_allow, (s1, sigma_allow)
    return prob


if __name__ == "__main__":
    main()
