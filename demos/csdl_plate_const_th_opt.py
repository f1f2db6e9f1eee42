#!/usr/bin/env python
"""Constant per-patch thickness plate optimization THROUGH THE CSDL
GRAPH.

1:1 port of the reference's csdl_alpha driver
(/root/reference/demos_csdl_alpha/thickness_opt/plate_const_th_opt_wint
.py:163-250 and its ThicknessOptModel): Recorder + Variable(h_th_design)
-> HthMapModel (per-patch constant -> flat thickness) -> DispStatesModel
(implicit) -> IntEnergyModel (objective) + VolumeModel (equality
constraint), optimized with the modopt CSDLAlphaProblem/SLSQP driver
shape. Runs on real csdl_alpha + modopt when installed, else on
goldfish_jax.csdl_shim (same API subset).

Run: python demos/csdl_plate_const_th_opt.py
"""

from __future__ import annotations

import numpy as np

try:
    import csdl_alpha as csdl
except ModuleNotFoundError:
    from goldfish_jax import csdl_shim as csdl

try:
    from modopt import CSDLAlphaProblem, SLSQP
except ModuleNotFoundError:
    from goldfish_jax.csdl_shim import CSDLAlphaProblem, SLSQP

from goldfish_jax.csdl_models.models import (
    DispStatesModel,
    HthMapModel,
    IntEnergyModel,
    VolumeModel,
)
from goldfish_jax.design.pipeline import CPLayout
from goldfish_jax.models import plate


def build_recorder(num_el=3, p=2, num_patches=3, rtol=1e-10):
    """Build the recorded csdl graph; returns (recorder, vars dict,
    sys)."""
    sys = plate.build(num_el=num_el, p=p, num_patches=num_patches)
    lay = CPLayout(sys.metas, sys.stack.max_cp)
    P = sys.num_splines

    recorder = csdl.Recorder(inline=True)
    recorder.start()

    cp_flat = np.asarray(lay.to_flat(sys.cp)).ravel()
    cp_iga = csdl.Variable(value=cp_flat, name="CP_IGA")
    h_th_design = csdl.Variable(value=np.full(P, plate.H_TH),
                                name="h_th_design")

    # ThicknessOptModel.evaluate (reference :163-190)
    h_th = HthMapModel(sys).evaluate(h_th_design)
    h_th.add_name("h_th")
    u = DispStatesModel(sys, rtol=rtol).evaluate(cp_iga, h_th)
    u.add_name("u")
    w_int = IntEnergyModel(sys).evaluate(cp_iga, h_th, u)
    w_int.add_name("w_int")
    vol = VolumeModel(sys).evaluate(cp_iga, h_th, u)
    vol.add_name("vol")

    out = dict(cp_iga=cp_iga, h_th_design=h_th_design, h_th=h_th,
               u=u, w_int=w_int, vol=vol)
    return recorder, out, sys


def main(num_el=3, p=2, num_patches=3, maxiter=20, verbose=True):
    recorder, v, sys = build_recorder(num_el=num_el, p=p,
                                      num_patches=num_patches)
    vol_val = float(v["vol"].value)
    J0 = float(v["w_int"].value)

    # reference driver block (:228-246)
    v["h_th_design"].set_as_design_variable(lower=0.4 * plate.H_TH,
                                            upper=4.0 * plate.H_TH)
    v["vol"].set_as_constraint(lower=vol_val, upper=vol_val)
    v["w_int"].set_as_objective(scaler=1e3)
    sim = csdl.experimental.PySimulator(recorder)

    prob = CSDLAlphaProblem(problem_name="plate_thopt", simulator=sim)
    optimizer = SLSQP(prob, solver_options={
        "ftol": 1e-12, "maxiter": maxiter, "disp": verbose})
    optimizer.solve()
    if verbose:
        optimizer.print_results()
    recorder.stop()

    J1 = float(v["w_int"].value)
    vol1 = float(v["vol"].value)
    if verbose:
        print(f"w_int {J0:.6e} -> {J1:.6e} "
              f"({100 * (1 - J1 / J0):.1f}% lower)  vol {vol1:.6e} "
              f"(target {vol_val:.6e})")
        print("h_th per patch:", np.asarray(v["h_th_design"].value))
    assert J1 < J0
    assert abs(vol1 - vol_val) / vol_val < 1e-6
    return v, sys


if __name__ == "__main__":
    main()
