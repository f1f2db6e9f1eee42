#!/usr/bin/env python
"""4-patch tube shape optimization with MOVING seams, multi-block FFD
and xi bound constraints through the OpenMDAO graph.

1:1 port of the reference driver
(/root/reference/demos_om/shape_opt_mint/tube/tube_shopt_mi_4patch_wffd
.py ShapeOptGroup :20-238): a pressurized 4-patch tube whose two halves
are each parametrized by their own FFD block (multiFFD,
set_shopt_surf_inds_multiFFD :330-333), with

  inputs (reduced z-aligned FFD design per field)
    -> CPFFDesign2FullComp   (align expansion, :86-92)
    -> CPFFD2SurfComp        (:94-100)
    -> CPFE2IGAComp          (:102-108, exact identity here)
    -> CPIGA2XiComp          (implicit CP -> xi, :110-116)
    -> DispMintStatesComp    (implicit MI displacement solve, :118-126)
    -> IntEnergyComp         (objective, :128-135)
  constraints:
    CPFFDPinComp   (:149-154, set_shopt_pin_CP_multiFFD :383-388)
    CPFFDReguComp  (:137-147, set_shopt_regu_CP_multiFFD :389)
    xi bounds      (XiConsComp role, custom_comps/xi_cons_comp.py:1-40
                    + :233-234 `lower=0., upper=1.`) — here the KS
                    Max/MinIntXiComp aggregate over ALL xi dofs (this
                    build's xi residual pins the edge coordinates
                    itself, so the reference's 4 pinned end-entries are
                    identically satisfied; bounding the interior dofs
                    is the binding content of the constraint)

The initial design is OVALIZED (like the sibling draft-tube demo): the
optimizer must round the pressurized tube back out, dragging the four
axial seams through the implicit CP -> xi solve at every step.

Runs on real OpenMDAO when installed, else on goldfish_jax.om_shim.

Run: python demos/tube_shopt_mi_4patch_wffd.py [--num-el 3]
"""

from __future__ import annotations

import argparse

import numpy as np

try:
    import openmdao.api as om
except ModuleNotFoundError:
    from goldfish_jax.om_shim import api as om

from goldfish_jax.design.constraints import (
    align_expansion_operator,
    pin_operator,
    regu_operator,
)
from goldfish_jax.design.pipeline import CPLayout, MultiShapeFFD
from goldfish_jax.models import tube
from goldfish_jax.om_comps.components import (
    CPFFD2SurfComp,
    CPFFDAlignComp,
    CPFFDPinComp,
    CPFFDReguComp,
    CPIGA2XiComp,
    DispMintStatesComp,
    IntEnergyComp,
    MaxIntXiComp,
    MinIntXiComp,
)

from demos.draft_tube_shopt_mi_wffd import build_mi_tube


class TwoFieldMergeComp(om.ExplicitComponent):
    """Merge the optimized x/y flat CP fields with the frozen z field
    into the full flat CP vector (the per-field -> nonmatching CP
    bookkeeping of the reference ShapeOptGroup connects, reference:
    tube_shopt_mi_4patch_wffd.py:168-199)."""

    def initialize(self):
        self.options.declare("cp0_flat")      # (n_flat, 3)
        self.options.declare("input_names")   # one per optimized field
        self.options.declare("fields")        # e.g. (0, 1)
        self.options.declare("output_name", default="CP_IGA")

    def init_parameters(self):
        self.cp0 = np.asarray(self.options["cp0_flat"], dtype=float)
        self.in_names = list(self.options["input_names"])
        self.fields = tuple(self.options["fields"])
        self.out_name = self.options["output_name"]
        self.n_flat = self.cp0.shape[0]
        self._As = {}
        offset = self.cp0.ravel().copy()
        for name, f in zip(self.in_names, self.fields):
            A = np.zeros((3 * self.n_flat, self.n_flat))
            A[np.arange(self.n_flat) * 3 + f, np.arange(self.n_flat)] = 1.0
            self._As[name] = A
            offset[np.arange(self.n_flat) * 3 + f] = 0.0
        self._offset = offset

    def setup(self):
        for name in self.in_names:
            self.add_input(name, shape=self.n_flat)
        self.add_output(self.out_name, shape=3 * self.n_flat)
        for name in self.in_names:
            self.declare_partials(self.out_name, name,
                                  val=self._As[name])

    def compute(self, inputs, outputs):
        y = self._offset.copy()
        for name in self.in_names:
            y = y + self._As[name] @ np.asarray(inputs[name])
        outputs[self.out_name] = y


def _blockdiag(mats):
    rows = sum(m.shape[0] for m in mats)
    cols = sum(m.shape[1] for m in mats)
    A = np.zeros((rows, cols))
    r = c = 0
    for m in mats:
        A[r:r + m.shape[0], c:c + m.shape[1]] = m
        r += m.shape[0]
        c += m.shape[1]
    return A


class ShapeOptGroup(om.Group):
    """Reference ShapeOptGroup (tube_shopt_mi_4patch_wffd.py:20-238)."""

    def initialize(self):
        self.options.declare("nonmatching_sys")
        self.options.declare("mffd")          # MultiShapeFFD
        self.options.declare("oval", default=0.08)

    def init_parameters(self):
        self.opt_fields = (0, 1)
        self.design_names = [f"CP_design_FFD{f}" for f in self.opt_fields]
        self.full_names = [f"CP_FFD{f}" for f in self.opt_fields]
        self.surf_names = [f"CPS_IGA{f}" for f in self.opt_fields]
        self.cp_iga_name = "CP_IGA"
        self.xi_name = "int_para"
        self.disp_name = "displacements"
        self.int_energy_name = "int_E"

    def setup(self):
        sys = self.options["nonmatching_sys"]
        mffd = self.options["mffd"]
        lay = mffd.layout

        # per-block z-align expansion (design -> full block coeffs) and
        # the reduced design grids
        expans = []
        reps = []
        red_shapes = []
        for shp in mffd.shapes:
            A, rp = align_expansion_operator(shp, 2)
            expans.append(A)
            reps.append(rp)
            red_shapes.append((shp[0], shp[1], 1))
        A_expand = _blockdiag(expans)

        # full-coeff -> flat surface field placement (all 4 patches)
        n_flat = lay.n_flat
        A_surf = np.zeros((n_flat, int(mffd.offsets[-1])))
        for k, (F, rows) in enumerate(zip(mffd.Fs, mffd.rows)):
            A_surf[np.asarray(rows),
                   mffd.offsets[k]:mffd.offsets[k + 1]] = np.asarray(F)

        # initial designs: representative full-grid coefficients
        design0 = {}
        for f in self.opt_fields:
            design0[f] = np.concatenate(
                [ffd.p0[:, f][rp] for ffd, rp in zip(mffd.blocks, reps)])

        # pin operators first (set_shopt_pin_CP_multiFFD: block 0 pins
        # its x-side-0 slab, block 1 its y-side-0 slab, both fields) —
        # needed to keep the perturbed start FEASIBLE wrt the pins
        pins = []
        for k, shp in enumerate(
                [(s[0], s[1], 1) for s in mffd.shapes]):
            nx, ny, _ = shp
            if k == 0:
                pinned = [(0, j, 0) for j in range(ny)]
            else:
                pinned = [(i, 0, 0) for i in range(nx)]
            pins.append(pin_operator(shp, pinned))
        A_pin = _blockdiag(pins)
        pinned_mask = A_pin.sum(axis=0) > 0

        # OVALIZED start (see module docstring): stretch x, squeeze y
        # on the UNPINNED design dofs (feasible wrt the pin equalities)
        oval = float(self.options["oval"])
        start = {0: np.where(pinned_mask, design0[0],
                             design0[0] * (1.0 + oval)),
                 1: np.where(pinned_mask, design0[1],
                             design0[1] * (1.0 - 0.9 * oval))}

        inputs_comp = om.IndepVarComp()
        for f, name in zip(self.opt_fields, self.design_names):
            inputs_comp.add_output(name, shape=start[f].size,
                                   val=start[f])
        self.add_subsystem("inputs_comp", inputs_comp)

        for f, dname, fname, sname in zip(self.opt_fields,
                                          self.design_names,
                                          self.full_names,
                                          self.surf_names):
            d2f = CPFFDAlignComp(A=A_expand, input_name=dname,
                                 output_name=fname)
            d2f.init_parameters()
            self.add_subsystem(f"CPFFDDesign2Full_comp{f}", d2f)
            f2s = CPFFD2SurfComp(A=A_surf, input_name=fname,
                                 output_name=sname)
            f2s.init_parameters()
            self.add_subsystem(f"CPFFD2Surf_comp{f}", f2s)

        cp0_flat = np.asarray(lay.to_flat(sys.cp))
        merge = TwoFieldMergeComp(cp0_flat=cp0_flat,
                                  input_names=self.surf_names,
                                  fields=self.opt_fields,
                                  output_name=self.cp_iga_name)
        merge.init_parameters()
        self.add_subsystem("cp_merge_comp", merge)

        c2x = CPIGA2XiComp(nonmatching_sys=sys,
                           input_cp_name=self.cp_iga_name,
                           output_xi_name=self.xi_name)
        c2x.init_parameters()
        self.add_subsystem("cpiga2xi_comp", c2x)

        disp = DispMintStatesComp(nonmatching_sys=sys,
                                  input_cp_name=self.cp_iga_name,
                                  input_xi_name=self.xi_name,
                                  output_u_name=self.disp_name,
                                  rtol=1e-10)
        disp.init_parameters()
        self.add_subsystem("disp_states_comp", disp)

        wint = IntEnergyComp(nonmatching_sys=sys,
                             input_cp_name=self.cp_iga_name,
                             input_u_name=self.disp_name,
                             output_name=self.int_energy_name)
        wint.init_parameters()
        self.add_subsystem("internal_energy_comp", wint)

        # regu constraints (set_shopt_regu_CP_multiFFD): field 0
        # differences along the design-grid x axis, field 1 along y
        regus = {f: _blockdiag([regu_operator(shp, f)
                                for shp in red_shapes])
                 for f in self.opt_fields}

        pin_targets = {}
        for f, dname in zip(self.opt_fields, self.design_names):
            pin = CPFFDPinComp(A=A_pin, input_name=dname,
                               output_name=f"CP_FFD_pin{f}")
            pin.init_parameters()
            self.add_subsystem(f"CPFFD_pin_comp{f}", pin)
            pin_targets[f] = A_pin @ start[f]
            regu = CPFFDReguComp(A=regus[f], input_name=dname,
                                 output_name=f"CP_regu{f}")
            regu.init_parameters()
            self.add_subsystem(f"CPFFD_regu_comp{f}", regu)

        # xi bound constraints (the reference XiConsComp role) over the
        # FREE interior xi dofs — the edge/end-pinned coordinates sit
        # at exactly 0/1 by construction and would make a full-vector
        # KS bound unsatisfiable (geometry/cpiga2xi.xi_interior_dofs)
        from goldfish_jax.geometry.cpiga2xi import xi_interior_dofs

        xi_size = int(np.prod(sys.c2x.xi0_flat.shape))
        self.xi_free = xi_interior_dofs(sys.mi)
        A_sel = np.zeros((self.xi_free.size, xi_size))
        A_sel[np.arange(self.xi_free.size), self.xi_free] = 1.0
        xmax = MaxIntXiComp(input_name=self.xi_name, A=A_sel)
        xmax.init_parameters()
        self.add_subsystem("max_int_xi_comp", xmax)
        xmin = MinIntXiComp(input_name=self.xi_name, A=A_sel)
        xmin.init_parameters()
        self.add_subsystem("min_int_xi_comp", xmin)

        for f, dname, fname, sname in zip(self.opt_fields,
                                          self.design_names,
                                          self.full_names,
                                          self.surf_names):
            self.connect(f"inputs_comp.{dname}",
                         f"CPFFDDesign2Full_comp{f}.{dname}")
            self.connect(f"CPFFDDesign2Full_comp{f}.{fname}",
                         f"CPFFD2Surf_comp{f}.{fname}")
            self.connect(f"CPFFD2Surf_comp{f}.{sname}",
                         f"cp_merge_comp.{sname}")
            self.connect(f"inputs_comp.{dname}",
                         f"CPFFD_pin_comp{f}.{dname}")
            self.connect(f"inputs_comp.{dname}",
                         f"CPFFD_regu_comp{f}.{dname}")
        self.connect(f"cp_merge_comp.{self.cp_iga_name}",
                     f"cpiga2xi_comp.{self.cp_iga_name}")
        self.connect(f"cp_merge_comp.{self.cp_iga_name}",
                     f"disp_states_comp.{self.cp_iga_name}")
        self.connect(f"cp_merge_comp.{self.cp_iga_name}",
                     f"internal_energy_comp.{self.cp_iga_name}")
        self.connect(f"cpiga2xi_comp.{self.xi_name}",
                     f"disp_states_comp.{self.xi_name}")
        self.connect(f"disp_states_comp.{self.disp_name}",
                     f"internal_energy_comp.{self.disp_name}")
        self.connect(f"cpiga2xi_comp.{self.xi_name}",
                     "max_int_xi_comp.int_para")
        self.connect(f"cpiga2xi_comp.{self.xi_name}",
                     "min_int_xi_comp.int_para")

        # design vars / constraints / objective (reference :224-238)
        for f, dname in zip(self.opt_fields, self.design_names):
            self.add_design_var(
                f"inputs_comp.{dname}",
                lower=design0[f] - 0.4 * tube.RADIUS,
                upper=design0[f] + 0.4 * tube.RADIUS)
            self.add_constraint(f"CPFFD_pin_comp{f}.CP_FFD_pin{f}",
                                equals=pin_targets[f])
            self.add_constraint(f"CPFFD_regu_comp{f}.CP_regu{f}",
                                lower=1.0e-3)
        self.add_constraint("max_int_xi_comp.max_int_xi",
                            upper=1.0 - 1e-3)
        self.add_constraint("min_int_xi_comp.min_int_xi", lower=1e-3)
        self.add_objective(
            f"internal_energy_comp.{self.int_energy_name}", scaler=1e1)


def build_problem(num_el=3, p=3, ffd_num_els=(2, 2, 1), ffd_p=2,
                  maxiter=6, oval=0.08):
    sys = build_mi_tube(num_el=num_el, p=p)
    mffd = MultiShapeFFD(
        sys,
        groups=[{"patches": [0, 1], "num_els": ffd_num_els, "p": ffd_p},
                {"patches": [2, 3], "num_els": ffd_num_els, "p": ffd_p}],
        opt_fields=(0, 1))
    model = ShapeOptGroup(nonmatching_sys=sys, mffd=mffd, oval=oval)
    model.init_parameters()
    prob = om.Problem(model=model)
    prob.driver = om.ScipyOptimizeDriver()
    prob.driver.options["optimizer"] = "SLSQP"
    prob.driver.options["tol"] = 1e-12
    prob.driver.options["maxiter"] = maxiter
    prob.setup()
    return prob, sys, mffd


def main(num_el=3, maxiter=6):
    prob, sys, _ = build_problem(num_el=num_el, maxiter=maxiter)
    prob.run_model()
    J0 = float(np.asarray(
        prob["internal_energy_comp.int_E"]).ravel()[0])
    prob.run_driver()
    J1 = float(np.asarray(
        prob["internal_energy_comp.int_E"]).ravel()[0])
    xi = np.asarray(prob["cpiga2xi_comp.int_para"]).ravel()
    xi_free = xi[prob.model.xi_free]
    print(f"int_E {J0:.6e} -> {J1:.6e} "
          f"({100 * (1 - J1 / J0):.1f}% lower), "
          f"free xi in [{xi_free.min():.4f}, {xi_free.max():.4f}]")
    assert J1 < J0
    # the bound constraint holds on the free seam coordinates (pinned
    # edge/end dofs legitimately sit at exactly 0/1)
    assert xi_free.min() > 0.0 and xi_free.max() < 1.0
    return prob


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--num-el", type=int, default=3)
    ap.add_argument("--maxiter", type=int, default=6)
    a = ap.parse_args()
    from goldfish_jax import config

    config.use_x64(True)
    main(num_el=a.num_el, maxiter=a.maxiter)
