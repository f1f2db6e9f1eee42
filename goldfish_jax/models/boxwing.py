"""Pegasus-class box wing: the large-scale benchmark model.

Mirrors the scale of the reference's biggest problem (pegasus wing,
18 sections x 4 surfaces + 18 ribs = 90 patches; reference:
demos_om/thickness_opt/pegasus/pegasus_var_th_opt_wint.py:203-206): a
tapered, swept half-wing torsion box with upper/lower skins, front/rear
spars per section and a rib at every station — n_sections*4 +
(n_sections+1) penalty-coupled patches, clamped at the root rib, under
upper-skin pressure.

Patch parametrizations:
  skins:  u chordwise (LE -> TE), v spanwise
  spars:  u vertical (bottom -> top), v spanwise
  ribs:   u chordwise, v vertical
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.cadkit import bilinear
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver.system import NonMatchingSystem

E = 70.0e9
NU = 0.33
H_TH = 3.0e-3
HALF_SPAN = 9.0
ROOT_CHORD = 1.6
TAPER = 0.45
SWEEP = 1.2
BOX_DEPTH = 0.10   # box height / chord
PRESSURE = 20.0    # N/m^2 on the upper skin (+z)


def _chord(y):
    return ROOT_CHORD * (1.0 - (1.0 - TAPER) * y / HALF_SPAN)


def _xle(y):
    return SWEEP * y / HALF_SPAN


def _corners(y):
    c = _chord(y)
    x0, x1 = _xle(y), _xle(y) + c
    z = 0.5 * BOX_DEPTH * c
    return x0, x1, -z, +z


def build(n_sections: int = 18, num_el: int = 3, p: int = 3,
          penalty_coefficient: float = 1.0e3, load_scale: float = 1.0):
    ys = np.linspace(0.0, HALF_SPAN, n_sections + 1)
    surfs = []
    ids = {}

    def refine(s, ne0, ne1):
        s = s.elevate(0, p - 1).elevate(1, p - 1)
        s = s.refine(0, np.linspace(0, 1, ne0 + 1)[1:-1])
        return s.refine(1, np.linspace(0, 1, ne1 + 1)[1:-1])

    def add(name, s):
        ids[name] = len(surfs)
        surfs.append(s)

    for j in range(n_sections):
        y0, y1 = ys[j], ys[j + 1]
        x00, x10, zb0, zt0 = _corners(y0)
        x01, x11, zb1, zt1 = _corners(y1)
        ne = num_el + (j % 2)  # non-matching between sections
        add(f"up{j}", refine(bilinear(
            [x00, y0, zt0], [x10, y0, zt0],
            [x01, y1, zt1], [x11, y1, zt1]), ne, num_el))
        add(f"lo{j}", refine(bilinear(
            [x00, y0, zb0], [x10, y0, zb0],
            [x01, y1, zb1], [x11, y1, zb1]), ne, num_el))
        add(f"fs{j}", refine(bilinear(
            [x00, y0, zb0], [x00, y0, zt0],
            [x01, y1, zb1], [x01, y1, zt1]), max(num_el // 2, 1), num_el))
        add(f"rs{j}", refine(bilinear(
            [x10, y0, zb0], [x10, y0, zt0],
            [x11, y1, zb1], [x11, y1, zt1]), max(num_el // 2, 1), num_el))
    for j in range(n_sections + 1):
        y = ys[j]
        x0, x1, zb, zt = _corners(y)
        add(f"rib{j}", refine(bilinear(
            [x0, y, zb], [x1, y, zb], [x0, y, zt], [x1, y, zt]),
            num_el, max(num_el // 2, 1)))

    specs = []
    seg = {
        "u0": np.array([[0.0, 0.0], [0.0, 1.0]]),
        "u1": np.array([[1.0, 0.0], [1.0, 1.0]]),
        "v0": np.array([[0.0, 0.0], [1.0, 0.0]]),
        "v1": np.array([[0.0, 1.0], [1.0, 1.0]]),
    }

    def link(nA, eA, nB, eB, nel):
        specs.append(InterfaceSpec(
            pair=(ids[nA], ids[nB]), xi_ends_A=seg[eA], xi_ends_B=seg[eB],
            n_mortar_el=nel))

    nel_span = 2 * num_el + 2
    nel_chord = 2 * num_el + 2
    for j in range(n_sections):
        # skins <-> spars along the span edges
        link(f"up{j}", "u0", f"fs{j}", "u1", nel_span)
        link(f"up{j}", "u1", f"rs{j}", "u1", nel_span)
        link(f"lo{j}", "u0", f"fs{j}", "u0", nel_span)
        link(f"lo{j}", "u1", f"rs{j}", "u0", nel_span)
        # rib j <-> this section's panels at their inboard (v=0) edges
        link(f"rib{j}", "v1", f"up{j}", "v0", nel_chord)
        link(f"rib{j}", "v0", f"lo{j}", "v0", nel_chord)
        link(f"rib{j}", "u0", f"fs{j}", "v0", nel_chord)
        link(f"rib{j}", "u1", f"rs{j}", "v0", nel_chord)
        if j > 0:  # section-to-section panel continuity
            for pre in ("up", "lo", "fs", "rs"):
                link(f"{pre}{j-1}", "v1", f"{pre}{j}", "v0", nel_chord)
    # tip rib closes the last section
    jt = n_sections
    link(f"rib{jt}", "v1", f"up{jt-1}", "v1", nel_chord)
    link(f"rib{jt}", "v0", f"lo{jt-1}", "v1", nel_chord)
    link(f"rib{jt}", "u0", f"fs{jt-1}", "v1", nel_chord)
    link(f"rib{jt}", "u1", f"rs{jt-1}", "v1", nel_chord)

    sys = NonMatchingSystem(surfs, E, NU, H_TH, specs=specs,
                            penalty_coefficient=penalty_coefficient)
    # clamp the root rib completely
    m = sys.metas[ids["rib0"]]
    sys.add_zero_dofs(ids["rib0"], np.arange(m.n_cp))
    # pressure on the upper skins
    f = np.zeros((len(surfs), 3))
    for j in range(n_sections):
        f[ids[f"up{j}"], 2] = PRESSURE * load_scale
    sys.set_dead_load(f)
    sys.ids = ids
    return sys
