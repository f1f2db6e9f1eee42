"""Multi-patch swept tapered wing skin — the benchmark flagship model.

The scale model for BASELINE.md's governing metric (20-patch wing,
per-optimization-iteration wall clock) and the analogue of the
reference's larger aero examples (pegasus 90-patch / eVTOL wings,
reference: demos_om/thickness_opt/pegasus/pegasus_var_th_opt_wint.py:
203-206). Geometry is an analytic cambered, tapered, swept half-wing
split into an n_chord x n_span grid of cubic patches with deliberately
non-matching per-patch refinement, penalty-coupled along all shared
edges, clamped at the root, under a dead lift-like load.
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.cadkit import bilinear
from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver.system import NonMatchingSystem

E = 70.0e9        # aluminum-ish skin
NU = 0.33
H_TH = 4.0e-3     # 4 mm
HALF_SPAN = 4.0
ROOT_CHORD = 1.0
TAPER = 0.4       # tip chord / root chord
SWEEP = 0.8       # LE x-offset at tip
CAMBER = 0.06     # max camber / chord
LIFT = 40.0       # N/m^2 dead load in +z (tip deflection ~1% span)


def _chord(v):
    return ROOT_CHORD * (1.0 - (1.0 - TAPER) * v)


def _xle(v):
    return SWEEP * v


def _z(u, v):
    return CAMBER * _chord(v) * np.sin(np.pi * u)


def wing_patch(u0, u1, v0, v1, ne_u, ne_v, p) -> NURBS:
    """One patch of the analytic wing map S(u, v) =
    (xle + chord*u, half_span*v, camber surface)."""
    corners = []
    for (uu, vv) in [(u0, v0), (u1, v0), (u0, v1), (u1, v1)]:
        corners.append([_xle(vv) + _chord(vv) * uu, HALF_SPAN * vv, 0.0])
    s = bilinear(*corners)
    s = s.elevate(0, p - 1).elevate(1, p - 1)
    s = s.refine(0, np.linspace(0, 1, ne_u + 1)[1:-1])
    s = s.refine(1, np.linspace(0, 1, ne_v + 1)[1:-1])
    # linear precision: CP (x, y) = map of Greville (u, v); lift CPs
    # into the camber surface using their own parametric locations
    gu = s.greville_points(0)
    gv = s.greville_points(1)
    uu = u0 + (u1 - u0) * gu
    vv = v0 + (v1 - v0) * gv
    zz = _z(uu[:, None], vv[None, :])
    ctrl = s.control.copy()
    ctrl[..., 2] = zz * ctrl[..., 3]
    return NURBS(s.knots, ctrl)


def build(n_chord: int = 4, n_span: int = 5, num_el: int = 6, p: int = 3,
          penalty_coefficient: float = 1.0e3, load_scale: float = 1.0):
    """n_chord * n_span patches (default 20 — the BASELINE.md scale)."""
    surfs = []
    nes = {}
    for j in range(n_span):
        for i in range(n_chord):
            ne_u = num_el + (i + j) % 2        # non-matching refinement
            ne_v = num_el + (i + 2 * j + 1) % 3
            nes[(i, j)] = (ne_u, ne_v)
            surfs.append(wing_patch(
                i / n_chord, (i + 1) / n_chord,
                j / n_span, (j + 1) / n_span, ne_u, ne_v, p))

    def pid(i, j):
        return j * n_chord + i

    specs = []
    for j in range(n_span):
        for i in range(n_chord):
            if i + 1 < n_chord:  # chordwise neighbor: edge u=1 <-> u=0
                specs.append(InterfaceSpec(
                    pair=(pid(i, j), pid(i + 1, j)),
                    xi_ends_A=np.array([[1.0, 0.0], [1.0, 1.0]]),
                    xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
                    n_mortar_el=2 * max(nes[(i, j)][1],
                                        nes[(i + 1, j)][1])))
            if j + 1 < n_span:   # spanwise neighbor: edge v=1 <-> v=0
                specs.append(InterfaceSpec(
                    pair=(pid(i, j), pid(i, j + 1)),
                    xi_ends_A=np.array([[0.0, 1.0], [1.0, 1.0]]),
                    xi_ends_B=np.array([[0.0, 0.0], [1.0, 0.0]]),
                    n_mortar_el=2 * max(nes[(i, j)][0],
                                        nes[(i, j + 1)][0])))

    sys = NonMatchingSystem(surfs, E, NU, H_TH, specs=specs,
                            penalty_coefficient=penalty_coefficient)
    # clamp the root edge (v = 0) of the root-row patches, 2 CP layers
    for i in range(n_chord):
        sys.add_side_bc(pid(i, 0), direction=1, side=0, n_layers=2)
    sys.set_dead_load([0.0, 0.0, LIFT * load_scale])
    return sys
