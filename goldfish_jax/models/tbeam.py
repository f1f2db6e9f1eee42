"""Two-patch T-beam: the reference's canonical coupling fixture.

Mirrors GOLDFISH/tests/test_tbeam.py behaviorally: a flange (width 2 in
x, length 20 in y) and a web (depth 2 downward in z, same length) whose
midline/top-edge intersection runs the full length; both patches clamped
at y = 0; tip point load in z at the flange corner xi = (1, 1).
Deliberately non-matching element counts (num_el vs num_el + 1).
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.cadkit import line, ruled
from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver.system import NonMatchingSystem

E = 1.0e7
NU = 0.0
H_TH = 0.1
LENGTH = 20.0
WIDTH = 2.0
DEPTH = 2.0


def create_surf(pts, num_el0, num_el1, p) -> NURBS:
    """Ruled surface between line(pts[0], pts[1]) and line(pts[2], pts[3]),
    elevated to degree p, refined to (num_el0, num_el1) elements
    (reference: GOLDFISH/tests/test_tbeam.py:5-16)."""
    s = ruled(line(pts[0], pts[1]), line(pts[2], pts[3]))
    p0, p1 = s.degree
    s = s.elevate(0, p - p0).elevate(1, p - p1)
    s = s.refine(0, np.linspace(0, 1, num_el0 + 1)[1:-1])
    s = s.refine(1, np.linspace(0, 1, num_el1 + 1)[1:-1])
    return s


def build(num_el: int = 10, p: int = 3, penalty_coefficient: float = 1.0e3,
          tip_load: float = 10.0, var_thickness: bool = False):
    """Assemble the 2-patch T-beam system.

    var_thickness only affects downstream drivers (h is always a CP
    coefficient field here; the reference's Function-vs-Constant split,
    GOLDFISH/tests/test_dRdt.py, is unnecessary in the rebuild).
    """
    w2 = WIDTH / 2.0
    pts0 = [[-w2, 0.0, 0.0], [w2, 0.0, 0.0],
            [-w2, LENGTH, 0.0], [w2, LENGTH, 0.0]]
    pts1 = [[0.0, 0.0, 0.0], [0.0, 0.0, -DEPTH],
            [0.0, LENGTH, 0.0], [0.0, LENGTH, -DEPTH]]
    num_el0, num_el1 = num_el, num_el + 1
    srf0 = create_surf(pts0, max(num_el0 // 2, 1), num_el0, p)
    srf1 = create_surf(pts1, max(num_el1 // 2, 1), num_el1, p)

    # interface: flange u=0.5 line <-> web u=0 line, both along v
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=2 * num_el1,
    )]

    sys = NonMatchingSystem([srf0, srf1], E, NU, H_TH, specs=specs,
                            penalty_coefficient=penalty_coefficient)
    # clamp y=0 end of both patches (direction 1, side 0)
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    # tip point load, z-direction at flange corner (1, 1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, tip_load])
    return sys


def build_mi(num_el: int = 40, p: int = 3, n_pts: int = 17):
    """The T-beam with a MOVING intersection: the web's top edge is
    located on the flange by the CP -> xi solve, so the seam follows a
    shape design of either patch (reference:
    demos_om/shape_opt_mint/T-beam/T_beam_2patch_shopt_mi.py).

    The defaults are the benchmark size: 2 patches, 1 seam, N = 6003
    dofs; `n_pts` intersection points carry the moving seam.
    """
    from goldfish_jax.solver.system_mi import MINonMatchingSystem

    w2 = WIDTH / 2.0
    pts0 = [[-w2, 0.0, 0.0], [w2, 0.0, 0.0],
            [-w2, LENGTH, 0.0], [w2, LENGTH, 0.0]]
    pts1 = [[0.0, 0.0, 0.0], [0.0, 0.0, -DEPTH],
            [0.0, LENGTH, 0.0], [0.0, LENGTH, -DEPTH]]
    srf0 = create_surf(pts0, max(num_el // 2, 1), num_el, p)
    srf1 = create_surf(pts1, max((num_el + 1) // 2, 1), num_el + 1, p)
    specs = [InterfaceSpec(
        pair=(0, 1),
        xi_ends_A=np.array([[0.5, 0.0], [0.5, 1.0]]),
        xi_ends_B=np.array([[0.0, 0.0], [0.0, 1.0]]),
        n_mortar_el=n_pts - 1)]
    sys = MINonMatchingSystem([srf0, srf1], E, NU, H_TH, specs=specs,
                              n_pts_list=[n_pts])
    sys.add_side_bc(0, direction=1, side=0, n_layers=1)
    sys.add_side_bc(1, direction=1, side=0, n_layers=1)
    sys.add_point_load(0, [1.0, 1.0], [0.0, 0.0, 10.0])
    return sys
