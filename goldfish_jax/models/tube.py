"""Four-patch tube (quarter cylinders, exact rational geometry).

The geometry family of the reference's tube demos
(demos_om/shape_opt/tube/draft_tube_shape_opt_mi_wffd_4patch.py): a
circular tube split into 4 penalty-coupled quarter patches along axial
seams, clamped at one end, loaded by internal pressure or a tip force.
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.cadkit import line, revolve
from goldfish_jax.physics.coupling import InterfaceSpec
from goldfish_jax.solver.system import NonMatchingSystem

E = 2.0e9
NU = 0.3
H_TH = 5.0e-3
RADIUS = 0.5
LENGTH = 3.0


def build(num_el: int = 4, p: int = 3, penalty_coefficient: float = 1.0e3,
          pressure: float = 0.0, tip_force=None):
    surfs = []
    for k in range(4):
        gen = line([RADIUS, 0.0, 0.0], [RADIUS, 0.0, LENGTH])
        s = revolve(gen, point=(0, 0, 0), axis=(0, 0, 1),
                    angle=(k * np.pi / 2, (k + 1) * np.pi / 2))
        # u: axial (degree 1 -> elevate), v: circumferential (rational,
        # keep degree 2 and refine)
        s = s.elevate(0, p - s.degree[0])
        ne_u = num_el + (k % 2)
        s = s.refine(0, np.linspace(0, 1, 2 * ne_u + 1)[1:-1])
        s = s.refine(1, np.linspace(0, 1, ne_u + 1)[1:-1])
        surfs.append(s)

    specs = []
    for k in range(4):
        specs.append(InterfaceSpec(
            pair=(k, (k + 1) % 4),
            xi_ends_A=np.array([[0.0, 1.0], [1.0, 1.0]]),
            xi_ends_B=np.array([[0.0, 0.0], [1.0, 0.0]]),
            n_mortar_el=2 * num_el + 2))

    sys = NonMatchingSystem(surfs, E, NU, H_TH, specs=specs,
                            penalty_coefficient=penalty_coefficient)
    for k in range(4):
        sys.add_side_bc(k, direction=0, side=0, n_layers=2)  # clamp z=0
    if pressure:
        sys.set_pressure([pressure] * 4)
    if tip_force is not None:
        for k in range(4):
            sys.add_edge_load(k, direction=0, side=1,
                              force=np.asarray(tip_force) / 4.0)
    return sys
