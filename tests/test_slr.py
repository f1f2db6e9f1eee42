"""Scordelis-Lo roof: the reference's published correctness anchor.

QoI_ref = 0.3006 (reference: GOLDFISH/tests/test_slr.py:50) - the
vertical displacement at the free-edge midpoint in the LINEAR regime
(at nominal load the geometrically nonlinear SVK response is ~0.2535).
"""

import numpy as np
import pytest

from goldfish_jax.models import slr
from goldfish_jax.solver.system import NonMatchingSystem


def test_single_patch_qoi():
    s = slr.roof_patch(12, 3, [50, 130], [0, slr.L])
    sys = NonMatchingSystem([s], slr.E, slr.NU, slr.H_TH)
    sys.add_side_bc(0, direction=1, side=0, n_layers=1, fields=(0, 1))
    sys.add_side_bc(0, direction=1, side=1, n_layers=1, fields=(0, 1))
    sys.add_zero_dofs(0, [0], fields=(2,))
    scale = 1e-3
    sys.set_dead_load([0.0, -slr.AREAL_FORCE * scale, 0.0])
    d = sys.solve_nonlinear()
    qoi = abs(sys.evaluate_displacement(d, 0, [0.0, 0.5])[1]) / scale
    assert abs(qoi - slr.QOI_REF) / slr.QOI_REF < 2e-3


def test_nine_patch_nonmatching_qoi():
    """9 non-matching penalty-coupled patches hit the same anchor."""
    qoi, d, sys = slr.solve_qoi(num_el=6, load_scale=1e-3)
    assert abs(qoi - slr.QOI_REF) / slr.QOI_REF < 5e-3

    # interface continuity: displacement jump across patch 0 | patch 1
    scale = 1e-3
    uA = sys.evaluate_displacement(d, 0, [1.0, 0.7]) / scale
    uB = sys.evaluate_displacement(d, 1, [0.0, 0.7]) / scale
    assert np.linalg.norm(uA - uB) < 1e-5 * max(np.linalg.norm(uA), 1e-12)
