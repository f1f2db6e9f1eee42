"""Pegasus-class box wing: build + solve sanity at reduced scale."""

import numpy as np

from goldfish_jax.models import boxwing


def test_boxwing_solves():
    sys = boxwing.build(n_sections=3, num_el=3, p=2)
    assert sys.num_splines == 3 * 4 + 4
    d = sys.solve_nonlinear(rtol=1e-10)
    # upward pressure on the upper skin -> wing bends up
    u = sys.evaluate_displacement(d, sys.ids["up2"], [0.5, 1.0])
    assert np.isfinite(u).all()
    assert u[2] > 1e-6
    # root rib clamped
    u0 = sys.evaluate_displacement(d, sys.ids["rib0"], [0.5, 0.5])
    assert np.linalg.norm(u0) < 1e-12
    # box closure: upper skin and front spar agree along their seam
    ue = sys.evaluate_displacement(d, sys.ids["up1"], [0.0, 0.5])
    us = sys.evaluate_displacement(d, sys.ids["fs1"], [1.0, 0.5])
    rel = np.linalg.norm(ue - us) / max(np.linalg.norm(ue), 1e-12)
    assert rel < 5e-2, rel


def test_boxwing_full_scale_builds():
    sys = boxwing.build(n_sections=18, num_el=3, p=3)
    assert sys.num_splines == 18 * 4 + 19  # 91 patches (pegasus class)
    assert len(sys.specs) == 18 * 8 + 17 * 4 + 4
