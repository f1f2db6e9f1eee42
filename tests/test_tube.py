"""Four-patch rational tube: seam continuity + cantilever bending
sanity against beam theory."""

import numpy as np

from goldfish_jax.models import tube


def test_tube_bending_matches_beam_theory():
    sys = tube.build(num_el=4, p=3, tip_force=[50.0, 0.0, 0.0])
    d = sys.solve_nonlinear(rtol=1e-10)
    # tip deflection of a cantilever tube: PL^3/(3EI), I = pi r^3 t
    P, L, r, t = 50.0, tube.LENGTH, tube.RADIUS, tube.H_TH
    I = np.pi * r**3 * t
    w_beam = P * L**3 / (3 * tube.E * I)
    tip = sys.evaluate_displacement(d, 0, [1.0, 0.5])
    # shells are more flexible than beam theory (ovalization); expect
    # same order, within 40%
    assert 0.6 * w_beam < tip[0] < 1.6 * w_beam, (tip[0], w_beam)
    # seams stay together
    for k in range(4):
        ua = sys.evaluate_displacement(d, k, [0.5, 1.0])
        ub = sys.evaluate_displacement(d, (k + 1) % 4, [0.5, 0.0])
        gap = np.linalg.norm(ua - ub)
        assert gap < 5e-2 * abs(tip[0]), (k, gap, tip[0])
