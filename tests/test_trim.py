"""Trimmed-surface support: finite-cell quadrature masking + IGES
144/142/102/126 round-trip.

The reference analyzes untrimmed patches (its IGES corpus wraps
surfaces in trivial `144,<de>,0,0,0;` entities and delegates real trim
handling to OpenCASCADE); this build honors trims natively
(geometry/trim.py, igs_io.read_igs_trimmed)."""

import numpy as np
import pytest

from goldfish_jax.geometry.cadkit import bilinear
from goldfish_jax.geometry.igs_io import (
    read_igs_file,
    read_igs_trimmed,
    write_igs_file,
)
from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.geometry.patch_stack import (
    build_patch_stack,
    stack_control_points,
)
from goldfish_jax.geometry.trim import (
    points_in_polygon,
    sample_loop,
    trim_mask,
)
from goldfish_jax.physics.kl_shell import internal_energy, volume


def _plate(nel=8):
    s = bilinear([0, 0, 0], [1, 0, 0], [0, 1, 0], [1, 1, 0])
    s = s.elevate(0, 2).elevate(1, 2)
    r = np.linspace(0, 1, nel + 1)[1:-1]
    return s.refine(0, r).refine(1, r)


def _circle_poly(cx, cy, r, n=512):
    t = np.linspace(0, 2 * np.pi, n, endpoint=False)
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=-1)


def test_points_in_polygon():
    sq = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    pts = np.array([[0.5, 0.5], [1.5, 0.5], [-0.1, 0.2], [0.99, 0.01],
                    [0.5, 1.2]])
    got = points_in_polygon(pts, sq)
    assert got.tolist() == [True, False, False, True, False]
    # non-convex: L-shape, notch excluded
    L = np.array([[0, 0], [2, 0], [2, 1], [1, 1], [1, 2], [0, 2]],
                 dtype=float)
    pts = np.array([[1.5, 0.5], [1.5, 1.5], [0.5, 1.5]])
    assert points_in_polygon(pts, L).tolist() == [True, False, True]


def test_sample_loop_from_curves():
    """A composite loop of 4 degree-1 NURBS segments samples to the
    square's perimeter."""
    corners = [(0.2, 0.2), (0.8, 0.2), (0.8, 0.8), (0.2, 0.8)]
    segs = []
    for a, b in zip(corners, corners[1:] + corners[:1]):
        P = np.array([[a[0], a[1], 0.0], [b[0], b[1], 0.0]])
        segs.append(NURBS([np.array([0.0, 0.0, 1.0, 1.0])], P))
    poly = sample_loop(segs)
    assert poly.shape[1] == 2
    # every sampled point lies on the square perimeter
    on_edge = (
        (np.isclose(poly[:, 0], 0.2) | np.isclose(poly[:, 0], 0.8))
        & (poly[:, 1] > 0.2 - 1e-12) & (poly[:, 1] < 0.8 + 1e-12)
    ) | (
        (np.isclose(poly[:, 1], 0.2) | np.isclose(poly[:, 1], 0.8))
        & (poly[:, 0] > 0.2 - 1e-12) & (poly[:, 0] < 0.8 + 1e-12)
    )
    assert on_edge.all()
    # mask: center excluded when the square is a hole
    m = trim_mask(np.array([[0.5, 0.5], [0.1, 0.1]]), None, [segs])
    assert m.tolist() == [0.0, 1.0]


def test_trimmed_area_circular_hole():
    """Plate with a circular hole: coverage-corrected cut cells
    (exact polygon-cell clipping) integrate the area to the trim
    polygon's chord error — independent of subdiv — vs O(band) for
    binary Gauss masking."""
    from goldfish_jax.ops.quadrature import build_patch_quadrature
    from goldfish_jax.geometry.trim import apply_trim

    r = 0.25
    surf = _plate(nel=8)
    hole = _circle_poly(0.5, 0.5, r)
    stack, metas = build_patch_stack(
        [surf], trims=[(None, [hole])], trim_subdiv=3)
    cp = stack_control_points(metas)
    h = np.ones((1, cp.shape[1]))
    area = float(volume(stack, cp, h))
    exact = 1.0 - np.pi * r**2
    assert abs(area - exact) / exact < 1e-4  # chord floor ~5e-6
    # and strictly tighter than binary masking at the same subdiv
    p, q = surf.degree
    quad = build_patch_quadrature(surf.knots[0], surf.knots[1], p, q,
                                  surf.weights, subdiv=3)
    binary = apply_trim(quad, None, [hole], coverage=0)
    assert abs(area - exact) < 0.1 * abs(
        float(np.sum(binary.wq)) - exact)


def test_trimmed_outer_loop():
    """Outer loop restricts the domain: a centered half-size square
    keeps a quarter of the area."""
    surf = _plate(nel=6)
    outer = np.array([[0.25, 0.25], [0.75, 0.25], [0.75, 0.75],
                      [0.25, 0.75]])
    stack, metas = build_patch_stack(
        [surf], trims=[(outer, [])], trim_subdiv=4)
    cp = stack_control_points(metas)
    h = np.ones((1, cp.shape[1]))
    area = float(volume(stack, cp, h))
    assert abs(area - 0.25) < 1e-12  # loop lies on sub-cell lines


def test_trimmed_energy_and_gradient_finite():
    import jax

    surf = _plate(nel=6)
    hole = _circle_poly(0.5, 0.5, 0.2)
    stack, metas = build_patch_stack(
        [surf], trims=[(None, [hole])], trim_subdiv=3)
    cp = stack_control_points(metas)
    h = 0.01 * np.ones((1, cp.shape[1]))
    E = np.array([1e7])
    nu = np.array([0.3])
    rng = np.random.default_rng(0)
    d = 1e-3 * rng.standard_normal(cp.shape)
    W = internal_energy(stack, d, cp, h, E, nu)
    g = jax.grad(lambda dd: internal_energy(stack, dd, cp, h, E, nu))(d)
    assert np.isfinite(float(W)) and float(W) > 0
    assert np.all(np.isfinite(np.asarray(g)))


def test_trimmed_solve_softens_plate():
    """Equilibrium through NonMatchingSystem on a trimmed patch: a
    cantilever plate with a central hole deflects MORE than the solid
    plate under the same load, and the solve stays finite."""
    from goldfish_jax.solver.system import NonMatchingSystem

    E, nu, h, q = 1e7, 0.3, 0.05, 1e-4
    hole = _circle_poly(0.5, 0.5, 0.25)
    tips = []
    for trims in (None, [(None, [hole])]):
        surf = _plate(nel=6)
        sys = NonMatchingSystem([surf], E, nu, h, trims=trims)
        sys.add_side_bc(0, direction=0, side=0, n_layers=2)
        sys.set_dead_load([0, 0, -q])
        d = sys.solve_nonlinear()
        tips.append(float(sys.evaluate_displacement(d, 0, [1.0, 0.5])[2]))
    solid, holed = tips
    assert np.isfinite(holed) and holed < 0
    assert abs(holed) > 1.05 * abs(solid)


def test_igs_trim_roundtrip(tmp_path):
    surf = _plate(nel=4)
    # inner loop: composite of 4 degree-1 param-space curves (exercises
    # the 102 composite path); a second surface stays untrimmed
    corners = [(0.3, 0.3), (0.7, 0.3), (0.7, 0.7), (0.3, 0.7)]
    segs = []
    for a, b in zip(corners, corners[1:] + corners[:1]):
        P = np.array([[a[0], a[1], 0.0], [b[0], b[1], 0.0]])
        segs.append(NURBS([np.array([0.0, 0.0, 1.0, 1.0])], P))
    outer = _circle_poly(0.5, 0.5, 0.45, n=16)
    # outer as one closed degree-1 NURBS polyline (single-curve 142)
    opts = np.concatenate([outer, outer[:1]])
    n = len(opts)
    knots = np.concatenate([[0.0], np.linspace(0, 1, n), [1.0]])
    ocurve = NURBS([knots], np.concatenate(
        [opts, np.zeros((n, 1))], axis=1))
    path = str(tmp_path / "trimmed.igs")
    # a model-space curve rides along: trim-loop 126s are written
    # SUBORDINATE and must not leak into read_igs_curves
    model_curve = NURBS([np.array([0.0, 0.0, 1.0, 1.0])],
                        np.array([[0.0, 0.0, 0.0], [1.0, 2.0, 3.0]]))
    write_igs_file(path, [surf, _plate(nel=2)],
                   curves=[model_curve],
                   trims=[([ocurve], [segs]), None])
    from goldfish_jax.geometry.igs_io import read_igs_curves

    model_back = read_igs_curves(path)
    assert len(model_back) == 1
    np.testing.assert_allclose(model_back[0].points,
                               model_curve.points, atol=1e-12)
    got = read_igs_trimmed(path)
    assert len(got) == 2
    ts = got[0]
    np.testing.assert_allclose(ts.surf.points, surf.points, atol=1e-12)
    assert ts.outer is not None and len(ts.outer) == 1
    assert len(ts.inner) == 1 and len(ts.inner[0]) == 4
    np.testing.assert_allclose(
        sample_loop(ts.outer), sample_loop([ocurve]), atol=1e-12)
    np.testing.assert_allclose(
        sample_loop(ts.inner[0]), sample_loop(segs), atol=1e-12)
    assert got[1].outer is None and got[1].inner == []
    # legacy reader warns but still returns both surfaces untrimmed
    with pytest.warns(UserWarning, match="non-trivial trim"):
        surfs = read_igs_file(path)
    assert len(surfs) == 2


def test_zero_support_cps_pinned():
    """A CP whose entire basis support is trimmed away has a zero
    stiffness row; NonMatchingSystem must pin it or the tangent is
    singular (code-review round-3 finding)."""
    from goldfish_jax.geometry.trim import support_weights
    from goldfish_jax.solver.system import NonMatchingSystem

    # cubic, nel=10: the central CP's 4x4-span support box has corner
    # distance sqrt(2)*0.2 = 0.283 < 0.3 from the center -> fully
    # inside the hole
    surf = _plate(nel=10)
    hole = _circle_poly(0.5, 0.5, 0.3)
    sys = NonMatchingSystem([surf], 1e7, 0.3, 0.05,
                            trims=[(None, [hole])])
    w = support_weights(sys.stack)
    n_cp = sys.metas[0].n_cp
    dead = int((w[0, :n_cp] == 0.0).sum())
    assert dead > 0, "test geometry should void at least one CP"
    assert np.all(sys._free[0, :n_cp][w[0, :n_cp] == 0.0] == 0.0)
    sys.add_side_bc(0, direction=0, side=0, n_layers=2)
    sys.set_dead_load([0, 0, -1e-4])
    d = sys.solve_nonlinear()
    assert np.all(np.isfinite(np.asarray(d)))


def test_compress_voided_elements():
    """Fully-voided sub-cells are dropped so a trimmed patch does not
    inflate the stack's max_el padding by the void fraction."""
    from goldfish_jax.ops.quadrature import build_patch_quadrature
    from goldfish_jax.geometry.trim import apply_trim, compress_voided

    s = _plate(nel=8)
    p, q = s.degree
    quad = build_patch_quadrature(s.knots[0], s.knots[1], p, q,
                                  s.weights, subdiv=3)
    hole = _circle_poly(0.5, 0.5, 0.3)
    masked = apply_trim(quad, None, [hole])
    comp = compress_voided(masked)
    assert comp.n_el < masked.n_el
    np.testing.assert_allclose(np.sum(comp.wq), np.sum(masked.wq),
                               rtol=1e-14)


def test_igs_arc_trim_entity():
    """IGES type-100 circular arcs resolve to exact rational arcs in
    trim loops (the most common CAD trim-curve entity)."""
    from goldfish_jax.geometry.igs_io import _resolve_pcurve

    ents = {1: (100, ["100", "0", "0.5", "0.5",
                      "0.75", "0.5", "0.75", "0.5"])}
    (c,) = _resolve_pcurve(1, ents)
    poly = sample_loop([c], n_per_span=32)
    r = np.linalg.norm(poly - [0.5, 0.5], axis=1)
    np.testing.assert_allclose(r, 0.25, atol=1e-12)
    # mask: center inside, far corner outside
    m = trim_mask(np.array([[0.5, 0.5], [0.05, 0.05]]), [c], [])
    assert m.tolist() == [1.0, 0.0]


def test_cut_cell_coverage_convergence():
    """CONVERGENCE pin (round-4 verdict item 9): over subdiv 1/2/4 the
    binary-mask area error shrinks O(band) while coverage-corrected
    cut cells sit at the loop polygon's chord-error floor — strictly
    tighter than binary at EVERY subdiv, and binary strictly improves
    with refinement (finite-cell theory; geometry/trim.apply_trim)."""
    from goldfish_jax.geometry.trim import apply_trim
    from goldfish_jax.ops.quadrature import build_patch_quadrature

    r = 0.3
    surf = _plate(nel=6)
    hole = _circle_poly(0.5, 0.5, r, n=2048)
    exact = 1.0 - np.pi * r ** 2
    p, q = surf.degree
    err_bin, err_cov = [], []
    for subdiv in (1, 2, 4):
        quad = build_patch_quadrature(surf.knots[0], surf.knots[1],
                                      p, q, surf.weights,
                                      subdiv=subdiv)
        a_bin = float(np.sum(
            apply_trim(quad, None, [hole], coverage=0).wq))
        a_cov = float(np.sum(apply_trim(quad, None, [hole]).wq))
        err_bin.append(abs(a_bin - exact))
        err_cov.append(abs(a_cov - exact))
    # binary masking converges with subdivision
    assert err_bin[2] < 0.5 * err_bin[0], err_bin
    # coverage correction beats binary at every level...
    for b, c in zip(err_bin, err_cov):
        assert c < 0.2 * b, (err_bin, err_cov)
    # ...and already sits at the chord floor at subdiv=1
    assert err_cov[0] < 5e-5, err_cov
