"""Unit tests for the B-spline/NURBS basis core."""

import numpy as np
import pytest

from goldfish_jax.ops.bspline import (
    basis_at_points,
    ders_basis_funs,
    find_span,
    greville,
    open_uniform_knots,
    rational_basis_2d,
    unique_spans,
)
from goldfish_jax.ops.refine import (
    degree_elevation_operator,
    insert_knot_operator,
    refine_knots_operator,
)


def bspline_basis_fd(knots, p, i, u, eps=1e-7):
    """Cox-de-Boor by direct recursion (slow oracle)."""
    def N(i, p, u):
        if p == 0:
            lo, hi = knots[i], knots[i + 1]
            last = hi == knots[-1]
            return 1.0 if (lo <= u < hi or (last and u == hi)) else 0.0
        out = 0.0
        d1 = knots[i + p] - knots[i]
        d2 = knots[i + p + 1] - knots[i + 1]
        if d1 > 0:
            out += (u - knots[i]) / d1 * N(i, p - 1, u)
        if d2 > 0:
            out += (knots[i + p + 1] - u) / d2 * N(i + 1, p - 1, u)
        return out
    return N(i, p, u)


def test_partition_of_unity_and_oracle():
    p = 3
    knots = open_uniform_knots(p, 5)
    n = len(knots) - p - 1
    for u in [0.0, 0.1, 0.3333, 0.5, 0.77, 1.0]:
        span, ders = ders_basis_funs(knots, p, u, 2)
        assert abs(ders[0].sum() - 1.0) < 1e-12
        assert abs(ders[1].sum()) < 1e-10
        full = np.zeros(n)
        full[span - p: span + 1] = ders[0]
        for i in range(n):
            assert abs(full[i] - bspline_basis_fd(knots, p, i, u)) < 1e-12


def _full(knots, p, u, nd):
    n = len(knots) - p - 1
    span, d = ders_basis_funs(knots, p, u, nd)
    out = np.zeros((nd + 1, n))
    out[:, span - p: span + 1] = d
    return out


def test_derivatives_vs_fd():
    p = 4
    knots = open_uniform_knots(p, 4)
    eps = 1e-6
    for u in [0.21, 0.5, 0.83]:
        d = _full(knots, p, u, 2)
        dp = _full(knots, p, u + eps, 1)
        dm = _full(knots, p, u - eps, 1)
        fd1 = (dp[0] - dm[0]) / (2 * eps)
        fd2 = (dp[1] - dm[1]) / (2 * eps)
        assert np.allclose(d[1], fd1, atol=1e-5)
        assert np.allclose(d[2], fd2, atol=1e-4)


def test_find_span_edges():
    p = 2
    knots = open_uniform_knots(p, 3)
    assert find_span(knots, p, 0.0) == p
    assert find_span(knots, p, 1.0) == len(knots) - p - 2
    s = find_span(knots, p, 0.4)
    assert knots[s] <= 0.4 < knots[s + 1]


def test_greville():
    p = 2
    knots = np.array([0, 0, 0, 0.5, 1, 1, 1], dtype=float)
    g = greville(knots, p)
    assert np.allclose(g, [0.0, 0.25, 0.75, 1.0])


def test_knot_insertion_preserves_curve():
    rng = np.random.default_rng(0)
    p = 3
    knots = open_uniform_knots(p, 4)
    n = len(knots) - p - 1
    cps = rng.normal(size=(n, 3))
    A, nk = insert_knot_operator(knots, p, 0.37)
    cps2 = A @ cps
    us = np.linspace(0, 1, 23)
    for u in us:
        s1, d1 = ders_basis_funs(knots, p, u, 0)
        s2, d2 = ders_basis_funs(nk, p, u, 0)
        x1 = d1[0] @ cps[s1 - p: s1 + 1]
        x2 = d2[0] @ cps2[s2 - p: s2 + 1]
        assert np.allclose(x1, x2, atol=1e-12)


def test_refine_and_elevate_preserve_curve():
    rng = np.random.default_rng(1)
    p = 2
    knots = open_uniform_knots(p, 3)
    n = len(knots) - p - 1
    cps = rng.normal(size=(n, 3))

    A, nk = refine_knots_operator(knots, p, [0.1, 0.4, 0.4, 0.9])
    cps_r = A @ cps

    E, ek = degree_elevation_operator(knots, p, 2)
    cps_e = E @ cps
    pe = p + 2

    for u in np.linspace(0, 1, 17):
        s0, d0 = ders_basis_funs(knots, p, u, 0)
        x0 = d0[0] @ cps[s0 - p: s0 + 1]
        s1, d1 = ders_basis_funs(nk, p, u, 0)
        x1 = d1[0] @ cps_r[s1 - p: s1 + 1]
        s2, d2 = ders_basis_funs(ek, pe, u, 0)
        x2 = d2[0] @ cps_e[s2 - pe: s2 + 1]
        assert np.allclose(x0, x1, atol=1e-12)
        assert np.allclose(x0, x2, atol=1e-10)


def test_rational_basis_2d_reproduces_surface():
    """NURBS basis tables must reproduce an exact quarter cylinder."""
    from goldfish_jax.geometry.cadkit import circle, ruled, line

    arc0 = circle(center=[0, 0, 0], radius=2.0, angle=(0, np.pi / 2))
    arc1 = circle(center=[0, 0, 3], radius=2.0, angle=(0, np.pi / 2))
    srf = ruled(arc0, arc1)
    p, q = srf.degree
    w = srf.weights
    pts = np.array([[0.2, 0.3], [0.5, 0.5], [0.9, 0.1], [1.0, 1.0], [0.0, 0.0]])
    conn, tabs = rational_basis_2d(srf.knots[0], srf.knots[1], p, q, w, pts, nd=2)
    P = srf.points.reshape(-1, 3)
    for ipt, (u, v) in enumerate(pts):
        x = tabs[(0, 0)][ipt] @ P[conn[ipt]]
        # exact point on cylinder of radius 2
        assert abs(np.hypot(x[0], x[1]) - 2.0) < 1e-12
        xe = srf.evaluate([u], [v])[0, 0]
        assert np.allclose(x, xe, atol=1e-12)
    # derivative check vs FD
    eps = 1e-6
    for ipt, (u, v) in enumerate(pts[:3]):
        cp_, tp = rational_basis_2d(srf.knots[0], srf.knots[1], p, q, w,
                                    np.array([[u + eps, v]]), nd=0)
        cm_, tm = rational_basis_2d(srf.knots[0], srf.knots[1], p, q, w,
                                    np.array([[u - eps, v]]), nd=0)
        xp = tp[(0, 0)][0] @ P[cp_[0]]
        xm = tm[(0, 0)][0] @ P[cm_[0]]
        fd = (xp - xm) / (2 * eps)
        an = tabs[(1, 0)][ipt] @ P[conn[ipt]]
        assert np.allclose(fd, an, atol=1e-5)


def test_circle_exactness():
    from goldfish_jax.geometry.cadkit import circle

    arc = circle(center=[1, 2, 0], radius=3.0, angle=(0.3, 2.8))
    us = np.linspace(0, 1, 40)
    pts = arc.evaluate(us)
    r = np.linalg.norm(pts - np.array([1, 2, 0]), axis=-1)
    assert np.allclose(r, 3.0, atol=1e-12)


def test_revolve_exactness():
    from goldfish_jax.geometry.cadkit import line, revolve

    gen = line([2.0, 0.0, 0.0], [3.0, 0.0, 5.0])
    srf = revolve(gen, point=(0, 0, 0), axis=(0, 0, 1), angle=(0.0, np.pi))
    us = np.linspace(0, 1, 7)
    vs = np.linspace(0, 1, 9)
    pts = srf.evaluate(us, vs)
    # radius varies linearly with u, height = 5u
    for i, u in enumerate(us):
        r_expect = 2.0 + u * 1.0
        r = np.hypot(pts[i, :, 0], pts[i, :, 1])
        assert np.allclose(r, r_expect, atol=1e-10)
        assert np.allclose(pts[i, :, 2], 5 * u, atol=1e-10)
