"""CAD construction primitives (igakit-equivalents, written from scratch).

Provides the geometry builders the reference's tests/demos get from
igakit.cad (reference: GOLDFISH/tests/test_tbeam.py:3 `from igakit.cad
import *`; test_slr.py:8-17 circle/ruled): line, circle (exact rational
arc), ruled, extrude, revolve, bilinear. Constructions follow the
textbook formulas (Piegl & Tiller ch. 7), not any particular codebase.
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.geometry.nurbs import NURBS

__all__ = ["line", "circle", "ruled", "extrude", "revolve", "bilinear",
           "compat", "make_compatible"]


def _as3(p):
    p = np.asarray(p, dtype=np.float64).ravel()
    out = np.zeros(3)
    out[: len(p)] = p
    return out


def line(p0, p1) -> NURBS:
    """Degree-1 straight segment."""
    ctrl = np.stack([_as3(p0), _as3(p1)])
    return NURBS([np.array([0.0, 0.0, 1.0, 1.0])], ctrl)


def circle(center=(0, 0, 0), radius=1.0, angle=(0.0, 2 * np.pi)) -> NURBS:
    """Exact circular arc in the xy-plane as a rational quadratic NURBS.

    angle = (theta0, theta1) in radians; arcs > 90 deg are split into
    equal segments joined with double internal knots.
    """
    c = _as3(center)
    t0, t1 = float(angle[0]), float(angle[1])
    sweep = t1 - t0
    n_seg = max(1, int(np.ceil(abs(sweep) / (np.pi / 2.0 + 1e-12))))
    dth = sweep / n_seg
    w_mid = np.cos(dth / 2.0)

    ctrl = np.zeros((2 * n_seg + 1, 4))

    def on_circle(th):
        return c + radius * np.array([np.cos(th), np.sin(th), 0.0])

    for s in range(n_seg):
        a = t0 + s * dth
        b = a + dth
        m = 0.5 * (a + b)
        P0 = on_circle(a)
        P2 = on_circle(b)
        # tangent-intersection point at distance r/cos(dth/2) from center
        P1 = c + (radius / w_mid) * np.array([np.cos(m), np.sin(m), 0.0])
        ctrl[2 * s] = np.append(P0, 1.0)
        ctrl[2 * s + 1] = np.append(w_mid * P1, w_mid)
    ctrl[-1] = np.append(on_circle(t1), 1.0)

    knots = [0.0] * 3
    for s in range(1, n_seg):
        knots += [s / n_seg] * 2
    knots += [1.0] * 3
    return NURBS([np.array(knots)], ctrl)


def make_compatible(c1: NURBS, c2: NURBS) -> tuple[NURBS, NURBS]:
    """Elevate/refine two curves to a common degree and knot vector."""
    assert c1.dim == 1 and c2.dim == 1
    p = max(c1.degree[0], c2.degree[0])
    c1 = c1.elevate(0, p - c1.degree[0])
    c2 = c2.elevate(0, p - c2.degree[0])
    # merge knot multisets
    k1, k2 = list(c1.knots[0]), list(c2.knots[0])
    add1 = _multiset_sub(k2, k1)
    add2 = _multiset_sub(k1, k2)
    c1 = c1.refine(0, add1)
    c2 = c2.refine(0, add2)
    assert np.allclose(c1.knots[0], c2.knots[0])
    return c1, c2


compat = make_compatible


def _multiset_sub(a, b):
    """Elements of multiset a missing from b."""
    out = []
    b = sorted(b)
    j = 0
    for x in sorted(a):
        while j < len(b) and b[j] < x - 1e-12:
            j += 1
        if j < len(b) and abs(b[j] - x) <= 1e-12:
            j += 1
        else:
            out.append(x)
    return np.array(out)


def ruled(c1: NURBS, c2: NURBS) -> NURBS:
    """Ruled surface S(u, v) = (1-v) c1(u) + v c2(u)."""
    c1, c2 = make_compatible(c1, c2)
    ctrl = np.stack([c1.control, c2.control], axis=1)  # (n_u, 2, 4)
    return NURBS([c1.knots[0], np.array([0.0, 0.0, 1.0, 1.0])], ctrl)


def extrude(geom: NURBS, displ) -> NURBS:
    """Linear sweep of a curve/surface by a displacement vector."""
    d = _as3(displ)
    c0 = geom.control
    c1 = c0.copy()
    c1[..., :3] += d * c1[..., 3:4]
    ctrl = np.stack([c0, c1], axis=geom.dim)
    return NURBS(list(geom.knots) + [np.array([0.0, 0.0, 1.0, 1.0])], ctrl)


def revolve(curve: NURBS, point=(0, 0, 0), axis=(0, 0, 1), angle=(0.0, 2 * np.pi)) -> NURBS:
    """Surface of revolution of a curve about an axis (exact rational)."""
    point = _as3(point)
    ax = _as3(axis)
    ax = ax / np.linalg.norm(ax)
    arc = circle(center=(0, 0, 0), radius=1.0, angle=angle)
    arc_ctrl = arc.control  # (m, 4) in xy-plane around origin
    # local frame: e1, e2 perpendicular to ax
    tmp = np.array([1.0, 0.0, 0.0])
    if abs(ax @ tmp) > 0.9:
        tmp = np.array([0.0, 1.0, 0.0])
    e1 = tmp - (tmp @ ax) * ax
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(ax, e1)

    cc = curve.control
    m = arc_ctrl.shape[0]
    ctrl = np.zeros(cc.shape[:-1] + (m, 4))
    pts = curve.points  # (..., 3)
    wts = curve.weights
    rel = pts - point
    h = rel @ ax                       # height along axis
    rad_vec = rel - h[..., None] * ax  # radial offset
    r = np.linalg.norm(rad_vec, axis=-1)
    # rotate so each CP starts at angle of its own radial direction
    cos0 = np.where(r > 1e-14, rad_vec @ e1 / np.where(r > 1e-14, r, 1.0), 1.0)
    sin0 = np.where(r > 1e-14, rad_vec @ e2 / np.where(r > 1e-14, r, 1.0), 0.0)
    for j in range(m):
        aw = arc_ctrl[j, 3]
        axy = arc_ctrl[j, :2] / aw  # unscaled arc point (on unit circle/tangent)
        # rotate by each CP's start angle
        x = cos0 * axy[0] - sin0 * axy[1]
        y = sin0 * axy[0] + cos0 * axy[1]
        pos = (
            point
            + h[..., None] * ax
            + r[..., None] * (x[..., None] * e1 + y[..., None] * e2)
        )
        w = wts * aw
        ctrl[..., j, :3] = pos * w[..., None]
        ctrl[..., j, 3] = w
    return NURBS(list(curve.knots) + [arc.knots[0]], ctrl)


def bilinear(p00, p10, p01, p11) -> NURBS:
    """Bilinear surface from 4 corners; S(u,v), u: 0->1 along p00->p10."""
    ctrl = np.array(
        [[_as3(p00), _as3(p01)], [_as3(p10), _as3(p11)]], dtype=np.float64
    )
    e = np.ones((2, 2, 1))
    return NURBS(
        [np.array([0.0, 0.0, 1.0, 1.0])] * 2, np.concatenate([ctrl, e], axis=-1)
    )
