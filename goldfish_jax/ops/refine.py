"""B-spline refinement algebra as explicit linear operators.

Knot insertion, knot refinement, and degree elevation are all exact
linear maps on control points; representing them as matrices makes the
design -> analysis control-point pipeline a chain of (constant) matmuls,
which is exactly what an accelerator wants.

Replaces GOLDFISH/utils/bsp_utils.py:89-620 (insert_knot_mat,
refine_knot_mat, surface_knot_refine_operator,
surface_order_elevation_operator) and igakit elevate/refine. The
algorithms are the standard Piegl & Tiller ones (A5.1 knot insertion;
degree elevation done exactly via Bezier decomposition + binomial
elevation + exact recomposition by least squares, which is consistent
hence exact).

All matrices act on control points in HOMOGENEOUS form (w*x, w*y, w*z, w),
matching how NURBS refinement must treat weights.
"""

from __future__ import annotations

import numpy as np

from goldfish_jax.ops.bspline import find_span

__all__ = [
    "insert_knot_operator",
    "refine_knots_operator",
    "degree_elevation_operator",
    "surface_operator",
    "knots_after_insertion",
    "knots_after_elevation",
]


def insert_knot_operator(knots: np.ndarray, p: int, u: float):
    """Single-knot-insertion operator A with Q = A @ P.

    Returns (A (n+1, n), new_knots).
    """
    knots = np.asarray(knots, dtype=np.float64)
    n = len(knots) - p - 1
    k = find_span(knots, p, u)
    A = np.zeros((n + 1, n))
    for i in range(n + 1):
        if i <= k - p:
            A[i, i] = 1.0
        elif i >= k + 1:
            A[i, i - 1] = 1.0
        else:
            denom = knots[i + p] - knots[i]
            alpha = (u - knots[i]) / denom if denom > 0 else 0.0
            A[i, i] = alpha
            if i - 1 >= 0:
                A[i, i - 1] = 1.0 - alpha
    new_knots = np.sort(np.append(knots, u))
    return A, new_knots


def refine_knots_operator(knots: np.ndarray, p: int, new_knots):
    """Operator for inserting a list of knots (with multiplicity)."""
    knots = np.asarray(knots, dtype=np.float64)
    n = len(knots) - p - 1
    A = np.eye(n)
    for u in np.sort(np.asarray(new_knots, dtype=np.float64)):
        Ai, knots = insert_knot_operator(knots, p, float(u))
        A = Ai @ A
    return A, knots


def knots_after_insertion(knots, p, new_knots):
    return np.sort(np.concatenate([np.asarray(knots, float), np.asarray(new_knots, float)]))


def knots_after_elevation(knots, p: int, t: int):
    """Knot vector after elevating degree by t (each distinct knot's
    multiplicity increases by t)."""
    knots = np.asarray(knots, dtype=np.float64)
    vals, counts = np.unique(knots, return_counts=True)
    return np.repeat(vals, counts + t)


def _bezier_decompose_knots(knots, p):
    """Knots to insert so every interior distinct knot has multiplicity p."""
    knots = np.asarray(knots, dtype=np.float64)
    interior = knots[p + 1: len(knots) - p - 1]
    vals, counts = np.unique(interior, return_counts=True)
    add = []
    for v, c in zip(vals, counts):
        add.extend([v] * (p - c))
    return np.array(add, dtype=np.float64)


def _bezier_elevation_1seg(p: int, t: int) -> np.ndarray:
    """Exact Bezier degree elevation matrix (p+t+1, p+1)."""
    from math import comb

    E = np.zeros((p + t + 1, p + 1))
    for i in range(p + t + 1):
        for j in range(max(0, i - t), min(p, i) + 1):
            E[i, j] = comb(p, j) * comb(t, i - j) / comb(p + t, i)
    return E


def degree_elevation_operator(knots: np.ndarray, p: int, t: int):
    """Exact degree-elevation operator: Q = A @ P elevates degree p -> p+t.

    Route: decompose to Bezier segments (knot insertion), elevate each
    Bezier segment with the binomial formula, then recombine onto the
    target knot vector by solving the (consistent) interpolation system.
    Returns (A, new_knots).
    """
    if t == 0:
        n = len(knots) - p - 1
        return np.eye(n), np.asarray(knots, dtype=np.float64)
    knots = np.asarray(knots, dtype=np.float64)
    # 1) decompose
    add = _bezier_decompose_knots(knots, p)
    D, dec_knots = refine_knots_operator(knots, p, add)
    nseg = (len(dec_knots) - p - 1 - 1) // p  # CPs = nseg*p + 1
    # 2) per-segment elevation with shared endpoints
    Eseg = _bezier_elevation_1seg(p, t)
    pe = p + t
    n_dec_new = nseg * pe + 1
    n_dec_old = nseg * p + 1
    Ebez = np.zeros((n_dec_new, n_dec_old))
    for s in range(nseg):
        rows = slice(s * pe, s * pe + pe + 1)
        cols = slice(s * p, s * p + p + 1)
        # overwrite shared endpoint rows (identical values, exactness ok)
        Ebez[rows, cols] = 0.0
        Ebez[rows, cols] += Eseg
    # shared endpoint rows got written twice only via overwrite->add once; fix:
    # actually rows at segment joins are set by both neighbors; ensure single
    # contribution by rebuilding join rows from the right segment formula.
    for s in range(1, nseg):
        r = s * pe
        Ebez[r, :] = 0.0
        Ebez[r, s * p: s * p + p + 1] = Eseg[0]
    # 3) recombine: target knot vector, insertion from target to decomposed
    new_knots = knots_after_elevation(knots, p, t)
    dec_elev_knots = knots_after_elevation(dec_knots, p, t)
    add2 = _diff_multiset(dec_elev_knots, new_knots)
    C, _ = refine_knots_operator(new_knots, pe, add2)
    # Solve C @ A = Ebez @ D exactly (consistent least squares)
    A, *_ = np.linalg.lstsq(C, Ebez @ D, rcond=None)
    return A, new_knots


def _diff_multiset(big: np.ndarray, small: np.ndarray) -> np.ndarray:
    """Multiset difference big \\ small (both sorted)."""
    out = []
    j = 0
    small = list(small)
    for x in big:
        if j < len(small) and np.isclose(x, small[j]):
            j += 1
        else:
            out.append(x)
    assert j == len(small), "small is not a sub-multiset of big"
    return np.array(out, dtype=np.float64)


def surface_operator(A_u: np.ndarray, A_v: np.ndarray) -> np.ndarray:
    """Tensor-product operator on flattened (n_u*n_v) surface CPs.

    CP layout is row-major (i_u * n_v + i_v); result is kron(A_u, A_v).
    """
    return np.kron(A_u, A_v)
