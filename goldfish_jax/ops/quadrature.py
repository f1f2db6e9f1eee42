"""Gauss-Legendre quadrature over NURBS patch elements (host precompute).

Replaces the FEniCS quadrature/assembly loop (reference:
GOLDFISH/nonmatching_opt.py:726-770 `assemble_RFE` via `assemble(...)`).
Here quadrature points, weights, and rational basis tables are baked once
per geometry into dense arrays shaped for batched contraction:

    R[(a,b)] : (n_el, n_qp, n_loc)   rational basis (a,b)-derivative
    conn     : (n_el, n_loc)         local -> flat CP index
    wq       : (n_el, n_qp)          parametric quadrature weights

Contraction with gathered control points / displacement coefficients
(`cp[conn]` -> (n_el, n_loc, 3)) gives every geometric quantity the
Kirchhoff-Love shell energy needs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from goldfish_jax.ops.bspline import rational_basis_2d, unique_spans

__all__ = ["PatchQuadrature", "build_patch_quadrature"]

DKEYS = ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))


@dataclass
class PatchQuadrature:
    """Per-patch element quadrature + basis tables (numpy, host-side)."""

    n_el: int
    n_qp: int
    n_loc: int
    n_cp: int
    conn: np.ndarray           # (n_el, n_loc) int64
    wq: np.ndarray             # (n_el, n_qp) float64
    R: dict                    # {(a,b): (n_el, n_qp, n_loc)}
    qpts: np.ndarray           # (n_el, n_qp, 2) parametric points


def gauss_points_1d(n: int):
    return np.polynomial.legendre.leggauss(n)


def build_patch_quadrature(
    knots_u,
    knots_v,
    p: int,
    q: int,
    weights: np.ndarray,
    nq_u: int | None = None,
    nq_v: int | None = None,
    subdiv: int = 1,
) -> PatchQuadrature:
    """Tensor-product Gauss quadrature with (p+1)x(q+1) points/element.

    subdiv > 1 splits every knot span into subdiv x subdiv sub-cells,
    each carrying its own Gauss rule as a separate element (static
    shapes: n_el grows, n_qp stays). Used to sharpen finite-cell
    trimmed quadrature (geometry/trim.py) — within one span all
    sub-cells share the span's basis support, so per-element conn
    uniformity is preserved."""
    nq_u = nq_u or (p + 1)
    nq_v = nq_v or (q + 1)
    spans_u = unique_spans(knots_u, p)
    spans_v = unique_spans(knots_v, q)
    gu, wu = gauss_points_1d(nq_u)
    gv, wv = gauss_points_1d(nq_v)

    def _cells(a, b):
        edges = np.linspace(a, b, subdiv + 1)
        return zip(edges[:-1], edges[1:])

    pts = []
    wts = []
    for (_, ua0, ub0) in spans_u:
        for (_, va0, vb0) in spans_v:
            for ua, ub in _cells(ua0, ub0):
                for va, vb in _cells(va0, vb0):
                    uu = 0.5 * (ua + ub) + 0.5 * (ub - ua) * gu
                    vv = 0.5 * (va + vb) + 0.5 * (vb - va) * gv
                    U, V = np.meshgrid(uu, vv, indexing="ij")
                    W = np.outer(wu, wv) * (
                        0.25 * (ub - ua) * (vb - va))
                    pts.append(
                        np.stack([U.ravel(), V.ravel()], axis=-1))
                    wts.append(W.ravel())
    qpts = np.stack(pts)           # (n_el, n_qp, 2)
    wq = np.stack(wts)             # (n_el, n_qp)
    n_el, n_qp = wq.shape

    conn_flat, tables = rational_basis_2d(
        knots_u, knots_v, p, q, weights, qpts.reshape(-1, 2), nd=2
    )
    n_loc = conn_flat.shape[1]
    conn_pt = conn_flat.reshape(n_el, n_qp, n_loc)
    # within an element every qp shares the same support
    assert np.all(conn_pt == conn_pt[:, :1, :]), "per-element support mismatch"
    conn = conn_pt[:, 0, :]
    R = {k: tables[k].reshape(n_el, n_qp, n_loc) for k in DKEYS}
    n_cp = weights.size
    return PatchQuadrature(
        n_el=n_el, n_qp=n_qp, n_loc=n_loc, n_cp=n_cp,
        conn=conn, wq=wq, R=R, qpts=qpts,
    )
