"""Padded, stacked per-patch quadrature data as a JAX pytree.

This is the batched answer to the reference's ragged list of per-patch
FEniCS function spaces + PETSc nest vectors (reference:
GOLDFISH/nonmatching_opt.py:12-127): every patch's basis tables are
padded to common (max_el, n_qp, max_loc, max_cp) sizes and stacked along
a leading patch axis, so ALL physics evaluates as one batched einsum
chain with static shapes (SURVEY.md section 7.3 item 1).

Padding discipline: padded elements replicate element 0 of the same
patch with zero quadrature weight -> every intermediate quantity stays
well-conditioned (no 0/0 -> NaN guards needed), contributions vanish
exactly, and AD stays clean.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

from goldfish_jax.geometry.nurbs import NURBS
from goldfish_jax.ops.quadrature import PatchQuadrature, build_patch_quadrature

__all__ = ["PatchStack", "PatchMeta", "build_patch_stack", "side_dofs"]


class PatchStack(NamedTuple):
    """Device arrays. P = patches, E = max elements, Q = qps/element,
    L = max local basis size, C = max CPs/patch."""

    R00: jnp.ndarray  # (P, E, Q, L)
    R10: jnp.ndarray
    R01: jnp.ndarray
    R20: jnp.ndarray
    R11: jnp.ndarray
    R02: jnp.ndarray
    conn: jnp.ndarray     # (P, E, L) int32
    wq: jnp.ndarray       # (P, E, Q) parametric weights, 0 on padding
    cp_mask: jnp.ndarray  # (P, C) float: 1 for real control points

    @property
    def n_patches(self):
        return self.R00.shape[0]

    @property
    def max_cp(self):
        return self.cp_mask.shape[1]


class PatchMeta:
    """Host-side static metadata for one patch."""

    def __init__(self, surf: NURBS, quad: PatchQuadrature):
        self.surf = surf
        self.quad = quad
        self.n_u, self.n_v = surf.shape
        self.n_cp = self.n_u * self.n_v
        self.degree = surf.degree


def side_dofs(n_u: int, n_v: int, direction: int, side: int, n_layers: int = 1) -> np.ndarray:
    """Flat CP indices of a parametric side, n_layers rows deep.

    Matches tIGAr getSideDofs semantics (reference:
    GOLDFISH/tests/test_tbeam.py:27, test_slr.py:28): direction is the
    parametric direction NORMAL to which the side is selected is taken
    along; side 0 = start, 1 = end. CP layout is i_u * n_v + i_v.
    """
    iu = np.arange(n_u)
    iv = np.arange(n_v)
    if direction == 0:
        rows = iu[:n_layers] if side == 0 else iu[n_u - n_layers:]
        return (rows[:, None] * n_v + iv[None, :]).ravel()
    else:
        cols = iv[:n_layers] if side == 0 else iv[n_v - n_layers:]
        return (iu[:, None] * n_v + cols[None, :]).ravel()


def build_patch_stack(surfs: list[NURBS], nq: int | None = None,
                      dtype=jnp.float64, trims=None, trim_subdiv: int = 3):
    """Build (PatchStack, [PatchMeta]) from NURBS surfaces.

    nq: Gauss points per direction (default degree+1 per patch).
    trims: optional per-patch trim spec (len P list; None entries =
    untrimmed): each entry is `(outer, inners)` with loops as accepted
    by geometry/trim.sample_loop (param-space NURBS curve(s) or (M, 2)
    polygons; outer may be None for the natural domain). Trimmed
    patches get a `trim_subdiv`-subdivided rule and finite-cell weight
    masking (zero weight outside the trim, real geometry kept).
    """
    metas = []
    quads = []
    for i, s in enumerate(surfs):
        p, q = s.degree
        tr = trims[i] if trims is not None else None
        quad = build_patch_quadrature(
            s.knots[0], s.knots[1], p, q, s.weights,
            nq_u=nq or (p + 1), nq_v=nq or (q + 1),
            subdiv=trim_subdiv if tr is not None else 1,
        )
        if tr is not None:
            from goldfish_jax.geometry.trim import apply_trim, compress_voided
            outer, inners = tr
            quad = compress_voided(apply_trim(quad, outer, inners))
        metas.append(PatchMeta(s, quad))
        quads.append(quad)

    P = len(surfs)
    max_el = max(q.n_el for q in quads)
    max_loc = max(q.n_loc for q in quads)
    max_cp = max(m.n_cp for m in metas)
    n_qp = quads[0].n_qp
    assert all(q.n_qp == n_qp for q in quads), (
        "mixed qp counts per element not supported; pass nq explicitly"
    )

    def pad_patch(q: PatchQuadrature):
        def pad_R(a):  # (n_el, n_qp, n_loc) -> (max_el, n_qp, max_loc)
            a = np.pad(a, ((0, 0), (0, 0), (0, max_loc - a.shape[2])))
            if a.shape[0] < max_el:
                a = np.concatenate(
                    [a, np.repeat(a[:1], max_el - a.shape[0], axis=0)], axis=0
                )
            return a

        conn = np.pad(q.conn, ((0, 0), (0, max_loc - q.conn.shape[1])))
        if conn.shape[0] < max_el:
            conn = np.concatenate(
                [conn, np.repeat(conn[:1], max_el - conn.shape[0], axis=0)]
            )
        wq = np.pad(q.wq, ((0, max_el - q.wq.shape[0]), (0, 0)))
        return (
            [pad_R(q.R[k]) for k in ((0, 0), (1, 0), (0, 1), (2, 0), (1, 1), (0, 2))],
            conn,
            wq,
        )

    Rs = [[], [], [], [], [], []]
    conns, wqs, masks = [], [], []
    for q, m in zip(quads, metas):
        rlist, conn, wq = pad_patch(q)
        for i in range(6):
            Rs[i].append(rlist[i])
        conns.append(conn)
        wqs.append(wq)
        mask = np.zeros(max_cp)
        mask[: m.n_cp] = 1.0
        masks.append(mask)

    stack = PatchStack(
        R00=jnp.asarray(np.stack(Rs[0]), dtype=dtype),
        R10=jnp.asarray(np.stack(Rs[1]), dtype=dtype),
        R01=jnp.asarray(np.stack(Rs[2]), dtype=dtype),
        R20=jnp.asarray(np.stack(Rs[3]), dtype=dtype),
        R11=jnp.asarray(np.stack(Rs[4]), dtype=dtype),
        R02=jnp.asarray(np.stack(Rs[5]), dtype=dtype),
        conn=jnp.asarray(np.stack(conns), dtype=jnp.int32),
        wq=jnp.asarray(np.stack(wqs), dtype=dtype),
        cp_mask=jnp.asarray(np.stack(masks), dtype=dtype),
    )
    return stack, metas


def stack_control_points(metas: list[PatchMeta], dtype=jnp.float64):
    """Padded (P, C, 3) physical CP array from patch metadata."""
    max_cp = max(m.n_cp for m in metas)
    out = np.zeros((len(metas), max_cp, 3))
    for i, m in enumerate(metas):
        out[i, : m.n_cp] = m.surf.points.reshape(-1, 3)
    return jnp.asarray(out, dtype=dtype)
