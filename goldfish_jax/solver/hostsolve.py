"""Host f64 direct solve: the MUMPS-equivalent production linear solver.

At production refinement the equilibrated KL-shell tangent reaches
cond ~1e12+: NO f32 factorization can represent it (measured: f32 LU
backward residual ~3e3 at the 20-patch wing, while the same kernels are
backward stable on well-conditioned matrices — precision, not a kernel
bug). The reference pays f64 MUMPS on the host for the same reason
(reference: GOLDFISH/utils/opt_utils.py:156-209). Division of labor:
the device computes the physics (residuals, Hessian blocks,
objectives, AD); the HOST assembles the dense tangent from the
device blocks (precomputed scatter indices + bincount: ~0.2 s) and
LU-factors in native f64.

`PersistentHostFactor` amortizes the factorization across Newton and
optimizer iterations: every solve runs host-side iterative refinement
against the CURRENT host-assembled K, so results stay exact while the
factor is reused until it stops contracting. All IR arithmetic is on
the host.

Set GOLDFISH_HOST_SOLVE=0 to force the all-device GMRES-IR path
(solver/blocks.py), which is preferable below ~cond 1e10.
"""

from __future__ import annotations

import os

import numpy as np
import scipy.linalg

from goldfish_jax.solver.blocks import TangentBlocks
from goldfish_jax.solver.system import SystemData

__all__ = ["enabled", "host_assemble", "host_factor", "host_solve",
           "host_direction", "PersistentHostFactor"]


def enabled() -> bool:
    return os.environ.get("GOLDFISH_HOST_SOLVE", "1") != "0"


def _assembly_indices(data: SystemData):
    """Flat N*N scatter indices for element and interface blocks
    (constant per system; precompute once)."""
    stack = data.stack
    P, C = stack.n_patches, stack.max_cp
    N = P * C * 3
    conn = np.asarray(stack.conn)
    li = (conn[..., :, None] * 3 + np.arange(3)).reshape(
        P, conn.shape[1], -1)
    gi = li + (np.arange(P) * C * 3)[:, None, None]          # (P, E, 3L)
    rows = np.broadcast_to(gi[..., :, None],
                           gi.shape + (gi.shape[-1],))
    cols = np.broadcast_to(gi[..., None, :],
                           gi.shape[:-1] + (gi.shape[-1], gi.shape[-1]))
    idx_e = (rows.astype(np.int64) * N + cols).ravel()

    idx_i = None
    if data.ifs is not None and data.ifs.n_interfaces > 0:
        ifs = data.ifs
        connA = np.asarray(ifs.connA)
        connB = np.asarray(ifs.connB)
        pairA = np.asarray(ifs.pairA)
        pairB = np.asarray(ifs.pairB)
        liA = (connA[..., :, None] * 3 + np.arange(3)).reshape(
            connA.shape[0], connA.shape[1], -1)
        liB = (connB[..., :, None] * 3 + np.arange(3)).reshape(
            connB.shape[0], connB.shape[1], -1)
        gA = liA + (pairA * C * 3)[:, None, None]
        gB = liB + (pairB * C * 3)[:, None, None]
        gAB = np.concatenate([gA, gB], axis=-1)               # (I, Nq, 6L)
        rows = np.broadcast_to(gAB[..., :, None],
                               gAB.shape + (gAB.shape[-1],))
        cols = np.broadcast_to(gAB[..., None, :],
                               gAB.shape[:-1] + (gAB.shape[-1],
                                                 gAB.shape[-1]))
        idx_i = (rows.astype(np.int64) * N + cols).ravel()
    free = np.asarray(data.free).reshape(-1)
    return idx_e, idx_i, free, N


_IDX_CACHE: dict = {}


def _indices_for(data: SystemData):
    # Content-derived key: id() can be REUSED by CPython after the
    # first system is garbage-collected, silently handing a second
    # system the wrong scatter indices (round-1 advisor finding). The
    # cheap invariants below pin the assembly topology; the conn
    # checksum distinguishes same-shape systems with different
    # connectivity.
    conn = np.asarray(data.stack.conn)
    free = np.asarray(data.free)
    if data.ifs is None:
        ikey = None
    else:
        ikey = (hash(np.asarray(data.ifs.connA).tobytes()),
                hash(np.asarray(data.ifs.connB).tobytes()),
                hash(np.asarray(data.ifs.pairA).tobytes()),
                hash(np.asarray(data.ifs.pairB).tobytes()))
    key = (conn.shape, hash(conn.tobytes()), ikey,
           free.shape, hash(free.tobytes()))
    out = _IDX_CACHE.get(key)
    if out is None:
        out = _assembly_indices(data)
        _IDX_CACHE[key] = out
    return out


def host_assemble(data: SystemData, blocks: TangentBlocks) -> np.ndarray:
    """Dense f64 K on the host from device Hessian blocks (vectorized
    bincount scatter over precomputed indices)."""
    idx_e, idx_i, free, N = _indices_for(data)
    Ke = np.asarray(blocks.Ke, dtype=np.float64)
    vals = np.bincount(idx_e, weights=Ke.ravel(), minlength=N * N)
    if idx_i is not None and blocks.Ki is not None:
        Ki = np.asarray(blocks.Ki, dtype=np.float64)
        vals += np.bincount(idx_i, weights=Ki.ravel(), minlength=N * N)
    K = vals.reshape(N, N)
    K *= free[:, None]
    K *= free[None, :]
    K[np.arange(N), np.arange(N)] += 1.0 - free
    return K


def host_factor(K: np.ndarray):
    return scipy.linalg.lu_factor(K, check_finite=False)


def host_solve(fac, b: np.ndarray) -> np.ndarray:
    return scipy.linalg.lu_solve(fac, b, check_finite=False)


def host_direction(data: SystemData, blocks: TangentBlocks, r):
    """delta = -K^{-1} r via a fresh host f64 LU; r: (P, C, 3) device."""
    import jax.numpy as jnp

    K = host_assemble(data, blocks)
    fac = host_factor(K)
    rn = np.asarray(r).reshape(-1)
    x = host_solve(fac, -rn)
    return jnp.asarray(x.reshape(np.asarray(r).shape), dtype=r.dtype)


class PersistentHostFactor:
    """Amortized host f64 LU with host-side iterative refinement.

    Per solve: assemble the CURRENT K from the device blocks (cheap),
    refine against it using the (possibly stale) cached factor;
    refactor at most once per solve when refinement stops contracting.
    Warm-started optimization loops refactor rarely.
    """

    def __init__(self, data: SystemData, max_ir: int = 10,
                 tol: float = 1e-12):
        self.data = data
        self.max_ir = max_ir
        self.tol = tol
        self.fac = None
        self.n_factor = 0

    def solve(self, blocks: TangentBlocks, b):
        import jax.numpy as jnp

        K = host_assemble(self.data, blocks)
        if self.fac is None:
            self.fac = host_factor(K)
            self.n_factor += 1
        bn_arr = np.asarray(b, dtype=np.float64).reshape(-1)
        bn = float(np.linalg.norm(bn_arr))
        if bn == 0.0:
            return jnp.zeros_like(b)
        x = np.zeros_like(bn_arr)
        r = bn_arr.copy()
        prev = float("inf")
        refactored = False
        for _ in range(self.max_ir):
            x = x + host_solve(self.fac, r)
            r = bn_arr - K @ x
            rel = float(np.linalg.norm(r)) / bn
            if rel < self.tol:
                break
            if rel > 0.5 * prev:
                if refactored:
                    break
                self.fac = host_factor(K)
                self.n_factor += 1
                refactored = True
                x = np.zeros_like(bn_arr)
                r = bn_arr.copy()
                prev = float("inf")
                continue
            prev = rel
        return jnp.asarray(x.reshape(np.asarray(b).shape), dtype=b.dtype)