"""Block-operator tangent: unassembled Hessian blocks as the f64 matvec.

For hardware where writing the dense f64 tangent (N^2 doubles) costs
more than computing it, this module keeps the exact f64 tangent as its
natural blocks — per-element (P, E, 3L, 3L) and per-interface-qp
(I, Nq, 6L, 6L) — and provides:

  - `compute_blocks`: the blocks at a state (exact, f64);
  - `dense_f32_from_blocks`: the cheap f32 dense assembly feeding the
    equilibrated LU preconditioner (f32 scatter is native-speed);
  - `block_matvec`: exact K @ v by gather -> batched small matmuls ->
    scatter-add into (P, C, 3) (tiny writes);
  - `block_gmres_solve`: GMRES-IR over the block operator with the f32
    LU preconditioner — the mixed path's Newton direction, numerically
    identical to solving the dense f64 system.

This is a PETSc-nest-matrix replacement
(reference: GOLDFISH/nonmatching_opt.py:639-724 extraction + KSP).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from goldfish_jax.physics import kl_shell
from goldfish_jax.physics.coupling import interface_hessians
from goldfish_jax.solver.system import SystemData

__all__ = ["TangentBlocks", "compute_blocks", "dense_f32_from_blocks",
           "block_matvec", "block_gmres_solve"]


class TangentBlocks(NamedTuple):
    Ke: jnp.ndarray          # (P, E, 3L, 3L)
    Ki: jnp.ndarray | None   # (I, Nq, 6L, 6L) or None


def compute_blocks(data: SystemData, d, cp, h) -> TangentBlocks:
    Ke = kl_shell.element_hessians(data.stack, d, cp, h, data.E,
                                   data.nu, pressure=data.pressure)
    Ki = None
    if data.ifs is not None and data.ifs.n_interfaces > 0:
        Ki = interface_hessians(data.ifs, d, cp, h, data.E)
    return TangentBlocks(Ke=Ke, Ki=Ki)


def _elem_local_dofs(stack):
    """(P, E, 3L) within-patch dof of each element-local dof."""
    conn = stack.conn
    return (conn[..., :, None] * 3
            + jnp.arange(3, dtype=conn.dtype)).reshape(
        conn.shape[0], conn.shape[1], -1)


def _iface_local_dofs(conn):
    return (conn[..., :, None] * 3
            + jnp.arange(3, dtype=conn.dtype)).reshape(
        conn.shape[0], conn.shape[1], -1)


def block_matvec(data: SystemData, blocks: TangentBlocks, v):
    """Exact (BC-reduced) K @ v; v: (P, C, 3) -> (P, C, 3).

    Matches assemble_K's masked system: K = F K_blocks F + diag(1 - F),
    so fixed/padding dofs pass through identically.
    """
    stack = data.stack
    P, C = stack.n_patches, stack.max_cp
    vf = (v * data.free).reshape(P, C * 3)

    gather = jax.vmap(lambda row, idx: row[idx])

    # element contributions
    li = _elem_local_dofs(stack)                      # (P, E, 3L)
    vloc = gather(vf, li)                             # (P, E, 3L)
    mv = jnp.einsum("peab,peb->pea", blocks.Ke, vloc)
    out = jnp.zeros_like(vf)
    out = out.at[
        jnp.arange(P, dtype=li.dtype)[:, None, None], li].add(mv)

    if blocks.Ki is not None:
        ifs = data.ifs
        liA = _iface_local_dofs(ifs.connA)            # (I, Nq, 3L)
        liB = _iface_local_dofs(ifs.connB)
        vA = gather(vf[ifs.pairA], liA)
        vB = gather(vf[ifs.pairB], liB)
        vAB = jnp.concatenate([vA, vB], axis=-1)      # (I, Nq, 6L)
        mvi = jnp.einsum("inab,inb->ina", blocks.Ki, vAB)
        L3 = liA.shape[-1]
        out = out.at[ifs.pairA[:, None, None], liA].add(mvi[..., :L3])
        out = out.at[ifs.pairB[:, None, None], liB].add(mvi[..., L3:])

    out = out.reshape(v.shape) * data.free
    return out + (1.0 - data.free) * v


def dense_f32_from_blocks(data: SystemData, blocks: TangentBlocks):
    """f32 dense K (native-speed scatter) for the LU preconditioner."""
    from goldfish_jax.solver.system import (
        _interface_global_dofs,
        element_global_dofs,
    )

    stack = data.stack
    P, C = stack.n_patches, stack.max_cp
    N = P * C * 3
    gi = element_global_dofs(stack)
    K = jnp.zeros((N, N), dtype=jnp.float32)
    K = K.at[gi[..., :, None], gi[..., None, :]].add(
        blocks.Ke.astype(jnp.float32))
    if blocks.Ki is not None:
        gii = _interface_global_dofs(data.ifs, C)
        K = K.at[gii[..., :, None], gii[..., None, :]].add(
            blocks.Ki.astype(jnp.float32))
    free = data.free.reshape(-1).astype(jnp.float32)
    K = K * free[:, None] * free[None, :]
    K = K + jnp.diag(1.0 - free)
    return K


def block_gmres_solve(data: SystemData, blocks: TangentBlocks, b,
                      tol=1e-11, restart=32, maxiter=8, n_ir=3):
    """Solve K x = b (b: (P, C, 3)) via GMRES-IR on the block operator.

    f32 dense LU (equilibrated) preconditions f64 GMRES whose matvec is
    the exact block operator; outer iterative refinement restarts from
    the exact f64 residual to clear the f32-preconditioner noise floor.
    """
    K32 = dense_f32_from_blocks(data, blocks)
    dsc32 = jax.lax.rsqrt(jnp.abs(jnp.diagonal(K32)) + 1e-30)
    Keq = K32 * dsc32[:, None] * dsc32[None, :]
    lu, piv = jax.scipy.linalg.lu_factor(Keq)
    dsc = dsc32.astype(b.dtype)

    def Aop(v):
        return block_matvec(data, blocks, v)

    def Mop(r):
        rf = (dsc * r.reshape(-1)).astype(jnp.float32)
        z = jax.scipy.linalg.lu_solve((lu, piv), rf)
        return (dsc * z.astype(r.dtype)).reshape(r.shape)

    x = jnp.zeros_like(b)
    r = b
    for _ in range(n_ir):
        dx, _ = jax.scipy.sparse.linalg.gmres(
            Aop, r, tol=tol, atol=0.0, restart=restart, maxiter=maxiter,
            M=Mop, solve_method="batched")
        x = x + dx
        r = b - Aop(x)
    return x
