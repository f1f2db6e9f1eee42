"""Multi-device execution: patch sharding over a jax.sharding.Mesh.

The reference's only parallelism is MPI-rank distribution of patches
through PETSc nest objects (SURVEY.md sections 2.4/2.5 — no NCCL, no
TP/PP/SP; patches ARE the data-parallel axis). The JAX mapping:

  - the `patch` mesh axis shards every (P, ...) array of the
    PatchStack / SystemData pytree across devices — element quadrature
    tables (the heavy arrays) and per-patch states live shard-local;
  - penalty-coupling terms gather both sides' coefficients by patch
    index; under GSPMD those gathers lower to XLA collectives between
    devices (NVLink on a multi-GPU host; the halo exchange of SURVEY.md
    section 2.5);
  - reductions (total energy, residual norms) become psums inserted by
    XLA; the dense tangent remains replicated (small relative to the
    quadrature data) — the analogue of the reference's allgathered
    global vectors at component boundaries, but staying on device.

Patch counts are padded to a multiple of the device count with
zero-weight phantom patches (padding discipline of
geometry/patch_stack.py: replicate real geometry, zero quadrature
weight/mask, so no NaN guards are needed anywhere).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from goldfish_jax.solver.system import SystemData

__all__ = ["maybe_init_distributed", "make_mesh", "padded_patch_count",
           "pad_system", "pad_patch_array", "system_shardings",
           "shard_system"]


def maybe_init_distributed(coordinator=None, num_processes=None,
                           process_id=None, env=None) -> bool:
    """Guarded multi-host entry point (the role of the reference's MPI
    world, reference: GOLDFISH/utils/opt_utils.py:28-54 allgather and
    nonmatching_opt.py:719-723 size branches — patch distribution over
    ranks becomes patch sharding over a global device mesh).

    Reads the standard JAX cluster env vars (or GOLDFISH_* overrides /
    explicit arguments) and calls `jax.distributed.initialize`; after
    it returns True, `jax.devices()` is GLOBAL and `make_mesh()` builds
    the cross-host mesh, with `padded_patch_count` sizing the phantom
    padding from the global device count. No-op (returns False) when
    unconfigured or single-process — the 1-chip bench environment and
    the CPU test environment take that path, and real multi-host cannot
    run here: the mesh/padding logic is instead unit-tested with mocked
    process/device counts (tests/test_sharding.py) and the driver's
    `dryrun_multichip` executes it on 8 virtual devices.

    Env vars (first match wins):
      coordinator: GOLDFISH_COORDINATOR, JAX_COORDINATOR_ADDRESS
      num_processes: GOLDFISH_NUM_PROCESSES, JAX_NUM_PROCESSES
      process_id: GOLDFISH_PROCESS_ID, JAX_PROCESS_ID

    Delegates to `goldfish_jax._boot.init_distributed_from_env`, which
    the package root already ran BEFORE any submodule import (the XLA
    backend initializes during `import goldfish_jax`, after which
    jax.distributed.initialize is rejected — the real 2-process test
    caught this ordering). Calling it again here is an idempotent
    confirmation: True for a configured cluster process either way.
    """
    from goldfish_jax._boot import init_distributed_from_env

    return init_distributed_from_env(coordinator=coordinator,
                                     num_processes=num_processes,
                                     process_id=process_id, env=env)


def make_mesh(devices=None, axis: str = "patch") -> Mesh:
    """Patch mesh over `devices` (default: ALL devices — global across
    hosts after `maybe_init_distributed`)."""
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis,))


def padded_patch_count(n_patches: int, n_devices: int) -> int:
    """Phantom-padded patch count: the smallest multiple of the
    (global) device count >= n_patches, so every device carries the
    same number of patch shards (the reference's rank load balancing,
    opt_utils.py:28-54, done by padding instead of ragged scatter)."""
    assert n_patches >= 1 and n_devices >= 1
    return int(-(-n_patches // n_devices) * n_devices)


def _pad_leading(x, P_new, mode):
    """Pad axis 0 from P to P_new: 'repeat' replicates entry 0,
    'zero' pads zeros."""
    k = P_new - x.shape[0]
    if k <= 0:
        return x
    if mode == "repeat":
        filler = jnp.repeat(x[:1], k, axis=0)
    else:
        filler = jnp.zeros((k,) + x.shape[1:], dtype=x.dtype)
    return jnp.concatenate([x, filler], axis=0)


def pad_patch_array(x, P_old, P_new, mode="repeat"):
    assert x.shape[0] == P_old
    return _pad_leading(x, P_new, mode)


def pad_system(data: SystemData, P_new: int) -> SystemData:
    """Append phantom patches: real geometry replicated from patch 0,
    zero quadrature weights, zero masks, fully-fixed dofs."""
    st = data.stack
    P = st.n_patches
    if P_new == P:
        return data
    assert P_new > P
    new_stack = st._replace(
        R00=_pad_leading(st.R00, P_new, "repeat"),
        R10=_pad_leading(st.R10, P_new, "repeat"),
        R01=_pad_leading(st.R01, P_new, "repeat"),
        R20=_pad_leading(st.R20, P_new, "repeat"),
        R11=_pad_leading(st.R11, P_new, "repeat"),
        R02=_pad_leading(st.R02, P_new, "repeat"),
        conn=_pad_leading(st.conn, P_new, "repeat"),
        wq=_pad_leading(st.wq, P_new, "zero"),
        cp_mask=_pad_leading(st.cp_mask, P_new, "zero"),
    )
    return data._replace(
        stack=new_stack,
        free=_pad_leading(data.free, P_new, "zero"),
        E=_pad_leading(data.E, P_new, "repeat"),
        nu=_pad_leading(data.nu, P_new, "repeat"),
        f_areal=None if data.f_areal is None
        else _pad_leading(data.f_areal, P_new, "zero"),
        pressure=None if data.pressure is None
        else _pad_leading(data.pressure, P_new, "zero"),
        f_field=None if data.f_field is None
        else _pad_leading(data.f_field, P_new, "zero"),
    )


def pad_state(x, P_new, mode="repeat"):
    """Pad a (P, C, ...) state/coefficient array (cp: 'repeat' keeps
    real geometry under the phantom patches; d/h: either works)."""
    return _pad_leading(x, P_new, mode)


def system_shardings(data: SystemData, mesh: Mesh, axis: str = "patch"):
    """Sharding pytree for SystemData: (P, ...) leaves sharded on
    `axis`, everything else (interfaces, loads, scalars) replicated."""
    P_ = data.stack.n_patches
    repl = NamedSharding(mesh, P())

    def leaf_sharding(x):
        if hasattr(x, "ndim") and x.ndim >= 1 and x.shape[0] == P_:
            return NamedSharding(mesh, P(axis))
        return repl

    return jax.tree_util.tree_map(leaf_sharding, data)


def state_sharding(mesh: Mesh, axis: str = "patch"):
    return NamedSharding(mesh, P(axis))


def shard_system(data: SystemData, mesh: Mesh, axis: str = "patch"):
    """device_put the system pytree with patch sharding."""
    shardings = system_shardings(data, mesh, axis)
    return jax.tree_util.tree_map(
        lambda x, s: jax.device_put(x, s), data, shardings)
