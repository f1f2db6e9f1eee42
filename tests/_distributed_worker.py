"""Subprocess worker for the REAL 2-process jax.distributed test.

Run as:  python tests/_distributed_worker.py <out.npz> [reference]

In distributed mode the parent sets GOLDFISH_COORDINATOR /
GOLDFISH_NUM_PROCESSES / GOLDFISH_PROCESS_ID plus
XLA_FLAGS=--xla_force_host_platform_device_count=2, so each of the two
processes contributes 2 virtual CPU devices to a 4-device GLOBAL mesh
through `maybe_init_distributed` — the reference's multi-rank MPI world
(GOLDFISH/utils/opt_utils.py:28-54, nonmatching_opt.py:719-723) crossed
by a real process boundary instead of a mock. In `reference` mode the
same objective/gradient is computed unsharded in one process.
"""

import os
import sys

os.environ.setdefault("GOLDFISH_X64", "1")

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np


def main():
    out_path = sys.argv[1]
    reference = len(sys.argv) > 2 and sys.argv[2] == "reference"

    import jax.numpy as jnp

    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.models import wing
    from goldfish_jax.parallel.sharding import (
        make_mesh,
        maybe_init_distributed,
        pad_state,
        pad_system,
        padded_patch_count,
        shard_system,
        state_sharding,
    )
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn_dataarg

    if not reference:
        assert maybe_init_distributed() is True, "cluster spec not picked up"
        assert jax.process_count() == 2, jax.process_count()
        assert len(jax.devices()) == 4, jax.devices()
        assert len(jax.local_devices()) == 2, jax.local_devices()

    sys_ = wing.build(n_chord=2, n_span=2, num_el=2, p=2)
    P = sys_.num_splines
    n_dev = len(jax.devices()) if not reference else 1
    P_pad = padded_patch_count(P, n_dev)

    # host-side numpy pytrees: device_put uploads each process's
    # addressable shards of the GLOBAL sharding
    data_np = jax.tree_util.tree_map(
        lambda x: None if x is None else np.asarray(x),
        pad_system(sys_.data, P_pad))
    cp_np = np.asarray(pad_state(sys_.cp, P_pad, "repeat"))
    d0_np = np.asarray(pad_state(sys_.zero_displacement(), P_pad, "zero"))

    if reference:
        data = data_np
        cp = jnp.asarray(cp_np)
        d0 = jnp.asarray(d0_np)
    else:
        mesh = make_mesh()          # GLOBAL mesh over all 4 devices
        data = shard_system(data_np, mesh)
        sh = state_sharding(mesh)
        cp = jax.device_put(cp_np, sh)
        d0 = jax.device_put(d0_np, sh)

    th = ThicknessFFD(sys_, num_els=(2, 1, 1), p=(2, 1, 1))
    # data/cp flow as jit ARGUMENTS: multi-process jit forbids closing
    # over global-sharded arrays (see build_solve_fn_dataarg docstring)
    solve = build_solve_fn_dataarg(rtol=1e-8, max_it=12)

    def train_step(data_, cp_, h_ffd, d_prev):
        h = pad_state(th(h_ffd), P_pad, "repeat")
        d = solve(data_, cp_, h, d_prev)
        J = kl_shell.internal_energy(data_.stack, d, cp_, h,
                                     data_.E, data_.nu)
        return J, d

    vg = jax.jit(jax.value_and_grad(train_step, argnums=2,
                                    has_aux=True))
    h_ffd = jnp.asarray(th.init_h_ffd(wing.H_TH))
    (J, d), g = vg(data, cp, h_ffd, d0)
    jax.block_until_ready((J, d, g))

    # J and g are replicated (scalar objective, replicated design
    # input) -> every process can read them fully
    J_host = float(jax.device_get(J))
    g_host = np.asarray(jax.device_get(g))
    assert np.isfinite(J_host) and np.all(np.isfinite(g_host))

    tag = "ref" if reference else f"p{jax.process_index()}"
    np.savez(f"{out_path}.{tag}", J=J_host, g=g_host,
             n_global_devices=len(jax.devices()),
             process_count=1 if reference else jax.process_count())
    print(f"worker {tag} done: J={J_host:.6e}", flush=True)

    if not reference:
        # leave the barrier AFTER results are written so a crash of the
        # peer cannot deadlock the writer
        jax.experimental.multihost_utils.sync_global_devices("done")


if __name__ == "__main__":
    import jax.experimental.multihost_utils  # noqa: F401  (import check)
    main()
