"""Patch-sharded execution equivalence: the sharded system must produce
the same residual/energy/solution as the unsharded one (8 virtual CPU
devices via conftest)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

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
from goldfish_jax.solver.implicit import newton_solve
from goldfish_jax.solver.system import residual, total_potential


@pytest.fixture(scope="module")
def small_wing():
    return wing.build(n_chord=2, n_span=2, num_el=2, p=2)


def test_padded_system_equivalence(small_wing):
    sys = small_wing
    P = sys.num_splines
    data8 = pad_system(sys.data, 8)
    cp8 = pad_state(sys.cp, 8, "repeat")
    h8 = pad_state(sys.h_init, 8, "repeat")
    d8 = pad_state(sys.zero_displacement(), 8, "zero")
    Pi = float(total_potential(sys.data, sys.zero_displacement(),
                               sys.cp, sys.h_init))
    Pi8 = float(total_potential(data8, d8, cp8, h8))
    assert abs(Pi - Pi8) <= 1e-12 * max(abs(Pi), 1.0)
    r = residual(sys.data, sys.zero_displacement(), sys.cp, sys.h_init)
    r8 = residual(data8, d8, cp8, h8)
    assert np.allclose(np.asarray(r8[:P]), np.asarray(r), atol=1e-12)
    assert np.abs(np.asarray(r8[P:])).max() == 0.0


def test_sharded_solve_matches_unsharded(small_wing):
    sys = small_wing
    assert len(jax.devices()) >= 8
    d_ref, it_ref, _ = newton_solve(sys.data, sys.cp, sys.h_init,
                                    sys.zero_displacement(), rtol=1e-10)

    mesh = make_mesh(jax.devices()[:8])
    data8 = shard_system(pad_system(sys.data, 8), mesh)
    sh = state_sharding(mesh)
    cp8 = jax.device_put(pad_state(sys.cp, 8, "repeat"), sh)
    h8 = jax.device_put(pad_state(sys.h_init, 8, "repeat"), sh)
    d08 = jax.device_put(pad_state(sys.zero_displacement(), 8, "zero"), sh)
    d8, it8, _ = newton_solve(data8, cp8, h8, d08, rtol=1e-10)

    P = sys.num_splines
    err = np.abs(np.asarray(d8[:P]) - np.asarray(d_ref)).max()
    scale = np.abs(np.asarray(d_ref)).max()
    assert err < 1e-9 * max(scale, 1e-30), (err, scale)


def test_padded_patch_count():
    """Global load balance: padded count is the smallest multiple of
    the (global) device count (the reference's MPI rank distribution,
    opt_utils.py:28-54, done by phantom padding)."""
    assert padded_patch_count(91, 8) == 96
    assert padded_patch_count(91, 32) == 96     # 4 hosts x 8 chips
    assert padded_patch_count(20, 8) == 24
    assert padded_patch_count(8, 8) == 8
    assert padded_patch_count(1, 8) == 8


def test_maybe_init_distributed_guarded(monkeypatch):
    """Multi-host entry point: no-op when unconfigured/single-process;
    calls jax.distributed.initialize with the env-var cluster spec when
    configured. Real multi-host cannot run in this environment — the
    initialize call is mocked and only the guard/plumbing is pinned
    (the mesh/padding logic it feeds is exercised on 8 virtual devices
    by the other tests and by dryrun_multichip)."""
    from goldfish_jax import _boot

    calls = []

    def fake_init(coordinator_address, num_processes, process_id):
        calls.append((coordinator_address, num_processes, process_id))

    monkeypatch.setattr(jax.distributed, "initialize", fake_init)
    monkeypatch.setattr(_boot, "_initialized", False)

    # unconfigured -> False, no init
    assert maybe_init_distributed(env={}) is False
    # single process -> False even with a coordinator
    assert maybe_init_distributed(
        env={"GOLDFISH_COORDINATOR": "h0:1234",
             "GOLDFISH_NUM_PROCESSES": "1"}) is False
    assert calls == []
    # a 4-process cluster spec from env vars -> initialize called
    assert maybe_init_distributed(
        env={"GOLDFISH_COORDINATOR": "h0:1234",
             "GOLDFISH_NUM_PROCESSES": "4",
             "GOLDFISH_PROCESS_ID": "2"}) is True
    assert calls == [("h0:1234", 4, 2)]
    # idempotent: a second configured call confirms without re-init
    # (the package root already booted a real cluster process)
    assert maybe_init_distributed(
        env={"GOLDFISH_COORDINATOR": "h0:1234",
             "GOLDFISH_NUM_PROCESSES": "4",
             "GOLDFISH_PROCESS_ID": "2"}) is True
    assert len(calls) == 1
    # jax-standard env var spellings work too; explicit args win
    monkeypatch.setattr(_boot, "_initialized", False)
    assert maybe_init_distributed(
        process_id=3,
        env={"JAX_COORDINATOR_ADDRESS": "h1:99",
             "JAX_NUM_PROCESSES": "8",
             "JAX_PROCESS_ID": "0"}) is True
    assert calls[-1] == ("h1:99", 8, 3)
