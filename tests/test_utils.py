"""Auxiliary subsystems: VTK IO roundtrip, checkpoint/resume, profiler."""

import os
import sys

import numpy as np
import pytest

from goldfish_jax.models import tbeam
from goldfish_jax.utils.checkpoint import Checkpointer
from goldfish_jax.utils.profiling import Profiler
from goldfish_jax.utils.vtk_io import SurfaceWriter, write_structured_vtk


def test_vtk_roundtrip(tmp_path):
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "visualization"))
    from view_results import read_structured_vtk

    pts = np.random.default_rng(0).normal(size=(4, 5, 3))
    data = {"displacement": np.random.default_rng(1).normal(size=(4, 5, 3)),
            "thickness": np.abs(np.random.default_rng(2).normal(size=(4, 5)))}
    p = str(tmp_path / "s.vtk")
    write_structured_vtk(p, pts, data)
    dims, rpts, rdata = read_structured_vtk(p)
    assert dims == (4, 5, 1)
    # VTK orders x fastest; reader returns flat arrays in file order
    ref = pts.transpose(1, 0, 2).reshape(-1, 3)
    assert np.allclose(rpts, ref)
    refu = data["displacement"].transpose(1, 0, 2).reshape(-1, 3)
    assert np.allclose(rdata["displacement"], refu)


def test_surface_writer(tmp_path):
    sys_ = tbeam.build(num_el=3, p=2)
    d = sys_.solve_nonlinear(rtol=1e-8, max_it=10)
    w = SurfaceWriter(sys_, save_path=str(tmp_path), n_eval=9)
    w.save(d=np.asarray(d), h=np.asarray(sys_.h_init))
    files = os.listdir(tmp_path)
    assert len(files) == 2  # one per patch


def test_vtu_pvd_series_roundtrip(tmp_path):
    """ParaView-pipeline format (reference: nonmatching_opt.py
    :1448-1576 writes .pvd/.vtu series): the vtu files parse as valid
    XML UnstructuredGrids, agree with the legacy-vtk writer's point
    order, and each patch's .pvd collection indexes every snapshot."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..",
                                    "visualization"))
    from view_results import read_pvd, read_structured_vtk, read_vtu

    from goldfish_jax.utils.vtk_io import write_vtu

    rng = np.random.default_rng(0)
    pts = rng.normal(size=(4, 5, 3))
    data = {"displacement": rng.normal(size=(4, 5, 3)),
            "thickness": np.abs(rng.normal(size=(4, 5)))}
    write_vtu(str(tmp_path / "s.vtu"), pts, data)
    write_structured_vtk(str(tmp_path / "s.vtk"), pts, data)
    _, p_x, d_x = read_vtu(str(tmp_path / "s.vtu"))
    _, p_l, d_l = read_structured_vtk(str(tmp_path / "s.vtk"))
    assert np.allclose(p_x, p_l)
    assert np.allclose(d_x["displacement"], d_l["displacement"])
    assert np.allclose(d_x["thickness"], d_l["thickness"])

    # quad connectivity covers the full sample grid exactly once
    import xml.etree.ElementTree as ET
    root = ET.parse(str(tmp_path / "s.vtu")).getroot()
    piece = root.find(".//Piece")
    assert int(piece.get("NumberOfPoints")) == 20
    assert int(piece.get("NumberOfCells")) == 3 * 4
    conn = next(np.asarray(da.text.split(), dtype=int)
                for da in piece.iter("DataArray")
                if da.get("Name") == "connectivity")
    assert conn.size == 4 * 12 and conn.min() == 0 and conn.max() == 19

    # SurfaceWriter in vtu mode: per-patch pvd time series
    sys_ = tbeam.build(num_el=2, p=2)
    w = SurfaceWriter(sys_, save_path=str(tmp_path / "series"),
                      n_eval=5, fmt="vtu")
    w.save(h=np.asarray(sys_.h_init))
    w.save(h=np.asarray(sys_.h_init))
    series = read_pvd(str(tmp_path / "series" / "surf0.pvd"))
    assert [t for t, _ in series] == [0.0, 1.0]
    for _, f in series:
        assert os.path.exists(f)
        _, p_s, d_s = read_vtu(f)
        assert p_s.shape == (25, 3) and "thickness" in d_s


def test_checkpoint_roundtrip(tmp_path):
    ck = Checkpointer(str(tmp_path / "state.npz"))
    design = {"h_ffd": np.arange(5.0), "p_z": np.ones((2, 3))}
    state = np.full((4,), 2.5)
    ck.save(design, state=state, meta={"iter": 7, "J": 1.25})
    out = ck.load()
    assert out is not None
    d2, s2, meta = out
    assert np.allclose(d2["h_ffd"], design["h_ffd"])
    assert np.allclose(d2["p_z"], design["p_z"])
    assert np.allclose(s2, state)
    assert meta == {"iter": 7, "J": 1.25}


def test_checkpoint_missing(tmp_path):
    assert Checkpointer(str(tmp_path / "nope.npz")).load() is None


def test_resume_run_survives_process_death(tmp_path):
    """utils/checkpoint.resume_run: an optimization killed mid-run
    resumes from the last accepted iterate in a FRESH process (fresh
    OptProblem), with the warm-start state rehydrated and the iteration
    budget reduced by the iterations already done."""
    import jax.numpy as jnp
    import pytest

    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.utils.checkpoint import resume_run

    ckpt_path = str(tmp_path / "resume.npz")
    x_star = np.array([0.3, -0.2, 0.7])

    def build():
        prob = OptProblem()
        prob.add_design_var("x", np.zeros(3), lower=-1.0, upper=1.0)

        def obj(dvs, state):
            # state threads a fake warm start (here: eval counter)
            return jnp.sum((dvs["x"] - x_star) ** 2), state + 1.0
        prob.set_objective(obj, state0=jnp.zeros(()))
        return prob

    # --- process 1: dies after 2 accepted iterations -----------------
    class Killed(RuntimeError):
        pass

    prob1 = build()
    nits = [0]

    def killer(xdict, J):
        nits[0] += 1
        if nits[0] >= 2:
            raise Killed()
    prob1.iter_callback = killer

    ck = Checkpointer(ckpt_path)
    with pytest.raises(Killed):
        resume_run(prob1, ck, maxiter=50)
    snap = ck.load()
    assert snap is not None
    design_mid, state_mid, meta = snap
    assert meta["iter"] == 2
    assert state_mid is not None and float(state_mid) > 0

    # --- process 2 (fresh everything): resumes and finishes ----------
    prob2 = build()
    res, done = resume_run(prob2, Checkpointer(ckpt_path), maxiter=50)
    assert done == 2
    # the resumed run started FROM the snapshot, not from x0
    assert np.allclose(np.asarray(prob2._dvs[0].init).ravel(),
                       design_mid["x"].ravel())
    # the warm-start state was rehydrated (not reset to zero)
    assert float(state_mid) <= float(prob2.state_box[0])
    assert res.success and np.allclose(res.x["x"], x_star, atol=1e-6)
    # the snapshot kept advancing monotonically across the resume
    *_, meta2 = Checkpointer(ckpt_path).load()
    assert meta2["iter"] > 2


def test_resume_run_exhausted_budget_is_restore_only(tmp_path):
    """A snapshot recording done >= maxiter must NOT run any further
    optimizer iterations (a supervising retry loop re-invoking after a
    crash at the budget would otherwise overrun maxiter forever)."""
    import jax.numpy as jnp

    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.utils.checkpoint import resume_run

    ckpt_path = str(tmp_path / "full.npz")
    x_done = np.array([0.1, 0.2])
    Checkpointer(ckpt_path).save({"x": x_done},
                                 meta={"iter": 5, "J": 1.25})

    prob = OptProblem()
    prob.add_design_var("x", np.zeros(2))
    evals = [0]

    def obj(dvs):
        evals[0] += 1
        return jnp.sum(dvs["x"] ** 2)
    prob.set_objective(obj)

    res, done = resume_run(prob, Checkpointer(ckpt_path), maxiter=5)
    assert done == 5
    assert evals[0] == 0                      # no objective evaluation
    assert res.nit == 0 and res.success
    np.testing.assert_allclose(res.x["x"], x_done)
    assert abs(res.fun - 1.25) < 1e-14

    # obj_scaler != 1: the checkpointed meta['J'] follows the
    # iter_callback convention (SCALED objective), while normal runs
    # descale res.fun by obj_scaler — the restore-only path must too.
    prob_s = OptProblem()
    prob_s.add_design_var("x", np.zeros(2))
    prob_s.set_objective(lambda dvs: jnp.sum(dvs["x"] ** 2), scaler=100.0)
    Checkpointer(str(tmp_path / "scaled.npz")).save(
        {"x": x_done}, meta={"iter": 5, "J": 100.0 * 0.25})
    res_s, done_s = resume_run(prob_s, Checkpointer(
        str(tmp_path / "scaled.npz")), maxiter=5)
    assert done_s == 5 and res_s.nit == 0
    assert abs(res_s.fun - 0.25) < 1e-12      # unscaled, like a live run


def test_profiler():
    import jax.numpy as jnp

    prof = Profiler()
    with prof.stage("stage_a") as box:
        box[0] = jnp.ones(16) * 2
    with prof.stage("stage_a"):
        pass
    s = prof.summary()
    assert "stage_a" in s and "2" in s
    assert len(prof.records["stage_a"]) == 2


def test_retry_transient():
    """utils/retry.py: known-transient device errors are retried with
    backoff; anything else propagates immediately."""
    import pytest

    from goldfish_jax.utils.retry import retry_transient

    calls = {"n": 0}
    sleeps = []

    @retry_transient(retries=2, base_sleep=1.0, sleep=sleeps.append)
    def flaky(x):
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError(
                "UNAVAILABLE: device worker restarted")
        return x + 1

    assert flaky(41) == 42
    assert calls["n"] == 3
    assert sleeps == [1.0, 2.0]  # exponential backoff

    # exhausted retries -> the transient error propagates
    calls["n"] = -10
    with pytest.raises(RuntimeError, match="UNAVAILABLE"):
        flaky(0)

    # non-transient errors are NOT retried
    boom = {"n": 0}

    @retry_transient(retries=5, sleep=lambda s: None)
    def broken():
        boom["n"] += 1
        raise ValueError("shape mismatch")

    with pytest.raises(ValueError):
        broken()
    assert boom["n"] == 1


def test_bench_watchdog_reports_latest_timed_median(capsys):
    """bench.Watchdog: the timed loop records the median-so-far each
    iteration; the emitted value must be the LATEST such median, not
    the minimum over running medians (advisor finding, round 4 —
    min-keeping reported the single fastest early sample). Provisional
    probes keep min semantics and never override a timed value."""
    import json
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "bench_mod", os.path.join(os.path.dirname(__file__), "..",
                                  "bench.py"))
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)

    wd = bench.Watchdog(budget_s=1e9)
    # provisional probes: min is kept (pessimistic early number is fine)
    for v in (1.4, 1.2, 1.3):
        wd.record(v, provisional=True)
    assert wd.best == 1.2
    # timed loop: medians-so-far of [0.90,0.96,0.97,0.98,1.00]
    for med in (0.90, 0.96, 0.96, 0.965, 0.97):
        wd.record(med)
    assert wd.final == 0.97  # the LAST median, not min(0.90)
    wd.emit(partial=False)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["value"] == 0.97
    assert rec["detail"]["provisional_timing"] is False


@pytest.mark.parametrize("env, expected", [
    ({"JAX_COMPILATION_CACHE_DIR": "/elsewhere/cache"}, None),
    ({}, "checkout"),
])
def test_compile_cache_dir(env, expected):
    """config.compile_cache_dir: JAX's own variable wins and the code
    then sets nothing; otherwise a fixed directory inside the checkout
    (never a home, temp or per-process path)."""
    from goldfish_jax import config

    got = config.compile_cache_dir(env)
    if expected is None:
        assert got is None
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, ".jax_cache") == config.CACHE_DIR
        assert config.compile_cache_dir(dict(env)) == got  # fixed


@pytest.mark.parametrize("env_dir", [None, "{tmp}/jaxcache"])
def test_compile_cache_config_in_fresh_process(tmp_path, env_dir):
    """Importing the package sets JAX's cache directory only when
    JAX_COMPILATION_CACHE_DIR is unset, and does not initialize a
    backend at import."""
    import subprocess

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "JAX_COMPILATION_CACHE_DIR")}
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir.format(tmp=tmp_path)
    code = ("import jax, goldfish_jax.config as c; "
            "from jax._src import xla_bridge as xb; "
            "print(jax.config.jax_compilation_cache_dir); "
            "print(xb.backends_are_initialized())")
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    cache_dir, initialized = out.stdout.split()
    want = (os.path.join(repo, ".jax_cache") if env_dir is None
            else env["JAX_COMPILATION_CACHE_DIR"])
    assert cache_dir == want
    assert initialized == "False"
