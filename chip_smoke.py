#!/usr/bin/env python
"""Start-up proof on an NVIDIA GPU: the shell-optimization path end to end.

Run from the root of a checkout, on a machine with a GPU:

    python chip_smoke.py             # phases A-D on one card
    python chip_smoke.py --chips 4   # only the patch-sharded box wing

Everything runs in f64 in this one process; the CPU f64 direct-solve
oracle runs inside it on `jax.devices("cpu")[0]`.

  A  20-patch wing (N = 6600, bench.py's workload): one optimization
     iteration (warm Newton, energy, adjoint dJ/dh_ffd) through
     `build_solve_fn`, on the direct and the mixed solver path in turns
     (direct, mixed, mixed, direct). Each turn times three warm 1e-4
     design steps and one 1e-2 step. dJ/dh_ffd at the first step is
     compared with the CPU oracle (1e-6 relative) in every turn.
  B  the wing thickness problem of demos/wing_thickness_opt.py: three
     SLSQP iterations through `OptProblem.run_slsqp`; J must decrease
     and the volume constraint hold to 1e-6 relative.
  C  moving-intersection T-beam (`tbeam.build_mi`, N = 6003): one warm
     CP -> xi -> d -> adjoint iteration; dJ/dCP vs the oracle (1e-6).
  D  91-patch box wing (`boxwing.build`, N_pad = 11466): forward +
     adjoint; J (1e-9) and dJ/dh_ffd (1e-6) vs the oracle.
  --chips 4: the box wing of D patch-sharded over four GPUs against the
     same solve on one (`__graft_entry__.boxwing_sharded_parity`).

Each phase prints its set-up seconds (the first call: compilation plus
the cold solve), the compile seconds JAX reports, its timed seconds
(each call ended by `jax.block_until_ready`), the compiles inside the
timed window and the device's `peak_bytes_in_use` (process peak so
far). Every such line starts with the card's name and power limit. The
last line of stdout is one JSON object, `{"ok": true, "device": ...}`.
Any failure raises: the exit code is non-zero and no JSON is printed.
The script exits non-zero before any result when JAX finds no GPU or
when the package is not beside it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

WING_RTOL = 1e-9
GRAD_TOL = 1e-6      # dJ/dp parity target against the CPU f64 oracle
ENERGY_TOL = 1e-9    # J parity target (box wing)


# ---------------------------------------------------------------- plumbing
class CompileClock:
    """Sums the compile durations JAX reports (trace, lowering, XLA
    backend compile) and counts backend compiles."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.secs = 0.0
        self.n = 0

    def __call__(self, event, duration, **kwargs):
        if event in self.EVENTS:
            self.secs += duration
            self.n += event == self.EVENTS[-1]

    def mark(self):
        return self.secs, self.n


CLOCK = CompileClock()


class Report:
    """Prints result lines that carry the card's name and power limit."""

    def __init__(self, card):
        self.card = card

    def __call__(self, phase, **fields):
        body = " ".join(f"{k}={_fmt(v)}" for k, v in fields.items())
        print(f"[{self.card}] {phase}: {body}", flush=True)


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    if isinstance(v, (list, tuple)):
        return "[" + ",".join(_fmt(x) for x in v) + "]"
    return str(v)


def peak_bytes(device):
    stats = device.memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


@contextlib.contextmanager
def solver_path(path):
    """Run under an explicit solver path ('direct' / 'mixed')."""
    from goldfish_jax.solver import linalg

    prev = linalg._MODE
    linalg.set_mode(path)
    try:
        yield
    finally:
        linalg.set_mode(prev)


@contextlib.contextmanager
def on_oracle(device):
    """The CPU f64 direct-solve reference: default device `device` and
    the direct path set explicitly (`mode()` reads the process's
    backend, not the arrays' device)."""
    import jax

    with jax.default_device(device), solver_path("direct"):
        yield


def timed(fn, *args):
    """(out, seconds, compiles inside) of one call ended by
    block_until_ready."""
    import jax

    _, n0 = CLOCK.mark()
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0, CLOCK.mark()[1] - n0


def setup_call(fn, *args):
    """(out, wall seconds, compile seconds) of a first call."""
    import jax

    c0, _ = CLOCK.mark()
    t0 = time.perf_counter()
    out = fn(*args)
    jax.block_until_ready(out)
    return out, time.perf_counter() - t0, CLOCK.mark()[0] - c0


def rel(a, b):
    import numpy as np

    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def check(ok, what):
    if not ok:
        raise AssertionError(what)


# ------------------------------------------------------------- phase A
def wing_iteration(sys_, th, data):
    """value_and_grad of one optimization iteration: (h_ffd, d0) ->
    ((J, d), dJ/dh_ffd), on the current solver path."""
    import jax

    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn
    from goldfish_jax.solver.linalg import jit_for_path

    solve = build_solve_fn(data, rtol=WING_RTOL, max_it=30)
    cp = data_cp(sys_, data)

    def opt_iteration(h_ffd, d0):
        h = th(h_ffd)
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(data.stack, d, cp, h, data.E, data.nu)
        return J, d

    return jit_for_path(jax.value_and_grad(opt_iteration, has_aux=True))


def data_cp(sys_, data):
    """The control net on the device that holds `data`."""
    import jax

    dev = next(iter(data.free.devices()))
    return jax.device_put(sys_.cp, dev)


def phase_wing_ab(report, oracle_dev, device, num_el=6, p=3,
                  paths=("direct", "mixed", "mixed", "direct")):
    """Phase A. Returns {path: {"warm": [s...], "big": [s...],
    "compiles": n}}."""
    import jax
    import jax.numpy as jnp

    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.models import wing

    sys_ = wing.build(num_el=num_el, p=p)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    h0 = jnp.asarray(th.init_h_ffd(wing.H_TH))
    n_dofs = sys_.num_splines * sys_.stack.max_cp * 3
    h_par = h0 * (1.0 + 1e-4)

    vgs, d_ref = {}, None
    times = {pth: {"warm": [], "big": [], "compiles": 0} for pth in paths}
    grads = []
    for turn, pth in enumerate(paths):
        prec = "highest" if pth == "mixed" else None
        with solver_path(pth), jax.default_matmul_precision(prec):
            if pth not in vgs:
                vgs[pth] = wing_iteration(sys_, th, sys_.data)
                ((J0, d0), _), t_set, t_comp = setup_call(
                    vgs[pth], h0, sys_.zero_displacement())
                report(f"A wing {pth}", n_dofs=n_dofs, setup_s=t_set,
                       compile_s=t_comp, J0=float(J0))
                if d_ref is None:
                    d_ref = d0
            vg = vgs[pth]
            d = d_ref
            n_in = 0
            for k in (1, 2, 3):
                ((J, d), g), dt, nc = timed(vg, h0 * (1.0 + 1e-4 * k), d)
                times[pth]["warm"].append(dt)
                n_in += nc
                if k == 1:
                    grads.append((pth, g))
            (_, g_big), dt, nc = timed(vg, h0 * (1.0 + 1e-2), d)
            times[pth]["big"].append(dt)
            n_in += nc
        times[pth]["compiles"] += n_in
        report(f"A wing turn {turn + 1} {pth}",
               warm_s=times[pth]["warm"][-3:], big_step_s=dt,
               compiles_in_window=n_in, peak_bytes=peak_bytes(device))

    with on_oracle(oracle_dev):
        data_c = jax.device_put(sys_.data, oracle_dev)
        vg_c = wing_iteration(sys_, th, data_c)
        (_, g_ref), t_orc, _ = setup_call(
            vg_c, jax.device_put(h_par, oracle_dev),
            jax.device_put(d_ref, oracle_dev))
    parity = [rel(g, g_ref) for _, g in grads]
    spread = max(rel(a, grads[0][1]) for _, a in grads)
    for pth in dict.fromkeys(paths):
        t = times[pth]
        report(f"A wing {pth} medians",
               warm_median_s=statistics.median(t["warm"]),
               big_step_median_s=statistics.median(t["big"]),
               warm_min_s=min(t["warm"]), big_step_min_s=min(t["big"]),
               compiles_in_windows=t["compiles"])
    report("A wing parity", dJdh_rel_vs_cpu=parity, tol=GRAD_TOL,
           spread_across_turns=spread, oracle_s=t_orc)
    check(max(parity) <= GRAD_TOL,
          f"wing dJ/dh parity {max(parity):.3e} > {GRAD_TOL}")
    return times


# ------------------------------------------------------------- phase B
def phase_wing_slsqp(report, device, num_el=6, p=3, maxiter=3):
    """Phase B: the demos/wing_thickness_opt.py problem, short run."""
    import jax.numpy as jnp
    import numpy as np

    from goldfish_jax.design.constraints import align_operator
    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.models import wing
    from goldfish_jax.opt.problem import OptProblem
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn

    sys_ = wing.build(num_el=num_el, p=p)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    solve = build_solve_fn(sys_.data, rtol=WING_RTOL, max_it=30)
    cp = sys_.cp
    V0 = float(sys_.volume())

    def obj(dvs, d0):
        h = th(dvs["h_ffd"])
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return J, d

    def vol(dvs):
        return kl_shell.volume(sys_.stack, cp, th(dvs["h_ffd"]))

    A = jnp.asarray(align_operator(th.shape, axis=2))
    prob = OptProblem()
    prob.add_design_var("h_ffd", th.init_h_ffd(wing.H_TH),
                        lower=wing.H_TH / 10, upper=wing.H_TH * 10,
                        scaler=1e2)
    prob.set_objective(obj, scaler=1.0, state0=sys_.zero_displacement())
    prob.add_constraint("volume", vol, equals=V0, scaler=1e2)
    prob.add_constraint("align", lambda dvs: A @ dvs["h_ffd"],
                        equals=np.zeros(A.shape[0]))

    c0, _ = CLOCK.mark()
    t0 = time.perf_counter()
    prob.preflight()
    t_set = time.perf_counter() - t0
    t_comp = CLOCK.mark()[0] - c0
    J0 = prob._build_callables()[0](prob._x0())
    _, n0 = CLOCK.mark()
    t0 = time.perf_counter()
    res = prob.run_slsqp(maxiter=maxiter, tol=1e-12)
    wall = time.perf_counter() - t0
    n_in = CLOCK.mark()[1] - n0
    h_opt = jnp.asarray(res.x["h_ffd"])
    vol_rel = abs(float(vol({"h_ffd": h_opt})) - V0) / abs(V0)
    report("B wing slsqp", setup_s=t_set, compile_s=t_comp, J0=J0,
           J_final=res.fun, nit=res.nit, wall_s=wall,
           s_per_it=wall / max(res.nit, 1), compiles_in_window=n_in,
           volume_rel_err=vol_rel, tol=GRAD_TOL,
           peak_bytes=peak_bytes(device))
    check(res.nit >= 1, "SLSQP took no iteration")
    check(res.fun < J0, f"J did not decrease: {J0} -> {res.fun}")
    check(vol_rel <= GRAD_TOL, f"volume constraint off by {vol_rel:.3e}")
    return res


# ------------------------------------------------------------- phase C
def tbeam_iteration(sys_, data, mi, co, ss):
    """value_and_grad wrt cp of the CP -> xi -> d -> energy chain:
    (cp, h, xi0, d0) -> ((J, (xi, d)), dJ/dcp)."""
    import jax

    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.linalg import jit_for_path
    from goldfish_jax.solver.system_mi import build_solve_fn_mi

    solve_d = build_solve_fn_mi(data, mi, co, ss, sys_.pdeg, sys_.qdeg,
                                rtol=WING_RTOL, max_it=30)
    c2x = sys_.c2x

    def J(cp, h, xi0, d0):
        xi = c2x.solve(cp, xi0)
        d = solve_d(cp, h, xi, d0)
        return kl_shell.internal_energy(data.stack, d, cp, h, data.E,
                                        data.nu), (xi, d)

    return jit_for_path(jax.value_and_grad(J, has_aux=True))


def phase_tbeam_mi(report, oracle_dev, device, num_el=40, p=3, n_pts=17):
    """Phase C: moving-intersection T-beam, one warm iteration."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from goldfish_jax.models import tbeam

    sys_ = tbeam.build_mi(num_el=num_el, p=p, n_pts=n_pts)
    n_dofs = sum(m.n_cp for m in sys_.metas) * 3
    m = sys_.metas[1]
    gv = sys_.surfs[1].greville_points(1)
    bend = jnp.asarray(np.tile(np.sin(np.pi * gv)[None, :],
                               (m.n_u, 1)).ravel())

    def design(amp):  # a bending shape mode of the web
        return sys_.cp.at[1, : m.n_cp, 0].add(amp * bend)

    vg = tbeam_iteration(sys_, sys_.data, sys_.mi, sys_.co, sys_.ss)
    h = sys_.h_init
    ((J0, (xi0, d0)), _), t_set, t_comp = setup_call(
        vg, design(0.05), h, sys_.c2x.xi0_flat, sys_.zero_displacement())
    cp1 = design(0.05 * (1.0 + 1e-3))
    ((J1, _), g), dt, n_in = timed(vg, cp1, h, xi0, d0)
    report("C tbeam mi", n_dofs=n_dofs, setup_s=t_set, compile_s=t_comp,
           timed_s=dt, compiles_in_window=n_in, J=float(J1),
           peak_bytes=peak_bytes(device))

    put = lambda x: jax.device_put(x, oracle_dev)  # noqa: E731
    with on_oracle(oracle_dev):
        vg_c = tbeam_iteration(sys_, put(sys_.data), put(sys_.mi),
                               put(sys_.co), put(sys_.ss))
        ((J_ref, _), g_ref), t_orc, _ = setup_call(
            vg_c, put(cp1), put(h), put(xi0), put(d0))
    r = rel(g, g_ref)
    report("C tbeam mi parity", dJdcp_rel_vs_cpu=r, tol=GRAD_TOL,
           J_rel_vs_cpu=rel(J1, J_ref), oracle_s=t_orc)
    check(r <= GRAD_TOL, f"MI dJ/dCP parity {r:.3e} > {GRAD_TOL}")
    return r


# ------------------------------------------------------------- phase D
def phase_boxwing(report, oracle_dev, device, n_sections=18, num_el=3,
                  p=3):
    """Phase D: 91-patch box wing, one forward + adjoint."""
    import jax
    import jax.numpy as jnp

    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.models import boxwing

    sys_ = boxwing.build(n_sections=n_sections, num_el=num_el, p=p)
    th = ThicknessFFD(sys_, num_els=(1, 6, 1), p=(1, 2, 1))
    h0 = jnp.asarray(th.init_h_ffd(boxwing.H_TH))
    n_pad = sys_.num_splines * sys_.stack.max_cp * 3
    vg = wing_iteration(sys_, th, sys_.data)
    ((_, d0), _), t_set, t_comp = setup_call(vg, h0,
                                             sys_.zero_displacement())
    h1 = h0 * (1.0 + 1e-4)
    ((J1, _), g), dt, n_in = timed(vg, h1, d0)
    report("D boxwing", n_patches=sys_.num_splines, n_dofs_padded=n_pad,
           setup_s=t_set, compile_s=t_comp, timed_s=dt,
           compiles_in_window=n_in, J=float(J1),
           peak_bytes=peak_bytes(device))

    with on_oracle(oracle_dev):
        vg_c = wing_iteration(sys_, th,
                              jax.device_put(sys_.data, oracle_dev))
        ((J_ref, _), g_ref), t_orc, _ = setup_call(
            vg_c, jax.device_put(h1, oracle_dev),
            jax.device_put(d0, oracle_dev))
    rJ, rg = rel(J1, J_ref), rel(g, g_ref)
    report("D boxwing parity", J_rel_vs_cpu=rJ, J_tol=ENERGY_TOL,
           dJdh_rel_vs_cpu=rg, tol=GRAD_TOL, oracle_s=t_orc)
    check(rJ <= ENERGY_TOL, f"boxwing J parity {rJ:.3e} > {ENERGY_TOL}")
    check(rg <= GRAD_TOL, f"boxwing dJ parity {rg:.3e} > {GRAD_TOL}")
    return rJ, rg


# ------------------------------------------------------------ --chips 4
def phase_sharded(report, devices, **size):
    """The box wing patch-sharded over `devices` vs one device."""
    from __graft_entry__ import boxwing_sharded_parity

    out = boxwing_sharded_parity(devices, **size)
    report("4x boxwing sharded", **out,
           peak_bytes_per_device=[peak_bytes(d) for d in devices])
    return out


# ----------------------------------------------------------------- main
def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the patch-sharded box wing")
    ap.add_argument("--phases", default="ABCD",
                    help="subset of the one-card phases to run")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_enable_x64", True)
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: JAX found no GPU (platform "
              f"{devices[0].platform!r}); refusing to run",
              file=sys.stderr)
        return 2
    if len(devices) < args.chips:
        print(f"chip_smoke: {args.chips} GPUs asked for, "
              f"{len(devices)} found", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    try:
        import goldfish_jax
    except ImportError as e:
        print(f"chip_smoke: the goldfish_jax package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 3
    pkg = os.path.dirname(os.path.abspath(goldfish_jax.__file__))
    if os.path.dirname(pkg) != HERE:
        print(f"chip_smoke: goldfish_jax imported from {pkg}, not from "
              f"the checkout holding this script", file=sys.stderr)
        return 3

    import jax.monitoring

    jax.monitoring.register_event_duration_secs_listener(CLOCK)
    cards = card_line()
    report = Report(cards[0])
    for c in cards:  # verbatim, as nvidia-smi prints them
        print(c, flush=True)
    dev = devices[0]
    print(f"[{cards[0]}] jax {jax.__version__}, device_kind "
          f"{dev.device_kind!r}, {len(devices)} device(s), x64 on",
          flush=True)
    oracle = jax.devices("cpu")[0]

    if args.chips == 4:
        phase_sharded(report, devices[:4], n_sections=18, num_el=3, p=3,
                      ffd_els=(1, 6, 1), ffd_p=(1, 2, 1))
    else:
        if "A" in args.phases:
            phase_wing_ab(report, oracle, dev)
        if "B" in args.phases:
            phase_wing_slsqp(report, dev)
        if "C" in args.phases:
            phase_tbeam_mi(report, oracle, dev)
        if "D" in args.phases:
            phase_boxwing(report, oracle, dev)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
