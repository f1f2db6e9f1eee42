#!/usr/bin/env python
"""Benchmark: per-optimization-iteration wall clock on the 20-patch wing.

Governing metric (BASELINE.md): one full optimization iteration =
warm-started nonlinear forward solve + objective + full adjoint gradient
(dJ/d h_ffd through the implicit solve), on a 20-patch non-matching
wing, in f64. The reference publishes no numbers; the recorded baseline
is the identical workload on a one-core build host's CPU in float64,
measured via GOLDFISH_BENCH_CPU=1 and pinned below.

Runs on an NVIDIA GPU and refuses any other device unless
GOLDFISH_BENCH_CPU=1 asks for the CPU baseline. Each iteration is timed
to `jax.block_until_ready`. The record names the device it ran on
(platform, device_kind, count) and the card's power limit.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": ..., "unit": "s", "vs_baseline": ...}
vs_baseline = CPU_BASELINE_S / value  (>1 means faster than baseline).

Hardened against a harness timeout:
  - progress lines on stderr at every phase ('# bench ...' — never
    JSON-parseable, so a tail parser ignores them);
  - a wall-clock budget (GOLDFISH_BENCH_BUDGET_S, default 2400 s) with
    per-phase fractions: warm-up variants are SKIPPED once the budget
    fraction is spent, timed iterations stop early, and the refactor
    honesty iteration is dropped last;
  - a SIGALRM/SIGTERM watchdog that emits the best-so-far JSON line
    (flagged "partial": true) before the process dies;
  - transient-failure retries (utils/retry.py) around the build and
    every evaluation.

Provenance: the detail block records host, date, load average at
process start and sample count. In CPU-baseline mode a contended
machine (load > 0.5 before we start) marks the record
"contended": true — such a number must NEVER be pinned as
CPU_BASELINE_S.
"""

import json
import os
import signal
import socket
import sys
import time

# CPU float64 baseline for the identical workload (see module docstring):
# median of 5 warm iterations on a one-core build host, exact-tangent
# Newton, uncontended. A record with "contended": true is not eligible
# to update this constant.
CPU_BASELINE_S = 19.6

T0 = time.monotonic()


def elapsed():
    return time.monotonic() - T0


def progress(msg):
    print(f"# bench +{elapsed():7.1f}s {msg}", file=sys.stderr, flush=True)


class Watchdog:
    """Guarantees ONE parseable JSON line on stdout, whatever happens.

    `record()` keeps the best-so-far measurement; `emit()` prints it
    exactly once. SIGTERM (the driver's `timeout` kill) and SIGALRM
    (our own budget) both route through `emit(partial=True)` and exit
    0 so the driver's artifact has rc=0 + parsed JSON instead of the
    round-3 rc=124/null."""

    def __init__(self, budget_s):
        self.budget_s = float(budget_s)
        self.phase = "init"
        self.best = None       # provisional (early-probe) measurement
        self.final = None      # proper timed-loop measurement
        self.detail = {}
        self.emitted = False

    def remaining(self):
        return self.budget_s - elapsed()

    def record(self, value, provisional=False, **detail):
        self.detail.update(detail)
        if value is None:
            return
        if provisional:
            if self.best is None or value < self.best:
                self.best = value
        else:
            # Always take the LATEST timed-loop value: the loop records
            # the median-so-far each iteration, so keeping a min here
            # would report the single fastest early sample instead of
            # the final median (advisor finding, round 4).
            self.final = value

    def emit(self, partial):
        if self.emitted:
            return
        self.emitted = True
        v = self.final if self.final is not None else self.best
        d = dict(self.detail)
        d["partial"] = bool(partial)
        d["provisional_timing"] = self.final is None
        d["phase"] = self.phase
        d["elapsed_s"] = round(elapsed(), 1)
        d["cpu_baseline_s"] = CPU_BASELINE_S
        print(json.dumps({
            "metric": "wing20_opt_iteration_wall",
            "value": None if v is None else round(v, 4),
            "unit": "s",
            "vs_baseline": None if v is None else round(CPU_BASELINE_S / v, 2),
            "detail": d,
        }), flush=True)

    def _handler(self, signum, frame):
        progress(f"signal {signum} during phase '{self.phase}' — "
                 "emitting best-so-far and exiting")
        self.emit(partial=True)
        os._exit(0)

    def arm(self):
        signal.signal(signal.SIGTERM, self._handler)
        signal.signal(signal.SIGALRM, self._handler)
        signal.alarm(max(int(self.budget_s), 1))


def build_workload():
    import jax
    import jax.numpy as jnp

    from goldfish_jax.design.pipeline import ThicknessFFD
    from goldfish_jax.models import wing
    from goldfish_jax.physics import kl_shell
    from goldfish_jax.solver.implicit import build_solve_fn
    from goldfish_jax.solver.linalg import jit_for_path

    sys_ = wing.build(num_el=6, p=3)
    th = ThicknessFFD(sys_, num_els=(4, 4, 1), p=(2, 2, 1))
    # exact-tangent Newton (freeze_K degrades gradient parity below the
    # 1e-6 target)
    solve = build_solve_fn(sys_.data, rtol=1e-9, max_it=30)
    cp = sys_.cp

    def opt_iteration(h_ffd, d0):
        h = th(h_ffd)
        d = solve(cp, h, d0)
        J = kl_shell.internal_energy(sys_.stack, d, cp, h, sys_.E, sys_.nu)
        return J, d

    vg = jit_for_path(jax.value_and_grad(opt_iteration, has_aux=True))
    h0 = jnp.asarray(th.init_h_ffd(wing.H_TH))
    d0 = sys_.zero_displacement()
    n_dofs = sys_.num_splines * sys_.stack.max_cp * 3
    return vg, h0, d0, n_dofs, getattr(solve, "device_factor", None)


def power_limit():
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]


def main():
    wd = Watchdog(os.environ.get("GOLDFISH_BENCH_BUDGET_S", "2400"))
    wd.arm()
    try:
        load0 = os.getloadavg()[0]
    except OSError:
        load0 = -1.0
    cpu_mode = os.environ.get("GOLDFISH_BENCH_CPU") == "1"
    wd.record(None,
              host=socket.gethostname(),
              date=time.strftime("%Y-%m-%dT%H:%M:%S"),
              load_at_start=round(load0, 2),
              contended=bool(load0 > 0.5),
              n_samples=0)
    if cpu_mode and load0 > 0.5:
        progress(f"WARNING: load {load0:.2f} on a 1-core host — this CPU "
                 "baseline is CONTENDED and must not be pinned")

    import jax

    if cpu_mode:
        jax.config.update("jax_platforms", "cpu")
    dev = jax.devices()[0]
    if not cpu_mode and dev.platform != "gpu":
        progress(f"refusing to run on {dev.platform!r}: no GPU found "
                 "(GOLDFISH_BENCH_CPU=1 runs the CPU baseline)")
        return 2
    wd.record(None, platform=dev.platform, device_kind=dev.device_kind,
              device_count=len(jax.devices()),
              card=None if cpu_mode else power_limit())

    from goldfish_jax.config import use_x64
    use_x64(True)

    from goldfish_jax.opt.warmstart import SecantWarmStart
    from goldfish_jax.utils.retry import retry_transient

    wd.phase = "build"
    progress(f"building workload on {dev.platform} ({dev.device_kind}), "
             f"budget {wd.budget_s:.0f}s")
    vg, h0, d0, n_dofs, fac = retry_transient(build_workload)()
    wd.record(None, n_patches=20, n_dofs=n_dofs)
    progress("workload built")

    def force(*xs):
        # dispatch is asynchronous: stop the clock only once every
        # output is computed
        jax.block_until_ready(xs)

    eval_once = retry_transient(
        lambda h, d: vg(h, d), retries=1, base_sleep=10.0)

    # compile + converge the warm start
    wd.phase = "compile"
    progress("first evaluation (compiles the fwd+adjoint programs)")
    (J, d), g = eval_once(h0, d0)
    force(J, d, g)
    progress(f"first evaluation done, J={float(J):.6e}")
    wd.record(None, J=float(J))

    # secant-extrapolated warm start across iterations (the production
    # operations layer does the same, operations/disp_imop.py)
    ws = SecantWarmStart()
    ws.update(h0, d)

    # early probes: a provisional per-iteration number on record within
    # minutes; the timed loop below overrides it
    wd.phase = "probe"
    for k in range(3):
        hp = h0 * (1.0 - 1e-4 * (k + 1))
        t0 = time.perf_counter()
        (Jp, d), gp = eval_once(hp, ws.predict(hp, d))
        force(Jp, d, gp)
        dt = time.perf_counter() - t0
        ws.update(hp, d)
        wd.record(dt, provisional=True)
        progress(f"early probe {k + 1}/3: {dt:.3f}s")

    # mixed path only: compile every IR sweep-menu program variant
    # before timing (each distinct n_ir is a separate program)
    wd.phase = "preload"
    if fac is not None and getattr(fac, "_ref", None) is not None \
            and wd.remaining() > 0.35 * wd.budget_s:
        progress("preloading IR sweep-menu program variants")
        fac.preload()
        progress("preload done")
    else:
        progress("skipping preload (no factor or budget too tight)")

    # warm-up over BOTH step signs and a larger delta (on the mixed
    # path this also settles the adaptive IR sweep policy)
    wd.phase = "warmup"
    n_warm = 0
    for dh in (-1e-4, -2e-4, 1e-4, 5e-4, -1e-4):
        if wd.remaining() < 0.25 * wd.budget_s:
            progress(f"budget: stopping warm-up after {n_warm}/5 variants")
            break
        hw = h0 * (1.0 + dh)
        (Jw, dw), gw = eval_once(hw, ws.predict(hw, d))
        force(Jw, dw, gw)
        ws.update(hw, dw)
        d = dw
        n_warm += 1
        progress(f"warm-up {n_warm}/5 (dh={dh:+.0e}) done")

    # mixed path: refactor at the reference state last, untimed
    if fac is not None and getattr(fac, "_ref", None) is not None:
        fac.ensure(*fac._ref, force=True, why="pre-timed-reload")
        progress("factor ladder re-loaded (untimed)")

    wd.phase = "timed"
    times = []
    for k in range(5):
        if times and wd.remaining() < 2.5 * max(times):
            progress(f"budget: stopping timed loop after {len(times)}/5")
            break
        hk = h0 * (1.0 + 1e-4 * (k + 1))  # optimizer-step-sized change
        t0 = time.perf_counter()
        (J, d), g = eval_once(hk, ws.predict(hk, d))
        force(J, d, g)
        times.append(time.perf_counter() - t0)
        ws.update(hk, d)
        srt = sorted(times)
        wd.record(srt[len(srt) // 2],
                  all_times=[round(x, 4) for x in times],
                  n_samples=len(times), J=float(J))
        progress(f"timed iteration {len(times)}/5: {times[-1]:.3f}s "
                 f"(median so far {srt[len(srt) // 2]:.3f}s)")

    # honesty iteration: an SLSQP-realistic EARLY design delta (1e-2
    # relative) that forces tangent refactorization — the warm 1e-4
    # steps above sit inside the stale-factor comfort zone, so this
    # bounds steady-state optimizer throughput from below
    wd.phase = "refactor"
    if times and wd.remaining() > 12.0 * max(times) + 30.0:
        h_big = h0 * (1.0 + 1e-2)
        t0 = time.perf_counter()
        (Jb, db), gb = eval_once(h_big, ws.predict(h_big, d))
        force(Jb, db, gb)
        wd.record(None,
                  refactor_iteration_s=round(time.perf_counter() - t0, 4))
        progress(f"refactor honesty iteration: "
                 f"{wd.detail['refactor_iteration_s']:.3f}s")
    else:
        progress("budget: skipping refactor honesty iteration")

    if fac is not None:
        # outlier attribution: refactors and IR certificates tell a
        # multi-second timed iteration apart from a program load
        progress(f"refactor_log: {getattr(fac, 'refactor_log', [])}")
        progress(f"cert_log tail: {getattr(fac, 'cert_log', [])[-16:]}")
    wd.phase = "done"
    wd.emit(partial=len(times) < 5)
    return 0


if __name__ == "__main__":
    sys.exit(main())
