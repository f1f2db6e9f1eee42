"""Tracing / profiling subsystem.

The reference's instrumentation is two `perf_counter` prints around
`run_driver` (SURVEY.md section 5). Here: named stage timers with
device synchronization, per-stage statistics, and optional JAX device
profiler traces (TensorBoard format) around any stage.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import jax

__all__ = ["Profiler", "profiler", "fence"]


def fence(tree):
    """Block until every array leaf of `tree` is computed (JAX dispatch
    is asynchronous: without a fence a timer measures the enqueue)."""
    return jax.block_until_ready(tree)


class Profiler:
    def __init__(self, trace_dir: str | None = None):
        self.records = defaultdict(list)
        self.trace_dir = trace_dir
        self.enabled = True

    @contextlib.contextmanager
    def stage(self, name: str, sync=None, trace: bool = False):
        """Time a stage; `sync` is an optional array/pytree to
        block_until_ready before stopping the clock (without it you time
        dispatch, not execution)."""
        if not self.enabled:
            yield
            return
        ctx = (jax.profiler.trace(self.trace_dir)
               if trace and self.trace_dir else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            box = [None]
            yield box
            if box[0] is not None:
                fence(box[0])
            elif sync is not None:
                fence(sync)
        self.records[name].append(time.perf_counter() - t0)

    def summary(self) -> str:
        lines = [f"{'stage':30s} {'calls':>6s} {'total s':>10s} "
                 f"{'mean ms':>10s} {'last ms':>10s}"]
        for name, ts in sorted(self.records.items()):
            tot = sum(ts)
            lines.append(f"{name:30s} {len(ts):6d} {tot:10.3f} "
                         f"{1e3 * tot / len(ts):10.2f} {1e3 * ts[-1]:10.2f}")
        return "\n".join(lines)

    def reset(self):
        self.records.clear()


profiler = Profiler()
