"""Per-evaluation stage tracing (env-gated, zero-cost when off).

`GOLDFISH_TRACE_EVAL=1` turns every optimizer evaluation into a
timestamped stderr log of its host-loop stages: solve entry, each
Newton iteration (branch taken, drift, |r|), adjoint pipeline legs,
factorizations, and the OptProblem fun/jac/constraint callables. The
timestamps are taken at READBACK boundaries (dispatch is async; only
readbacks synchronize), so consecutive deltas are real wall
attribution of the host-composed (mixed) solver loops.
"""

from __future__ import annotations

import os
import sys
import time

_T0 = time.perf_counter()

enabled = os.environ.get("GOLDFISH_TRACE_EVAL") == "1"


def trace(tag: str, **kw):
    """One stderr line: [evtrace <t since import> +<dt since last>] tag k=v ..."""
    if not enabled:
        return
    now = time.perf_counter() - _T0
    last = getattr(trace, "_last", now)
    trace._last = now
    parts = " ".join(
        f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}"
        for k, v in kw.items())
    print(f"[evtrace {now:9.3f} +{now - last:7.3f}] {tag} {parts}",
          file=sys.stderr, flush=True)


class span:
    """Context manager: trace `tag.start` / `tag.end dt=...`."""

    def __init__(self, tag, **kw):
        self.tag = tag
        self.kw = kw

    def __enter__(self):
        if enabled:
            self.t0 = time.perf_counter()
            trace(self.tag + ".start", **self.kw)
        return self

    def __exit__(self, *exc):
        if enabled:
            trace(self.tag + ".end", dt=time.perf_counter() - self.t0)
        return False
