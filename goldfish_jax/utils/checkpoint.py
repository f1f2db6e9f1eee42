"""Optimization checkpoint / resume.

The reference has NO design-variable restart (SURVEY.md section 5:
output-only pvd snapshots + SNOPT print files). This build makes
checkpointing a first-class subsystem: every optimizer iteration can
atomically persist the design vector, warm-start displacement, iteration
counter and objective history, and an interrupted run resumes exactly.
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

__all__ = ["Checkpointer", "resume_run"]


class Checkpointer:
    def __init__(self, path: str, every: int = 1):
        self.path = path
        self.every = max(int(every), 1)
        self._count = 0

    def save(self, design: dict, state=None, meta: dict | None = None):
        """Atomic snapshot (write-to-temp + rename)."""
        self._count += 1
        if self._count % self.every:
            return
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        payload = {f"design__{k}": np.asarray(v) for k, v in design.items()}
        if state is not None:
            payload["state"] = np.asarray(state)
        payload["meta"] = np.frombuffer(
            json.dumps(meta or {}).encode(), dtype=np.uint8)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path) or ".",
                                   suffix=".npz.tmp")
        os.close(fd)
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **payload)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def load(self):
        """Returns (design dict, state or None, meta dict) or None."""
        if not os.path.exists(self.path):
            return None
        with np.load(self.path, allow_pickle=False) as z:
            design = {k[len("design__"):]: z[k] for k in z.files
                      if k.startswith("design__")}
            state = z["state"] if "state" in z.files else None
            meta = json.loads(bytes(z["meta"]).decode()) if "meta" in z.files \
                else {}
        return design, state, meta

    def attach(self, prob, state_box=None, start_iter=0):
        """Wire into OptProblem.iter_callback (saves each iteration).
        Chains with any callback already installed; `start_iter` keeps
        the persisted iteration counter monotonic across resumes."""
        it = [int(start_iter)]
        prev_cb = prob.iter_callback

        def cb(xdict, J):
            it[0] += 1
            self.save({k: np.asarray(v) for k, v in xdict.items()},
                      state=None if state_box is None else state_box[0],
                      meta={"iter": it[0], "J": float(J)})
            if prev_cb is not None:
                prev_cb(xdict, J)

        prob.iter_callback = cb
        return prob


def resume_run(prob, ckpt: Checkpointer, maxiter=100, state_box=None,
               **run_kwargs):
    """Process-death-safe optimization entry point.

    Invoke instead of `prob.run(...)`: if `ckpt` holds a snapshot from a
    previous (killed/crashed) process, the design variables are restored
    from it, the warm-start state is rehydrated into `state_box` (the
    same mutable box the caller's objective closure threads its
    displacement warm start through), and only the REMAINING iterations
    run. Every accepted optimizer iteration re-snapshots atomically, so
    the run can be killed and re-invoked any number of times and always
    continues from the last accepted iterate. Complements
    utils/retry.py: retry handles transient in-process device failures,
    this handles the process dying outright.

    The reference has no counterpart (output-only pvd snapshots,
    SURVEY.md section 5); multi-hour pegasus-class runs need one.

    Returns (result, done_iters_from_previous_processes).
    """
    if state_box is None:
        # the driver's own threaded-state box (OptProblem.set_objective)
        state_box = getattr(prob, "state_box", None)
    done = 0
    snap = ckpt.load()
    if snap is not None:
        design, state, meta = snap
        for dv in prob._dvs:
            if dv.name in design:
                dv.init = np.asarray(
                    design[dv.name], dtype=np.float64).reshape(
                        dv.init.shape)
        if state is not None and state_box is not None:
            state_box[0] = state
        done = int(meta.get("iter", 0))
    if snap is not None and done >= int(maxiter):
        # Budget already exhausted by previous processes: restore-only.
        # Running "one more iteration" here would let a supervising
        # retry loop overrun maxiter indefinitely on a flaky machine.
        from goldfish_jax.opt.problem import OptResult
        design, _, meta = snap
        # meta['J'] is recorded by the iter_callback convention (both
        # run_slsqp's cb and the pyoptsparse sens hook), which sees the
        # SCALED objective; normal runs descale res.fun by obj_scaler,
        # so the restore-only path must too or an exhausted-budget
        # resume reports fun obj_scaler-times off.
        obj_scaler = float(getattr(prob, "_obj_scaler", 1.0) or 1.0)
        return OptResult(
            x={k: np.asarray(v) for k, v in design.items()},
            fun=float(meta.get("J", np.nan)) / obj_scaler,
            nit=0, success=True,
            message=f"resume: {done} >= maxiter={int(maxiter)} "
                    "iterations already completed", history=[]), done
    ckpt.attach(prob, state_box=state_box, start_iter=done)
    res = prob.run(maxiter=int(maxiter) - done, **run_kwargs)
    return res, done
