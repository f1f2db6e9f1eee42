"""Transient-failure retry for device dispatches.

A device runtime can fail a call transiently (an UNAVAILABLE status, a
deadline, a dropped connection to a remote worker); a rerun succeeds.
Optimization drivers wrap their objective/constraint evaluations with
`retry_transient` so a multi-hour run survives such a failure instead of
dying at SLSQP iteration 40. Only KNOWN-transient error texts are
retried — anything else propagates immediately (masking real failures
would be worse than dying).

Reference role: the reference has no failure recovery at all; this
module plus utils/checkpoint.py is this build's failure-detection/
recovery subsystem.
"""

from __future__ import annotations

import functools
import time
import warnings

__all__ = ["TRANSIENT_MARKERS", "retry_transient"]

# lowercase substrings of error texts known to be transient
TRANSIENT_MARKERS = (
    "unavailable",
    "deadline exceeded",
    "socket closed",
)


def is_transient(exc: BaseException) -> bool:
    msg = str(exc).lower()
    return any(m in msg for m in TRANSIENT_MARKERS)


def retry_transient(fn=None, *, retries: int = 2, base_sleep: float = 5.0,
                    sleep=time.sleep):
    """Decorator/wrapper: re-invoke `fn` after a known-transient device
    failure (exponential backoff), at most `retries` times. Non-
    transient exceptions and the final failed attempt propagate.

    `fn` must be safe to re-run (pure jitted evaluations are; the
    OptProblem objective/constraint closures only commit state on
    success)."""
    if fn is None:
        return lambda f: retry_transient(f, retries=retries,
                                         base_sleep=base_sleep,
                                         sleep=sleep)

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        for attempt in range(retries + 1):
            try:
                return fn(*args, **kwargs)
            except Exception as e:  # noqa: BLE001 — filtered below
                if attempt >= retries or not is_transient(e):
                    raise
                warnings.warn(
                    f"transient device failure "
                    f"(attempt {attempt + 1}/{retries + 1}), "
                    f"retrying: {str(e)[:200]}", stacklevel=2)
                sleep(base_sleep * 2**attempt)
        raise AssertionError("unreachable")

    return wrapped
