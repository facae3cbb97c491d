"""Bounded retry with exponential backoff + full jitter (copied from
``deeplearning4j_tpu/resilience/retry.py``).

One retry helper for every client-side recovery site (serving submits
today; import/export RPCs tomorrow).  Policy follows the standard AWS
analysis: exponential base so a persistent outage backs off fast, FULL
jitter (uniform over [0, cap]) so a thundering herd of callers whose
requests all failed at the same watchdog restart do not re-collide on
the same millisecond.  Retries are bounded — an unbounded retry loop
is an availability bug wearing a resilience costume.
"""
from __future__ import annotations

import random
import time
from typing import Callable, Optional, Tuple, Type

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.resilience.errors import RetryableServerError

_ATTEMPTS = telemetry.histogram(
    "retry_attempts",
    "attempts consumed per retry_call invocation (1 = first try won)",
    labelnames=("op",), buckets=(1., 2., 3., 4., 6., 8., 16.))
_BACKOFF = telemetry.histogram(
    "retry_backoff_seconds", "per-retry backoff sleeps, post-jitter",
    labelnames=("op",),
    buckets=(.001, .005, .02, .1, .5, 2., 10.))


def backoff_delay(attempt: int, base_delay: float, max_delay: float,
                  rng: Optional[random.Random] = None) -> float:
    """Full-jitter exponential backoff: uniform over
    ``[0, min(max_delay, base_delay * 2**attempt)]``."""
    cap = min(max_delay, base_delay * (2.0 ** attempt))
    return (rng.uniform if rng is not None else random.uniform)(0.0, cap)


def retry_call(fn: Callable, retries: int = 3, base_delay: float = 0.05,
               max_delay: float = 2.0,
               retry_on: Tuple[Type[BaseException], ...] =
               (RetryableServerError,),
               op: str = "call", seed: Optional[int] = None,
               delay_floor: Optional[Callable[[BaseException], float]]
               = None):
    """Call ``fn()``; on an exception in ``retry_on`` sleep a jittered
    exponential backoff and retry, up to ``retries`` retries (so at
    most ``retries + 1`` attempts).  Any other exception, and the last
    ``retry_on`` failure, propagate.  ``seed`` pins the jitter for
    reproducible tests.

    ``delay_floor`` maps the caught exception to a MINIMUM for the
    next sleep — the server-advised retry-after contract
    (``AdmissionRejectedError.retry_after_s``): jitter still spreads
    callers out above the floor, but nobody re-knocks before the
    server said capacity could be back."""
    rng = random.Random(seed) if seed is not None else None
    attempt = 0
    while True:
        try:
            result = fn()
            _ATTEMPTS.labels(op=op).observe(attempt + 1)
            return result
        except retry_on as e:
            if attempt >= retries:
                _ATTEMPTS.labels(op=op).observe(attempt + 1)
                raise
            delay = backoff_delay(attempt, base_delay, max_delay, rng)
            if delay_floor is not None:
                try:
                    delay = max(delay, float(delay_floor(e) or 0.0))
                except Exception:
                    pass             # an advisory floor never breaks
                                     # the retry loop itself
            _BACKOFF.labels(op=op).observe(delay)
            time.sleep(delay)
            attempt += 1
