"""Typed failure vocabulary for the fault-tolerance layer (copied from
``deeplearning4j_tpu/resilience/errors.py``).

Recovery code dispatches on TYPE, not message text: a load balancer
retries ``RetryableServerError`` but surfaces ``DeadlineExceededError``
to the caller; a supervisor restarts on ``TrainingPreempted`` but lets
a genuine model bug propagate.  ``InjectedFault`` marks chaos-injected
failures so tests can assert the recovery path fired for the right
reason (and nothing swallows a real error by matching on it).
"""
from __future__ import annotations

from concurrent.futures import CancelledError  # re-export  # noqa: F401


class InjectedFault(RuntimeError):
    """Deterministic chaos fault raised by :class:`FaultInjector`."""

    def __init__(self, kind: str, index: int):
        super().__init__(f"injected fault {kind!r} at index {index}")
        self.kind = kind
        self.index = index


class TrainingPreempted(RuntimeError):
    """Raised by ``run_fit`` after a SIGTERM/SIGINT (or simulated
    preemption) once the forced final checkpoint has landed.  ``step``
    is the orbax step label of that checkpoint (None when no
    checkpointer was attached — state is lost, resume starts over)."""

    def __init__(self, step=None):
        super().__init__(
            f"training preempted (final checkpoint step={step})")
        self.step = step


class FleetResumeExhausted(RuntimeError):
    """``fleet_resume_fit`` burned through ``max_restarts`` without the
    fit completing.  Carries the LAST fleet-agreed checkpoint step and
    the world size the final attempt ran at, so a supervisor one level
    up (cluster manager, on-call tooling) can decide whether to retry
    at a different world or page — instead of parsing an ambiguous
    re-raised ``TrainingPreempted``."""

    def __init__(self, step=None, world=None, last_error=None):
        super().__init__(
            f"fleet resume exhausted its restart budget (last agreed "
            f"checkpoint step={step}, world={world})")
        self.step = step
        self.world = world
        self.last_error = last_error


class ElasticWorldError(RuntimeError):
    """The requested world size cannot carry the configured workload —
    e.g. a shrunk fleet whose GLOBAL batch size does not divide over
    the new data axis (per-rank microbatches can grow, but only in
    whole examples).  Typed so an elastic supervisor distinguishes
    'this world is impossible' from a transient training failure."""


class RetryableServerError(RuntimeError):
    """The server failed this request through no fault of the request:
    the decode scheduler crashed, was recovered by the watchdog, or was
    rebuilding its slot pool.  The request was NOT partially applied to
    any durable state — resubmitting is always safe."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline elapsed before it retired (queue wait +
    decode).  Deliberately NOT retryable: the caller's time budget is
    spent; retrying is the caller's call, not the transport's."""
