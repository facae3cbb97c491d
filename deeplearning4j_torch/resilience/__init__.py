"""Fault tolerance for the serving path (port of
``deeplearning4j_tpu.resilience``): the typed failure vocabulary
(``errors``), the bounded retry helper (``retry``) and the deterministic
fault injector the decode scheduler consults (``faults``).  The
training-side preemption, bad-step policy and fleet coordination come
with a later slice.

Every recovery event lands in the telemetry registry:
``faults_injected_total{kind=}``, ``serve_watchdog_restarts_total``,
``server_healthy``, ``retry_{attempts,backoff_seconds}{op=}``.
"""
from deeplearning4j_torch.resilience.errors import (
    CancelledError, DeadlineExceededError, ElasticWorldError,
    FleetResumeExhausted, InjectedFault, RetryableServerError,
    TrainingPreempted)
from deeplearning4j_torch.resilience.faults import (
    FAULT_KINDS, FaultInjector, FaultSpec)
from deeplearning4j_torch.resilience.retry import backoff_delay, retry_call

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultSpec",
    "InjectedFault", "TrainingPreempted", "RetryableServerError",
    "DeadlineExceededError", "CancelledError",
    "FleetResumeExhausted", "ElasticWorldError",
    "retry_call", "backoff_delay",
]
