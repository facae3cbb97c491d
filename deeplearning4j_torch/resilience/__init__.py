"""Fault tolerance (port of ``deeplearning4j_tpu.resilience``): the typed
failure vocabulary (``errors``), the deterministic fault injector the
fit loop, the checkpointer and the decode scheduler consult
(``faults``), preemption-safe training and the restart supervisor
(``preemption``: ``PreemptionGuard``, ``auto_resume_fit``), the bad-step
policy (``policy``: skip, LR backoff, rollback) and the bounded retry
helper (``retry``).  Fleet-wide preemption coordination comes with the
training scale-out slice.

Every recovery event lands in the telemetry registry:
``faults_injected_total{kind=}``, ``train_{preemptions,resumes}_total``,
``bad_steps_{skipped,rolled_back}_total``,
``serve_watchdog_restarts_total``, ``server_healthy``,
``retry_{attempts,backoff_seconds}{op=}``.
"""
from deeplearning4j_torch.resilience.errors import (
    CancelledError, DeadlineExceededError, ElasticWorldError,
    FleetResumeExhausted, InjectedFault, RetryableServerError,
    TrainingPreempted)
from deeplearning4j_torch.resilience.faults import (
    FAULT_KINDS, FaultInjector, FaultSpec)
from deeplearning4j_torch.resilience.policy import BadStepPolicy
from deeplearning4j_torch.resilience.preemption import (
    PreemptionGuard, auto_resume_fit, clear_preemption,
    preemption_requested, request_preemption)
from deeplearning4j_torch.resilience.retry import backoff_delay, retry_call

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultSpec",
    "InjectedFault", "TrainingPreempted", "RetryableServerError",
    "DeadlineExceededError", "CancelledError",
    "BadStepPolicy",
    "FleetResumeExhausted", "ElasticWorldError",
    "PreemptionGuard", "auto_resume_fit", "request_preemption",
    "preemption_requested", "clear_preemption",
    "retry_call", "backoff_delay",
]
