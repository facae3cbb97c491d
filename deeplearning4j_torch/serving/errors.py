"""Typed admission vocabulary for the serving fleet (copied from
``deeplearning4j_tpu/serving/errors.py``).

The resilience layer's rule (``resilience.errors``) applies one level
up too: a router dispatches on TYPE.  A quota rejection is the
tenant's problem (shed load, bill them, raise their quota), a
deadline-infeasibility rejection is the caller's problem (their SLO
cannot be met — retrying the identical request is pointless), and a
no-healthy-replica failure is the FLEET's problem — transient by
construction (a replica is restarting or being replaced), so it IS
``RetryableServerError`` and rides the existing submit-retry
machinery unchanged.
"""
from __future__ import annotations

from deeplearning4j_torch.resilience.errors import RetryableServerError


class FleetAdmissionError(RuntimeError):
    """Base of the router's admission rejections.  Raised BEFORE any
    replica state is touched — a rejected request burned no KV blocks,
    no slot, and no prefill compute."""


class QuotaExceededError(FleetAdmissionError):
    """The tenant's quota can never cover this request (cost above the
    token-bucket burst) or its queue cap is already full.  Transient
    over-rate traffic does NOT raise — it queues until the bucket
    refills; this error means waiting cannot help."""


class DeadlineInfeasibleError(FleetAdmissionError):
    """The request's ``deadline_s`` cannot be met even if it were
    dispatched immediately (decode-time floor above the budget, or the
    deadline is already in the past) — rejected at admission instead
    of burning blocks on a request that must expire mid-decode."""


class NoHealthyReplicaError(RetryableServerError):
    """Every replica is dead, draining, or unhealthy.  Retryable: a
    fleet in this state is being repaired (watchdog restarts, rolling
    replace), and the request was never applied anywhere."""


class AdmissionRejectedError(FleetAdmissionError):
    """The SLO projection says admitting this tenant's request would
    deepen an error-budget overdraft that is already burning.  Unlike
    ``QuotaExceededError`` this IS worth retrying — but not blindly:
    ``retry_after_s`` is the budget-recovery slope's estimate of when
    capacity returns, and ``submit(retries=)`` honors it as the FLOOR
    of its next backoff instead of hammering the recovering fleet."""

    def __init__(self, tenant: str, retry_after_s: float,
                 projected_burn: float, reason: str = ""):
        self.tenant = str(tenant)
        self.retry_after_s = float(retry_after_s)
        self.projected_burn = float(projected_burn)
        msg = (f"tenant {self.tenant!r} rejected at admission: "
               f"projected burn {self.projected_burn:.3g}x, retry "
               f"after {self.retry_after_s:.3g}s")
        if reason:
            msg += f" ({reason})"
        super().__init__(msg)
