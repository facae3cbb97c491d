"""Multi-replica serving (port of ``deeplearning4j_tpu.serving``): the
fleet router over the port's ``GenerationServer`` replicas.

* :class:`ServingFleet` — admission with per-tenant quotas
  (:class:`TenantQuota` / :class:`TenantAccountant`), earliest-deadline-
  first dispatch within priority classes, placement by prefix affinity,
  least load and failover (:mod:`~.placement`), drain / kill / live
  migration, elastic ``add_replica`` / ``remove_replica``, disaggregated
  prefill/decode roles with block handoff (``export_prefix`` ->
  ``import_blocks``), request-scoped trace ids and tail-latency hedging;
* closed-loop autoscaling (:mod:`~.autoscale`): an :class:`Autoscaler`
  evaluates the process or fleet-wide metric view against an
  :class:`AutoscalePolicy` and drives ``add_replica`` /
  ``remove_replica`` with hysteresis and cooldown, deferring and
  shedding batch-class tenants before interactive ones, pre-warming on
  a :class:`BacklogForecaster` projection or a firing SLO alert;
* overload protection: admission-time SLO burn projection (admit /
  degrade / reject with a retry-after, through ``attach_slo``) and the
  reversible degradation ladder (:class:`~.degrade.DegradeLadder`,
  through ``attach_degrade``: shrink budgets, force greedy, shrink the
  draft depth, speculation off, shed batch);
* the typed admission errors (:mod:`~.errors`).

Telemetry rides the process registry under the reference's names:
``fleet_requests_total{tenant=,outcome=}``,
``fleet_replica_dispatch_total{replica=,reason=}``,
``fleet_queue_wait_seconds{tenant=}``, ``fleet_replicas_healthy``,
``fleet_request_phase_seconds{phase=}``,
``fleet_edf_slack_seconds{tenant=}``, ``fleet_degrade_rung`` and the
``fleet_autoscale_*`` action/shed series.
"""
from deeplearning4j_torch.serving.autoscale import (AutoscalePolicy,
                                                    Autoscaler,
                                                    BacklogForecaster,
                                                    fit_trend,
                                                    predict_breach_s)
from deeplearning4j_torch.serving.degrade import RUNGS, DegradeLadder
from deeplearning4j_torch.serving.errors import (AdmissionRejectedError,
                                                 DeadlineInfeasibleError,
                                                 FleetAdmissionError,
                                                 NoHealthyReplicaError,
                                                 QuotaExceededError)
from deeplearning4j_torch.serving.placement import (AFFINITY, FAILOVER,
                                                    HANDOFF, LEAST_LOADED,
                                                    PREFILL, ROLE_DECODE,
                                                    ROLE_PREFILL,
                                                    ROLE_UNIFIED, ROLES,
                                                    choose_replica,
                                                    replica_view)
from deeplearning4j_torch.serving.router import ServingFleet
from deeplearning4j_torch.serving.tenancy import (TenantAccountant,
                                                  TenantQuota)

__all__ = [
    "ServingFleet", "TenantQuota", "TenantAccountant",
    "Autoscaler", "AutoscalePolicy", "BacklogForecaster",
    "fit_trend", "predict_breach_s",
    "DegradeLadder", "RUNGS",
    "FleetAdmissionError", "QuotaExceededError",
    "DeadlineInfeasibleError", "NoHealthyReplicaError",
    "AdmissionRejectedError",
    "choose_replica", "replica_view",
    "AFFINITY", "LEAST_LOADED", "FAILOVER", "PREFILL", "HANDOFF",
    "ROLES", "ROLE_PREFILL", "ROLE_DECODE", "ROLE_UNIFIED",
]
