"""Multi-replica serving (port of ``deeplearning4j_tpu.serving``): the
fleet router over the port's ``GenerationServer`` replicas.

* :class:`ServingFleet` — admission with per-tenant quotas
  (:class:`TenantQuota` / :class:`TenantAccountant`), earliest-deadline-
  first dispatch within priority classes, placement by prefix affinity,
  least load and failover (:mod:`~.placement`), drain / kill / live
  migration, elastic ``add_replica`` / ``remove_replica``, disaggregated
  prefill/decode roles with block handoff (``export_prefix`` ->
  ``import_blocks``), request-scoped trace ids and tail-latency hedging;
* the typed admission errors (:mod:`~.errors`).

An SLO engine and a degradation ladder attach as duck-typed objects
(``attach_slo``, ``attach_degrade``).  The reference's ``autoscale`` and
``degrade`` modules, which need its SLO alert engine, come with a later
slice.

Telemetry rides the process registry under the reference's names:
``fleet_requests_total{tenant=,outcome=}``,
``fleet_replica_dispatch_total{replica=,reason=}``,
``fleet_queue_wait_seconds{tenant=}``, ``fleet_replicas_healthy``,
``fleet_request_phase_seconds{phase=}`` and
``fleet_edf_slack_seconds{tenant=}``.
"""
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
    "FleetAdmissionError", "QuotaExceededError",
    "DeadlineInfeasibleError", "NoHealthyReplicaError",
    "AdmissionRejectedError",
    "choose_replica", "replica_view",
    "AFFINITY", "LEAST_LOADED", "FAILOVER", "PREFILL", "HANDOFF",
    "ROLES", "ROLE_PREFILL", "ROLE_DECODE", "ROLE_UNIFIED",
]
