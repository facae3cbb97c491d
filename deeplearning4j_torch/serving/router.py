"""ServingFleet: an admission router over N decode-server replicas (port
of ``deeplearning4j_tpu/serving/router.py``, over the port's
``GenerationServer``).

``GenerationServer`` is a single-replica continuous-batching decode
server (paged KV, shared-prefix reuse, self-healing).  This module is the
thin scheduling/placement frontend that turns N of those into a
SERVING SYSTEM — the TensorFlow-paper split of a small stateful
scheduler over homogeneous compute workers, applied one level up from
the slot scheduler inside each ``GenerationServer``:

* **admission** — every ``submit(tenant=...)`` passes the per-tenant
  token buckets + concurrency/queue caps in
  :class:`~.tenancy.TenantAccountant` before it can touch a replica.
  A hot tenant saturating its bucket WAITS; a structurally-
  unadmittable request (cost above burst, queue cap hit) fails fast
  with :class:`~.errors.QuotaExceededError`; and because the dispatch
  pass walks ALL waiting requests each pass (not FIFO across
  tenants), a capped hot tenant cannot delay a cold tenant's
  admission beyond one scheduling pass;
* **SLO-aware dispatch** — waiting requests dispatch in
  (priority, earliest deadline, arrival) order — EDF within a
  priority class, reusing the per-request ``deadline_s`` plumbing
  end to end (the remaining budget rides into the replica, which
  enforces expiry mid-decode).  Requests whose deadline cannot be met
  even dispatched immediately (``est_token_s * n_new`` above the
  budget, or a non-positive budget) are rejected at submit with
  :class:`~.errors.DeadlineInfeasibleError` — no KV blocks burned on
  a request that must expire;
* **placement** — prefix-affinity first (route same-prefix requests
  to the replica whose cache is warm, via the bytes-verified
  ``prefix_warmth`` probe the chain hashes enable), least-loaded
  by free KV blocks otherwise (:mod:`~.placement`); unhealthy and
  draining replicas are never candidates (health-weighted dispatch
  off the same liveness the ``server_healthy`` gauge exposes);
* **lifecycle** — :meth:`ServingFleet.drain` rolls a replica out
  (admission stops, in-flight finishes; ``hard=True`` also migrates
  its work), :meth:`ServingFleet.kill` is the chaos-drill
  SIGKILL-equivalent, and LIVE MIGRATION closes ROADMAP item 4's
  remainder: when a replica dies or is drained hard, its queued AND
  in-flight requests re-place onto surviving replicas through the
  existing retry machinery (typed retryable errors +
  ``resilience.retry.backoff_delay`` jitter, bounded by
  ``migration_retries``) and complete byte-identical to offline
  ``generate()`` — greedy decode is deterministic, so a from-scratch
  re-decode on the survivor IS the same bytes;
* **elastic scale** — :meth:`ServingFleet.add_replica`
  joins one more replica built from the founding config (it becomes a
  dispatch candidate only after its first successful ``stats()``) and
  :meth:`ServingFleet.remove_replica` scales in through the same
  drain→migrate machinery — the serving mirror of the training
  layer's N→M elastic resume;
* **disaggregated prefill/decode** — ``roles`` assigns
  each replica ``"prefill"``/``"decode"``/``"unified"`` (default
  unified: existing fleets untouched).  Chunked prefill is
  compute-bound and decode memory-bound, and in a unified replica one
  long admission stalls every decoding stream behind its prefill.
  With roles split, the router classifies at admission (it already
  costs prompt+budget tokens): prompts >= ``prefill_threshold``
  tokens stage through a prefill replica
  (``GenerationServer.prefill_async`` — admit + chunked prefill +
  prefix-cache registration, no decode ticks), then the finished
  prefix hands off to a decode replica as a BLOCK TRANSFER through
  the table abstraction: ``export_prefix`` serializes the blocks
  (chain hashes + raw token bytes + K/V bytes), ``import_blocks``
  lands them on the target, and the decode admission restores them
  with one batched H2D and registers them device-resident — every
  later same-prefix admission maps them copy-free.  Greedy byte
  parity holds end to end (the restored bytes ARE the prefill
  replica's, and both replicas run identical prefill numerics), and a
  prefill replica dying mid-handoff re-places the request through the
  EXISTING migration machinery — reclassified against the surviving
  topology, completing byte-identical either way.

The fleet is in-process: replicas share the host, but a replica no
longer maps to at most one chip — ``devices=`` hands each replica its
own (disjoint) device slice and the server lays its tick over a
``data``/``tp`` mesh (``parallel/mesh.py``), so ONE fleet
mixes single-chip and multi-chip replicas.  The router stays
placement-policy-only: a replica's span is invisible to admission,
affinity and migration (a tp=2 victim's requests re-place
byte-identically onto a single-chip survivor), and the per-replica
``fleet_replica_devices{replica=}`` gauge is the only router-side
trace of the topology.

Telemetry: ``fleet_requests_total{tenant=,outcome=}`` (admitted /
queued / rejected_quota / rejected_deadline / migrated — plus
terminal cancelled / expired / failed), ``fleet_replica_dispatch_
total{replica=,reason=}`` (affinity / least_loaded / failover),
``fleet_queue_wait_seconds{tenant=}``, ``fleet_replicas_healthy`` and
``fleet_queue_depth``.

Request-scoped TRACING: ``submit`` mints a trace id that
flows admission -> placement -> replica queue -> prefill -> decode ->
retire; every phase records a tracked span tagged ``trace=<id>``
(``telemetry.get_tracer().events_for_trace(id)`` is one request's
cross-component tree) and the same instrumentation observes
``fleet_request_phase_seconds{phase=}`` — TTFT decomposed into its
phases — plus ``fleet_edf_slack_seconds{tenant=}`` at dispatch, the
autoscaler's pressure signal.  ``demote_waiting`` is the autoscaler's
shed/defer actuator for batch-class tenants.
"""
from __future__ import annotations

import itertools
import logging
import os
import queue
import threading
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.parallel.generation_server import GenerationServer
from deeplearning4j_torch.resilience.errors import (CancelledError,
                                                  DeadlineExceededError,
                                                  RetryableServerError)
from deeplearning4j_torch.resilience.retry import backoff_delay, retry_call
from deeplearning4j_torch.serving.errors import (AdmissionRejectedError,
                                               DeadlineInfeasibleError,
                                               NoHealthyReplicaError,
                                               QuotaExceededError)
from deeplearning4j_torch.serving.placement import (FAILOVER, HANDOFF,
                                                  PREFILL, ROLE_PREFILL,
                                                  ROLE_UNIFIED, ROLES,
                                                  choose_replica)
from deeplearning4j_torch.serving.tenancy import TenantAccountant, TenantQuota

log = logging.getLogger("deeplearning4j_torch")

_INF = float("inf")

_REQS = telemetry.counter(
    "fleet_requests_total",
    "fleet admission outcomes per tenant: admitted (first dispatch "
    "to a replica — a disagg request's prefill placement), queued "
    "(waited >= 1 pass on quota/capacity), rejected_quota, "
    "rejected_deadline (infeasible SLO), rejected_slo (admission-"
    "time burn projection / rung-4 shed), migrated (re-placed off a "
    "dead/drained replica), handed_off (a disagg request's decode "
    "placement carrying its exported prefix), cancelled, expired, "
    "failed", labelnames=("tenant", "outcome"))
_DISPATCH = telemetry.counter(
    "fleet_replica_dispatch_total",
    "requests dispatched per replica by placement reason: affinity "
    "(prefix-cache warm), least_loaded (most free KV blocks), "
    "failover (migration off a dead/drained replica)",
    labelnames=("replica", "reason"))
_QWAIT = telemetry.histogram(
    "fleet_queue_wait_seconds",
    "submit -> first dispatch per request, by tenant (the admission "
    "delay quotas and capacity impose — the fairness signal)",
    labelnames=("tenant",))
_REPL_HEALTHY = telemetry.gauge(
    "fleet_replicas_healthy",
    "replicas currently dispatchable (healthy, not dead, not "
    "draining) — a fleet balancer's aggregate health signal")
_REPL_DEVICES = telemetry.gauge(
    "fleet_replica_devices",
    "chips in each replica's device slice: 1 = single-chip "
    "replica, N = a mesh-sharded replica spanning N chips as one tp "
    "group", labelnames=("replica",))
_FLEET_QDEPTH = telemetry.gauge(
    "fleet_queue_depth",
    "requests waiting in the fleet router (intake + quota/capacity "
    "wait line; per-replica queues are counted by the replicas)")
# Request-phase decomposition: the SAME instrumentation
# that records each request's trace spans observes this family, so
# TTFT stops being one opaque number — admission wait, placement,
# replica queue, prefill and decode each carry their own series.
_PHASE = telemetry.histogram(
    "fleet_request_phase_seconds",
    "per-request phase wall times (the trace spans' durations): "
    "admission (submit -> first dispatch), placement (candidate "
    "ranking + replica handoff), total (submit -> retire); the "
    "replica-side queue/prefill/decode phases come from the decode "
    "server's half of the same family", labelnames=("phase",))
_EDF_SLACK = telemetry.histogram(
    "fleet_edf_slack_seconds",
    "remaining deadline budget at dispatch, per tenant — the EDF "
    "slack whose low percentiles collapsing toward 0 are the "
    "autoscaler's scale-up pressure", labelnames=("tenant",))
_SLO_DEFER = telemetry.counter(
    "fleet_slo_budget_deferrals_total",
    "waiting requests demoted behind within-budget tenants because "
    "their tenant's SLO error budget is exhausted ("
    "budget-exhausted batch work defers BEFORE any interactive "
    "tenant is shed)", labelnames=("tenant",))
# Production front door: admission-time SLO projection and
# degradation-ladder shaping, counted per tenant BEFORE any reserve —
# a rejected request costs the pool nothing, and the three outcomes
# partition every submit_async that reached the front door.
_ADMIT_OK = telemetry.counter(
    "fleet_admission_admitted_total",
    "requests admitted untouched by the SLO projection and the "
    "degradation ladder", labelnames=("tenant",))
_ADMIT_DEG = telemetry.counter(
    "fleet_admission_degraded_total",
    "requests admitted DEGRADED (n_new capped and/or forced greedy) "
    "by the SLO projection or the active degradation rung",
    labelnames=("tenant",))
_ADMIT_REJ = telemetry.counter(
    "fleet_admission_rejected_total",
    "requests rejected at admission with AdmissionRejectedError "
    "(projected budget overdraft, or rung 4 shedding the batch "
    "class) — zero replica cost, retry_after_s attached",
    labelnames=("tenant",))
# Tail-latency hedging: near-deadline interactive requests
# duplicate onto a second warm replica; first completion wins.
_HEDGE_LAUNCH = telemetry.counter(
    "fleet_hedges_launched_total",
    "hedge placements launched (a near-deadline request duplicated "
    "byte-identically onto a second warm replica, raced first-wins)")
_HEDGE_WON = telemetry.counter(
    "fleet_hedges_won_total",
    "hedge races the HEDGE placement won (the primary was cancelled "
    "and the hedge's bytes delivered)")
_HEDGE_CANCEL = telemetry.counter(
    "fleet_hedges_cancelled_total",
    "hedge races resolved by cancelling the loser — exactly one per "
    "resolved race, whichever side lost")

#: the per-host flight recorder: placement decisions,
#: migrations, handoffs and chaos kills land in the black-box ring a
#: postmortem bundle freezes
_FLIGHT = telemetry.get_flight_recorder()

#: intake sentinel that wakes the scheduler without meaning "stop"
_WAKE = object()

#: process-unique request trace ids (the pid makes them fleet-unique
#: across workers beaconing into one shared trace store)
_TRACE_SEQ = itertools.count()


def _mint_trace_id() -> str:
    return f"req-{os.getpid():x}-{next(_TRACE_SEQ):x}"


class _FleetRequest:
    """One request riding through the fleet.  ``result()`` blocks the
    caller; the fleet scheduler fills ``_result``/``_error``.  The
    handle survives migration: ``inner``/``replica`` point at the
    CURRENT placement and are rewritten when the request re-places off
    a dead replica."""

    __slots__ = ("prompt", "n_new", "eos_id", "seed", "sampling",
                 "tenant", "priority", "cost", "deadline", "t_submit",
                 "t_submit_m", "cancelled", "migrations", "replica",
                 "inner", "ttft", "trace_id", "spans", "stage",
                 "handoff", "prefill_replica", "hedge_inner",
                 "hedge_replica", "_t_hedge", "_t_dispatch",
                 "_not_before", "_migrate", "_quota_held",
                 "_queued_counted", "_migrating", "_budget_deferred",
                 "_result", "_error", "_event")

    def __init__(self, prompt, n_new, eos_id, seed, sampling, tenant,
                 priority, cost, deadline):
        self.trace_id = _mint_trace_id()
        self.spans = {}               # phase -> open telemetry.Span
        self.prompt = prompt
        self.n_new = n_new
        self.eos_id = eos_id
        self.seed = seed
        self.sampling = sampling
        self.tenant = tenant
        self.priority = priority
        self.cost = cost
        self.deadline = deadline      # absolute time.monotonic() or None
        self.t_submit = time.perf_counter()
        self.t_submit_m = time.monotonic()
        self.cancelled = False
        self.migrations = 0
        self.replica: Optional[int] = None
        self.inner = None             # the replica-side handle
        # disaggregated serving: ``stage`` is the NEXT
        # placement's kind — None (unclassified), "prefill" (route to
        # a prefill-role replica) or "decode"; ``handoff`` carries the
        # exported prefix payload between the stages (kept until the
        # request finishes, so a decode-replica death re-imports on
        # the survivor instead of re-prefilling)
        self.stage: Optional[str] = None
        self.handoff = None
        self.prefill_replica: Optional[int] = None
        # tail-latency hedge: a SECOND byte-identical
        # placement racing the primary; first completion wins and the
        # loser is cancelled through its replica-side handle
        self.hedge_inner = None
        self.hedge_replica: Optional[int] = None
        self._t_hedge = None          # hedge launch wall time (the
                                      # winner's ttft base when the
                                      # hedge wins)
        self.ttft = None              # submit -> first token of the
                                      # SUCCESSFUL attempt (queue wait
                                      # + any migration included)
        self._t_dispatch = None
        self._not_before = 0.0        # migration backoff gate
        self._migrate = False         # replica died / hard-drained
        self._quota_held = False      # bucket charged + concurrency
                                      # slot taken (kept across
                                      # migrations — one request, one
                                      # charge)
        self._queued_counted = False
        self._migrating = False       # next dispatch is a failover
        self._budget_deferred = False  # counted once per request when
                                       # its tenant's exhausted error
                                       # budget demotes it in line
        self._result = None
        self._error = None
        self._event = threading.Event()

    @property
    def emitted(self) -> int:
        """Tokens emitted by the CURRENT placement (0 while waiting)."""
        inner = self.inner
        return inner.emitted if inner is not None else 0

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request retires fleet-side; returns the
        full sequence (prompt + generated).  A ``TimeoutError`` leaves
        the request LIVE — ``cancel()`` releases it."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"fleet result not ready within {timeout}s (the "
                "request is still live; cancel() releases it)")
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> bool:
        """Best-effort cancellation (queue entry or in-flight slot is
        released at the next scheduling pass).  False when already
        completed."""
        if self._event.is_set():
            return False
        self.cancelled = True
        inner = self.inner
        if inner is not None:
            inner.cancel()
        hedge = self.hedge_inner
        if hedge is not None:
            hedge.cancel()
        return True


class ServingFleet:
    """Admission router + lifecycle manager over ``n_replicas``
    in-process :class:`GenerationServer` replicas.

    >>> fleet = ServingFleet(net, n_replicas=2, n_slots=8,
    ...                      quotas={"free": TenantQuota(
    ...                          tokens_per_s=500, max_concurrent=2)})
    >>> out = fleet.submit(ids, n_new=64, tenant="free")  # blocking
    >>> h = fleet.submit_async(ids, n_new=64, deadline_s=2.0,
    ...                        priority=1)
    >>> out = h.result(); h.replica; h.migrations
    >>> fleet.drain(0); fleet.stats(); fleet.shutdown(drain=True)

    ``quotas`` maps tenant name -> :class:`TenantQuota`
    (``default_quota`` covers everyone else; the no-argument default
    is unlimited).  ``est_token_s`` is the per-token decode-time floor
    the deadline-feasibility screen uses (None disables the screen
    beyond "deadline already spent").  ``migration_retries`` bounds
    how many times one request may re-place off dying replicas before
    its last failure propagates; re-placements back off with the
    resilience layer's full-jitter ``backoff_delay``.

    ``roles`` disaggregates the fleet: one
    ``"prefill"``/``"decode"``/``"unified"`` entry per replica
    (default all unified).  Prompts of at least ``prefill_threshold``
    tokens (default: two full KV blocks + 1) stage through a prefill
    replica and hand their finished prefix blocks off to a decode
    replica — byte-identical to a unified decode, with the long
    prefill off the decode replicas' tick path.  Pass
    ``host_tier_blocks`` (a server kwarg) to also spill evicted
    prefix blocks to host RAM on every replica.

    ``devices`` gives each replica its own DEVICE SLICE —
    one entry per replica, ``None`` (default placement) or an
    explicit device list the replica mesh-shards across as one tp
    group (``GenerationServer(devices=...)``) — so one fleet mixes
    single-chip and multi-chip replicas.  Slices must be disjoint.
    The router itself stays placement-policy-only: affinity /
    least-loaded / failover ranking never looks at what a replica
    spans.

    The production front door: ``slo_engine`` +
    ``admission_control=True`` projects the tenant's SLO burn at
    ``submit`` — reject (typed
    :class:`~.errors.AdmissionRejectedError` with a server-advised
    ``retry_after_s``; ``submit(retries=)`` floors its backoff there)
    or degrade BEFORE any quota token or KV block is spent; an
    attached :class:`~.degrade.DegradeLadder`
    (:meth:`attach_degrade`) shapes admissions whenever its rung is
    elevated, flag or no flag.  ``hedge_slack_s`` arms tail-latency
    hedging: a decoding request whose deadline slack dips under it
    duplicates onto a second warm replica, first completion wins and
    the loser is cancelled, with ``hedge_budget`` bounding hedges to
    a fraction of admissions.  Remaining
    ``**server_kwargs`` construct the replicas (``speculative`` —
    draft-verified multi-token decode, whose per-replica acceptance
    rate surfaces through ``stats()`` — plus ``n_slots``,
    ``block_size``, ``tick_batch``, ...)."""

    def __init__(self, net, n_replicas: int = 2,
                 quotas: Optional[Dict[str, TenantQuota]] = None,
                 default_quota: Optional[TenantQuota] = None,
                 est_token_s: Optional[float] = None,
                 migration_retries: int = 3,
                 retry_backoff_s: float = 0.02,
                 poll_interval_s: float = 0.002,
                 dead_after_s: float = 1.0,
                 queue_limit: int = 4096,
                 roles: Optional[Iterable[str]] = None,
                 devices: Optional[Iterable] = None,
                 prefill_threshold: Optional[int] = None,
                 slo_engine=None,
                 admission_control: bool = False,
                 hedge_slack_s: Optional[float] = None,
                 hedge_budget: float = 0.25,
                 **server_kwargs):
        self.n_replicas = int(n_replicas)
        if self.n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        # per-replica roles (disaggregated prefill/decode) —
        # validated BEFORE any replica is constructed, so a bad config
        # leaks no scheduler threads
        if roles is None:
            role_list = [ROLE_UNIFIED] * self.n_replicas
        else:
            role_list = [str(r) for r in roles]
            if len(role_list) != self.n_replicas:
                raise ValueError(
                    f"roles has {len(role_list)} entries for "
                    f"n_replicas={self.n_replicas}")
            bad = [r for r in role_list if r not in ROLES]
            if bad:
                raise ValueError(f"unknown role(s) {bad}; each role "
                                 f"must be one of {ROLES}")
            if (ROLE_PREFILL in role_list
                    and all(r == ROLE_PREFILL for r in role_list)):
                raise ValueError(
                    "a prefill-only fleet cannot decode — at least "
                    "one replica needs role 'decode' or 'unified'")
        self._roles: List[str] = role_list
        # per-replica device slices (mesh-sharded serving):
        # one entry per replica — None (the process default device) or
        # an explicit device list the replica mesh-shards across.  The
        # router stays PLACEMENT-POLICY-ONLY: nothing downstream cares
        # what a replica spans — slices only size the replicas and the
        # fleet_replica_devices gauge.  Validated like roles, before
        # any replica is constructed; overlapping slices double-book a
        # chip's HBM and are refused.
        if devices is None:
            dev_list = [None] * self.n_replicas
        else:
            dev_list = [None if d is None else list(d) for d in devices]
            if len(dev_list) != self.n_replicas:
                raise ValueError(
                    f"devices has {len(dev_list)} slices for "
                    f"n_replicas={self.n_replicas}")
            seen = {}
            for i, slc in enumerate(dev_list):
                for d in (slc or ()):
                    # a torch device by (type, index); a slice may list
                    # one device twice (one card driven as two tp
                    # shards), two replicas may not share one
                    key = ((d.type, d.index or 0)
                           if isinstance(d, torch.device) else
                           (getattr(d, "platform", "?"),
                            getattr(d, "id", id(d))))
                    if seen.get(key, i) != i:
                        raise ValueError(
                            f"device {key[0]}:{key[1]} appears in "
                            f"replica {seen[key]}'s and replica "
                            f"{i}'s slices — slices must be disjoint")
                    seen[key] = i
        self._devices: List = dev_list
        self.est_token_s = (float(est_token_s)
                            if est_token_s is not None else None)
        self.migration_retries = int(migration_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self.poll_interval_s = float(poll_interval_s)
        self.dead_after_s = float(dead_after_s)
        # kept for elastic scale-out: add_replica() constructs
        # newcomers from the SAME net + config the founders got
        self._net = net
        self._server_kwargs = dict(server_kwargs)
        self._servers = [
            GenerationServer(net, **(dict(server_kwargs, devices=dev)
                                     if dev is not None
                                     else server_kwargs))
            for dev in dev_list]
        for i, dev in enumerate(dev_list):
            _REPL_DEVICES.labels(replica=str(i)).set(
                len(dev) if dev is not None else 1)
        # disagg classification bar: prompts at least this long (>= 2
        # full KV blocks by default) route through a prefill replica
        # when one is live; shorter prompts always go direct — their
        # prefill is too cheap to be worth a handoff round trip
        self.prefill_threshold = (
            int(prefill_threshold) if prefill_threshold is not None
            else 2 * self._servers[0].block_size + 1)
        self._acct = TenantAccountant(default_quota, quotas)
        # SLO error-budget engine: when attached (here or
        # via attach_slo), each dispatch pass reads its exhausted-
        # tenant set and demotes those tenants' waiting work WITHIN
        # its priority class — budget-exhausted batch traffic defers
        # before any interactive tenant would be shed
        self._slo = slo_engine
        # production front door.  admission_control=True
        # makes every submit consult the engine's SLO projection
        # BEFORE any reserve (admit / degrade / reject with retry-
        # after) — opt-in, because an attached engine alone must not
        # start reshaping fleets that only wanted dispatch-order
        # deferral.  The degradation ladder attaches via
        # attach_degrade and shapes admission whenever its rung > 0.
        self.admission_control = bool(admission_control)
        self._degrade = None
        # tail-latency hedging: a deadline-carrying interactive
        # request whose remaining budget falls under hedge_slack_s
        # duplicates onto a second warm replica (byte-identical
        # re-place, raced first-wins).  None disables.  hedge_budget
        # bounds concurrent hedges to a fraction of the flight — the
        # defense must not amplify the overload it defends against.
        self.hedge_slack_s = (None if hedge_slack_s is None
                              else float(hedge_slack_s))
        if self.hedge_slack_s is not None and self.hedge_slack_s <= 0:
            raise ValueError("hedge_slack_s must be > 0 (or None to "
                             "disable hedging)")
        self.hedge_budget = float(hedge_budget)
        if not 0.0 <= self.hedge_budget <= 1.0:
            raise ValueError("hedge_budget must be in [0, 1]")
        # fleet scheduler state: everything below mutates ONLY under
        # _lock (the GenerationServer discipline, one level up)
        self._lock = threading.RLock()
        self._intake: "queue.Queue" = queue.Queue(maxsize=int(queue_limit))
        self._waiting: List[_FleetRequest] = []
        self._inflight: List[_FleetRequest] = []
        self._dead = set()
        self._draining = set()
        self._joining = set()     # added replicas not yet dispatchable
        self._removed = set()     # scaled-in replicas (never candidates)
        self._unhealthy_since: Dict[int, float] = {}
        self._shutdown = False
        self._drain_mode = False
        _REPL_HEALTHY.set(self.n_replicas)
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- public API ----------------------------------------------------
    def submit_async(self, prompt_ids, n_new: int, tenant: str = "default",
                     eos_id: Optional[int] = None, seed: int = 0,
                     priority: int = 0,
                     deadline_s: Optional[float] = None,
                     sampling: Optional[dict] = None,
                     trace_id: Optional[str] = None) -> _FleetRequest:
        """Enqueue one request under ``tenant``'s quota; returns a
        handle whose ``result()`` blocks.  ``priority`` orders
        dispatch (lower = sooner); within a priority class requests
        dispatch earliest-deadline-first.  ``deadline_s`` bounds total
        residence (fleet queue wait included) and is feasibility-
        screened HERE — an unmeetable deadline raises
        :class:`DeadlineInfeasibleError` before any replica state is
        touched.  Structurally-unadmittable quota violations raise
        :class:`QuotaExceededError` the same way.

        ``trace_id`` CONTINUES an existing trace instead of minting
        one — the cross-host handoff path: a request
        migrating in from another host's fleet keeps its origin trace
        id, its local root span is named ``request/handoff``, and the
        aggregator's ``FleetTraceStore`` stitches this host's
        fragment under the origin host's submit->retire root."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("ServingFleet has been shut down")
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt_ids must be a non-empty 1-D int "
                             f"array, got shape {prompt.shape}")
        n_new = int(n_new)
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        max_len = self._servers[0].max_len
        if len(prompt) + n_new > max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + n_new ({n_new}) exceeds the "
                f"replica cache length ({max_len})")
        tenant = str(tenant)
        # production front door: the SLO projection and
        # the degradation ladder run BEFORE the reserve, the cost
        # computation and the feasibility screen — a reject burns no
        # quota, no blocks, no prefill, and the shaped (capped /
        # greedy) request is what everything downstream costs.
        with self._lock:
            slo = self._slo if self.admission_control else None
            ladder = self._degrade
        degraded = False
        if slo is not None and hasattr(slo, "admission_decision"):
            verdict = slo.admission_decision(tenant)
            if verdict["decision"] == "reject":
                _ADMIT_REJ.labels(tenant=tenant).inc()
                _REQS.labels(tenant=tenant,
                             outcome="rejected_slo").inc()
                raise AdmissionRejectedError(
                    tenant, verdict["retry_after_s"],
                    verdict["projected_burn"],
                    reason=f"SLO {verdict['slo']} projects the "
                           "budget overdraft deepening")
            if verdict["decision"] == "degrade":
                capped = max(1, n_new // 2)
                degraded = degraded or capped < n_new
                n_new = capped
        if ladder is not None:
            n_new, sampling, shape = ladder.shape_admission(
                tenant, n_new, sampling)
            if shape == "reject":
                _ADMIT_REJ.labels(tenant=tenant).inc()
                _REQS.labels(tenant=tenant,
                             outcome="rejected_slo").inc()
                raise AdmissionRejectedError(
                    tenant, ladder.shed_retry_after_s,
                    ladder.state()["burn"],
                    reason=f"degradation rung {ladder.rung()} sheds "
                           "the batch class")
            degraded = degraded or shape == "degraded"
        if ladder is not None or slo is not None:
            (_ADMIT_DEG if degraded else _ADMIT_OK).labels(
                tenant=tenant).inc()
        cost = float(len(prompt) + n_new)
        if deadline_s is not None:
            deadline_s = float(deadline_s)
            floor = (self.est_token_s or 0.0) * n_new
            if deadline_s <= 0 or floor > deadline_s:
                _REQS.labels(tenant=tenant,
                             outcome="rejected_deadline").inc()
                raise DeadlineInfeasibleError(
                    f"deadline_s={deadline_s:g} cannot be met: the "
                    f"decode-time floor for n_new={n_new} is "
                    f"{floor:g}s (est_token_s="
                    f"{self.est_token_s}) — rejected before burning "
                    "blocks")
        reason = self._acct.reserve_queued(tenant, cost)
        if reason is not None:
            _REQS.labels(tenant=tenant, outcome="rejected_quota").inc()
            raise QuotaExceededError(reason)
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = _FleetRequest(prompt, n_new,
                            None if eos_id is None else int(eos_id),
                            int(seed), sampling, tenant, int(priority),
                            cost, deadline)
        # the request's trace is born HERE: a root span covering the
        # whole fleet residence plus the admission phase, both tagged
        # with the minted trace id every later component (placement,
        # replica queue/prefill/decode) stamps its own spans with —
        # one submit -> retire tree per request in the trace viewer.
        # A handed-off request keeps its ORIGIN id and roots its local
        # fragment at request/handoff, so the fleet trace store sees
        # one tree, not two roots.
        tracer = telemetry.get_tracer()
        if trace_id is not None:
            req.trace_id = str(trace_id)
        req.spans["request"] = tracer.begin(
            "request" if trace_id is None else "request/handoff",
            trace=req.trace_id, tenant=tenant,
            n_new=n_new, priority=int(priority))
        req.spans["admission"] = tracer.begin(
            "request/admission", trace=req.trace_id, tenant=tenant)
        while True:
            try:
                self._intake.put(req, timeout=0.1)
                break
            except queue.Full:
                with self._lock:
                    down = self._shutdown
                if down:
                    self._acct.drop_queued(tenant)
                    for sp in (req.spans.pop(p, None)
                               for p in ("admission", "request")):
                        if sp is not None:
                            sp.end(outcome="rejected")
                    raise RuntimeError(
                        "ServingFleet has been shut down") from None
        with self._lock:
            dead = self._shutdown and not self._worker.is_alive()
        if dead:
            # raced shutdown(): the put may have landed after the
            # scheduler's final drain — fail leftovers ourselves
            self._fail_leftovers()
        return req

    def submit(self, prompt_ids, n_new: int, tenant: str = "default",
               eos_id: Optional[int] = None, seed: int = 0,
               priority: int = 0, timeout: Optional[float] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[dict] = None,
               retries: int = 0) -> np.ndarray:
        """Blocking ``submit_async().result()``.  ``retries``
        re-submits after a ``RetryableServerError`` (e.g. the whole
        fleet was momentarily unhealthy) or an
        ``AdmissionRejectedError`` through the existing ``retry_call``
        machinery with full-jitter backoff — an admission rejection's
        ``retry_after_s`` is honored as the FLOOR of the next sleep
        (the server-advised recovery slope outranks blind
        exponential; jitter still spreads callers above it)."""

        def attempt():
            return self.submit_async(
                prompt_ids, n_new, tenant=tenant, eos_id=eos_id,
                seed=seed, priority=priority, deadline_s=deadline_s,
                sampling=sampling).result(timeout)

        if retries <= 0:
            return attempt()
        return retry_call(
            attempt, retries=int(retries),
            base_delay=self.retry_backoff_s,
            retry_on=(RetryableServerError, AdmissionRejectedError),
            delay_floor=lambda e: getattr(e, "retry_after_s", 0.0),
            op="serving_fleet.submit")

    def drain(self, replica: int, hard: bool = False) -> None:
        """Roll ``replica`` out of dispatch: admission to it stops
        (placement never picks a draining replica) and its own
        admission closes (``GenerationServer.drain``).  Default: work
        already on it finishes there.  ``hard=True`` additionally
        MIGRATES its queued and in-flight requests to surviving
        replicas (each completes byte-identical to offline
        ``generate()`` — greedy decode is deterministic, so the
        survivor's from-scratch decode is the same bytes)."""
        idx = self._check_replica(replica)
        with self._lock:
            self._draining.add(idx)
        self._servers[idx].drain()
        if hard:
            self._mark_migrate(idx)
        self._wake()

    def kill(self, replica: int, timeout: float = 10.0) -> None:
        """SIGKILL-equivalent replica death (chaos drills and tests):
        the replica is marked dead, hard-stopped, and every request
        that was queued on or in flight at it migrates to surviving
        replicas and completes byte-identical to offline
        ``generate()``."""
        idx = self._check_replica(replica)
        with self._lock:
            already = idx in self._dead
            self._dead.add(idx)
        if not already:
            # the kill IS a crash drill: freeze the black box NOW,
            # while the victim's in-flight requests' spans are still
            # open — the bundle is the forensic record the migration
            # then outruns.  First kill only: a repeated kill of a
            # corpse must not bury the real crash bundle under an
            # empty post-recovery one.
            _FLIGHT.record("chaos_kill", replica=idx)
            _FLIGHT.request_dump(f"chaos_kill: replica {idx}")
        self._mark_migrate(idx)
        if not already:
            # hard stop: in-flight handles fail immediately (the
            # migration trigger); no graceful drain, like a real kill
            self._servers[idx].shutdown(drain=False, timeout=timeout)
        self._wake()

    def add_replica(self, role: str = ROLE_UNIFIED,
                    devices=None) -> int:
        """LIVE SCALE-OUT: construct one more replica from the fleet's
        founding ``net`` + server config and join it; returns its
        index.  ``role`` slots it into the disagg topology (default
        unified); ``devices`` gives the newcomer its own device slice
        (a scaled-out replica may span chips the founders did not —
        ONE fleet mixes single- and multi-chip replicas).  The
        newcomer enters the dispatch candidate set —
        and the prefix-affinity probe — only after its FIRST
        successful ``stats()`` (observed by the scheduler's health
        sweep): a replica still constructing must not catch traffic it
        cannot report on, and ``fleet_replicas_healthy`` only rises
        when it actually becomes dispatchable."""
        role = str(role)
        if role not in ROLES:
            raise ValueError(f"unknown role {role!r}; must be one of "
                             f"{ROLES}")
        with self._lock:
            if self._shutdown:
                raise RuntimeError("ServingFleet has been shut down")
        # constructed OUTSIDE the lock: replica construction allocates
        # the KV pool and may compile — the fleet must keep serving
        dev = None if devices is None else list(devices)
        srv = GenerationServer(
            self._net, **(dict(self._server_kwargs, devices=dev)
                          if dev is not None else self._server_kwargs))
        with self._lock:
            if self._shutdown:
                down = True
            else:
                down = False
                idx = len(self._servers)
                self._servers.append(srv)
                self._roles.append(role)
                self._devices.append(dev)
                self.n_replicas += 1
                self._joining.add(idx)
                _REPL_DEVICES.labels(replica=str(idx)).set(
                    len(dev) if dev is not None else 1)
        if down:
            srv.shutdown(drain=False)
            raise RuntimeError("ServingFleet has been shut down")
        log.info("ServingFleet: replica %d constructed; joins the "
                 "dispatch set after its first successful stats()", idx)
        self._wake()
        return idx

    def remove_replica(self, replica: int, timeout: float = 30.0) -> None:
        """LIVE SCALE-IN: roll ``replica`` out through the existing
        drain→migrate machinery — admission to it stops, its queued
        and in-flight requests re-place onto the survivors (completing
        byte-identical), and once its work has left, the underlying
        server stops.  The index stays allocated (indices are stable
        identities requests and telemetry reference) but never becomes
        a candidate again.  Unknown indices raise ``ValueError``."""
        idx = self._check_replica(replica)
        with self._lock:
            if idx in self._removed:
                return
            roles = list(self._roles)
            if roles[idx] != ROLE_PREFILL:
                # the constructor's >=1-decode-capable invariant must
                # survive scale-in too: removing the last live decode
                # replica would brick the fleet (a surviving prefill
                # replica cannot complete anything) — refuse, like the
                # role validation at construction
                others = [i for i in range(len(self._servers))
                          if i != idx and i not in self._removed
                          and i not in self._dead
                          and roles[i] != ROLE_PREFILL]
                if not others:
                    raise ValueError(
                        f"replica {idx} is the last live "
                        "decode-capable replica — removing it would "
                        "leave the fleet unable to decode (add a "
                        "decode/unified replica first)")
            self._removed.add(idx)
            self._joining.discard(idx)
        self.drain(idx, hard=True)
        deadline = time.monotonic() + float(timeout)
        while time.monotonic() < deadline:
            with self._lock:
                busy = any(r.replica == idx for r in self._inflight)
            if not busy:
                break
            time.sleep(self.poll_interval_s)
        try:
            self._servers[idx].shutdown(drain=False, timeout=timeout)
        except Exception:
            log.exception("removed replica %d shutdown failed", idx)
        self._wake()

    def attach_slo(self, engine) -> None:
        """Attach (or replace; None detaches) the SLO error-budget
        engine consulted by every dispatch pass — see
        ``slo_engine=`` on the constructor."""
        with self._lock:
            self._slo = engine

    def attach_degrade(self, ladder) -> None:
        """Attach (or replace; None detaches) the degradation ladder
       : every admission is shaped through its current
        rung, and rung changes actuate through
        :meth:`apply_degrade`."""
        with self._lock:
            self._degrade = ladder

    def apply_degrade(self, max_n_new_factor: Optional[float] = None,
                      min_n_new: int = 1, force_greedy: bool = False,
                      draft_k_cap: Optional[int] = None,
                      spec: bool = True,
                      shed_tenants: Iterable[str] = ()) -> None:
        """Actuate one degradation-ladder policy on the LIVE fleet
        (new admissions are shaped separately, per request): cap the
        wait lines' ``n_new`` budgets, flip waiting work to greedy,
        cap each replica's speculative draft depth
        (``shrink_draft_k``), suspend/resume speculative decoding per
        replica, and shed the named tenants' waiting requests.
        Idempotent — the ladder calls it once per rung change with the
        FULL nested policy, so re-applying a rung is harmless."""
        shed = tuple(str(t) for t in shed_tenants)
        demoted = 0
        with self._lock:
            # wait-line demotion under the fleet lock: the dispatch
            # pass reads n_new/sampling/cost under the same lock, so
            # a request is either shaped HERE or dispatched with its
            # old budget — never half of each
            for req in self._waiting:
                if max_n_new_factor is not None:
                    capped = max(max(1, int(min_n_new)),
                                 int(req.n_new
                                     * float(max_n_new_factor)))
                    if capped < req.n_new:
                        req.n_new = capped
                        req.cost = float(len(req.prompt) + req.n_new)
                        demoted += 1
                if force_greedy:
                    temp = (req.sampling or {}).get("temperature",
                                                    None)
                    if temp is None or float(temp) > 0.0:
                        req.sampling = {"temperature": 0.0}
                        demoted += 1
            servers = list(self._servers)
            dead = set(self._dead) | set(self._removed)
        for i, srv in enumerate(servers):
            if i in dead:
                continue
            try:
                srv.set_spec_enabled(spec)
                srv.set_draft_k_cap(draft_k_cap)
                demoted += srv.demote_waiting(
                    n_new_factor=max_n_new_factor,
                    force_greedy=force_greedy)
            except Exception:
                log.exception("degrade actuation on replica %d "
                              "failed", i)
        if shed:
            demoted += self.demote_waiting(shed, cancel=True)
        if demoted:
            self._wake()

    def demote_waiting(self, tenants: Iterable[str],
                       priority: Optional[int] = None,
                       cancel: bool = False) -> int:
        """Load-shedding hooks for the autoscaler's batch-before-
        interactive policy, applied to the WAIT LINE only (in-flight
        work is never touched):

        * ``priority=N`` DEFERS: every waiting request of the named
          tenants whose priority is better (lower) than ``N`` is
          demoted to ``N``, so interactive traffic dispatches first
          while the batch work keeps its place in line;
        * ``cancel=True`` SHEDS: the named tenants' waiting requests
          are cancelled outright (their callers see
          ``CancelledError``; quota charges are refunded by the
          normal cancel accounting).

        Returns how many requests were demoted/cancelled."""
        tenants = {str(t) for t in tenants}
        hit: List[_FleetRequest] = []
        with self._lock:
            for req in self._waiting:
                if req.tenant not in tenants:
                    continue
                if cancel:
                    hit.append(req)
                elif priority is not None and req.priority < int(priority):
                    req.priority = int(priority)
                    hit.append(req)
        if cancel:
            for req in hit:
                req.cancel()
            if hit:
                self._wake()
        return len(hit)

    def stats(self) -> dict:
        """Fleet snapshot: per-replica ``GenerationServer.stats()``
        (plus fleet-side ``dead``/``draining``/``joining``/``removed``
        flags), wait-line and in-flight depths, dispatchable-replica
        count, and the per-tenant accounting view."""
        with self._lock:
            servers = list(self._servers)
            roles = list(self._roles)
            dead = set(self._dead)
            draining = set(self._draining)
            joining = set(self._joining)
            removed = set(self._removed)
            waiting = len(self._waiting)
            inflight = len(self._inflight)
        replicas = []
        for i, srv in enumerate(servers):
            st = srv.stats()
            st["role"] = roles[i]
            st["dead"] = i in dead
            st["draining"] = bool(st["draining"]) or i in draining
            st["joining"] = i in joining
            st["removed"] = i in removed
            replicas.append(st)
        healthy = sum(1 for st in replicas
                      if st["healthy"] and not st["dead"]
                      and not st["draining"] and not st["joining"]
                      and not st["removed"])
        return {"replicas": replicas, "waiting": waiting,
                "inflight": inflight, "healthy_replicas": healthy,
                "tenants": self._acct.snapshot()}

    def replica(self, idx: int) -> GenerationServer:
        """The underlying replica (tests / advanced introspection)."""
        return self._servers[self._check_replica(idx)]

    def shutdown(self, drain: bool = False, timeout: float = 30.0):
        """Stop the fleet.  Default: waiting and in-flight requests
        fail with RuntimeError.  ``drain=True``: admission closes but
        everything already submitted runs to completion (including
        any pending migrations) before the scheduler and the replicas
        exit."""
        with self._lock:
            self._drain_mode = bool(drain)
            self._shutdown = True
            worker = self._worker
        self._intake.put(None)
        worker.join(timeout=timeout)
        if worker.is_alive():
            log.warning("ServingFleet scheduler did not exit within "
                        "%.3gs (drain=%s); failing its in-flight "
                        "requests", timeout, drain)
            self._fail_all(RuntimeError(
                "ServingFleet shut down while the scheduler was "
                "unresponsive"))
        with self._lock:
            servers = list(self._servers)
        for i, srv in enumerate(servers):
            # dead replicas included: a kill() already shut its server
            # down (GenerationServer.shutdown is idempotent), but an
            # ORGANICALLY-dead one still owns a watchdog thread and
            # queued leftovers that must be stopped and failed — the
            # fleet marking it dead never stopped the server itself
            try:
                srv.shutdown(drain=drain, timeout=timeout)
            except Exception:
                log.exception("replica %d shutdown failed", i)
        self._fail_leftovers()
        _REPL_HEALTHY.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- internals -----------------------------------------------------
    def _check_replica(self, idx: int) -> int:
        idx = int(idx)
        with self._lock:
            n = len(self._servers)
        if not 0 <= idx < n:
            raise ValueError(f"replica {idx} out of range [0, {n})")
        return idx

    def _wake(self) -> None:
        """Nudge a sleeping scheduler without enqueueing work."""
        try:
            self._intake.put_nowait(_WAKE)
        except queue.Full:
            pass                     # a full intake is awake already

    def _mark_migrate(self, idx: int) -> None:
        """Flag every in-flight request on ``idx`` for migration and
        cancel its replica-side handle (the handle failing is what
        hands the request back to the dispatch pass)."""
        with self._lock:
            victims = [r for r in self._inflight if r.replica == idx]
            for req in victims:
                req._migrate = True
            hedged = [r for r in self._inflight
                      if r.hedge_replica == idx]
        for req in victims:
            inner = req.inner
            if inner is not None:
                inner.cancel()
        for req in hedged:
            # the HEDGE placement died with the replica: resolve its
            # race — the primary races on alone
            self._drop_hedge(req)

    def _fail_leftovers(self) -> None:
        """Drain and fail intake entries once the scheduler is gone."""
        err = RuntimeError("ServingFleet shut down with the request "
                           "in flight")
        while True:
            try:
                item = self._intake.get_nowait()
            except queue.Empty:
                return
            if isinstance(item, _FleetRequest):
                self._acct.drop_queued(item.tenant)
                for sp in (item.spans.pop(p, None)
                           for p in ("admission", "request")):
                    if sp is not None:
                        sp.end(outcome="failed")
                item._error = err
                item._event.set()

    def _fail_all(self, err) -> None:
        with self._lock:
            victims = self._waiting + self._inflight
            self._waiting = []
            self._inflight = []
        for req in victims:
            self._drop_hedge(req, "failed")
            inner = req.inner
            if inner is not None:
                inner.cancel()
                inner.close_spans("failed")
            if req._quota_held:
                self._acct.release(req.tenant)
            else:
                self._acct.drop_queued(req.tenant)
            for sp in (req.spans.pop(p, None)
                       for p in ("admission", "request")):
                if sp is not None:
                    sp.end(outcome="failed")
            req._error = err
            req._event.set()
        _FLEET_QDEPTH.set(self._intake.qsize())

    def _finish(self, req: _FleetRequest, result=None, error=None,
                outcome: Optional[str] = None) -> None:
        """Terminal accounting for one request (already removed from
        the wait/flight lists by the caller)."""
        if req._quota_held:
            self._acct.release(req.tenant)
            if req._t_dispatch is None:
                # charged at the quota gate but never dispatched to
                # any replica: the tokens bought nothing — refund
                self._acct.refund(req.tenant, req.cost)
        else:
            self._acct.drop_queued(req.tenant)
        if outcome:
            _REQS.labels(tenant=req.tenant, outcome=outcome).inc()
        # the handle outlives the request (callers hold it for
        # .ttft/.replica): drop the exported K/V payload now — its
        # re-import-on-migration purpose ends at terminal state
        req.handoff = None
        if error is not None:
            req._error = error
        else:
            req._result = result
            inner = req.inner
            if (req._t_dispatch is not None and inner is not None
                    and inner.ttft is not None):
                req.ttft = (req._t_dispatch - req.t_submit) + inner.ttft
        # close the request's remaining trace spans (root span
        # included) wherever this runs — the scheduler thread normally,
        # but also shutdown/teardown paths; cross-thread end is what
        # the tracked-span API exists for
        final = outcome or ("ok" if error is None else "error")
        for sp in (req.spans.pop(p, None)
                   for p in ("admission", "request")):
            if sp is not None:
                sp.end(outcome=final)
        _PHASE.labels(phase="total").observe(
            time.perf_counter() - req.t_submit)
        req._event.set()

    # -- scheduler passes (scheduler thread only) ----------------------
    def _ingest(self, item, stop: bool) -> bool:
        """Returns the updated stop flag."""
        if item is None:
            return True
        if item is _WAKE:
            return stop
        with self._lock:
            self._waiting.append(item)
        return stop

    def _sweep_health(self, now: float) -> None:
        """Declare replicas dead after ``dead_after_s`` of continuous
        unhealthiness (a watchdog recovery flickers for milliseconds —
        that must not trigger a migration storm), trigger migration
        for their in-flight work, and promote JOINING replicas into
        the dispatch set on their first successful ``stats()``."""
        with self._lock:
            servers = list(self._servers)
            joining = sorted(self._joining)
        for i in joining:
            # the join gate: one successful lock-consistent snapshot
            # proves the newcomer can answer the placement questions
            # (free blocks, warmth) dispatch will ask it
            try:
                st = servers[i].stats()
            except Exception:       # pragma: no cover - defensive
                continue
            if st["healthy"]:
                with self._lock:
                    self._joining.discard(i)
                log.info("ServingFleet: replica %d reported healthy "
                         "stats — joined the dispatch set", i)
        newly_dead = []
        for i, srv in enumerate(servers):
            with self._lock:
                if i in self._dead or i in self._removed \
                        or i in self._joining:
                    continue
            if srv.healthy():
                with self._lock:
                    self._unhealthy_since.pop(i, None)
                continue
            with self._lock:
                t0 = self._unhealthy_since.setdefault(i, now)
                if now - t0 >= self.dead_after_s:
                    self._dead.add(i)
                    newly_dead.append(i)
        for i in newly_dead:
            log.warning("ServingFleet: replica %d unhealthy for "
                        ">= %.3gs — declaring it dead and migrating "
                        "its requests", i, self.dead_after_s)
            self._mark_migrate(i)
        with self._lock:
            n_up = sum(1 for i in range(len(self._servers))
                       if i not in self._dead
                       and i not in self._draining
                       and i not in self._removed
                       and i not in self._joining
                       and i not in self._unhealthy_since)
        _REPL_HEALTHY.set(n_up)

    def _reap_waiting(self, now: float) -> None:
        """Cancelled / deadline-expired requests leave the wait line."""
        with self._lock:
            keep, victims = [], []
            for req in self._waiting:
                if req.cancelled:
                    victims.append((req, "cancelled", CancelledError(
                        "fleet request cancelled")))
                elif req.deadline is not None and now > req.deadline:
                    victims.append((req, "expired",
                                    DeadlineExceededError(
                                        "fleet request deadline "
                                        "elapsed before dispatch")))
                else:
                    keep.append(req)
            self._waiting = keep
        for req, outcome, err in victims:
            self._finish(req, error=err, outcome=outcome)

    def _count_queued(self, req: _FleetRequest) -> None:
        """First wait — quota OR capacity — counts the queued outcome
        (once per request; the label means 'waited >= 1 pass')."""
        if not req._queued_counted:
            req._queued_counted = True
            _REQS.labels(tenant=req.tenant, outcome="queued").inc()

    def _dispatch_pass(self, now: float) -> int:
        """Walk the wait line in (priority, deadline, arrival) order
        and dispatch everything quota + capacity allow.  Returns the
        number dispatched.

        Cost discipline: the quota gate runs FIRST (a blocked
        tenant's backlog must cost zero replica traffic), and replica
        ``stats()`` snapshots are taken ONCE per pass — a long wait
        line must not hammer every replica's lock per request.
        Intra-pass dispatches fold back in via ``extra_load`` so
        least-loaded placement still spreads within one pass; only
        the per-request prefix-warmth probe touches a replica per
        waiting request, and only after its quota cleared.

        DISAGG classification happens here, where the
        router already costs the prompt: a request whose prompt is at
        least ``prefill_threshold`` tokens — and whose prefix is not
        already warm on a decode-capable replica — stages through a
        prefill-role replica first (``stage="prefill"``); everything
        else decodes direct.  Prefill replicas never take decode
        traffic, decode replicas never take prefill stages, unified
        replicas take only decode/direct traffic (a unified replica
        IS its own prefill)."""
        budget_deferred: List[str] = []
        with self._lock:
            if not self._waiting:
                return 0
            # SLO budget defer: tenants whose error budget
            # is exhausted sort BEHIND within-budget tenants of the
            # same priority class — their backlog waits out the burn
            # instead of forcing the autoscaler to shed interactive
            # work.  The engine lock is a leaf (it never calls back
            # into the fleet), so the nested read cannot deadlock.
            slo = self._slo
            exhausted = (slo.exhausted_tenants()
                         if slo is not None else frozenset())
            if exhausted:
                for req in self._waiting:
                    if req.tenant in exhausted \
                            and not req._budget_deferred:
                        req._budget_deferred = True
                        budget_deferred.append(req.tenant)
            line = sorted(self._waiting,
                          key=lambda r: (r.priority,
                                         r.tenant in exhausted,
                                         r.deadline if r.deadline
                                         is not None else _INF,
                                         r.t_submit_m))
            n = len(self._servers)
            roles = list(self._roles)
            # terminal only when nothing can EVER take the work: every
            # non-removed DECODE-CAPABLE replica is dead and no
            # newcomer is joining (a fleet of surviving prefill-only
            # replicas cannot complete anything either)
            all_dead = (not self._joining
                        and all(i in self._dead or i in self._removed
                                or roles[i] == ROLE_PREFILL
                                for i in range(n)))
            cand = [i for i in range(n)
                    if i not in self._dead and i not in self._draining
                    and i not in self._removed
                    and i not in self._joining]
        for t in budget_deferred:
            _SLO_DEFER.labels(tenant=t).inc()
        pre_cand = [i for i in cand if roles[i] == ROLE_PREFILL]
        base, pbase = {}, {}
        for i in cand:
            st = self._servers[i].stats()
            if st["healthy"] and not st["draining"]:
                (pbase if roles[i] == ROLE_PREFILL else base)[i] = st
        extra_load = {i: 0 for i in (*base, *pbase)}
        extra_blocks = {i: 0 for i in (*base, *pbase)}
        # blocks claimed this pass (free_blocks is a snapshot —
        # without the compensation, one stale count piles a whole
        # burst onto one replica)
        n_dispatched = 0
        for req in line:
            if now < req._not_before:
                continue             # migration backoff
            if req.cancelled or (req.deadline is not None
                                 and now > req.deadline):
                continue             # next reap pass collects it
            if all_dead:
                with self._lock:
                    if req in self._waiting:
                        self._waiting.remove(req)
                self._finish(req, error=NoHealthyReplicaError(
                    "every decode-capable fleet replica is dead — "
                    "the request was never applied; safe to retry"),
                    outcome="failed")
                continue
            if not req._quota_held:
                if not self._acct.try_dispatch(req.tenant, req.cost,
                                               now):
                    self._count_queued(req)
                    continue
                req._quota_held = True
            warmths = None           # classification probes, reused
                                     # by the views below (one hash
                                     # walk per replica per request)
            if req.stage is None:
                req.stage = "decode"
                if (pre_cand and req.handoff is None
                        and len(req.prompt) >= self.prefill_threshold):
                    # block_size is a static server attribute (all
                    # replicas share the founding kwargs) — deriving
                    # it from the healthy-stats snapshot would stamp
                    # a long prompt "decode" forever during a pass
                    # where no replica happened to be dispatchable
                    full = ((len(req.prompt) - 1)
                            // self._servers[0].block_size)
                    warmths = {i: self._servers[i].prefix_warmth(
                        req.prompt) for i in base}
                    # an already-warm decode replica beats a handoff:
                    # its admission maps the blocks copy-free, so the
                    # prefill stage would buy nothing
                    if full > 0 and max(warmths.values(),
                                        default=0) < full:
                        req.stage = "prefill"
            if req.stage == "prefill" and not pbase:
                if pre_cand:
                    # prefill replicas exist but none is dispatchable
                    # this pass (recovering): wait, don't stall decode
                    # replicas with a long prefill
                    self._count_queued(req)
                    continue
                req.stage = "decode"     # none left: decode direct
            if req.stage == "prefill":
                pool = pbase
            else:
                pool = base
            if not pool:
                # capacity wait: every candidate draining/recovering
                self._count_queued(req)
                continue
            if warmths is None or pool is not base:
                warmths = {i: self._servers[i].prefix_warmth(
                    req.prompt) for i in pool}
            views = [{"idx": i,
                      "warmth": warmths[i],
                      "free_blocks": (st["free_blocks"]
                                      - extra_blocks[i]),
                      "load": (st["live_slots"] + st["queue_depth"]
                               + extra_load[i]),
                      "spec_k": st.get("spec_k", 0),
                      "spec_acceptance": st.get(
                          "spec_acceptance_rate", 0.0)}
                     for i, st in pool.items()]
            refused = set()
            status, idx = self._place(req, views, refused)
            for i in refused:
                # a refusing replica (raced drain/shutdown) refuses
                # everyone: stop re-attempting it this pass
                pool.pop(i, None)
            if status == "placed":
                extra_load[idx] += 1
                bs = pool[idx]["block_size"]
                n_toks = len(req.prompt) + (
                    0 if req.stage == "prefill" else req.n_new)
                blocks = -(-n_toks // bs)
                if pool[idx].get("spec_k", 0) \
                        and req.stage != "prefill":
                    # a speculative replica pins the draft's table too
                    # — without the 2x the intra-pass compensation
                    # under-counts and a burst piles onto the replica.
                    # Prefill-ONLY admissions claim no draft table
                    # (generation_server skips dneed), so they stay 1x
                    blocks *= 2
                extra_blocks[idx] += blocks
                n_dispatched += 1
            elif status == "refused":
                self._count_queued(req)
        return n_dispatched

    def _place(self, req: _FleetRequest, views: List[dict],
               refused_out: Optional[set] = None):
        """Dispatch ``req`` onto the best candidate in ``views``
        (falling down the ranking when a replica refuses — raced
        drain/shutdown; refusers are reported through ``refused_out``
        so a pass can stop re-attempting them).  Returns
        ``("placed", replica_idx)``, ``("refused", None)`` when every
        candidate refused, or ``("failed", None)`` when the request
        terminally failed."""
        views = list(views)
        prefill_stage = req.stage == "prefill"
        sp_place = telemetry.get_tracer().begin(
            "request/placement", trace=req.trace_id,
            candidates=len(views), stage=req.stage or "decode")
        t_place = time.perf_counter()
        while views:
            idx, reason = choose_replica(views)
            if req._migrating:
                reason = FAILOVER
            elif prefill_stage:
                reason = PREFILL
            elif req.handoff is not None:
                reason = HANDOFF
            srv = self._servers[idx]
            remaining = (None if req.deadline is None
                         else max(req.deadline - time.monotonic(),
                                  1e-3))
            try:
                if prefill_stage:
                    # disagg stage 1: chunked prefill into the prefill
                    # replica's pool; the handoff export happens when
                    # the handle resolves (completion pass)
                    inner = srv.prefill_async(
                        req.prompt, deadline_s=remaining,
                        trace_id=req.trace_id)
                else:
                    if req.handoff is not None:
                        # disagg stage 2: land the exported prefix in
                        # THIS replica before its admission runs, so
                        # the chain walk restores it (one batched H2D)
                        # instead of re-prefilling.  A failed import
                        # only costs a cold prefill, never the request.
                        try:
                            srv.import_blocks(req.handoff)
                        except Exception:
                            log.exception(
                                "handoff import into replica %d "
                                "failed; decoding cold", idx)
                    inner = srv.submit_async(
                        req.prompt, req.n_new, eos_id=req.eos_id,
                        seed=req.seed, deadline_s=remaining,
                        sampling=req.sampling, trace_id=req.trace_id,
                        tenant=req.tenant)
            except RuntimeError:
                # raced into a draining/shutdown replica: drop it from
                # the candidate ranking and try the next one
                if refused_out is not None:
                    refused_out.add(idx)
                views = [v for v in views if v["idx"] != idx]
                continue
            except Exception as e:
                sp_place.end(outcome="failed")
                with self._lock:
                    if req in self._waiting:
                        self._waiting.remove(req)
                self._finish(req, error=e, outcome="failed")
                return "failed", None
            with self._lock:
                if req in self._waiting:
                    self._waiting.remove(req)
                req.inner = inner
                req.replica = idx
                req._migrate = False
                self._inflight.append(req)
            first = req._t_dispatch is None
            req._t_dispatch = time.perf_counter()
            _FLIGHT.record("dispatch", replica=idx, reason=reason,
                           trace=req.trace_id, tenant=req.tenant,
                           stage=req.stage or "decode")
            sp_place.end(replica=idx, reason=reason)
            _PHASE.labels(phase="placement").observe(
                req._t_dispatch - t_place)
            if first:
                wait = req._t_dispatch - req.t_submit
                _QWAIT.labels(tenant=req.tenant).observe(wait)
                _PHASE.labels(phase="admission").observe(wait)
                sp_adm = req.spans.pop("admission", None)
                if sp_adm is not None:
                    sp_adm.end(replica=idx)
            if req.deadline is not None:
                # EDF slack at dispatch: the SLO headroom the fleet
                # still has for this request — the autoscaler's
                # earliest-collapsing pressure signal
                _EDF_SLACK.labels(tenant=req.tenant).observe(
                    max(0.0, req.deadline - time.monotonic()))
            _DISPATCH.labels(replica=str(idx), reason=reason).inc()
            if req._migrating:
                req._migrating = False
                _REQS.labels(tenant=req.tenant,
                             outcome="migrated").inc()
            elif first:
                _REQS.labels(tenant=req.tenant,
                             outcome="admitted").inc()
            else:
                # the decode stage of a disagg request already counted
                # admitted at its prefill placement — one request, one
                # admitted outcome; the handoff gets its own label
                _REQS.labels(tenant=req.tenant,
                             outcome="handed_off").inc()
            if req.cancelled:
                inner.cancel()       # raced a cancel mid-placement
            return "placed", idx
        sp_place.end(outcome="refused")
        return "refused", None       # every candidate refused

    def _drop_hedge(self, req: _FleetRequest,
                    outcome: str = "cancelled") -> None:
        """Resolve a hedge race AGAINST the hedge (the primary won,
        or the request went terminal/migrating): detach the hedge
        handle, cancel it, flush its replica-side spans, and count
        the resolution — exactly one ``fleet_hedges_cancelled_total``
        per resolved race, whichever side lost."""
        with self._lock:
            hedge = req.hedge_inner
            req.hedge_inner = None
            req.hedge_replica = None
        if hedge is None:
            return
        hedge.cancel()
        hedge.close_spans(outcome)
        _HEDGE_CANCEL.inc()

    def _hedge_pass(self, now: float) -> int:
        """Tail-latency hedging: duplicate each
        near-deadline interactive decode onto a second warm replica —
        the SAME prompt/n_new/seed/sampling, so greedy decode makes
        the two placements byte-identical and first-completion-wins
        is a pure latency race.  Bounded by ``hedge_budget`` (a
        fraction of the current flight) so hedging cannot amplify the
        overload it defends against.  Returns hedges launched."""
        if self.hedge_slack_s is None:
            return 0
        with self._lock:
            flight = list(self._inflight)
            n_hedged = sum(1 for r in flight
                           if r.hedge_inner is not None)
            roles = list(self._roles)
            cand = [i for i in range(len(self._servers))
                    if i not in self._dead
                    and i not in self._draining
                    and i not in self._removed
                    and i not in self._joining
                    and roles[i] != ROLE_PREFILL]
        budget = max(1, int(self.hedge_budget * len(flight)))
        launched = 0
        stats_cache: Dict[int, dict] = {}
        for req in flight:
            if n_hedged + launched >= budget:
                break
            if (req.hedge_inner is not None or req.deadline is None
                    or req.priority > 0 or req.cancelled
                    or req._migrate or req.stage == "prefill"
                    or req.inner is None or req.inner.done()):
                continue
            remaining = req.deadline - now
            if remaining <= 0 or remaining >= self.hedge_slack_s:
                continue
            targets = []
            for i in cand:
                if i == req.replica:
                    continue
                st = stats_cache.get(i)
                if st is None:
                    try:
                        st = self._servers[i].stats()
                    except Exception:
                        continue
                    stats_cache[i] = st
                if st["healthy"] and not st["draining"]:
                    targets.append((-(st["free_blocks"]
                                      - st["queue_depth"]), i))
            if not targets:
                continue
            tgt = min(targets)[1]       # most free blocks, least queue
            srv = self._servers[tgt]
            rem = max(req.deadline - time.monotonic(), 1e-3)
            try:
                hedge = srv.submit_async(
                    req.prompt, req.n_new, eos_id=req.eos_id,
                    seed=req.seed, deadline_s=rem,
                    sampling=req.sampling, trace_id=req.trace_id,
                    tenant=req.tenant)
            except Exception:
                continue             # raced drain/shutdown: no hedge
            committed = False
            with self._lock:
                if (req in self._inflight and req.hedge_inner is None
                        and not req._migrate and not req.cancelled):
                    req.hedge_inner = hedge
                    req.hedge_replica = tgt
                    req._t_hedge = time.perf_counter()
                    committed = True
            if not committed:
                # the primary resolved (or went terminal) between the
                # snapshot and the launch: the race is void
                hedge.cancel()
                hedge.close_spans("cancelled")
                continue
            _HEDGE_LAUNCH.inc()
            _FLIGHT.record("hedge", trace=req.trace_id,
                           tenant=req.tenant, primary=req.replica,
                           replica=tgt,
                           remaining_s=round(remaining, 4))
            launched += 1
        return launched

    def _completion_pass(self, now: float) -> int:
        """Resolve finished replica-side handles: deliver results,
        propagate terminal errors, and REQUEUE migration candidates
        (dead/hard-drained replica, or a retryable server failure)
        with jittered backoff.  A hedged request resolves FIRST-WINS:
        whichever placement finishes first delivers its bytes and the
        loser is cancelled.  Returns the number resolved."""
        with self._lock:
            flight = list(self._inflight)
        n_done = 0
        for req in flight:
            inner = req.inner
            hedge = req.hedge_inner
            if (hedge is not None and hedge.done()
                    and not (inner is not None and inner.done())):
                herr = None
                try:
                    hres = hedge.result(timeout=1.0)
                except BaseException as e:
                    herr, hres = e, None
                if herr is None:
                    # the hedge WON: adopt its placement (ttft re-
                    # based on the hedge launch — the caller's wait
                    # really did end with the hedge's first token),
                    # cancel the primary, deliver
                    with self._lock:
                        if req in self._inflight:
                            self._inflight.remove(req)
                        req.inner = hedge
                        req.replica = req.hedge_replica
                        req.hedge_inner = None
                        req.hedge_replica = None
                        if req._t_hedge is not None:
                            req._t_dispatch = req._t_hedge
                    if inner is not None:
                        inner.cancel()
                        inner.close_spans("cancelled")
                    _HEDGE_WON.inc()
                    _HEDGE_CANCEL.inc()
                    _FLIGHT.record("hedge_won", trace=req.trace_id,
                                   replica=req.replica)
                    self._finish(req, result=hres)
                    n_done += 1
                    continue
                # the hedge died (its replica drained/expired it):
                # the primary races on alone — resolve the race
                # against the hedge
                with self._lock:
                    req.hedge_inner = None
                    req.hedge_replica = None
                hedge.close_spans("failed")
                _HEDGE_CANCEL.inc()
                hedge = None
            if inner is None or not inner.done():
                if req._migrate:
                    # the placement is GONE (dead replica or hard
                    # drain): do not wait for a scheduler that may
                    # never resolve the cancelled handle — a kill()
                    # fails handles via shutdown, but an organically-
                    # dead scheduler resolves nothing, ever.  Abandon
                    # the old handle and requeue (or finish) now.
                    n_done += self._abandon_placement(req, now)
                continue
            n_done += 1
            err = None
            try:
                result = inner.result(timeout=1.0)
            except BaseException as e:
                err, result = e, None
            if err is None:
                if req.stage == "prefill":
                    # disagg stage 1 finished: export the prefix off
                    # the prefill replica and requeue for the decode
                    # stage (NOT a migration — no backoff, and the
                    # cancelled/expired cases fall to the next reap)
                    self._hand_off(req)
                    continue
                # the primary won any hedge race: cancel the hedge
                self._drop_hedge(req)
                with self._lock:
                    if req in self._inflight:
                        self._inflight.remove(req)
                self._finish(req, result=result)
                continue
            # error classification
            if isinstance(err, CancelledError) and req.cancelled:
                self._remove_and_finish(req, err, "cancelled")
            elif isinstance(err, DeadlineExceededError):
                self._remove_and_finish(req, err, "expired")
            elif self._migratable(req, err, now):
                if hedge is not None:
                    # the hedge IS the migration: promote the live
                    # second placement instead of re-placing from
                    # scratch (no backoff, no lost progress) — the
                    # race resolves against the dead primary
                    with self._lock:
                        req.inner = hedge
                        req.replica = req.hedge_replica
                        req.hedge_inner = None
                        req.hedge_replica = None
                        req._migrate = False
                        if req._t_hedge is not None:
                            req._t_dispatch = req._t_hedge
                    inner.close_spans("abandoned")
                    _HEDGE_CANCEL.inc()
                    _FLIGHT.record("hedge_promote",
                                   trace=req.trace_id,
                                   replica=req.replica)
                else:
                    self._requeue(req, now)
            else:
                self._remove_and_finish(req, err, "failed")
        return n_done

    def _hand_off(self, req: _FleetRequest) -> None:
        """Disagg stage transition: the prefill replica finished, so
        export its registered prefix blocks (raw bytes + chain
        hashes) and send the request back to the wait line as a
        decode-stage request carrying the payload.  An export that
        fails (replica dying under us) degrades to an empty handoff —
        the decode replica re-prefills, byte-identically."""
        payload = None
        try:
            # short dirty-read budget: this runs ON the fleet
            # scheduler thread, so a long retry loop would stall
            # every tenant's dispatch behind one handoff — an export
            # that can't read a committed pool quickly degrades to an
            # empty payload (decode re-prefills, byte-identically).
            # On a prefill-ONLY replica the scheduler idles right
            # after the retire, so the first read is normally clean.
            payload = self._servers[req.replica].export_prefix(
                req.prompt, max_wait_s=0.25)
        except Exception:
            log.exception("prefix export off replica %s failed; the "
                          "decode stage will re-prefill", req.replica)
        _FLIGHT.record("handoff", trace=req.trace_id,
                       off_replica=req.replica,
                       blocks=len(payload or ()))
        with self._lock:
            if req in self._inflight:
                self._inflight.remove(req)
            req.prefill_replica = req.replica
            req.inner = None
            req.replica = None
            req._migrate = False
            req.stage = "decode"
            req.handoff = payload or None
            self._waiting.append(req)

    def _abandon_placement(self, req: _FleetRequest,
                           now: float) -> int:
        """A migrating request whose replica-side handle may never
        resolve: drop the handle and requeue — unless the caller no
        longer wants it, its deadline is spent, or its migration
        budget is exhausted (terminal then).  Returns 1 (the request
        always moves somewhere — progress for the pacing loop)."""
        if req.cancelled:
            self._remove_and_finish(req, CancelledError(
                "fleet request cancelled"), "cancelled")
        elif req.deadline is not None and now > req.deadline:
            self._remove_and_finish(req, DeadlineExceededError(
                "fleet request deadline elapsed while its replica "
                "was dying"), "expired")
        elif req.migrations >= self.migration_retries:
            self._remove_and_finish(req, NoHealthyReplicaError(
                "request exhausted its migration budget on dying "
                "replicas — it was never applied; safe to retry"),
                "failed")
        else:
            self._requeue(req, now)
        return 1

    def _remove_and_finish(self, req: _FleetRequest, err,
                           outcome: str) -> None:
        self._drop_hedge(req, outcome)
        inner = req.inner
        if inner is not None:
            # terminal abandon paths included: a dying replica's
            # unresolved handle still flushes its spans (idempotent
            # when the replica retired it first)
            inner.close_spans(outcome)
        with self._lock:
            if req in self._inflight:
                self._inflight.remove(req)
        self._finish(req, error=err, outcome=outcome)

    def _migratable(self, req: _FleetRequest, err, now: float) -> bool:
        """A failed in-flight request migrates when the failure was
        the REPLICA's fault (marked for migration, replica dead or
        unhealthy, or a typed retryable failure), the caller still
        wants it, its deadline still has budget, and the migration
        bound has room.  The request was never partially applied —
        the survivor re-decodes from scratch, byte-identically."""
        if req.cancelled:
            return False
        if req.deadline is not None and now > req.deadline:
            return False
        if req.migrations >= self.migration_retries:
            return False
        if req._migrate:
            return True
        with self._lock:
            replica_gone = (req.replica in self._dead
                            or req.replica in self._unhealthy_since)
        if replica_gone and isinstance(err, (RetryableServerError,
                                             RuntimeError,
                                             CancelledError)):
            return True
        # healthy replica, typed retryable failure (watchdog recovery
        # dropped the slot): same re-placement path, still bounded
        return isinstance(err, RetryableServerError)

    def _requeue(self, req: _FleetRequest, now: float) -> None:
        self._drop_hedge(req, "abandoned")
        req.migrations += 1
        _FLIGHT.record("migrate", trace=req.trace_id,
                       tenant=req.tenant, off_replica=req.replica,
                       migrations=req.migrations)
        delay = backoff_delay(req.migrations - 1,
                              self.retry_backoff_s, 1.0)
        inner = req.inner
        if inner is not None:
            # the abandoned placement's replica-side spans must flush
            # NOW: a dead replica's scheduler will never retire them
            # (idempotent no-op when the replica did retire first)
            inner.close_spans("abandoned")
        with self._lock:
            if req in self._inflight:
                self._inflight.remove(req)
            req.inner = None
            req.replica = None
            req._migrate = False
            req._migrating = True
            req._not_before = now + delay
            # re-classify on the next pass: the replica set changed
            # (a killed prefill replica's request may go direct; a
            # held handoff payload keeps its decode-stage fast path)
            req.stage = None
            self._waiting.append(req)

    def _run(self) -> None:
        stop = False
        while True:
            with self._lock:
                idle = not self._waiting and not self._inflight
            if idle and not stop:
                stop = self._ingest(self._intake.get(), stop)
            while True:                       # opportunistic drain
                try:
                    item = self._intake.get_nowait()
                except queue.Empty:
                    break
                stop = self._ingest(item, stop)
            with self._lock:
                drain_mode = self._drain_mode
            if stop and not drain_mode:
                self._fail_all(RuntimeError(
                    "ServingFleet shut down with the request in "
                    "flight"))
                _FLEET_QDEPTH.set(0)
                return
            if stop:
                with self._lock:
                    done = not self._waiting and not self._inflight
                if done and self._intake.empty():
                    _FLEET_QDEPTH.set(0)
                    return
            try:
                now = time.monotonic()
                self._sweep_health(now)
                self._reap_waiting(now)
                n_disp = self._dispatch_pass(now)
                n_hedge = self._hedge_pass(now)
                n_done = self._completion_pass(now)
                with self._lock:
                    busy = bool(self._waiting or self._inflight)
                    depth = len(self._waiting)
                _FLEET_QDEPTH.set(depth + self._intake.qsize())
                if busy and not (n_disp or n_hedge or n_done) \
                        and not stop:
                    # nothing moved: sleep ON the intake so a new
                    # submit / wake nudge cuts the latency short
                    try:
                        stop = self._ingest(
                            self._intake.get(
                                timeout=self.poll_interval_s), stop)
                    except queue.Empty:
                        pass
            except Exception:
                # the fleet scheduler must not die of one bad pass —
                # log, breathe, keep serving (replica-side failures
                # already have their own watchdog story)
                log.exception("ServingFleet scheduler pass failed")
                time.sleep(0.05)
