"""GenerationServer: continuous-batching decode serving (port of
``deeplearning4j_tpu/parallel/generation_server.py``, with speculative
decode, the host KV tier, prefix handoff, the watchdog and the
mesh-sharded tick).

Many concurrent ``submit()`` callers are multiplexed onto ONE decode
tick over a fixed pool of ``n_slots`` slots — requests join and leave
mid-flight instead of waiting for the whole batch.

KV memory is PAGED: K/V live in a global pool of ``kv_blocks``
fixed-size blocks ([n_layers, 1 + kv_blocks, h, block_size, dh]; block 0
is the never-read scratch sink for masked-inactive writes) and every
slot carries a device-resident ``[max_blocks]`` int32 block table beside
its pos / remaining / EOS / sampling state.  A request pins
``ceil((t0 + n_new) / block_size)`` blocks, so BLOCKS — not slots — are
what admission queues on.  Attention reads through the table via
``kernels.paged_decode_attention``: the hand-written CUDA kernel on the
card, its plain version on the CPU.

Shared-prefix reuse rides on the block pool: admission chain-hashes the
prompt's full blocks, looks them up in a host-side ref-counted prefix
cache (token bytes verified on every hit), maps hits into the new slot's
table COPY-FREE, and prefills only the uncached suffix.  A retired block
whose refcount drains stays resident as an EVICTABLE cache entry,
LRU-evicted only when admission runs short of free blocks.

Design:

* per-slot state lives in device tensors; the tick samples, writes each
  active slot's new K/V row at its (block, offset) and reads attention
  through the tables, inactive slots masked to block 0;
* the scheduler runs up to ``tick_batch`` ticks per dispatch
  (``_decode_scan``) without reading anything back: sampled tokens stage
  in a [B, K] device tensor and the host syncs ONCE per scan.  K is 1
  whenever admission is pending (TTFT does not regress behind a long
  scan) and otherwise the largest power of two <= the longest live
  budget, capped at ``tick_batch``;
* between scans the host admits queued requests into free slots: a
  prefix MISS prefills the prompt padded to a power-of-two bucket, a HIT
  gathers the cached blocks as the key prefix (EXACT length) and prefills
  only the suffix; the K/V rows scatter into the slot's fresh blocks;
* finished slots (budget exhausted or EOS sampled) retire to their
  callers; cancelled or deadline-expired ones are killed on the device
  (their budget zeroed) so they stop burning ticks.

Speculative decode (``speculative={"k": .., "rounds": .., "draft_layers"
| "draft_net": .., "adaptive": .., "k_max": ..}``, ``parallel.
speculative``): a dispatch runs R rounds of draft → verify → accept
(``_spec_rounds``) instead of K plain ticks.  The draft's KV lives in
ordinary pool blocks under a second per-slot table (``dtable``), so a
speculative admission claims about twice the blocks, draft prompt blocks
join the prefix cache in their own hash domain, and a retiring slot
releases both tables.  The verify pass reads attention through
``kernels.paged_verify_attention`` (its CUDA kernel on the card).
Greedy slots commit exactly the target's argmax tokens; sampled slots
run rejection sampling with the residual held for the next anchor
(``rawlg``).  Each slot's draft depth is fixed at ``k`` or, adaptive,
picked per (tenant, prompt-prefix) by the ``AcceptanceController``.

Sampling is PER REQUEST (temperature / top-k / top-p as [B] tensors,
greedy and sampled requests share one batch).  Each slot's draw is a
pure function of (request seed, stream, position, token id)
(``models.generation._gumbel_rows``), so sampled output is reproducible
per seed and invariant to ``tick_batch`` and to speculative ``rounds``.
The streams: the token at a position is drawn with ``STREAM_SAMPLE``
(the plain tick and a round's anchor alike), a draft proposal for a
position with ``STREAM_DRAFT``, and the acceptance uniform of that
proposal with ``STREAM_ACCEPT`` (``_uniform_rows``).  A rejected
position's replacement is the next round's anchor at that position,
drawn from the held residual with ``STREAM_SAMPLE`` — noise no earlier
decision consumed, since a position's anchor is drawn only once.

TIERED KV (``host_tier_blocks`` > 0): an LRU-evicted prefix block SPILLS
its bytes to a capacity-bounded host-RAM LRU (``kv_tiering.HostKVTier``,
keyed by the same chain hashes) instead of dying, and an admission whose
chain walk runs past the device map into the tier restores the spilled
blocks with ONE batched host-to-device copy, then prefills only the
still-uncached suffix.  Host entries are numpy arrays of the block's K
and V ([n_layers, h, block_size, dh]); a bf16 pool's blocks travel as
float32 (numpy has no bf16; the widening is exact, so a spill -> fetch
round trip restores the same bytes).  The same store carries
DISAGGREGATED prefill/decode handoffs: ``prefill_async`` runs admission
+ prefill and retires without a decode tick, ``export_prefix``
serializes the cached blocks as ``(chain_hash, token_bytes, k, v)``
entries and ``import_blocks`` lands them in another replica's tier (the
reference's format, so within one process a payload of either package
lands in the other).  An export reads the pool only behind the
scheduler's last committed dispatch: the read is enqueued under the
server lock after a CUDA event the scheduler records at each commit.

Self-healing: the scheduler's in-flight state lives on the instance
under a lock, and the scheduler thread holds an EPOCH token.  The
watchdog (``tick_timeout_s``, default 30 s; the deadline scales with
the dispatch's tick count) declares a dispatch stuck or the scheduler
dead, bumps the epoch — the old thread, if it ever wakes, finds its
token stale at every commit point and exits — salvages the pool and
starts a fresh scheduler.  Salvage is BLOCK-GRANULAR
(``_recover_pool``): a finiteness screen per pool block implicates only
the slots whose own blocks (or held logits) are poisoned; the kept
slots' blocks and the finite prefix-cache blocks are copied into a NEW
pool, so unaffected in-flight requests complete without resubmission
and the cache stays warm.  The pool is updated in place by every
dispatch, so the copy is the epoch fence on the device side too: a
superseded thread still holds the OLD pool tensors, and nothing it
writes can reach a block the new scheduler hands out.  A failed
dispatch recovers the same way inline, implicating only the slot of a
raising admission.

MESH-SHARDED replica (``devices=[...]``, ``tp=``; ``parallel.mesh``):
the slice is a ``("data", "tp")`` mesh and the tick threads a
``TpShardCtx``.  The KV pool splits its HEAD axis over the tp devices
(:class:`HeadShardedPool`; the block axis and the host allocator stay
global, and each data row holds a replica that every write reaches),
the block weights their OUTPUT columns — each shard's own
heads' q|k|v columns, and ``Wo``/``W1``/``W2``, the head's vocab columns
and the embedding's vocab rows as ``TpLeaf``s — and every tp shard
launches the decode and verify kernels on its own heads, choosing the
split-K chunk from the replica's unsharded shape.  ``TpShardCtx.rep``
gathers the heads before every reduction over the feature axis, so no
contraction is split.  On the CPU the plain versions run, as
everywhere.  The slice may repeat a device (one card driven as two
shards).  With a data axis > 1 the tick runs data row r's slots, B/data
of them, on row r's tp devices with its own placement of the weights
and its own pool replica; the per-slot state rows stay with the server
on the slice's first device and each tick hands row r its rows.
"""
from __future__ import annotations

import itertools
import logging
import queue
import threading
import time
from collections import OrderedDict, namedtuple
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.analysis import sanitize as _sanitize
from deeplearning4j_torch.models.generation import (TransformerGenerator,
                                                    _filter_logits_rows,
                                                    _filtered_logprobs_rows,
                                                    _gumbel_rows,
                                                    _uniform_rows)
from deeplearning4j_torch.parallel import speculative as _speculative
from deeplearning4j_torch.parallel.inference import _bucket
from deeplearning4j_torch.parallel.kv_tiering import HostKVTier
from deeplearning4j_torch.parallel.mesh import (TpLeaf, TpShardCtx,
                                                _own_copy, serving_mesh)
from deeplearning4j_torch.resilience import faults as _faults
from deeplearning4j_torch.resilience.errors import (CancelledError,
                                                    DeadlineExceededError,
                                                    RetryableServerError)
from deeplearning4j_torch.resilience.retry import retry_call

log = logging.getLogger("deeplearning4j_torch")

#: the per-host flight recorder: admissions, retires, allocator
#: spill/fetch and watchdog transitions land in its black-box ring
_FLIGHT = telemetry.get_flight_recorder()

# Serving-decode telemetry, under the reference's names: slot occupancy
# answers "is the decode pool saturated", queue depth is the backpressure
# a load balancer watches, TTFT and per-request tokens/s are the
# caller-visible SLOs.
_ADMITTED = telemetry.counter(
    "generation_server_admitted_total",
    "requests admitted into a decode slot (prefill done)")
_RETIRED = telemetry.counter(
    "generation_server_retired_total",
    "requests retired back to their caller (budget or EOS)")
_TICKS = telemetry.counter(
    "generation_server_ticks_total",
    "device decode ticks executed (a K-tick scan counts K; a speculative "
    "dispatch counts its verify passes, one per round)")
_SCANS = telemetry.counter(
    "generation_server_scan_ticks_total",
    "fused decode scans dispatched, by scan length k (k=1 is the "
    "admission-pending fallback)", labelnames=("k",))
_HOST_SYNCS = telemetry.counter(
    "generation_server_host_syncs_total",
    "device->host polls by the scheduler (one per decode scan)")
_TOK_PER_DISPATCH = telemetry.gauge(
    "generation_server_tokens_per_dispatch",
    "new tokens emitted by the last decode dispatch (active slots x "
    "live scan ticks — the host-sync amortization factor)")
_SLOTS_BUSY = telemetry.gauge(
    "generation_server_slots_busy", "slots decoding at the last tick")
_QDEPTH = telemetry.gauge(
    "generation_server_queue_depth",
    "submitted requests waiting for a free slot")
_OCC = telemetry.histogram(
    "generation_server_slot_occupancy",
    "active slots / n_slots per tick (params-stream amortization)",
    buckets=telemetry.RATIO_BUCKETS)
_TTFT = telemetry.histogram(
    "generation_server_ttft_seconds",
    "submit -> first generated token per request (queue wait + "
    "prefill + first tick)")
_RATE = telemetry.histogram(
    "generation_server_request_tokens_per_sec",
    "per-request generated tokens / residence seconds",
    buckets=(1., 4., 16., 64., 256., 1024., 4096., 16384.))
# Self-healing series: a load balancer drains on server_healthy == 0;
# watchdog restarts at any steady rate are an incident, not noise.
_HEALTHY = telemetry.gauge(
    "server_healthy",
    "1 while the decode scheduler is alive and admitting; 0 during "
    "watchdog recovery and after shutdown (one child per server "
    "instance — a process can run several)", labelnames=("server",))
_SERVER_SEQ = itertools.count()
_WATCHDOG_RESTARTS = telemetry.counter(
    "serve_watchdog_restarts_total",
    "scheduler restarts forced by the watchdog (stuck tick or dead "
    "scheduler thread)")
_TICK_FAILURES = telemetry.counter(
    "generation_server_tick_failures_total",
    "decode/prefill dispatch failures absorbed by the inline "
    "recovery path")
_DEADLINE_EXCEEDED = telemetry.counter(
    "generation_server_deadline_exceeded_total",
    "requests failed because their deadline elapsed (queue + decode)")
_CANCELLED = telemetry.counter(
    "generation_server_cancelled_total",
    "requests released via handle.cancel() before completion")
# Surgical-recovery series: a recovery that salvages N-1 of N slots is
# routine self-healing; growth in dropped slots is lost caller work.
_KV_SALVAGED = telemetry.counter(
    "kv_slots_salvaged_total",
    "in-flight slots whose KV rows + device state survived a pool "
    "recovery (the requests completed without resubmission)")
_KV_DROPPED = telemetry.counter(
    "kv_slots_dropped_total",
    "in-flight slots failed by a pool recovery (implicated in the "
    "failure, non-finite state, or an unreadable pool)")
# Paged-pool series: the block economy.
_KV_BLK_ALLOC = telemetry.counter(
    "kv_blocks_allocated_total",
    "fresh KV blocks claimed from the pool at admission")
_KV_BLK_FREED = telemetry.counter(
    "kv_blocks_freed_total",
    "KV blocks whose refcount drained at retire/cancel/recovery "
    "(cached blocks stay resident as evictable entries)")
_KV_BLK_SHARED = telemetry.counter(
    "kv_blocks_shared_total",
    "prefix-cache blocks mapped copy-free into an admitted slot's "
    "block table (prefill skipped for these tokens)")
_POOL_FREE = telemetry.gauge(
    "kv_pool_blocks_free",
    "FREE-LIST KV blocks (unclaimed, holding no cache entry); "
    "evictable refcount-0 cache entries are counted in "
    "kv_pool_blocks_evictable")
_POOL_EVICTABLE = telemetry.gauge(
    "kv_pool_blocks_evictable",
    "refcount-0 prefix-cache blocks resident in the device pool "
    "(reclaimable by admission; with a host tier configured an "
    "eviction spills the block instead of dropping it).  Admission "
    "headroom = kv_pool_blocks_free + this")
# Tiered-KV series: the device -> host spill economy.
_TIER_SPILLS = telemetry.counter(
    "kv_tier_spills_total",
    "evicted device prefix-cache blocks spilled to the host-RAM tier "
    "(bytes preserved; the next same-prefix admission pays one "
    "host-to-device copy instead of a re-prefill)")
_TIER_FETCHES = telemetry.counter(
    "kv_tier_fetches_total",
    "KV blocks restored from the host tier into device pool blocks "
    "by an admission (batched: one copy per admission regardless of "
    "block count)")
_TIER_HITS = telemetry.counter(
    "kv_tier_hits_total",
    "admissions whose chain-hash walk missed the device prefix map "
    "but restored >= 1 spilled block from the host tier")
# Disaggregated-serving handoff series: a prefill replica's finished
# prefix blocks shipped into a decode replica (export_prefix ->
# import_blocks).
_HANDOFF_BLOCKS = telemetry.counter(
    "kv_handoff_blocks_total",
    "prefix KV blocks imported from another replica's export "
    "(disaggregated prefill->decode handoff)")
_HANDOFF_BYTES = telemetry.counter(
    "kv_handoff_bytes_total",
    "raw K/V bytes imported through prefix handoffs (at the pool's "
    "element size)")
_PREFIX_HITS = telemetry.counter(
    "prefix_cache_hits_total",
    "admissions that mapped >= 1 cached prefix block (prefill ran "
    "only on the uncached suffix)")
_PREFIX_MISSES = telemetry.counter(
    "prefix_cache_misses_total",
    "admissions with no cached prefix block (full-prompt prefill)")
# Block-granular salvage series.
_KV_BLK_SALVAGED = telemetry.counter(
    "kv_blocks_salvaged_total",
    "KV blocks carried over a pool recovery (kept slots' blocks + "
    "finite prefix-cache blocks)")
_KV_BLK_DROPPED = telemetry.counter(
    "kv_blocks_dropped_total",
    "previously-used KV blocks zeroed by a pool recovery (implicated "
    "slots' private blocks + poisoned cache entries)")
# speculative decode: proposed counts every draft token that could
# commit, accepted the ones the target agreed with — their ratio is the
# health number of a speculative deployment
_SPEC_PROPOSED = telemetry.counter(
    "generation_server_spec_proposed_total",
    "draft tokens proposed for target verification (K per active "
    "slot per speculative round)")
_SPEC_ACCEPTED = telemetry.counter(
    "generation_server_spec_accepted_total",
    "draft proposals the batched target verification accepted")
_SPEC_ACCEPT_RATE = telemetry.gauge(
    "generation_server_spec_acceptance_rate",
    "cumulative accepted/proposed draft-token ratio of the most "
    "recently dispatching speculative server")
_SPEC_ADAPTIVE_K = telemetry.gauge(
    "generation_server_spec_adaptive_k",
    "draft depth K of the most recent speculative dispatch (max over "
    "live slots of the controller's pick or the fixed k, clamped by "
    "set_draft_k_cap)")
_TENANT_SPEC_ACCEPT = telemetry.gauge(
    "generation_server_tenant_spec_acceptance_rate",
    "cumulative per-tenant accepted/proposed draft-token ratio",
    labelnames=("tenant",))
_TP_DEGREE = telemetry.gauge(
    "generation_server_tp_degree",
    "tensor-parallel degree of the most recently constructed server")
# Replica-side half of the request-phase family (the fleet router owns
# the admission/placement/total phases): the spans that build a
# request's trace tree observe these series, so TTFT decomposes into
# replica queue wait + prefill + decode.
_PHASE = telemetry.histogram(
    "fleet_request_phase_seconds",
    "per-request phase wall times (the trace spans' durations)",
    labelnames=("phase",))

#: prefill device-time sampling rate: timing an admission waits on its
#: closing CUDA event inside the scheduler loop, so only 1-in-N
#: admissions pays that wait (the decode tick syncs anyway, so every
#: tick is sampled)
_PROFILE_PREFILL_EVERY = 4

# counter-hash streams of a slot's random draws (see the module docstring)
STREAM_SAMPLE = 0
STREAM_DRAFT = 0x5D
STREAM_ACCEPT = 0xAC


class HeadShardedPool:
    """A KV pool [..., h, block_size, dh] with its head axis split over
    the tp devices and one replica per data row of the slice:
    ``replicas[r][c]`` holds heads ``[c*h/tp, (c+1)*h/tp)`` on device
    (r, c), and ``shards`` is the replica of the row this view reads
    (``own``; :meth:`for_row`).  An int or slice on the leading (layer)
    axis gives the sharded view of those layers; any other read gathers
    the heads of ``shards`` (in shard order) onto its first device, and
    an assignment splits the value's heads over the shards of EVERY
    replica — so the allocator's host-side reads and writes (export,
    spill, restore, prefill scatter) run on it as on one tensor, and
    every data row sees every block."""

    def __init__(self, replicas, own: int = 0):
        self.replicas = [list(r) for r in replicas]
        self.own = own

    @property
    def shards(self):
        return self.replicas[self.own]

    def for_row(self, r: int) -> "HeadShardedPool":
        """The view that reads data row ``r``'s replica."""
        return HeadShardedPool(self.replicas, r)

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        s[-3] = sum(t.shape[-3] for t in self.shards)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    def element_size(self) -> int:
        return self.shards[0].element_size()

    def map(self, fn) -> "HeadShardedPool":
        return HeadShardedPool([[fn(t) for t in r] for r in self.replicas],
                               self.own)

    @staticmethod
    def _on(idx, device):
        if isinstance(idx, tuple):
            return tuple(HeadShardedPool._on(i, device) for i in idx)
        return idx.to(device) if isinstance(idx, torch.Tensor) else idx

    def __getitem__(self, idx):
        if isinstance(idx, (int, slice)):
            return self.map(lambda t: t[idx])
        dev = self.device
        return torch.cat([t[self._on(idx, t.device)].to(dev)
                          for t in self.shards], dim=-3)

    def __setitem__(self, idx, value):
        sizes = [t.shape[-3] for t in self.shards]
        parts = torch.split(value, sizes, dim=-3)
        for r in self.replicas:
            for t, part in zip(r, parts):
                t[self._on(idx, t.device)] = part.to(t.device)


def _pool_where(mask, pool, zero):
    """``torch.where(mask, pool, zero)`` of a pool tensor or a
    :class:`HeadShardedPool`."""
    if isinstance(pool, HeadShardedPool):
        return pool.map(lambda t: torch.where(mask.to(t.device), t,
                                              zero.to(t.device)))
    return torch.where(mask, pool, zero)


def _blocks_finite(kc, vc):
    """[n_blocks] bool (host): every K and V element of the block finite,
    over every layer (and every head shard of every replica)."""
    if isinstance(kc, HeadShardedPool):
        fin = None
        for kr, vr in zip(kc.replicas, vc.replicas):
            for k, v in zip(kr, vr):
                f = _blocks_finite(k, v)
                fin = f if fin is None else fin & f
        return fin
    fin = torch.isfinite(kc) & torch.isfinite(vc)
    return fin.flatten(2).all(dim=2).all(dim=0).cpu().numpy()


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1) — scan lengths quantize to
    powers of two, and a floor (never a ceil) means a drain scan never
    runs ticks past the longest live budget."""
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


def _host_block(x) -> np.ndarray:
    """One block's K or V as a host numpy array: a tensor comes to the
    CPU (bf16 widened to float32 — exact), a numpy array of a dtype
    numpy cannot compute in (the reference's bf16) widens to float32."""
    if torch.is_tensor(x):
        # a COPY: on the CPU ``.to("cpu")`` would alias the pool block
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.asarray(x)
    if x.dtype.kind not in "fiub":
        x = x.astype(np.float32)
    return x


# One admission's block plan (host-side, built under _lock): ``phys`` —
# the slot's physical block ids in table order (cached prefix hits
# first, then the host-tier restore targets, then fresh); ``matched`` —
# how many leading entries the prefill gathers as the cached key prefix
# (device hits PLUS tier restores); ``hashes`` — the prompt's full-block
# chain hashes; ``n_fresh`` — blocks claimed off the free list;
# ``dphys`` / ``dmatched`` — the draft table's blocks and its cached
# prefix hits (speculative servers); ``reg_from`` — the first hash index
# NOT already in the device prefix map (registered after the prefill
# commits); ``fills`` — the host-tier ``(k, v)`` entries to restore,
# aligned with hash indices ``[reg_from, reg_from + len(fills))``.
_AdmitPlan = namedtuple("_AdmitPlan", ("phys", "matched", "hashes",
                                       "n_fresh", "dphys", "reg_from",
                                       "fills", "dmatched"),
                        defaults=((), 0, (), 0))


class RowState:
    """The per-slot device state of a slice with several data rows, placed
    as the reference's ``put_batch`` places it (the slot axis on
    ``data``): ``rows[r]`` is a dict of row r's slots ``[r*n, (r+1)*n)``
    on that row's first device.  The tick runs each row on its own dict;
    a key read (``state[key]``) gathers the rows onto ``device`` — the
    scheduler's host-side reads."""

    def __init__(self, rows, device):
        self.rows = list(rows)
        self.device = device
        self.n = int(self.rows[0]["pos"].shape[0])

    def __getitem__(self, key) -> torch.Tensor:
        return torch.cat([r[key].to(self.device) for r in self.rows])

    def split(self, t: torch.Tensor) -> List[torch.Tensor]:
        """A [B, ...] tensor's slots, row by row on each row's device."""
        n = self.n
        return [t[r * n:(r + 1) * n].to(row["pos"].device)
                for r, row in enumerate(self.rows)]

    def map_rows(self, fn) -> "RowState":
        """``fn(row dict, slot mask piece)`` per row -> a new state."""
        return RowState([fn(r, row) for r, row in enumerate(self.rows)],
                        self.device)


def _kill_slots(state, mask):
    """Zero the remaining budget of masked slots — the device-side
    early-kill for cancelled / deadline-expired requests."""
    if isinstance(state, RowState):
        parts = state.split(mask)
        return state.map_rows(lambda r, row: _kill_slots(row, parts[r]))
    return dict(state, remaining=torch.where(
        mask, torch.zeros_like(state["remaining"]), state["remaining"]))


class _Pending:
    """One submitted request.  ``result()`` blocks the caller; the
    scheduler thread fills ``_result``/``_error`` and sets the event.
    ``ttft`` (seconds) is populated when the first token lands."""

    __slots__ = ("prompt", "n_new", "eos_id", "seed", "temperature",
                 "top_k", "top_p", "t_submit", "deadline", "cancelled",
                 "t0", "emitted", "ttft", "trace_id", "spans",
                 "prefill_only", "tenant", "pkey", "_t_decode",
                 "_result", "_error", "_event")

    def __init__(self, prompt, n_new, eos_id, seed,
                 temperature: float = 0.0, top_k: int = 1,
                 top_p: float = 1.0, deadline: Optional[float] = None,
                 trace_id: Optional[str] = None,
                 prefill_only: bool = False,
                 tenant: str = "default", pkey=None):
        self.prompt = prompt
        self.n_new = n_new
        self.eos_id = eos_id
        self.seed = seed
        self.temperature = temperature   # resolved: <= 0 means greedy
        self.top_k = top_k               # resolved: vocab means "off"
        self.top_p = top_p               # resolved: 1.0 means "off"
        self.t_submit = time.perf_counter()
        self.deadline = deadline         # absolute time.monotonic(), or None
        self.cancelled = False
        self.t0 = len(prompt)
        self.emitted = 0
        self.ttft = None
        self.trace_id = trace_id         # fleet-minted; None standalone
        self.spans = {}                  # phase -> open telemetry.Span
        self.prefill_only = bool(prefill_only)   # disagg: admit +
                                         # prefill + cache-register, then
                                         # retire without a decode tick
        self._t_decode = None
        self.tenant = str(tenant)
        self.pkey = pkey                 # acceptance-controller key part
        self._result = None
        self._error = None
        self._event = threading.Event()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block until the request retires; returns the full sequence
        [t0 + n_emitted] (prompt + generated, EOS included when hit).  A
        ``TimeoutError`` leaves the request LIVE server-side — call
        :meth:`cancel` to release it."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"generation result not ready within {timeout}s "
                f"(the request is still live; cancel() releases it)")
        if self._error is not None:
            raise self._error
        return self._result

    def cancel(self) -> bool:
        """Best-effort cancellation: the scheduler releases the queue
        entry or the slot at the next scan boundary and ``result()``
        raises ``CancelledError``.  False when already completed."""
        if self._event.is_set():
            return False
        self.cancelled = True
        return True

    def close_spans(self, outcome: str) -> None:
        """End every phase span this request still holds (idempotent; any
        thread) — the retire path's close, and the fleet router's when it
        abandons a handle on a dead replica."""
        for phase in ("queue", "prefill", "decode"):
            sp = self.spans.pop(phase, None)
            if sp is not None:
                sp.end(outcome=outcome, emitted=self.emitted)


class GenerationServer:
    """Thread-safe continuous-batching decode server over a causal
    decoder MLN (same stack contract as ``TransformerGenerator``), on
    ``device`` (default ``"cuda"``).

    >>> srv = GenerationServer(net, n_slots=8, max_len=1024)
    >>> out = srv.submit(prompt_ids, n_new=64)           # blocking
    >>> h = srv.submit_async(prompt_ids, n_new=64)       # handle
    >>> out = h.result(); h.ttft                         # seconds
    >>> srv.shutdown(drain=True)                         # finish work

    ``temperature``/``top_k``/``top_p`` are per-request DEFAULTS (greedy
    by default), overridable via ``submit(..., sampling={"temperature":
    .., "top_k": .., "top_p": .., "seed": ..})``; ``eos_id`` per request
    stops decode early the tick the token is emitted.  ``tick_batch``
    fuses up to that many decode ticks per host sync.  ``block_size``,
    ``kv_blocks`` (default ``n_slots * ceil(max_len / block_size)``) and
    ``prefix_cache`` shape the paged pool (a speculative server's
    default ``kv_blocks`` doubles: each slot also holds a draft table).
    ``host_tier_blocks`` > 0 arms the host-RAM tier under the pool
    (spill on eviction, fetch on admission); ``prefill_async`` +
    ``export_prefix`` / ``import_blocks`` ride the same store for
    disaggregated prefill/decode handoff.  ``speculative`` turns on
    speculative decode (module docstring).

    Resilience knobs: ``tick_timeout_s`` (default 30 s, None disables)
    arms the watchdog — the stuck-dispatch deadline scales by the
    dispatch's tick count; ``request_deadline_s`` is the default
    per-request deadline; ``submit_retries`` / ``retry_backoff_s`` retry
    ``RetryableServerError`` in ``submit`` with jittered backoff."""

    def __init__(self, net, n_slots: int = 8,
                 max_len: Optional[int] = None,
                 compute_dtype: Optional[str] = None,
                 temperature: float = 0.0,
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 tick_batch: int = 8,
                 block_size: int = 16,
                 kv_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 host_tier_blocks: int = 0,
                 speculative: Optional[dict] = None,
                 devices=None,
                 tp: Optional[int] = None,
                 queue_limit: int = 1024,
                 tick_timeout_s: Optional[float] = 30.0,
                 request_deadline_s: Optional[float] = None,
                 submit_retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 device="cuda"):
        # a device slice builds the ("data", "tp") shard ctx every
        # dispatch threads through the decode/verify/prefill bodies; the
        # tick's replicated math runs on the slice's first device
        ctx = None
        if devices is not None:
            ctx = TpShardCtx(serving_mesh(devices, tp))
            device = ctx.devices[0]
        self._gen = TransformerGenerator(net, compute_dtype=compute_dtype,
                                         device=device)
        gen = self._gen
        self.device = gen.device
        self.n_slots = int(n_slots)
        if self.n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.max_len = int(max_len or gen.emb.max_len)
        if gen.emb.add_positional and self.max_len > gen.emb.max_len:
            raise ValueError(
                f"max_len {self.max_len} exceeds the model's positional "
                f"table ({gen.emb.max_len} rows)")
        self.block_size = int(block_size)
        if self.block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.max_blocks = -(-self.max_len // self.block_size)
        self._spec = (_speculative.SpecConfig.build(gen, speculative)
                      if speculative is not None else None)
        if self._spec is not None:
            demb = self._spec.draft.gen.emb
            if demb.add_positional and self.max_len > demb.max_len:
                raise ValueError(
                    f"max_len {self.max_len} exceeds the DRAFT model's "
                    f"positional table ({demb.max_len} rows)")
        # a speculative slot pins TWO tables' worth of blocks (target +
        # draft), so the default pool and the one-request floor double
        blocks_per_max = self.max_blocks * (2 if self._spec else 1)
        self.kv_blocks = (int(kv_blocks) if kv_blocks is not None
                          else self.n_slots * blocks_per_max)
        if self.kv_blocks < blocks_per_max:
            raise ValueError(
                f"kv_blocks={self.kv_blocks} cannot hold one max-length "
                f"request ({blocks_per_max} blocks of {self.block_size} "
                "tokens" + (", draft table included)" if self._spec
                            else ")"))
        self.prefix_cache = bool(prefix_cache)
        # host-RAM tier under the device pool: evicted prefix blocks
        # spill here instead of dying.  0 disables spilling;
        # import_blocks() lazily creates a default-sized tier so
        # handoffs work on an unconfigured server too
        self.host_tier_blocks = int(host_tier_blocks or 0)
        if self.host_tier_blocks < 0:
            raise ValueError("host_tier_blocks must be >= 0")
        if self.host_tier_blocks and not self.prefix_cache:
            raise ValueError("host_tier_blocks needs prefix_cache=True "
                             "(the tier stores evicted prefix-cache "
                             "blocks)")
        self._tier = (HostKVTier(self.host_tier_blocks)
                      if self.host_tier_blocks else None)
        if (top_k is not None or top_p is not None) and temperature <= 0:
            raise ValueError("top_k/top_p need temperature > 0 "
                             "(greedy ignores the filtered tail)")
        self._vocab = int(gen._params()[2]["W"].shape[-1])
        if top_k is not None and not 1 <= int(top_k) <= self._vocab:
            raise ValueError(f"top_k={top_k} out of range "
                             f"[1, {self._vocab}] (vocab size)")
        if top_p is not None and not 0.0 < float(top_p) <= 1.0:
            raise ValueError(f"top_p={top_p} out of range (0, 1]")
        self.temperature = float(temperature)
        self.top_k = top_k
        self.top_p = top_p
        self.tick_batch = int(tick_batch)
        if self.tick_batch < 1:
            raise ValueError("tick_batch must be >= 1")
        self.tick_timeout_s = (float(tick_timeout_s)
                               if tick_timeout_s else None)
        self.request_deadline_s = (float(request_deadline_s)
                                   if request_deadline_s else None)
        self.submit_retries = int(submit_retries)
        self.retry_backoff_s = float(retry_backoff_s)
        self._shard = None
        if ctx is not None:
            h = gen.blocks[0].n_heads
            if h % ctx.tp:
                raise ValueError(
                    f"n_heads={h} must divide by tp={ctx.tp} (the KV "
                    "pool's head axis is the tp shard)")
            if self._spec is not None:
                self._spec.draft.check_tp(ctx.tp)
            if self.n_slots % ctx.data:
                raise ValueError(
                    f"n_slots={self.n_slots} must divide by the mesh "
                    f"data axis ({ctx.data}) to shard per-slot state")
            # a one-device slice PINS the replica to that device and
            # keeps the unsharded tick
            self._shard = ctx if ctx.tp * ctx.data > 1 else None
        #: the ctx of each data row of the slice ([None] unsharded)
        self._rows = ([self._shard.row(r) for r in range(self._shard.data)]
                      if self._shard is not None else [None])
        self.tp_degree = ctx.tp if ctx is not None else 1
        #: "type:index" of the replica's devices (profiler attribution)
        self._device_labels = [
            f"{d.type}:{d.index or 0}"
            for d in (ctx.devices if ctx is not None else [self.device])]
        _TP_DEGREE.set(self.tp_degree)

        # Scheduler state shared with the watchdog: _active/_pending/
        # _free, the allocator and the device pool (_kc/_vc/_state)
        # change only under _lock; the epoch token fences a recovered-
        # past scheduler thread out of every commit point.
        self._lock = threading.RLock()
        self._commit_event = None        # CUDA event of the last commit
        self._fresh_pool()
        self._ids = np.zeros((self.n_slots, self.max_len),
                             np.int32)                # host output rows
        self.refresh_params()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=queue_limit)
        self._active = {}                # slot -> request
        self._staged = set()             # in _active, prefill not yet
                                         # COMMITTED — a recovery fails
                                         # these, never salvages them
        self._pending = []               # admitted-order wait line
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._epoch = 0
        self._tick_started = None        # (epoch, monotonic ts, k) while
                                         # a dispatch is in flight
        self._shutdown = False
        self._drain = False
        self._admission_closed = False   # drain(): submits raise
        # per-INSTANCE tallies beside the process-global counters (a
        # router comparing replicas needs the split)
        self._n_prefix_hits = 0
        self._n_prefix_misses = 0
        self._n_tier_spills = 0
        self._n_tier_fetches = 0
        self._n_tier_hits = 0
        # speculative state: the set_spec_enabled switch, this instance's
        # tallies (overall and per tenant), the set_draft_k_cap cap, and
        # the acceptance controller (it observes every speculative
        # server; it picks depths only when the config says adaptive)
        self._spec_off = False
        self._n_spec_proposed = 0
        self._n_spec_accepted = 0
        self._tenant_spec = {}           # tenant -> [proposed, accepted]
        self._draft_k_cap = None
        self._spec_ctl = None
        if self._spec is not None:
            self._spec_ctl = _speculative.AcceptanceController(
                self._spec.k_max,
                draft_cost=self._spec.draft.n_layers / len(gen.blocks))
        self._stop_event = threading.Event()   # ends the watchdog
        # retire prior DEAD servers' health series before adding ours
        for vals, child in _HEALTHY._items():
            if child.value == 0:
                _HEALTHY.remove(*vals)
        self._healthy = _HEALTHY.labels(server=str(next(_SERVER_SEQ)))
        self._worker = threading.Thread(target=self._run, args=(0,),
                                        daemon=True)
        self._worker.start()
        self._healthy.set(1)
        self._watchdog = None
        if self.tick_timeout_s:
            self._watchdog = threading.Thread(target=self._watch,
                                              daemon=True)
            self._watchdog.start()

    def _fresh_pool(self):
        """(Re)allocate the KV block pool and per-slot device state —
        every slot inactive, every block free, the prefix cache empty.
        Also the recovery path's clean rebuild, so it commits under the
        lock (the watchdog may run it while a fenced scheduler still
        holds the old pool)."""
        gen = self._gen
        B = self.n_slots
        h = gen.blocks[0].n_heads
        dh = gen.emb.n_out // h
        n_layers = len(gen.blocks)
        cd, dev = gen.compute_dtype, self.device
        nb = self.kv_blocks + 1      # + block 0, the never-read
                                     # scratch sink for masked writes
        shape = (n_layers, nb, h, self.block_size, dh)
        if self._shard is not None:
            # pool HEADS split over tp (each shard its head slice of
            # every block); the block axis stays GLOBAL, so the host
            # allocator's free view is the whole replica's, and each
            # data row holds a replica (every write reaches all of them)
            hs = h // self._shard.tp
            shard_shape = (n_layers, nb, hs, self.block_size, dh)
            kc, vc = (HeadShardedPool(
                [[torch.zeros(shard_shape, dtype=cd, device=d)
                  for d in row.tp_devices] for row in self._rows])
                for _ in range(2))
        else:
            kc = torch.zeros(shape, dtype=cd, device=dev)
            vc = torch.zeros(shape, dtype=cd, device=dev)
        if len(self._rows) > 1:
            # the per-slot state of each data row on that row's device
            # (the reference's put_batch); the tick reads it in place
            n = B // len(self._rows)
            state = RowState([self._slot_state(n, ctx.devices[0])
                              for ctx in self._rows], dev)
        else:
            state = self._slot_state(B, dev)
        with self._lock:
            self._kc, self._vc, self._state = kc, vc, state
            self._mark_commit_locked()
            self._blocks_free = list(range(self.kv_blocks, 0, -1))
            self._block_ref = np.zeros((nb,), np.int64)
            self._prefix_map = {}        # chain hash -> (pool block id,
                                         #  block token bytes — verified
                                         #  on every hit)
            self._block_hash = {}        # pool block id -> chain hash
            self._evictable = OrderedDict()   # cached ref-0 blocks, LRU
            self._slot_blocks = {}       # slot -> [pool block ids]
            # the DRAFT's prefix cache: same chain hashes, its own map —
            # a block holds either target KV or draft KV, never both;
            # _draft_cached marks the _block_hash entries of this domain
            # (draft blocks never spill: the tier holds target blocks)
            self._dprefix_map = {}       # chain hash -> (blk, tok)
            self._draft_cached = set()
        _POOL_FREE.set(self.kv_blocks)
        _POOL_EVICTABLE.set(0)

    def _slot_state(self, B: int, dev) -> dict:
        """Fresh per-slot device state of ``B`` slots on ``dev``."""
        i32 = dict(dtype=torch.int32, device=dev)
        return {
            "pos": torch.zeros((B,), **i32),           # next write index
            "remaining": torch.zeros((B,), **i32),     # tokens to emit
            "eos": torch.full((B,), -1, **i32),        # -1 disables
            "logits": torch.zeros((B, self._vocab), dtype=torch.float32,
                                  device=dev),
            "seed": torch.zeros((B,), dtype=torch.int64, device=dev),
            # per-slot sampling params: temp <= 0 decodes greedy,
            # tk == vocab and tp == 1.0 are "off"
            "temp": torch.zeros((B,), dtype=torch.float32, device=dev),
            "tk": torch.full((B,), self._vocab, **i32),
            "tp": torch.ones((B,), dtype=torch.float32, device=dev),
            # True while the slot's held "logits" are a rejection
            # residual (log-weights, already shaped): the next draw
            # samples it as it is, without temperature or filters
            "rawlg": torch.zeros((B,), dtype=torch.bool, device=dev),
            # logical block j of slot s lives in pool block table[s, j];
            # 0 = unallocated (scratch)
            "table": torch.zeros((B, self.max_blocks), **i32),
            # the DRAFT's block table (speculative servers): its KV
            # fills the first draft.n_layers pool layers of these blocks
            "dtable": torch.zeros((B, self.max_blocks), **i32),
        }

    def _mark_commit_locked(self) -> None:
        """Record a CUDA event behind the dispatch just committed (caller
        holds the lock): readers of the pool outside the scheduler
        (``export_prefix``) order their reads after it."""
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._commit_event = ev

    # -- public API ----------------------------------------------------
    def refresh_params(self):
        """Snapshot the net's params for serving: on the server's device,
        floating leaves cast ONCE to the compute dtype.  Call again after
        the underlying net's weights change."""
        params = self._gen._serving_params()
        #: one placement per data row of the slice (row 0's serves the
        #: admissions); the tick runs each row on its own
        self._params_rows = [self._place_params(params, c)
                             for c in self._rows]
        self._params = self._params_rows[0]
        if self._spec is not None:
            # a self-draft aliases the target's (placed) tensors; an
            # external draft snapshots its own net, placed here
            self._draft_rows = [
                self._place_params(self._spec.draft.params(p), c)
                for p, c in zip(self._params_rows, self._rows)]
            self._draft_params = self._draft_rows[0]

    @staticmethod
    def _place_params(params, shard):
        """Spread one serving snapshot over the tp devices of one data
        row (``shard``, a row's ctx; identity for None, and for a
        snapshot already placed): each block's q|k|v columns of shard
        c's heads (a list, one block per shard), ``Wo``/``W1``/``W2``
        and the head's ``W`` by output columns and the embedding's ``W``
        by vocab rows (``TpLeaf``s); biases, layer norms and the
        position table on the row's first device.  A weight whose split
        axis tp does not divide stays whole there."""
        emb_p, blk_ps, head_p = params
        if shard is None or (blk_ps and isinstance(blk_ps[0]["Wqkv"],
                                                     list)):
            return params
        tp, devs = shard.tp, shard.tp_devices
        home = lambda p: {k: v.to(devs[0])  # noqa: E731
                          for k, v in p.items()}

        def split(w, kind):
            axis = -1 if kind == "col" else 0
            if w.shape[axis] % tp:
                return w.to(devs[0])
            return TpLeaf([_own_copy(p.contiguous(), d) for p, d in
                           zip(torch.chunk(w, tp, dim=axis), devs)], kind)

        def qkv_cols(w):
            # [.., 3d] = q | k | v; shard c takes its heads' columns of
            # each third
            q, k, v = torch.chunk(w, 3, dim=-1)
            return [_own_copy(torch.cat([z.chunk(tp, dim=-1)[c]
                                         for z in (q, k, v)],
                                        dim=-1).contiguous(), d)
                    for c, d in enumerate(devs)]

        emb_p = dict(home(emb_p), W=split(emb_p["W"], "row"))
        placed = []
        for p in blk_ps:
            p = home(p)
            p["Wqkv"], p["bqkv"] = qkv_cols(p["Wqkv"]), qkv_cols(p["bqkv"])
            for k in ("Wo", "W1", "W2"):
                p[k] = split(p[k], "col")
            placed.append(p)
        head_p = dict(home(head_p), W=split(head_p["W"], "col"))
        return emb_p, placed, head_p

    def healthy(self) -> bool:
        """True while the scheduler thread is alive and not shut down."""
        with self._lock:
            return not self._shutdown and self._worker.is_alive()

    def stats(self) -> dict:
        """ONE lock-consistent snapshot of the serving state: slots,
        queue depth, block headroom (``free_blocks`` = free list +
        evictable cache entries), THIS instance's prefix hit/miss split,
        its host-tier tallies (``tier_*``) and its speculative tallies
        (``spec_*``)."""
        with self._lock:
            return {
                "healthy": (not self._shutdown
                            and self._worker.is_alive()),
                "draining": self._admission_closed or self._shutdown,
                "n_slots": self.n_slots,
                "live_slots": len(self._active),
                "free_slots": len(self._free),
                "queue_depth": len(self._pending) + self._queue.qsize(),
                "block_size": self.block_size,
                "kv_blocks": self.kv_blocks,
                "free_blocks": (len(self._blocks_free)
                                + len(self._evictable)),
                "free_list_blocks": len(self._blocks_free),
                "evictable_blocks": len(self._evictable),
                "cached_blocks": len(self._block_hash),
                "prefix_hits": self._n_prefix_hits,
                "prefix_misses": self._n_prefix_misses,
                "host_tier_blocks": (len(self._tier)
                                     if self._tier is not None else 0),
                "tier_spills": self._n_tier_spills,
                "tier_fetches": self._n_tier_fetches,
                "tier_hits": self._n_tier_hits,
                # speculative view: spec_k > 0 means an admission here
                # pins ~2x blocks (target + draft tables)
                "spec_k": (self._spec.k if self._spec else 0),
                "spec_adaptive": bool(self._spec.adaptive
                                      if self._spec else False),
                "spec_k_max": (self._spec.k_max if self._spec else 0),
                "spec_k_cap": self._draft_k_cap,
                "spec_proposed": self._n_spec_proposed,
                "spec_accepted": self._n_spec_accepted,
                "spec_acceptance_rate": (
                    self._n_spec_accepted / self._n_spec_proposed
                    if self._n_spec_proposed else 0.0),
                "tp": self.tp_degree,
                "devices": list(self._device_labels),
            }

    def prefix_warmth(self, prompt_ids) -> int:
        """Membership probe for prefix-affinity routing: how many of the
        prompt's leading FULL blocks are resident in THIS server's prefix
        cache right now, the host tier continuing the chain (bytes
        verified, nothing mutated, no refcount taken — advisory).  0 when
        the cache is disabled, the prompt is shorter than one full block,
        or nothing matches."""
        if not self.prefix_cache:
            return 0
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            return 0
        hashes = self._chain_hashes(prompt)   # pure — outside the lock
        n = 0
        with self._lock:
            tier = self._tier
            for hsh, tok in hashes:
                entry = self._prefix_map.get(hsh)
                if entry is None or entry[1] != tok:
                    break
                n += 1
            if tier is not None:
                # peek(): a probe must not touch the tier's LRU
                for j in range(n, len(hashes)):
                    hsh, tok = hashes[j]
                    if tier.peek(hsh, tok) is None:
                        break
                    n += 1
        return n

    # -- disaggregated handoff + host tier ------------------------------
    def _ensure_tier(self) -> HostKVTier:
        """The host tier, created on demand for handoff imports on a
        server constructed without ``host_tier_blocks`` (capacity: four
        device pools, so two concurrent handoffs cannot LRU-evict each
        other's chain heads before either admission runs)."""
        with self._lock:
            if self._tier is None:
                self._tier = HostKVTier(max(4 * self.kv_blocks, 1))
            return self._tier

    def export_prefix(self, prompt_ids, max_wait_s: float = 1.0):
        """Serialize the prompt's leading cached full blocks for a
        cross-replica handoff: a list of ``(chain_hash, token_bytes, k,
        v)`` entries, ``k``/``v`` host numpy [n_layers, h, block_size,
        dh] (a bf16 pool's as float32, exactly), readable by
        :meth:`import_blocks` on any replica of the SAME model.
        Device-resident entries are copied to the host; spilled entries
        come straight from the host tier.  Returns as many LEADING blocks
        as are resident right now (possibly none) — whatever was not
        handed off just prefills at the importer.

        Safe against the scheduler: the device blocks are gathered by one
        copy enqueued UNDER the server lock, behind the CUDA event of the
        scheduler's last committed dispatch — a later admission can only
        evict and rewrite one of these blocks after planning under the
        same lock, so its writes are queued behind the gather.
        ``max_wait_s`` is kept for the reference's signature (its reads
        retried against buffers a dispatch had donated; nothing is
        donated here)."""
        del max_wait_s
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            return []
        hashes = self._chain_hashes(prompt)   # pure — outside the lock
        entries, dev_blocks = [], []
        with self._lock:
            tier = self._tier
            for hsh, tok in hashes:
                entry = self._prefix_map.get(hsh)
                if entry is not None and entry[1] == tok:
                    entries.append((hsh, tok, len(dev_blocks)))
                    dev_blocks.append(entry[0])
                    continue
                spilled = (tier.peek(hsh, tok)
                           if tier is not None else None)
                if spilled is None:
                    break               # chain ends here
                entries.append((hsh, tok, spilled))
            if dev_blocks:
                if self._commit_event is not None:
                    torch.cuda.current_stream(self.device).wait_event(
                        self._commit_event)
                idx = torch.as_tensor(dev_blocks, dtype=torch.long,
                                      device=self.device)
                k_dev = self._kc[:, idx]
                v_dev = self._vc[:, idx]
        if dev_blocks:
            k_host = _host_block(k_dev)      # [n_layers, n, h, bs, dh]
            v_host = _host_block(v_dev)
        payload = []
        for hsh, tok, src in entries:
            if isinstance(src, int):
                payload.append((hsh, tok, np.ascontiguousarray(
                    k_host[:, src]), np.ascontiguousarray(v_host[:, src])))
            else:
                payload.append((hsh, tok) + tuple(src))
        return payload

    def import_blocks(self, payload) -> int:
        """Land an :meth:`export_prefix` payload (of this package or the
        reference's) in THIS replica's host tier (creating a
        default-capacity tier on first use): the next admission whose
        prompt chain-hashes onto the entries restores them into pool
        blocks with ONE batched copy and registers them as
        device-resident prefix-cache entries.  Entries whose chain hash
        is already device-resident (verified) are skipped.  Returns how
        many blocks landed."""
        n = n_elems = 0
        tier = None
        for hsh, tok, k, v in payload:
            with self._lock:
                entry = self._prefix_map.get(hsh)
                if entry is not None and entry[1] == tok:
                    continue         # already device-resident here
            if tier is None:
                tier = self._ensure_tier()
            k, v = _host_block(k), _host_block(v)
            tier.put(hsh, tok, k, v)
            n += 1
            n_elems += k.size + v.size
        if n:
            _HANDOFF_BLOCKS.inc(n)
            _HANDOFF_BYTES.inc(n_elems * self._kc.element_size())
        return n

    def drain(self) -> None:
        """Close admission WITHOUT stopping the server: later ``submit*``
        calls raise ``RuntimeError``; queued and in-flight work runs to
        completion, and the scheduler, ``stats()`` and the watchdog stay
        alive.  One-way."""
        with self._lock:
            self._admission_closed = True

    def set_spec_enabled(self, enabled: bool) -> None:
        """Suspend (False) or resume (True) speculative rounds on a live
        server: suspended, dispatches run plain ticks (a held residual is
        still drawn as it is).  The draft state stays resident; resuming
        costs only the acceptance dip of stale draft KV.  A no-op without
        ``speculative=``."""
        with self._lock:
            self._spec_off = not bool(enabled)

    def set_draft_k_cap(self, cap: Optional[int]) -> None:
        """Cap the draft depth on a live server from the next dispatch on
        (both the adaptive controller's pick and a fixed k); ``None``
        lifts the cap.  A no-op without ``speculative=``."""
        with self._lock:
            self._draft_k_cap = (None if cap is None
                                 else max(1, int(cap)))

    def attach_history(self, store) -> None:
        """Attach a metric-history store — any object with ``.rate(series,
        t0, t1)`` — so a cold acceptance controller seeds its estimate
        from the ``generation_server_spec_{proposed,accepted}_total``
        history instead of starting at ``k_max``.  A no-op without
        ``speculative=``."""
        if self._spec_ctl is not None:
            self._spec_ctl.attach_store(store)

    def demote_waiting(self, n_new_factor: Optional[float] = None,
                       force_greedy: bool = False) -> int:
        """Cheapen the NOT-YET-ADMITTED queue in place (the degradation
        ladder's replica-side actuator): scale each waiting request's
        ``n_new`` by ``n_new_factor`` (floor 1, never grown) and/or flip
        it to greedy decode.  Active slots are untouched.  Returns how
        many requests changed."""
        factor = None if n_new_factor is None else float(n_new_factor)
        if factor is not None and not 0.0 < factor <= 1.0:
            raise ValueError("n_new_factor must be in (0, 1]")
        changed = 0
        with self._lock:
            for r in self._pending:
                hit = False
                if factor is not None:
                    capped = max(1, int(r.n_new * factor))
                    if capped < r.n_new:
                        r.n_new = capped
                        hit = True
                if force_greedy and r.temperature > 0.0:
                    r.temperature = 0.0
                    hit = True
                changed += hit
        return changed

    def _resolve_sampling(self, sampling, seed):
        """Merge a per-request ``sampling`` dict over the server-wide
        defaults -> (temperature, effective top_k, effective top_p,
        seed); top_k resolves to the vocab size and top_p to 1.0 ("off")
        so the device-side [B] tensors always hold valid values."""
        samp = dict(sampling or {})
        unknown = set(samp) - {"temperature", "top_k", "top_p", "seed"}
        if unknown:
            raise ValueError(
                f"unknown sampling key(s) {sorted(unknown)} (expected "
                "temperature / top_k / top_p / seed)")
        temp = float(samp.get("temperature", self.temperature))
        tk = samp.get("top_k", None)
        if tk is not None:
            if temp <= 0:
                raise ValueError("sampling top_k needs temperature > 0 "
                                 "(greedy ignores the filtered tail)")
            tk = int(tk)
            if not 1 <= tk <= self._vocab:
                raise ValueError(f"sampling top_k={tk} out of range "
                                 f"[1, {self._vocab}] (vocab size)")
        elif temp > 0 and self.top_k is not None:
            tk = int(self.top_k)
        tp = samp.get("top_p", None)
        if tp is not None:
            if temp <= 0:
                raise ValueError("sampling top_p needs temperature > 0 "
                                 "(greedy ignores the filtered tail)")
            tp = float(tp)
            if not 0.0 < tp <= 1.0:
                raise ValueError(f"sampling top_p={tp} out of range "
                                 "(0, 1]")
        elif temp > 0 and self.top_p is not None:
            tp = float(self.top_p)
        tk_eff = self._vocab if tk is None else tk
        tp_eff = 1.0 if tp is None else tp
        return temp, tk_eff, tp_eff, int(samp.get("seed", seed))

    # -- block allocator + prefix cache (host truth, under _lock) ------
    def _chain_hashes(self, prompt: np.ndarray):
        """(chain hash, block token bytes) per FULL prompt block — h_j
        folds h_{j-1}, so a hit at j certifies the whole prefix through
        j; the raw bytes ride along because a lookup VERIFIES them.
        Capped at t0 - 1 tokens: a fully cached prompt must still
        prefill >= 1 suffix token, because logits come from the suffix
        forward.  The same formula as the reference's, so within one
        process the two packages' handoff payloads interoperate."""
        bs = self.block_size
        hashes, h = [], 0
        for j in range((len(prompt) - 1) // bs):
            tok = prompt[j * bs:(j + 1) * bs].tobytes()
            h = hash((h, tok))
            hashes.append((h, tok))
        return hashes

    def _evict_lru_locked(self) -> None:
        """Evict the LRU refcount-0 cache block back to the free list —
        SPILLING its bytes to the host tier first when one is configured
        (``host_tier_blocks`` > 0: a lazily-created handoff tier does not
        turn spilling on).  The device read runs under the server lock
        on the scheduler thread, behind every dispatch it enqueued."""
        blk, _ = self._evictable.popitem(last=False)
        hsh = self._block_hash.pop(blk)
        if blk in self._draft_cached:
            # draft-domain entry: its own map, never spilled (d cheap
            # layers of re-derivable KV would displace target blocks)
            self._draft_cached.discard(blk)
            self._dprefix_map.pop(hsh, None)
            self._blocks_free.append(blk)
            return
        _, tok = self._prefix_map.pop(hsh)
        if self._tier is not None and self.host_tier_blocks:
            self._tier.put(hsh, tok, _host_block(self._kc[:, blk]),
                           _host_block(self._vc[:, blk]))
            self._n_tier_spills += 1
            _TIER_SPILLS.inc()
            _FLIGHT.record("kv_spill", block=int(blk))
        self._blocks_free.append(blk)

    def _plan_admission_locked(self, req: _Pending):
        """Match cached prefix blocks and claim the rest off the free list
        (evicting LRU cache entries as needed); returns an ``_AdmitPlan``,
        or None when the pool cannot cover the request right now — the
        caller leaves it at the head of the wait line.

        The chain walk is TWO-tier: the device prefix map first, then the
        host tier continues the chain past the device segment — each tier
        hit claims a fresh pool block the admission restores.  A
        mid-chain miss ends the walk: the chain hash at j certifies the
        whole prefix through j, so a gap can never be bridged."""
        bs = self.block_size
        total = -(-(req.t0 + req.n_new) // bs)
        hashes = (self._chain_hashes(req.prompt)
                  if self.prefix_cache else [])
        matched_ids = []
        for hsh, tok in hashes:
            entry = self._prefix_map.get(hsh)
            if entry is None or entry[1] != tok:
                break                # miss — or a hash collision, which
            matched_ids.append(entry[0])   # must NOT map in
        dev_matched = len(matched_ids)
        # host-tier walk: peek() verifies the token bytes WITHOUT the LRU
        # touch (a plan that never commits must not pin its entries MRU;
        # the admit commit touches them)
        fills = []
        if self._tier is not None:
            for j in range(dev_matched, len(hashes)):
                hsh, tok = hashes[j]
                entry = self._tier.peek(hsh, tok)
                if entry is None:
                    break
                fills.append(entry)
        # speculative: the DRAFT's table needs as many blocks, from the
        # same free list.  Its full prompt blocks are prefix-shareable in
        # their own hash domain; the draft walk runs only when the target
        # side hit (both domains register together, so they track).  A
        # prefill-only request never decodes: no draft table at all
        use_draft = self._spec is not None and not req.prefill_only
        dmatched_ids = []
        if use_draft and (dev_matched or fills):
            for hsh, tok in hashes:
                entry = self._dprefix_map.get(hsh)
                if entry is None or entry[1] != tok:
                    break
                dmatched_ids.append(entry[0])
        dmatched = len(dmatched_ids)
        dneed = (total - dmatched) if use_draft else 0
        need = total - dev_matched + dneed
        # matched hits sitting in the evictable LRU are about to be
        # CLAIMED, not evicted — they don't count as reclaimable
        ev_matched = sum(1 for blk in matched_ids + dmatched_ids
                         if self._block_ref[blk] == 0
                         and blk in self._evictable)
        if need > (len(self._blocks_free) + len(self._evictable)
                   - ev_matched):
            return None
        for blk in matched_ids + dmatched_ids:   # claim the hits FIRST
            if self._block_ref[blk] == 0:
                self._evictable.pop(blk, None)
            self._block_ref[blk] += 1
        while need > len(self._blocks_free):
            self._evict_lru_locked()
        fresh = [self._blocks_free.pop() for _ in range(need)]
        for blk in fresh:
            self._block_ref[blk] = 1
        dphys = (dmatched_ids + fresh[need - dneed:]) if use_draft else []
        fresh = fresh[:need - dneed]
        # table order: device hits, then the tier-restore targets (the
        # FIRST len(fills) fresh claims), then the suffix's fresh blocks
        return _AdmitPlan(matched_ids + fresh, dev_matched + len(fills),
                          hashes, len(fresh) + len(dphys) - dmatched,
                          dphys, reg_from=dev_matched,
                          fills=tuple(fills), dmatched=dmatched)

    def _register_prefix_locked(self, plan: _AdmitPlan):
        """After the prefill COMMITS, publish the request's full prompt
        blocks past the device-matched prefix into the prefix cache —
        tier-restored and fresh alike.  Full prompt blocks are never
        written after prefill — decode writes land at pos >= t0 — so
        sharing them is safe by construction."""
        for j in range(plan.reg_from, len(plan.hashes)):
            hsh, tok = plan.hashes[j]
            if hsh in self._prefix_map:
                continue                 # coincident entry stands
            blk = plan.phys[j]
            self._prefix_map[hsh] = (blk, tok)
            self._block_hash[blk] = hsh

    def _register_draft_prefix_locked(self, plan: _AdmitPlan):
        """Publish the DRAFT's new full prompt blocks under the same chain
        hashes, in the draft-domain map.  Draft decode writes land at pos
        >= t0 too, so these blocks are write-free after prefill."""
        for j in range(plan.dmatched,
                       min(len(plan.hashes), len(plan.dphys))):
            hsh, tok = plan.hashes[j]
            if hsh in self._dprefix_map:
                continue                 # coincident entry stands
            blk = plan.dphys[j]
            self._dprefix_map[hsh] = (blk, tok)
            self._block_hash[blk] = hsh
            self._draft_cached.add(blk)

    def _release_slot_blocks_locked(self, slot: int) -> int:
        """Decref a retiring slot's blocks; refcount-0 blocks return to
        the free list, unless prefix-cached — those stay resident as
        evictable LRU entries.  Returns the number of refcount drains."""
        drained = 0
        for blk in self._slot_blocks.pop(slot, ()):
            self._block_ref[blk] -= 1
            if self._block_ref[blk] > 0:
                continue
            drained += 1
            if blk in self._block_hash:
                self._evictable[blk] = None
            else:
                self._blocks_free.append(blk)
        return drained

    def _update_free_gauge(self):
        with self._lock:
            n_free = len(self._blocks_free)
            n_ev = len(self._evictable)
        _POOL_FREE.set(n_free)
        _POOL_EVICTABLE.set(n_ev)

    def _check_open(self) -> None:
        with self._lock:
            if self._shutdown:
                raise RuntimeError("GenerationServer has been shut down")
            if self._admission_closed:
                raise RuntimeError(
                    "GenerationServer is draining (admission closed; "
                    "in-flight work continues)")

    def submit_async(self, prompt_ids, n_new: int,
                     eos_id: Optional[int] = None, seed: int = 0,
                     deadline_s: Optional[float] = None,
                     sampling: Optional[dict] = None,
                     trace_id: Optional[str] = None,
                     tenant: str = "default") -> _Pending:
        """Enqueue one sequence; returns a handle whose ``result()``
        blocks.  ``prompt_ids`` is a 1-D int array; the request decodes
        until ``n_new`` tokens are emitted or ``eos_id`` is sampled.
        ``deadline_s`` bounds the request's total residence, queue wait
        included (``DeadlineExceededError`` past it).  ``trace_id`` tags
        the request's phase spans (the fleet router mints one);
        ``tenant`` keys the speculative acceptance statistics."""
        self._check_open()
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt_ids must be a non-empty 1-D int "
                             f"array, got shape {prompt.shape}")
        n_new = int(n_new)
        if n_new < 1:
            raise ValueError("n_new must be >= 1")
        if len(prompt) + n_new > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) + n_new ({n_new}) exceeds the "
                f"slot cache length ({self.max_len})")
        deadline_s = (self.request_deadline_s if deadline_s is None
                      else float(deadline_s))
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        temp, tk_eff, tp_eff, seed = self._resolve_sampling(sampling, seed)
        # acceptance-controller key part: the first chain hash, so the
        # statistics pool per (tenant, prompt family), not per request
        bs = self.block_size
        pkey = (hash((0, prompt[:bs].tobytes()))
                if len(prompt) - 1 >= bs else None)
        req = _Pending(prompt, n_new,
                       -1 if eos_id is None else int(eos_id), seed,
                       temperature=temp, top_k=tk_eff, top_p=tp_eff,
                       deadline=deadline, trace_id=trace_id,
                       tenant=tenant, pkey=pkey)
        return self._enqueue(req)

    def prefill_async(self, prompt_ids,
                      deadline_s: Optional[float] = None,
                      trace_id: Optional[str] = None) -> _Pending:
        """Enqueue a PREFILL-ONLY request (disaggregated serving): the
        prompt admits into a slot, prefills through the normal
        prefix-cached machinery, registers its full prompt blocks in the
        prefix cache — and retires WITHOUT a decode tick, parking the
        blocks as evictable cache entries.  ``result()`` resolves to the
        prompt itself.  The prefill replica's half of the handoff:
        ``prefill_async(p).result()`` -> :meth:`export_prefix` -> the
        decode replica's :meth:`import_blocks`."""
        if not self.prefix_cache:
            raise ValueError("prefill_async needs prefix_cache=True "
                             "(a prefill-only request's sole product "
                             "is its cached prefix blocks)")
        self._check_open()
        prompt = np.asarray(prompt_ids, np.int32)
        if prompt.ndim != 1 or prompt.size == 0:
            raise ValueError("prompt_ids must be a non-empty 1-D int "
                             f"array, got shape {prompt.shape}")
        if len(prompt) > self.max_len:
            raise ValueError(
                f"prompt ({len(prompt)}) exceeds the slot cache "
                f"length ({self.max_len})")
        deadline_s = (self.request_deadline_s if deadline_s is None
                      else float(deadline_s))
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None else None)
        req = _Pending(prompt, 0, -1, 0, deadline=deadline,
                       trace_id=trace_id, prefill_only=True)
        return self._enqueue(req)

    def _enqueue(self, req: _Pending) -> _Pending:
        """Queue-put shared by ``submit_async`` / ``prefill_async``; opens
        the request's replica-queue span on the caller's thread (the
        scheduler ends it at admission)."""
        args = ({"trace": req.trace_id}
                if req.trace_id is not None else {})
        req.spans["queue"] = telemetry.get_tracer().begin(
            "request/replica_queue", **args)
        while True:
            try:
                self._queue.put(req, timeout=0.1)
                break
            except queue.Full:
                with self._lock:
                    down = self._shutdown
                if down:
                    req.close_spans("rejected")
                    raise RuntimeError(
                        "GenerationServer has been shut down") from None
        with self._lock:
            dead = self._shutdown and not self._worker.is_alive()
        if dead:
            # raced shutdown(): the put may have landed after the
            # worker's final drain — fail leftovers ourselves
            self._fail_leftovers()
        return req

    def submit(self, prompt_ids, n_new: int,
               eos_id: Optional[int] = None, seed: int = 0,
               timeout: Optional[float] = None,
               deadline_s: Optional[float] = None,
               sampling: Optional[dict] = None,
               retries: Optional[int] = None,
               tenant: str = "default") -> np.ndarray:
        """Blocking ``submit_async().result()``.  ``retries`` (default:
        the server's ``submit_retries``) re-submits after a
        ``RetryableServerError`` with full-jitter exponential backoff."""
        retries = self.submit_retries if retries is None else int(retries)

        def attempt():
            return self.submit_async(prompt_ids, n_new, eos_id, seed,
                                     deadline_s=deadline_s,
                                     sampling=sampling,
                                     tenant=tenant).result(timeout)

        if retries <= 0:
            return attempt()
        return retry_call(attempt, retries=retries,
                          base_delay=self.retry_backoff_s,
                          op="generation_server.submit")

    def _fail_leftovers(self):
        """Drain and fail queued requests once the worker is gone."""
        err = RuntimeError("GenerationServer shut down with the "
                           "request in flight")
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                self._retire(item, -1, error=err)

    def shutdown(self, drain: bool = False, timeout: float = 30.0):
        """Stop the scheduler.  Default: in-flight and queued requests fail
        immediately with RuntimeError.  ``drain=True``: admission closes
        but everything already submitted runs to completion first.
        ``timeout`` bounds the wait for the scheduler thread; past it the
        scheduler is fenced out and its requests fail."""
        with self._lock:
            self._drain = bool(drain)
            self._shutdown = True
            worker = self._worker
        self._queue.put(None)
        worker.join(timeout=timeout)
        if worker.is_alive():
            log.warning("GenerationServer scheduler did not exit within "
                        "%.3gs (drain=%s); abandoning it and failing its "
                        "in-flight requests", timeout, drain)
            with self._lock:
                self._epoch += 1     # fence the hung scheduler out
            self._fail_all_in_flight(RuntimeError(
                "GenerationServer shut down while the scheduler was "
                "unresponsive; the request was abandoned in flight"))
        self._stop_event.set()           # the watchdog stands down
        if self._watchdog is not None:
            self._watchdog.join(timeout=5)
        self._fail_leftovers()
        self._healthy.set(0)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- device work ---------------------------------------------------
    def _sampler(self, sampled: bool):
        """Token chooser for the tick (and a speculative round's anchor):
        the all-greedy variant is a plain argmax; the sampled variant
        applies each slot's temperature / top-k / top-p and draws by
        Gumbel-max with the slot's (seed, ``STREAM_SAMPLE``, position)
        noise — greedy rows take the argmax out of the same batch, and a
        row holding a rejection residual (``rawlg``) draws from it as it
        is (re-shaping it would break the rejection-sampling law)."""

        def pick_greedy(state):
            return torch.argmax(state["logits"], dim=-1)

        def pick_sampled(state):
            temp = state["temp"]
            safe = torch.where(temp > 0, temp, torch.ones_like(temp))
            lg = _filter_logits_rows(state["logits"] / safe[:, None],
                                     state["tk"], state["tp"])
            raw = state["rawlg"]
            lg = torch.where(raw[:, None], state["logits"], lg)
            noise = _gumbel_rows(state["seed"],
                                 torch.full_like(state["seed"],
                                                 STREAM_SAMPLE),
                                 state["pos"].long(), self._vocab)
            cand = torch.argmax(lg + noise, dim=-1)
            return torch.where((temp > 0) | raw, cand,
                               torch.argmax(state["logits"], dim=-1))

        return pick_sampled if sampled else pick_greedy

    def _row_step(self, step, params_rows, kc, vc, r: int = 0):
        """``step(*params, kc, vc, *rows, shard)`` — a decode step or a
        verify pass of the generator — bound to data row ``r``: that
        row's placement of the params, its replica of the pool (the pool
        writes reach every replica) and its ctx; called on the row's own
        per-slot tensors, it returns their logits on the row's device."""
        if len(self._rows) == 1:
            ctx = self._shard
        else:
            ctx, kc, vc = self._rows[r], kc.for_row(r), vc.for_row(r)
        params = params_rows[r]
        return lambda *rows: step(*params, kc, vc, *rows, ctx)[0]

    def _each_row(self, state, run):
        """``run(r, row state)`` -> (new row state, *[B_r, ...] outputs)
        over the slice's data rows: each row on its own state (a
        :class:`RowState`) with no copy in; the outputs come back in
        slot order on the first device.  One call without data rows."""
        if not isinstance(state, RowState):
            return run(0, state)
        parts = [run(r, row) for r, row in enumerate(state.rows)]
        out = [RowState([p[0] for p in parts], state.device)]
        for i in range(1, len(parts[0])):
            out.append(torch.cat([p[i].to(state.device) for p in parts]))
        return tuple(out)

    def _decode_scan(self, K: int, sampled: bool, kc, vc, state):
        """K decode ticks over every data row (:meth:`_decode_row`)."""
        gen = self._gen
        return self._each_row(state, lambda r, st: self._decode_row(
            K, sampled, self._row_step(gen._step_paged, self._params_rows,
                                       kc, vc, r), st))

    def _decode_row(self, K: int, sampled: bool, step, state):
        """K decode ticks back to back on the device, nothing read back:
        each tick samples every active slot's next token from its held
        logits, writes it at the slot's (block, offset) through its table
        (pools updated in place), advances every slot one step, decrements
        budgets, zeroes the budget on EOS.  Inactive slots (free, or
        retired MID-SCAN by EOS / budget) write the scratch block 0 at
        position 0, not their stale pos: a finished max-length request
        parks pos == max_len, past the positional table.

        Returns ``(state, tokens [B, K], emitted [B])`` — ``emitted``
        counts each slot's live ticks so the host unpacks exactly the
        tokens that were really generated."""
        pick = self._sampler(sampled)
        bs = self.block_size
        emitted = torch.zeros_like(state["remaining"])
        toks = []
        for _ in range(K):
            active = state["remaining"] > 0
            tok = torch.where(active, pick(state), 0)
            pos = torch.where(active, state["pos"], 0)
            tbl = state["table"]
            bidx = tbl.gather(1, (pos // bs).long()[:, None])[:, 0]
            wblk = torch.where(active, bidx, 0)
            woff = torch.where(active, pos % bs, 0)
            new_logits = step(tok, pos, tbl, wblk, woff)
            hit_eos = active & (tok == state["eos"])
            remaining = torch.where(active, state["remaining"] - 1, 0)
            remaining = torch.where(hit_eos, 0, remaining)
            state = dict(
                state,
                pos=torch.where(active, state["pos"] + 1, state["pos"]),
                remaining=remaining,
                logits=torch.where(active[:, None], new_logits,
                                   state["logits"]),
                # a held residual is consumed by its slot's first draw
                rawlg=state["rawlg"] & ~active)
            emitted = emitted + active.to(emitted.dtype)
            toks.append(tok)
        return state, torch.stack(toks, dim=1), emitted

    def _spec_rounds(self, R: int, K: int, sampled: bool, kc, vc, state,
                     kcap):
        """R speculative rounds over every data row
        (:meth:`_spec_row`)."""
        gen, dgen = self._gen, self._spec.draft.gen
        d = self._spec.draft.n_layers
        kcaps = (state.split(kcap) if isinstance(state, RowState)
                 else [kcap])
        return self._each_row(state, lambda r, st: self._spec_row(
            R, K, sampled,
            self._row_step(dgen._step_paged, self._draft_rows, kc[:d],
                           vc[:d], r),
            self._row_step(gen._verify_rows_paged, self._params_rows, kc,
                           vc, r), st, kcaps[r]))

    def _spec_row(self, R: int, K: int, sampled: bool, draft_step,
                  verify_step, state, kcap):
        """R speculative rounds back to back on the device, nothing read
        back (the speculative analogue of ``_decode_scan``).  ``K`` is the
        dispatch's draft depth (the pool max), ``kcap`` [B] int32 each
        slot's own depth — proposals past it never commit.  A round:

        * anchor: ``_sampler``'s pick from the held logits (argmax, a
          filtered draw, or a draw from a held residual);
        * draft: W = K+1 single-token steps of the draft through its
          table (pool layers [:d]); step j consumes chunk token v_j at
          pos+j and proposes v_{j+1} — argmax for greedy rows, a draw
          from the draft's filtered distribution (``STREAM_DRAFT`` at the
          proposal's position) for sampled ones.  The last proposal is
          discarded; its K/V write keeps the draft context whole;
        * verify: one W-token target pass (``_verify_rows_paged``);
          chunk rows past a slot's budget write the scratch block 0 with
          embed position 0;
        * accept: ``accept_greedy``, or ``accept_mixed`` when sampled
          rows ride along (uniforms from ``STREAM_ACCEPT`` at each
          proposal's position); a genuine rejection holds the residual
          as the slot's logits with ``rawlg`` set.  ``pos`` advances
          over the committed tokens only; rejected rows are overwritten
          by the next round.

        Returns ``(state, tokens [B, R*W], emitted [B], proposed [B],
        accepted [B])`` — committed tokens staged at each slot's cursor,
        per-slot commit counts, and per-slot proposal tallies (proposals
        that could commit: past a committed EOS nothing counts)."""
        pick = self._sampler(sampled)
        B, dev = state["pos"].shape[0], state["pos"].device
        W, bs = K + 1, self.block_size
        jidx = torch.arange(W, device=dev)[None, :]
        rows = torch.arange(B, device=dev)
        zeros = torch.zeros((B,), dtype=torch.int32, device=dev)
        staged = torch.zeros((B, R * W + 1), dtype=torch.int32, device=dev)
        emitted, prop, acc = zeros, zeros, zeros
        for _ in range(R):
            active = state["remaining"] > 0
            pos, rem = state["pos"], state["remaining"]
            tbl, dtbl = state["table"], state["dtable"]
            temp, tk, tp = state["temp"], state["tk"], state["tp"]
            seed = state["seed"]
            greedy_row = temp <= 0.0
            tok = torch.where(active, pick(state), 0)
            consumed, dlps = [], []
            for j in range(W):
                ok = active & (j < rem)
                p = torch.where(ok, pos + j, 0)
                bidx = dtbl.gather(1, (p // bs).long()[:, None])[:, 0]
                lg = draft_step(tok, p, dtbl, torch.where(ok, bidx, 0),
                                torch.where(ok, p % bs, 0))
                consumed.append(tok)
                if j == K:               # the discarded last proposal
                    break
                nxt = torch.argmax(lg, dim=-1)
                if sampled:
                    dlp = _filtered_logprobs_rows(lg, temp, tk, tp)
                    noise = _gumbel_rows(
                        seed, torch.full_like(seed, STREAM_DRAFT),
                        (pos + j + 1).long(), self._vocab)
                    nxt = torch.where(greedy_row, nxt,
                                      torch.argmax(dlp + noise, dim=-1))
                    dlps.append(dlp)
                tok = torch.where(ok, nxt, 0)
            v = torch.stack(consumed, dim=1)                  # [B, W]

            okv = active[:, None] & (jidx < rem[:, None])
            p = pos[:, None] + jidx
            bidx = tbl.gather(1, torch.where(okv, p // bs, 0).long())
            G = verify_step(
                torch.where(okv, v, 0), torch.where(active, pos, 0),
                torch.where(okv, p, 0), tbl, torch.where(okv, bidx, 0),
                torch.where(okv, p % bs, 0))
            g = torch.argmax(G, dim=-1)
            if sampled:
                # the target's filtered law at each proposal's position
                # (G_j judges v_{j+1}) and the draft's, [B, K, V]
                Pf = torch.stack([_filtered_logprobs_rows(G[:, j], temp,
                                                          tk, tp)
                                  for j in range(K)], dim=1)
                Qf = torch.stack(dlps, dim=1)
                ptok = v[:, 1:, None].long()
                u = torch.stack([_uniform_rows(
                    seed, torch.full_like(seed, STREAM_ACCEPT),
                    (pos + j + 1).long()) for j in range(K)], dim=1)
                c, rem_after, n_eval, rej = _speculative.accept_mixed(
                    greedy_row, v, g, Pf.gather(2, ptok)[..., 0],
                    Qf.gather(2, ptok)[..., 0], u, active, rem,
                    state["eos"], kcap=kcap)
            else:
                c, rem_after = _speculative.accept_greedy(
                    v, g, active, rem, state["eos"], kcap=kcap)
                n_eval = torch.where(
                    active, _speculative.n_evaluable(rem, K, kcap), 0)
                rej = torch.zeros_like(active)
            new_logits = G[rows, torch.clamp(c - 1, min=0).long()]
            rawlg = state["rawlg"]
            if sampled:
                ridx = torch.clamp(c - 1, 0, K - 1).long()
                # -inf zeros clamped to a finite floor: exp(-1e30) is
                # exactly 0 in f32, so the draw is the same
                res = torch.clamp(_speculative.residual_logits(
                    Pf[rows, ridx], Qf[rows, ridx]), min=-1e30)
                new_logits = torch.where(rej[:, None], res, new_logits)
                rawlg = torch.where(active, rej, rawlg)
            state = dict(
                state,
                pos=torch.where(active, pos + c, pos),
                remaining=torch.where(active, rem_after, rem),
                logits=torch.where(active[:, None], new_logits,
                                   state["logits"]),
                rawlg=rawlg)
            # stage the commits at each slot's cursor; uncommitted
            # columns dump into the extra last column
            keep = active[:, None] & (jidx < c[:, None])
            cols = torch.where(keep, emitted[:, None] + jidx, R * W)
            staged[rows[:, None], cols.long()] = v.to(torch.int32)
            emitted = emitted + c
            # after a committed EOS the rest of the chunk was flushed,
            # not rejected: only the proposals before it count
            prop_i = torch.where((rem_after == 0) & (c < rem),
                                 torch.clamp(c - 1, min=0), n_eval)
            prop = prop + torch.where(active, prop_i, 0)
            acc = acc + torch.clamp(c - 1, min=0)
        return state, staged[:, :R * W], emitted, prop, acc

    def _scatter_rows(self, pool, rows, phys):
        """Scatter prefill K/V rows into pool blocks IN PLACE: ``rows``
        [n_layers, 1, h, T, dh] with T a block-size multiple, ``phys``
        [T // block_size] physical block ids (entries past the slot's
        allocation at the scratch block 0 — pad rows land there)."""
        bs = self.block_size
        nl, _, h, T, dh = rows.shape
        blocks = rows[:, 0].reshape(nl, h, T // bs, bs, dh) \
                           .permute(0, 2, 1, 3, 4)
        pool[:nl, phys] = blocks

    def _arm_slot(self, state, logits, slot, req, plan):
        """Slot device-state update shared by both admission paths (on
        copies of the [B] tensors — a concurrent reader of the committed
        state never sees a half-armed slot).  With data rows only the
        slot's row is copied and armed."""
        if isinstance(state, RowState):
            r, i = divmod(slot, state.n)
            return state.map_rows(lambda j, row: row if j != r else
                                  self._arm_slot(row, logits, i, req, plan))
        st = {k: v.clone() for k, v in state.items()}
        st["pos"][slot] = req.t0
        st["remaining"][slot] = req.n_new
        st["eos"][slot] = req.eos_id
        st["logits"][slot] = logits[0].to(st["logits"].device)
        st["seed"][slot] = req.seed
        st["temp"][slot] = req.temperature
        st["tk"][slot] = req.top_k
        st["tp"][slot] = req.top_p
        st["rawlg"][slot] = False
        for key, ids in (("table", plan.phys), ("dtable", plan.dphys)):
            row = np.zeros((self.max_blocks,), np.int32)
            row[:len(ids)] = ids
            st[key][slot] = torch.as_tensor(row, device=st[key].device)
        return st

    def _scatter_ids(self, ids, n: int):
        """The first ``n`` of a table's block ids as a scatter target, the
        scratch block 0 past its allocation (pad rows land there)."""
        out = np.zeros((n,), np.int64)
        head = ids[:n]
        out[:len(head)] = head
        return torch.as_tensor(out, device=self.device)

    def _prefill_full(self, gen, params, kc, vc, req, ids):
        """Prefix-MISS prefill: batched causal prefill of the whole prompt
        padded to its power-of-two bucket (a block-size multiple), K/V
        rows scattered into the table's blocks ``ids`` (the first
        ``len(params[1])`` pool layers).  Returns the logits at t0 - 1."""
        bs = self.block_size
        tb = -(-_bucket(req.t0, self.max_len) // bs) * bs
        padded = np.zeros((1, tb), np.int64)
        padded[0, :req.t0] = req.prompt
        logits, ks, vs = gen._prefill_rows(
            *params, torch.as_tensor(padded, device=self.device), req.t0,
            self._shard)
        phys = self._scatter_ids(ids, tb // bs)
        self._scatter_rows(kc, ks, phys)
        self._scatter_rows(vc, vs, phys)
        return logits

    def _prefill_suffix(self, gen, params, kc, vc, req, ids, matched: int):
        """Prefix-HIT prefill: gather the ``matched`` cached blocks as the
        key prefix — EXACT length, never padded inside the key axis —
        chunk-prefill ONLY the suffix (padded to its bucket) and scatter
        its K/V into the table's next blocks.  Returns the logits at
        t0 - 1."""
        bs = self.block_size
        p0 = matched * bs
        suffix = req.prompt[p0:]
        sb = -(-_bucket(len(suffix), self.max_len) // bs) * bs
        padded = np.zeros((1, sb), np.int64)
        padded[0, :len(suffix)] = suffix
        nl = len(params[1])
        _, _, h, _, dh = kc.shape
        prefix = torch.as_tensor(np.asarray(ids[:matched], np.int64),
                                 device=self.device)

        def gather(pool):
            return pool[:nl, prefix].permute(0, 2, 1, 3, 4) \
                .reshape(nl, 1, h, p0, dh)

        logits, ks, vs = gen._prefill_rows_chunked(
            *params, torch.as_tensor(padded, device=self.device),
            gather(kc), gather(vc), p0, req.t0 - p0 - 1, self._shard)
        phys = self._scatter_ids(ids[matched:], sb // bs)
        self._scatter_rows(kc, ks, phys)
        self._scatter_rows(vc, vs, phys)
        return logits

    def _restore_fills(self, kc, vc, plan):
        """Host-tier restore: ONE batched host-to-device copy per cache
        side writes the plan's spilled blocks into their fresh pool
        blocks (``phys[reg_from:reg_from + len(fills)]``), in place,
        before the suffix prefill gathers them as key prefix."""
        n = len(plan.fills)
        ids = torch.as_tensor(
            np.asarray(plan.phys[plan.reg_from:plan.reg_from + n],
                       np.int64), device=self.device)
        for pool, side in ((kc, 0), (vc, 1)):
            blocks = np.stack([f[side] for f in plan.fills], axis=1)
            pool[:, ids] = torch.as_tensor(blocks, device=self.device) \
                .to(pool.dtype)

    def _admit_fn(self, kc, vc, state, req, slot, plan):
        """One admission's device work: the host-tier restore (if any),
        the target's prefill (suffix-only on a prefix hit), the draft's
        on a speculative server (suffix-only on a draft-domain hit; its
        logits are unused — rounds re-feed from the anchor), then the
        slot armed.  A prefill-only request claims no draft table."""
        if plan.fills:
            self._restore_fills(kc, vc, plan)
        if plan.matched:
            logits = self._prefill_suffix(self._gen, self._params, kc, vc,
                                          req, plan.phys, plan.matched)
        else:
            logits = self._prefill_full(self._gen, self._params, kc, vc,
                                        req, plan.phys)
        if self._spec is not None and plan.dphys:
            dgen, dparams = self._spec.draft.gen, self._draft_params
            if plan.dmatched:
                self._prefill_suffix(dgen, dparams, kc, vc, req,
                                     plan.dphys, plan.dmatched)
            else:
                self._prefill_full(dgen, dparams, kc, vc, req, plan.dphys)
        return self._arm_slot(state, logits, slot, req, plan)

    # -- scheduler -----------------------------------------------------
    def _admit(self, req: _Pending, slot: int, plan: _AdmitPlan,
               my_epoch: int) -> bool:
        """Prefill dispatch + commit (pool, slot state, prefix cache);
        returns False when a watchdog recovery superseded this scheduler
        mid-admission (the caller exits without touching shared state —
        the recovery already reconciled the allocator)."""
        with self._lock:
            kc, vc, state = self._kc, self._vc, self._state
        # device-phase sample: 1-in-N admissions waits on its closing
        # event, the rest stay asynchronous
        with telemetry.get_profiler().measure(
                "prefill", every=_PROFILE_PREFILL_EVERY,
                devices=self._device_labels):
            state = self._admit_fn(kc, vc, state, req, slot, plan)
        n_fills = len(plan.fills)
        with self._lock:
            if self._epoch != my_epoch:
                return False
            self._state = state
            self._mark_commit_locked()
            self._staged.discard(slot)   # prefill committed: the slot's
                                         # device rows are this request's
            self._ids[slot, :req.t0] = req.prompt
            if self.prefix_cache:
                self._register_prefix_locked(plan)
                if plan.dphys:
                    self._register_draft_prefix_locked(plan)
            if plan.matched:
                self._n_prefix_hits += 1
            else:
                self._n_prefix_misses += 1
            if n_fills:
                self._n_tier_fetches += n_fills
                self._n_tier_hits += 1
                if self._tier is not None:
                    # LRU touch at COMMIT, not at plan time (peek)
                    for j in range(plan.reg_from, plan.reg_from + n_fills):
                        self._tier.touch(plan.hashes[j][0])
        _ADMITTED.inc()
        _FLIGHT.record("admit", slot=slot, trace=req.trace_id, t0=req.t0,
                       n_new=req.n_new, cached=plan.matched,
                       tier_fills=n_fills,
                       prefill_only=bool(req.prefill_only))
        if n_fills:
            _FLIGHT.record("kv_fetch", slot=slot, blocks=n_fills)
        if plan.matched:
            _PREFIX_HITS.inc()
            # device-map hits are copy-free shares; tier restores are
            # fetches, not shares
            if plan.matched > n_fills:
                _KV_BLK_SHARED.inc(plan.matched - n_fills)
            if n_fills:
                _TIER_FETCHES.inc(n_fills)
                _TIER_HITS.inc()
        else:
            _PREFIX_MISSES.inc()
        if plan.n_fresh:
            _KV_BLK_ALLOC.inc(plan.n_fresh)
        self._update_free_gauge()
        return True

    def _retire(self, req: _Pending, slot: int, error=None):
        if error is not None:
            req._error = error
        else:
            with self._lock:
                req._result = self._ids[slot,
                                        :req.t0 + req.emitted].copy()
            dt = time.perf_counter() - req.t_submit
            # prefill-only retires emit nothing by design: a 0.0 sample
            # per staged request would drag tokens/s percentiles to 0
            if dt > 0 and not req.prefill_only:
                _RATE.observe(req.emitted / dt)
        # close every phase span the request still holds, on whatever
        # thread retires it (scheduler, watchdog recovery, shutdown)
        if req._t_decode is not None and "decode" in req.spans:
            _PHASE.labels(phase="decode").observe(
                time.perf_counter() - req._t_decode)
        req.close_spans("ok" if error is None else type(error).__name__)
        _RETIRED.inc()
        _FLIGHT.record("retire", slot=slot, trace=req.trace_id,
                       emitted=req.emitted,
                       error=(None if error is None
                              else type(error).__name__))
        req._event.set()

    def _reap_pending_locked(self, now: float):
        """Drop cancelled / deadline-expired requests from the wait line
        (caller holds the lock); returns the victims to retire outside
        it."""
        keep, victims = [], []
        for req in self._pending:
            if req.cancelled:
                victims.append((req, "cancel"))
            elif req.deadline is not None and now > req.deadline:
                victims.append((req, "deadline"))
            else:
                keep.append(req)
        self._pending = keep
        return victims

    def _retire_reaped(self, victims):
        for req, why in victims:
            if why == "cancel":
                _CANCELLED.inc()
                self._retire(req, -1, error=CancelledError(
                    "generation request cancelled"))
            else:
                _DEADLINE_EXCEEDED.inc()
                self._retire(req, -1, error=DeadlineExceededError(
                    "generation request deadline elapsed before "
                    "completion"))

    def _superseded(self, my_epoch: int) -> bool:
        """True when a watchdog recovery bumped the epoch past this
        scheduler (locked read — the fence must not be torn)."""
        with self._lock:
            return self._epoch != my_epoch

    def _mark_tick(self, my_epoch: int, value) -> None:
        """Set/clear the in-flight dispatch record ``(epoch, started,
        k)`` while this scheduler still owns the epoch.  ``k`` is the
        dispatch's tick count: the watchdog scales its deadline by it."""
        with self._lock:
            if self._epoch == my_epoch:
                self._tick_started = value

    def _fail_all_in_flight(self, err) -> None:
        """Clear active + pending under the lock and fail every caller
        (the SHUTDOWN teardown — recoveries salvage through
        :meth:`_recover_pool`)."""
        with self._lock:
            victims = list(self._active.values()) + list(self._pending)
            self._active.clear()
            self._staged.clear()
            self._pending = []
            self._free = list(range(self.n_slots - 1, -1, -1))
            for slot in list(self._slot_blocks):
                self._release_slot_blocks_locked(slot)
        for req in victims:
            self._retire(req, -1, error=err)
        self._update_free_gauge()
        _SLOTS_BUSY.set(0)
        _QDEPTH.set(self._queue.qsize())

    def _salvage_pool_locked(self, keep, blk_fin):
        """The block-granular salvage copy (caller holds the lock): a NEW
        pool holding the kept slots' blocks and the finite prefix-cache
        blocks, every other block zero, and new per-slot state keeping
        the kept slots' rows.  Poisoned cache entries leave the maps
        first.  Returns the bool block mask of what was carried over."""
        for b in [b for b in self._block_hash if not bool(blk_fin[b])]:
            hsh = self._block_hash.pop(b)
            if b in self._draft_cached:
                self._draft_cached.discard(b)
                self._dprefix_map.pop(hsh, None)
            else:
                del self._prefix_map[hsh]
            self._evictable.pop(b, None)
            if self._block_ref[b] == 0:
                self._blocks_free.append(b)
        bmask = np.zeros((self.kv_blocks + 1,), bool)
        for s in keep:
            bmask[self._slot_blocks.get(s, ())] = True
        for b in self._block_hash:
            bmask[b] = True
        dev = self.device
        bm = torch.as_tensor(bmask, device=dev)[:, None, None, None]
        zero = torch.zeros((), dtype=self._kc.dtype, device=dev)
        kc = _pool_where(bm, self._kc, zero)
        vc = _pool_where(bm, self._vc, zero)
        mask = np.zeros((self.n_slots,), bool)
        mask[keep] = True
        m = torch.as_tensor(mask, device=dev)
        fills = {"pos": 0, "remaining": 0, "eos": -1, "logits": 0.0,
                 "seed": 0, "temp": 0.0, "tk": self._vocab, "tp": 1.0,
                 "rawlg": False, "table": 0, "dtable": 0}

        def keep_rows(row, m):
            out = {}
            for key, x in row.items():
                mm = m.view(-1, *([1] * (x.dim() - 1)))
                out[key] = torch.where(mm, x,
                                       torch.full_like(x, fills[key]))
            return out
        state = self._state
        if isinstance(state, RowState):
            parts = state.split(m)
            state = state.map_rows(lambda r, row: keep_rows(row, parts[r]))
        else:
            state = keep_rows(state, m)
        self._kc, self._vc, self._state = kc, vc, state
        self._mark_commit_locked()
        return bmask

    def _recover_pool(self, my_epoch: int, err,
                      implicated=frozenset()) -> bool:
        """Surgical pool recovery: keep the KV blocks + per-slot device
        state of active slots NOT implicated in the failure, copied into
        a NEW pool (with the finite prefix-cache blocks, so the cache
        stays warm), and fail ONLY the implicated slots — unaffected
        in-flight requests keep their slot, their emitted prefix and
        their sampling stream, and complete without resubmission.

        A slot is implicated when (a) the caller names it (the admission
        that raised), (b) its prefill never committed (staged), (c) its
        request was cancelled or its deadline passed, or (d) one of its
        own blocks or its held logits is non-finite.  The finiteness
        screen runs per pool BLOCK.  When the pool cannot be read at all
        (a CUDA error) every active slot drops and the pool is rebuilt.

        The copy is what keeps a superseded scheduler harmless: it still
        holds the old pool tensors and may write them when it wakes, but
        no block of the new pool is reachable from it.  Queued requests
        hold no pool state and wait the recovery out.  Returns False when
        a concurrent recovery superseded ``my_epoch``."""
        to_fail = []
        keep = []
        n_blk_salvaged = n_blk_dropped = 0
        with self._lock:
            if self._epoch != my_epoch:
                return False
            kc, vc, state = self._kc, self._vc, self._state
            try:
                blk_fin = _blocks_finite(kc, vc)
                log_fin = torch.isfinite(state["logits"]).all(dim=1) \
                    .cpu().numpy()
                pos_h = state["pos"].cpu().numpy()
                rem_h = state["remaining"].cpu().numpy()
                pool_alive = True
            except RuntimeError:
                pool_alive = False   # a CUDA error: nothing is readable
            now = time.monotonic()
            victims = {}                     # slot -> why
            for slot, req in self._active.items():
                blocks = self._slot_blocks.get(slot, ())
                if not pool_alive:
                    victims[slot] = "unrecoverable"
                elif slot in implicated:
                    victims[slot] = "implicated"
                elif slot in self._staged:
                    # its prefill never COMMITTED: the device rows are a
                    # previous occupant's — fail retryably
                    victims[slot] = "unadmitted"
                elif req.cancelled:
                    victims[slot] = "cancelled"
                elif req.deadline is not None and now > req.deadline:
                    victims[slot] = "deadline"
                elif not (bool(log_fin[slot])
                          and all(bool(blk_fin[b]) for b in blocks)):
                    victims[slot] = "poisoned"
                elif pos_h[slot] == 0 and rem_h[slot] == 0:
                    victims[slot] = "unadmitted"
            keep = sorted(s for s in self._active if s not in victims)
            used_before = set(self._block_hash)
            for s in self._active:
                used_before.update(self._slot_blocks.get(s, ()))
            if pool_alive and keep:
                try:
                    bmask = self._salvage_pool_locked(keep, blk_fin)
                    n_blk_salvaged = int(bmask.sum())
                    n_blk_dropped = len(used_before
                                        - set(np.nonzero(bmask)[0]))
                except RuntimeError:
                    # the copy itself failed: demote every kept slot
                    for slot in keep:
                        victims[slot] = "unrecoverable"
                    keep = []
                    self._fresh_pool()
                    n_blk_dropped = len(used_before)
            else:
                # nothing to keep (or nothing readable): clean rebuild,
                # allocator and prefix cache with it (RLock: the
                # rebuild's own commit nests in this section)
                self._fresh_pool()
                n_blk_dropped = len(used_before)
            for slot, why in victims.items():
                to_fail.append((self._active.pop(slot), why))
                # reconcile the allocator (a no-op after a rebuild)
                self._release_slot_blocks_locked(slot)
            self._staged.clear()
            self._free = [s for s in range(self.n_slots - 1, -1, -1)
                          if s not in self._active]
            n_active = len(self._active)
            n_pending = len(self._pending)
        if keep:
            _KV_SALVAGED.inc(len(keep))
        if to_fail:
            _KV_DROPPED.inc(len(to_fail))
        if n_blk_salvaged:
            _KV_BLK_SALVAGED.inc(n_blk_salvaged)
        if n_blk_dropped:
            _KV_BLK_DROPPED.inc(n_blk_dropped)
        self._update_free_gauge()
        log.warning("pool recovery: salvaged %d in-flight slot(s) %s "
                    "(%d block(s)), dropped %d (%s; %d block(s))",
                    len(keep), keep, n_blk_salvaged, len(to_fail),
                    ", ".join(why for _, why in to_fail) or "none",
                    n_blk_dropped)
        for req, why in to_fail:
            if why == "cancelled":
                _CANCELLED.inc()
                self._retire(req, -1, error=CancelledError(
                    "generation request cancelled"))
            elif why == "deadline":
                _DEADLINE_EXCEEDED.inc()
                self._retire(req, -1, error=DeadlineExceededError(
                    "generation request deadline elapsed before "
                    "completion"))
            else:
                self._retire(req, -1, error=err)
        _SLOTS_BUSY.set(n_active)
        _QDEPTH.set(n_pending + self._queue.qsize())
        return True

    def _run(self, my_epoch: int):
        with torch.no_grad():
            self._loop(my_epoch)

    def _ingest(self, item, my_epoch: int) -> Optional[bool]:
        """One queue item: True for the shutdown sentinel, False for a
        request (appended to the wait line), None when this scheduler was
        superseded (the item goes back to the live scheduler)."""
        if self._superseded(my_epoch):
            self._queue.put(item)
            return None
        if item is None:
            return True
        with self._lock:
            self._pending.append(item)
        return False

    def _loop(self, my_epoch: int):
        stop = False
        while True:
            with self._lock:
                if self._epoch != my_epoch:
                    return
                idle = not self._active and not self._pending
            # ingest: block only when idle, else drain without waiting
            items = []
            if idle and not stop:
                items.append(self._queue.get())
            while True:
                try:
                    items.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            for i, item in enumerate(items):
                got = self._ingest(item, my_epoch)
                if got is None:      # hand the rest to the live scheduler
                    for rest in items[i + 1:]:
                        self._queue.put(rest)
                    return
                stop = stop or got
            # chaos site (post-ingest, pre-dispatch, OUTSIDE the inline
            # try): an exception here kills the scheduler thread — the
            # watchdog must notice, salvage and restart it
            _faults.maybe_fail("serve_tick_fail")
            with self._lock:
                drain = self._drain
            if stop and not drain:
                self._fail_all_in_flight(
                    RuntimeError("GenerationServer shut down with the "
                                 "request in flight"))
                _QDEPTH.set(0)
                return
            if stop:                 # drain mode: exit once everything ran
                with self._lock:
                    done = not self._active and not self._pending
                if done and self._queue.empty():
                    _SLOTS_BUSY.set(0)
                    _QDEPTH.set(0)
                    return
            cur = [None]             # the slot mid-prefill, if any
            try:
                if not self._pass(my_epoch, cur):
                    return
            except Exception as e:  # surface to the implicated callers
                self._mark_tick(my_epoch, None)
                if self._superseded(my_epoch):
                    return
                _TICK_FAILURES.inc()
                _FLIGHT.record("tick_failure", error=type(e).__name__)
                err = RetryableServerError(
                    "decode dispatch failed and the slot pool was "
                    "recovered; the request was not applied — safe to "
                    "retry")
                err.__cause__ = e
                log.exception("GenerationServer tick/admit failed; "
                              "salvaging unaffected slots")
                # a raising ADMISSION implicates only its own slot
                implicated = (frozenset((cur[0],)) if cur[0] is not None
                              else frozenset())
                if not self._recover_pool(my_epoch, err,
                                          implicated=implicated):
                    return           # a watchdog recovery superseded us

    def _draft_depths(self, live_items, cap) -> np.ndarray:
        """Per-slot draft depth [B] for the next speculative dispatch: the
        acceptance controller's pick per (tenant, prompt prefix) when
        adaptive, else the fixed k, both clamped by ``cap``; 0 for free
        slots."""
        kcap = np.zeros((self.n_slots,), np.int32)
        for slot, r in live_items:
            if self._spec.adaptive:
                kcap[slot] = self._spec_ctl.k_for((r.tenant, r.pkey),
                                                  cap=cap)
            else:
                kcap[slot] = (self._spec.k if cap is None
                              else max(1, min(self._spec.k, cap)))
        return kcap

    def _spec_account(self, live_items, K, prop_h, acc_h) -> None:
        """Host side of a speculative dispatch: the proposed / accepted
        counters and gauges, this instance's and each tenant's tallies,
        and the acceptance controller's observations."""
        n_prop, n_acc = int(prop_h.sum()), int(acc_h.sum())
        _SPEC_ADAPTIVE_K.set(K)
        if n_prop:
            _SPEC_PROPOSED.inc(n_prop)
        if n_acc:
            _SPEC_ACCEPTED.inc(n_acc)
        tenant_rows, obs = [], []
        with self._lock:
            self._n_spec_proposed += n_prop
            self._n_spec_accepted += n_acc
            if self._n_spec_proposed:
                _SPEC_ACCEPT_RATE.set(self._n_spec_accepted
                                      / self._n_spec_proposed)
            for slot, r in live_items:
                p_i, a_i = int(prop_h[slot]), int(acc_h[slot])
                if p_i <= 0:
                    continue
                ent = self._tenant_spec.setdefault(r.tenant, [0, 0])
                ent[0] += p_i
                ent[1] += a_i
                tenant_rows.append((r.tenant, ent[0], ent[1]))
                obs.append(((r.tenant, r.pkey), p_i, a_i))
        # gauges and controller outside the server lock (each has its own)
        for tenant, p_tot, a_tot in tenant_rows:
            _TENANT_SPEC_ACCEPT.labels(tenant=tenant).set(a_tot / p_tot)
        for key, p_i, a_i in obs:
            self._spec_ctl.observe(key, p_i, a_i)

    def _admit_staged(self, admits, my_epoch: int, cur) -> bool:
        """Prefill and commit each planned admission (phase spans and
        histograms around each); a prefill-only request retires at once,
        its blocks parked as evictable cache entries.  False when a
        recovery superseded this scheduler."""
        tracer = telemetry.get_tracer()
        for req, slot, plan in admits:
            t_adm = time.perf_counter()
            sp_q = req.spans.pop("queue", None)
            if sp_q is not None:
                sp_q.end(slot=slot)
            _PHASE.labels(phase="queue").observe(t_adm - req.t_submit)
            targs = ({"trace": req.trace_id}
                     if req.trace_id is not None else {})
            req.spans["prefill"] = tracer.begin(
                "request/prefill", slot=slot,
                cached_blocks=plan.matched, **targs)
            self._mark_tick(my_epoch, (my_epoch, time.monotonic(), 1))
            cur[0] = slot            # a raising prefill implicates it
            committed = self._admit(req, slot, plan, my_epoch)
            cur[0] = None
            self._mark_tick(my_epoch, None)
            if not committed:
                return False
            sp_p = req.spans.pop("prefill", None)
            if sp_p is not None:
                sp_p.end()
            t_done = time.perf_counter()
            _PHASE.labels(phase="prefill").observe(t_done - t_adm)
            if req.prefill_only:
                with self._lock:
                    if self._epoch != my_epoch:
                        return False
                    del self._active[slot]
                    self._free.append(slot)
                    n_drained = self._release_slot_blocks_locked(slot)
                if n_drained:
                    _KV_BLK_FREED.inc(n_drained)
                self._update_free_gauge()
                self._retire(req, slot)
                continue
            req._t_decode = t_done
            req.spans["decode"] = tracer.begin("request/decode",
                                               slot=slot, **targs)
        return True

    def _pass(self, my_epoch: int, cur) -> bool:
        """One scheduler pass: reap, admit, one dispatch (a decode scan,
        or speculative rounds), retire.  False when a recovery superseded
        this scheduler."""
        now = time.monotonic()
        with self._lock:
            if self._epoch != my_epoch:
                return False
            reaped = self._reap_pending_locked(now)
            admits = []
            while self._free and self._pending:
                req = self._pending[0]
                # BLOCKS are the scarce resource: when the pool cannot
                # cover the head request it waits at the head of the line
                # (FIFO — no starvation by smaller requests behind it)
                plan = self._plan_admission_locked(req)
                if plan is None:
                    break
                self._pending.pop(0)
                slot = self._free.pop()
                # active (and staged) BEFORE the prefill: a recovery that
                # takes over mid-admission fails it, and reconciles its
                # blocks through _slot_blocks
                self._active[slot] = req
                self._staged.add(slot)
                self._slot_blocks[slot] = list(plan.phys) + list(plan.dphys)
                admits.append((req, slot, plan))
            n_pending = len(self._pending)
        self._retire_reaped(reaped)
        if not self._admit_staged(admits, my_epoch, cur):
            return False
        with self._lock:
            if self._epoch != my_epoch:
                return False
            live_items = list(self._active.items())
            use_spec = self._spec is not None and not self._spec_off
            draft_cap = self._draft_k_cap
        n_active = len(live_items)
        _QDEPTH.set(n_pending + self._queue.qsize())
        _SLOTS_BUSY.set(n_active)
        if not live_items:
            return True
        k_drain = max(r.n_new - r.emitted for _, r in live_items)
        sampled = any(r.temperature > 0.0 for _, r in live_items)
        # adaptive scan length: single ticks (rounds) while ANY request
        # waits for admission (a join never waits behind a long scan),
        # else the largest power of two <= the longest live budget (each
        # tick or round commits >= 1 token per live slot)
        queue_busy = n_pending > 0 or not self._queue.empty()
        if use_spec:
            kcap_h = self._draft_depths(live_items, draft_cap)
            K = int(max(1, kcap_h.max()))
            R = 1 if queue_busy else min(self._spec.rounds,
                                         _pow2_floor(k_drain))
            k = R * (K + 1)          # the watchdog's scale: R draft scans
                                     # and R W-wide verify passes
        else:
            k = 1 if queue_busy else min(self.tick_batch,
                                         _pow2_floor(k_drain))
        tracer = telemetry.get_tracer()
        prof = telemetry.get_profiler()
        # the tick span's owner is this scheduler INCARNATION (id,
        # epoch): the watchdog flushes a superseded one's spans
        with tracer.span("serve/tick", owner=(id(self), my_epoch),
                         active=n_active, queued=n_pending, k=k,
                         spec=int(use_spec)):
            self._mark_tick(my_epoch, (my_epoch, time.monotonic(), k))
            # chaos site: a hung dispatch — the host blocks here past the
            # (k-scaled) deadline and the watchdog takes over; on wake
            # the epoch checks fence this thread out
            _faults.maybe_stall("serve_tick_stall")
            with self._lock:
                if self._epoch != my_epoch:
                    return False
                kc, vc, state_in = self._kc, self._vc, self._state
            with prof.measure("verify" if use_spec else "decode_tick",
                              devices=self._device_labels):
                if use_spec:
                    state, toks, emitted, prop, acc = self._spec_rounds(
                        R, K, sampled, kc, vc, state_in,
                        torch.as_tensor(kcap_h, device=self.device))
                    tallies = [prop[:, None], acc[:, None]]
                else:
                    state, toks, emitted = self._decode_scan(
                        k, sampled, kc, vc, state_in)
                    tallies = []
                # THE host sync: one device->host copy per dispatch —
                # staged tokens, per-slot commit counts, budgets left (and
                # the speculative tallies)
                n_tok = toks.shape[1]
                packed = torch.cat([toks.to(torch.int32), emitted[:, None],
                                    state["remaining"][:, None], *tallies],
                                   dim=1).cpu().numpy()
            toks_h, emit_h, rem_h = (packed[:, :n_tok], packed[:, n_tok],
                                     packed[:, n_tok + 1])
            _HOST_SYNCS.inc()
            self._mark_tick(my_epoch, None)
            if _sanitize.active("nan"):
                # the decode-tick finite check (DL4J_TPU_SANITIZE=nan):
                # only ACTIVE slots' held logits must be finite — free
                # slots park stale values
                with self._lock:
                    mask = np.zeros((self.n_slots,), bool)
                    for s in self._active:
                        mask[s] = True
                _sanitize.check_finite_rows(
                    "serve/tick logits", state["logits"], mask,
                    detail="slot KV cache poisoned?")
        if use_spec:
            # a speculative round's verify pass is its target "tick"
            _TICKS.inc(R)
            _SCANS.labels(k=f"spec{R}x{K + 1}").inc()
            self._spec_account(live_items, K, packed[:, n_tok + 2],
                               packed[:, n_tok + 3])
        else:
            _TICKS.inc(k)
            _SCANS.labels(k=str(k)).inc()
        _TOK_PER_DISPATCH.set(float(emit_h.sum()))
        _OCC.observe(n_active / self.n_slots)
        now_p = time.perf_counter()
        now_m = time.monotonic()
        finished, kill = [], []
        n_drained = 0
        with self._lock:
            if self._epoch != my_epoch:
                return False
            self._state = state
            self._mark_commit_locked()
            for slot in list(self._active):
                req = self._active[slot]
                e = int(emit_h[slot])
                if e:
                    base = req.t0 + req.emitted
                    self._ids[slot, base:base + e] = toks_h[slot, :e]
                    req.emitted += e
                    if req.ttft is None:
                        req.ttft = now_p - req.t_submit
                        _TTFT.observe(req.ttft)
                done = rem_h[slot] == 0
                expired = (req.deadline is not None
                           and now_m > req.deadline)
                if done or req.cancelled or expired:
                    del self._active[slot]
                    self._free.append(slot)
                    # blocks back to the pool (cached prefix blocks park
                    # in the evictable LRU)
                    n_drained += self._release_slot_blocks_locked(slot)
                    finished.append((req, slot, done))
                    if not done:
                        kill.append(slot)
            n_active = len(self._active)
            n_pending = len(self._pending)
        if n_drained:
            _KV_BLK_FREED.inc(n_drained)
        if finished:
            self._update_free_gauge()
        for req, slot, done in finished:
            if done:
                self._retire(req, slot)
            elif req.cancelled:
                _CANCELLED.inc()
                self._retire(req, slot, error=CancelledError(
                    "generation request cancelled"))
            else:
                _DEADLINE_EXCEEDED.inc()
                self._retire(req, slot, error=DeadlineExceededError(
                    "generation request deadline elapsed mid-decode"))
        if kill:
            # device-side early kill: zero the cancelled / expired slots'
            # budgets so they stop burning ticks as zombies
            mask = np.zeros((self.n_slots,), bool)
            mask[kill] = True
            with self._lock:
                if self._epoch != my_epoch:
                    return False
                self._state = _kill_slots(
                    self._state, torch.as_tensor(mask, device=self.device))
        _SLOTS_BUSY.set(n_active)
        _QDEPTH.set(n_pending + self._queue.qsize())
        return True

    # -- watchdog ------------------------------------------------------
    def _watch(self):
        """Detect a stuck dispatch (``tick_timeout_s`` x its tick count
        exceeded) or a dead scheduler thread, then salvage the pool and
        restart the scheduler — graceful degradation instead of a dead
        server."""
        interval = max(0.01, min(self.tick_timeout_s / 4.0, 0.5))
        while True:
            if self._stop_event.wait(interval):
                return
            with self._lock:
                if self._shutdown:   # shutdown owns the thread now
                    return
                worker = self._worker
                started = self._tick_started
                epoch = self._epoch
            stuck = (started is not None and started[0] == epoch and
                     time.monotonic() - started[1] >
                     self.tick_timeout_s * max(1, started[2]))
            if stuck:
                self._recover(f"dispatch exceeded tick_timeout_s="
                              f"{self.tick_timeout_s:g} x k={started[2]}")
            elif not worker.is_alive():
                self._recover("scheduler thread died")

    def _recover(self, reason: str):
        with self._lock:
            if self._stop_event.is_set() or self._shutdown:
                return
            self._epoch += 1         # fences the old scheduler out of
            new_epoch = self._epoch  # every commit point
            self._tick_started = None
            self._healthy.set(0)
        _WATCHDOG_RESTARTS.inc()
        _FLIGHT.record("watchdog", reason=reason, epoch=int(new_epoch))
        # freeze the black box BEFORE the span flush and the salvage: the
        # bundle holds the hung dispatch's still-open tick span
        _FLIGHT.request_dump(f"watchdog: {reason}")
        telemetry.get_tracer().end_owned_by(
            (id(self), new_epoch - 1), error="watchdog_recovery")
        log.warning("GenerationServer watchdog: %s — salvaging "
                    "unaffected slots and restarting the scheduler",
                    reason)
        self._recover_pool(new_epoch, RetryableServerError(
            f"decode scheduler recovered ({reason}); the request failed "
            f"in flight and was not applied — safe to retry"))
        with self._lock:
            if self._stop_event.is_set() or self._shutdown:
                return
            self._worker = threading.Thread(target=self._run,
                                            args=(new_epoch,), daemon=True)
            self._worker.start()
            self._healthy.set(1)
