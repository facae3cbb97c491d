"""GenerationServer: continuous-batching decode serving (port of
``deeplearning4j_tpu/parallel/generation_server.py`` at tp = 1, with
speculative decode).

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

Later slices: ``devices=``/``tp=``, the host KV tier
(``host_tier_blocks``, ``export_prefix``/``import_blocks``) and the
watchdog with block-granular salvage (``tick_timeout_s``) raise
``NotImplementedError``.  A failed dispatch fails the requests in flight
with ``RetryableServerError`` and rebuilds the pool; queued requests wait
it out.
"""
from __future__ import annotations

import logging
import queue
import random
import threading
import time
from collections import OrderedDict, namedtuple
from typing import Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.models.generation import (TransformerGenerator,
                                                    _filter_logits_rows,
                                                    _filtered_logprobs_rows,
                                                    _gumbel_rows,
                                                    _uniform_rows)
from deeplearning4j_torch.parallel import speculative as _speculative
from deeplearning4j_torch.parallel.inference import _bucket
from deeplearning4j_torch.resilience.errors import (CancelledError,
                                                    DeadlineExceededError,
                                                    RetryableServerError)

log = logging.getLogger("deeplearning4j_torch")

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
_HOST_SYNCS = telemetry.counter(
    "generation_server_host_syncs_total",
    "device->host polls by the scheduler (one per decode scan)")
_PREFIX_HITS = telemetry.counter(
    "prefix_cache_hits_total",
    "admissions that mapped >= 1 cached prefix block (prefill ran "
    "only on the uncached suffix)")
_PREFIX_MISSES = telemetry.counter(
    "prefix_cache_misses_total",
    "admissions with no cached prefix block (full-prompt prefill)")
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

# counter-hash streams of a slot's random draws (see the module docstring)
STREAM_SAMPLE = 0
STREAM_DRAFT = 0x5D
STREAM_ACCEPT = 0xAC


def _later(feature: str, slice_name: str) -> NotImplementedError:
    return NotImplementedError(
        f"{feature} is not ported to deeplearning4j_torch yet; it comes "
        f"with the {slice_name} (ROADMAP.md)")


def _pow2_floor(n: int) -> int:
    """Largest power of two <= n (n >= 1) — scan lengths quantize to
    powers of two, and a floor (never a ceil) means a drain scan never
    runs ticks past the longest live budget."""
    b = 1
    while b * 2 <= n:
        b *= 2
    return b


# One admission's block plan (host-side, built under _lock): ``phys`` —
# the slot's physical block ids in table order (cached prefix hits
# first, then fresh); ``matched`` — how many leading entries are cached
# prefix hits (gathered as the key prefix); ``hashes`` — the prompt's
# full-block chain hashes (registered after the prefill commits);
# ``dphys`` / ``dmatched`` — the draft table's blocks and cached prefix
# hits (speculative servers only).
_AdmitPlan = namedtuple("_AdmitPlan", ("phys", "matched", "hashes",
                                       "dphys", "dmatched"),
                        defaults=((), 0))


def _kill_slots(state, mask):
    """Zero the remaining budget of masked slots — the device-side
    early-kill for cancelled / deadline-expired requests."""
    return dict(state, remaining=torch.where(
        mask, torch.zeros_like(state["remaining"]), state["remaining"]))


class _Pending:
    """One submitted request.  ``result()`` blocks the caller; the
    scheduler thread fills ``_result``/``_error`` and sets the event.
    ``ttft`` (seconds) is populated when the first token lands."""

    __slots__ = ("prompt", "n_new", "eos_id", "seed", "temperature",
                 "top_k", "top_p", "t_submit", "deadline", "cancelled",
                 "t0", "emitted", "ttft", "tenant", "pkey", "_result",
                 "_error", "_event")

    def __init__(self, prompt, n_new, eos_id, seed,
                 temperature: float = 0.0, top_k: int = 1,
                 top_p: float = 1.0, deadline: Optional[float] = None,
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
        self.tenant = tenant
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
    ``speculative`` turns on speculative decode (module docstring).
    ``request_deadline_s`` is the default per-request deadline;
    ``submit_retries`` / ``retry_backoff_s`` retry
    ``RetryableServerError`` in ``submit``."""

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
                 tick_timeout_s: Optional[float] = None,
                 request_deadline_s: Optional[float] = None,
                 submit_retries: int = 0,
                 retry_backoff_s: float = 0.05,
                 device="cuda"):
        if devices is not None or tp not in (None, 1):
            raise _later("mesh-sharded serving (devices= / tp=)",
                         "multi-GPU serving slice")
        if host_tier_blocks:
            raise _later("the host KV tier (host_tier_blocks > 0)",
                         "tiered-KV slice")
        if tick_timeout_s is not None:
            raise _later("the watchdog (tick_timeout_s)",
                         "resilience slice (watchdog + block salvage)")
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
        self.request_deadline_s = (float(request_deadline_s)
                                   if request_deadline_s else None)
        self.submit_retries = int(submit_retries)
        self.retry_backoff_s = float(retry_backoff_s)

        # Scheduler state: _active/_pending/_free, the allocator and the
        # device pool (_kc/_vc/_state) change only under _lock.
        self._lock = threading.RLock()
        self._fresh_pool()
        self._ids = np.zeros((self.n_slots, self.max_len),
                             np.int32)                # host output rows
        self.refresh_params()
        self._queue: "queue.Queue[Optional[_Pending]]" = queue.Queue(
            maxsize=queue_limit)
        self._active = {}                # slot -> request
        self._pending = []               # admitted-order wait line
        self._free = list(range(self.n_slots - 1, -1, -1))
        self._shutdown = False
        self._drain = False
        self._admission_closed = False   # drain(): submits raise
        self._n_prefix_hits = 0
        self._n_prefix_misses = 0
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
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def _fresh_pool(self):
        """(Re)allocate the KV block pool and per-slot device state —
        every slot inactive, every block free, the prefix cache empty.
        Also the reset after a failed dispatch (the pool is updated in
        place, so a dispatch that raised may have left it half-written)."""
        gen = self._gen
        B = self.n_slots
        h = gen.blocks[0].n_heads
        dh = gen.emb.n_out // h
        n_layers = len(gen.blocks)
        cd, dev = gen.compute_dtype, self.device
        nb = self.kv_blocks + 1      # + block 0, the never-read
                                     # scratch sink for masked writes
        shape = (n_layers, nb, h, self.block_size, dh)
        kc = torch.zeros(shape, dtype=cd, device=dev)
        vc = torch.zeros(shape, dtype=cd, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        state = {
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
        with self._lock:
            self._kc, self._vc, self._state = kc, vc, state
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
            self._dprefix_map = {}       # chain hash -> (blk, tok)
            self._draft_cached = set()

    # -- public API ----------------------------------------------------
    def refresh_params(self):
        """Snapshot the net's params for serving: on the server's device,
        floating leaves cast ONCE to the compute dtype.  Call again after
        the underlying net's weights change."""
        self._params = self._gen._serving_params()
        if self._spec is not None:
            # a self-draft aliases the target's tensors; an external
            # draft snapshots its own net
            self._draft_params = self._spec.draft.params(self._params)

    def healthy(self) -> bool:
        """True while the scheduler thread is alive and not shut down."""
        with self._lock:
            return not self._shutdown and self._worker.is_alive()

    def stats(self) -> dict:
        """ONE lock-consistent snapshot of the serving state: slots,
        queue depth, block headroom (``free_blocks`` = free list +
        evictable cache entries), THIS instance's prefix hit/miss split
        and its speculative tallies (``spec_*``)."""
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
            }

    def export_prefix(self, prompt_ids, max_wait_s: float = 1.0):
        raise _later("export_prefix (disaggregated handoff)",
                     "tiered-KV slice")

    def import_blocks(self, payload) -> int:
        raise _later("import_blocks (disaggregated handoff)",
                     "tiered-KV slice")

    def drain(self) -> None:
        """Close admission WITHOUT stopping the server: later ``submit*``
        calls raise ``RuntimeError``; queued and in-flight work runs to
        completion.  One-way."""
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
        forward."""
        bs = self.block_size
        hashes, h = [], 0
        for j in range((len(prompt) - 1) // bs):
            tok = prompt[j * bs:(j + 1) * bs].tobytes()
            h = hash((h, tok))
            hashes.append((h, tok))
        return hashes

    def _evict_lru_locked(self) -> None:
        """Evict the LRU refcount-0 cache block back to the free list."""
        blk, _ = self._evictable.popitem(last=False)
        hsh = self._block_hash.pop(blk)
        if blk in self._draft_cached:
            self._draft_cached.discard(blk)
            self._dprefix_map.pop(hsh)
        else:
            self._prefix_map.pop(hsh)
        self._blocks_free.append(blk)

    def _plan_admission_locked(self, req: _Pending):
        """Match cached prefix blocks and claim the rest off the free list
        (evicting LRU cache entries as needed); returns an ``_AdmitPlan``,
        or None when the pool cannot cover the request right now — the
        caller leaves it at the head of the wait line."""
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
        # speculative: the DRAFT's table needs as many blocks, from the
        # same free list.  Its full prompt blocks are prefix-shareable in
        # their own hash domain; the draft walk runs only when the target
        # side hit (both domains register together, so they track)
        use_draft = self._spec is not None
        dmatched_ids = []
        if use_draft and matched_ids:
            for hsh, tok in hashes:
                entry = self._dprefix_map.get(hsh)
                if entry is None or entry[1] != tok:
                    break
                dmatched_ids.append(entry[0])
        dneed = (total - len(dmatched_ids)) if use_draft else 0
        need = total - len(matched_ids) + dneed
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
        return _AdmitPlan(matched_ids + fresh, len(matched_ids), hashes,
                          dphys, len(dmatched_ids))

    def _register_prefix_locked(self, plan: _AdmitPlan):
        """After the prefill COMMITS, publish the request's new full
        prompt blocks into the prefix cache.  Full prompt blocks are never
        written after prefill — decode writes land at pos >= t0 — so
        sharing them is safe by construction."""
        for j in range(plan.matched, len(plan.hashes)):
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

    def _release_slot_blocks_locked(self, slot: int) -> None:
        """Decref a retiring slot's blocks; refcount-0 blocks return to
        the free list, unless prefix-cached — those stay resident as
        evictable LRU entries."""
        for blk in self._slot_blocks.pop(slot, ()):
            self._block_ref[blk] -= 1
            if self._block_ref[blk] > 0:
                continue
            if blk in self._block_hash:
                self._evictable[blk] = None
            else:
                self._blocks_free.append(blk)

    def submit_async(self, prompt_ids, n_new: int,
                     eos_id: Optional[int] = None, seed: int = 0,
                     deadline_s: Optional[float] = None,
                     sampling: Optional[dict] = None,
                     tenant: str = "default") -> _Pending:
        """Enqueue one sequence; returns a handle whose ``result()``
        blocks.  ``prompt_ids`` is a 1-D int array; the request decodes
        until ``n_new`` tokens are emitted or ``eos_id`` is sampled.
        ``deadline_s`` bounds the request's total residence, queue wait
        included (``DeadlineExceededError`` past it).  ``tenant`` keys the
        speculative acceptance statistics."""
        with self._lock:
            if self._shutdown:
                raise RuntimeError("GenerationServer has been shut down")
            if self._admission_closed:
                raise RuntimeError(
                    "GenerationServer is draining (admission closed; "
                    "in-flight work continues)")
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
                       deadline=deadline, tenant=str(tenant), pkey=pkey)
        while True:
            try:
                self._queue.put(req, timeout=0.1)
                break
            except queue.Full:
                with self._lock:
                    down = self._shutdown
                if down:
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
        for attempt in range(retries + 1):
            try:
                return self.submit_async(
                    prompt_ids, n_new, eos_id, seed, deadline_s=deadline_s,
                    sampling=sampling, tenant=tenant).result(timeout)
            except RetryableServerError:
                if attempt == retries:
                    raise
                time.sleep(random.uniform(
                    0.0, self.retry_backoff_s * 2 ** attempt))

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
        but everything already submitted runs to completion first."""
        with self._lock:
            self._drain = bool(drain)
            self._shutdown = True
        self._queue.put(None)
        self._worker.join(timeout=timeout)
        if self._worker.is_alive():
            log.warning("GenerationServer scheduler did not exit within "
                        "%.3gs (drain=%s)", timeout, drain)
        self._fail_leftovers()

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

    def _decode_scan(self, K: int, sampled: bool, kc, vc, state):
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
        gen = self._gen
        emb_p, blk_ps, head_p = self._params
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
            new_logits, kc, vc = gen._step_paged(
                emb_p, blk_ps, head_p, kc, vc, tok, pos, tbl, wblk, woff)
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
        gen, dgen = self._gen, self._spec.draft.gen
        emb_p, blk_ps, head_p = self._params
        demb_p, dblk_ps, dhead_p = self._draft_params
        d = self._spec.draft.n_layers
        kcd, vcd = kc[:d], vc[:d]           # the draft's pool layers
        pick = self._sampler(sampled)
        W, bs, B, dev = K + 1, self.block_size, self.n_slots, self.device
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
                lg, _, _ = dgen._step_paged(
                    demb_p, dblk_ps, dhead_p, kcd, vcd, tok, p, dtbl,
                    torch.where(ok, bidx, 0), torch.where(ok, p % bs, 0))
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
            G, _, _ = gen._verify_rows_paged(
                emb_p, blk_ps, head_p, kc, vc, torch.where(okv, v, 0),
                torch.where(active, pos, 0), torch.where(okv, p, 0), tbl,
                torch.where(okv, bidx, 0), torch.where(okv, p % bs, 0))
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
        state never sees a half-armed slot)."""
        st = {k: v.clone() for k, v in state.items()}
        st["pos"][slot] = req.t0
        st["remaining"][slot] = req.n_new
        st["eos"][slot] = req.eos_id
        st["logits"][slot] = logits[0]
        st["seed"][slot] = req.seed
        st["temp"][slot] = req.temperature
        st["tk"][slot] = req.top_k
        st["tp"][slot] = req.top_p
        st["rawlg"][slot] = False
        for key, ids in (("table", plan.phys), ("dtable", plan.dphys)):
            row = np.zeros((self.max_blocks,), np.int32)
            row[:len(ids)] = ids
            st[key][slot] = torch.as_tensor(row, device=self.device)
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
            *params, torch.as_tensor(padded, device=self.device), req.t0)
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
            gather(kc), gather(vc), p0, req.t0 - p0 - 1)
        phys = self._scatter_ids(ids[matched:], sb // bs)
        self._scatter_rows(kc, ks, phys)
        self._scatter_rows(vc, vs, phys)
        return logits

    def _admit_fn(self, kc, vc, state, req, slot, plan):
        """One admission's device work: the target's prefill (suffix-only
        on a prefix hit), the draft's on a speculative server (suffix-only
        on a draft-domain hit; its logits are unused — rounds re-feed
        from the anchor), then the slot armed."""
        if plan.matched:
            logits = self._prefill_suffix(self._gen, self._params, kc, vc,
                                          req, plan.phys, plan.matched)
        else:
            logits = self._prefill_full(self._gen, self._params, kc, vc,
                                        req, plan.phys)
        if self._spec is not None:
            dgen, dparams = self._spec.draft.gen, self._draft_params
            if plan.dmatched:
                self._prefill_suffix(dgen, dparams, kc, vc, req,
                                     plan.dphys, plan.dmatched)
            else:
                self._prefill_full(dgen, dparams, kc, vc, req, plan.dphys)
        return self._arm_slot(state, logits, slot, req, plan)

    # -- scheduler -----------------------------------------------------
    def _admit(self, req: _Pending, slot: int, plan: _AdmitPlan) -> None:
        """Prefill dispatch + commit (pool, slot state, prefix cache)."""
        with self._lock:
            kc, vc, state = self._kc, self._vc, self._state
        state = self._admit_fn(kc, vc, state, req, slot, plan)
        with self._lock:
            self._state = state
            self._ids[slot, :req.t0] = req.prompt
            if self.prefix_cache:
                self._register_prefix_locked(plan)
                self._register_draft_prefix_locked(plan)
            if plan.matched:
                self._n_prefix_hits += 1
            else:
                self._n_prefix_misses += 1
        _ADMITTED.inc()
        (_PREFIX_HITS if plan.matched else _PREFIX_MISSES).inc()

    def _retire(self, req: _Pending, slot: int, error=None):
        if error is not None:
            req._error = error
        else:
            with self._lock:
                req._result = self._ids[slot,
                                        :req.t0 + req.emitted].copy()
        _RETIRED.inc()
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
                self._retire(req, -1, error=CancelledError(
                    "generation request cancelled"))
            else:
                self._retire(req, -1, error=DeadlineExceededError(
                    "generation request deadline elapsed before "
                    "completion"))

    def _fail_all_in_flight(self, err) -> None:
        """Clear active + pending under the lock and fail every caller
        (the shutdown teardown)."""
        with self._lock:
            victims = list(self._active.values()) + list(self._pending)
            self._active.clear()
            self._pending = []
            self._free = list(range(self.n_slots - 1, -1, -1))
            for slot in list(self._slot_blocks):
                self._release_slot_blocks_locked(slot)
        for req in victims:
            self._retire(req, -1, error=err)

    def _rebuild_after_failure(self, err) -> None:
        """A dispatch raised: fail the ADMITTED requests (their KV may be
        half-written — the pool is updated in place), rebuild a zeroed
        pool, and keep the wait line; queued requests admit into the
        fresh pool."""
        with self._lock:
            victims = list(self._active.values())
            self._active.clear()
            self._free = list(range(self.n_slots - 1, -1, -1))
        for req in victims:
            self._retire(req, -1, error=err)
        self._fresh_pool()

    def _run(self):
        with torch.no_grad():
            self._loop()

    def _loop(self):
        stop = False
        while True:
            with self._lock:
                idle = not self._active and not self._pending
            # ingest: block only when idle, else drain without waiting
            if idle and not stop:
                item = self._queue.get()
                if item is None:
                    stop = True
                else:
                    with self._lock:
                        self._pending.append(item)
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                else:
                    with self._lock:
                        self._pending.append(item)
            with self._lock:
                drain = self._drain
            if stop and not drain:
                self._fail_all_in_flight(
                    RuntimeError("GenerationServer shut down with the "
                                 "request in flight"))
                return
            if stop:
                with self._lock:
                    done = not self._active and not self._pending
                if done and self._queue.empty():
                    return
            try:
                self._pass()
            except Exception as e:  # surface to the callers in flight
                err = RetryableServerError(
                    "decode dispatch failed and the slot pool was "
                    "rebuilt; the request was not applied — safe to "
                    "retry")
                err.__cause__ = e
                log.exception("GenerationServer tick/admit failed; "
                              "failing the admitted requests")
                self._rebuild_after_failure(err)

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

    def _pass(self):
        """One scheduler pass: reap, admit, one dispatch (a decode scan, or
        speculative rounds), retire."""
        now = time.monotonic()
        with self._lock:
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
                self._active[slot] = req
                # both tables' blocks: retire releases them together
                self._slot_blocks[slot] = list(plan.phys) + list(plan.dphys)
                admits.append((req, slot, plan))
            n_pending = len(self._pending)
        self._retire_reaped(reaped)
        for req, slot, plan in admits:
            self._admit(req, slot, plan)
        with self._lock:
            live_items = list(self._active.items())
            use_spec = self._spec is not None and not self._spec_off
            draft_cap = self._draft_k_cap
        if not live_items:
            return
        k_drain = max(r.n_new - r.emitted for _, r in live_items)
        sampled = any(r.temperature > 0.0 for _, r in live_items)
        # adaptive scan length: single ticks (rounds) while ANY request
        # waits for admission (a join never waits behind a long scan),
        # else the largest power of two <= the longest live budget (each
        # tick or round commits >= 1 token per live slot)
        queue_busy = n_pending > 0 or not self._queue.empty()
        with self._lock:
            kc, vc, state_in = self._kc, self._vc, self._state
        if use_spec:
            kcap_h = self._draft_depths(live_items, draft_cap)
            K = int(max(1, kcap_h.max()))
            k = 1 if queue_busy else min(self._spec.rounds,
                                         _pow2_floor(k_drain))
            state, toks, emitted, prop, acc = self._spec_rounds(
                k, K, sampled, kc, vc, state_in,
                torch.as_tensor(kcap_h, device=self.device))
            tallies = [prop[:, None], acc[:, None]]
        else:
            k = 1 if queue_busy else min(self.tick_batch,
                                         _pow2_floor(k_drain))
            state, toks, emitted = self._decode_scan(k, sampled, kc, vc,
                                                     state_in)
            tallies = []
        # THE host sync: one device->host copy per dispatch — staged
        # tokens, per-slot commit counts, budgets left (and the
        # speculative tallies)
        n_tok = toks.shape[1]
        packed = torch.cat([toks.to(torch.int32), emitted[:, None],
                            state["remaining"][:, None], *tallies],
                           dim=1).cpu().numpy()
        toks_h, emit_h, rem_h = (packed[:, :n_tok], packed[:, n_tok],
                                 packed[:, n_tok + 1])
        _HOST_SYNCS.inc()
        # a speculative round's verify pass is its target "tick"
        _TICKS.inc(k)
        if use_spec:
            self._spec_account(live_items, K, packed[:, n_tok + 2],
                               packed[:, n_tok + 3])
        now_p = time.perf_counter()
        now_m = time.monotonic()
        finished = []
        kill = []
        with self._lock:
            self._state = state
            for slot in list(self._active):
                req = self._active[slot]
                e = int(emit_h[slot])
                if e:
                    base = req.t0 + req.emitted
                    self._ids[slot, base:base + e] = toks_h[slot, :e]
                    req.emitted += e
                    if req.ttft is None:
                        req.ttft = now_p - req.t_submit
                done = rem_h[slot] == 0
                expired = (req.deadline is not None
                           and now_m > req.deadline)
                if done or req.cancelled or expired:
                    del self._active[slot]
                    self._free.append(slot)
                    self._release_slot_blocks_locked(slot)
                    finished.append((req, slot, done))
                    if not done:
                        kill.append(slot)
        for req, slot, done in finished:
            if done:
                self._retire(req, slot)
            elif req.cancelled:
                self._retire(req, slot, error=CancelledError(
                    "generation request cancelled"))
            else:
                self._retire(req, slot, error=DeadlineExceededError(
                    "generation request deadline elapsed mid-decode"))
        if kill:
            # device-side early kill: zero the cancelled / expired slots'
            # budgets so they stop burning ticks as zombies
            mask = np.zeros((self.n_slots,), bool)
            mask[kill] = True
            with self._lock:
                self._state = _kill_slots(
                    self._state, torch.as_tensor(mask, device=self.device))
