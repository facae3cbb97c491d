"""Lightweight nestable span tracer with Chrome-trace jsonl export (copied
from ``deeplearning4j_tpu/telemetry/tracing.py``).

Spans are host-side wall-time intervals (``with tracer.span("train/step")``)
recorded as Chrome Trace Event Format complete events (``"ph": "X"``) —
the schema ``about://tracing`` / Perfetto / ``chrome://tracing`` load
directly.  Nesting needs no explicit parent pointers: the viewers nest
same-thread events by timestamp containment, which a ``with``-stack
guarantees.  For per-op DEVICE timelines use a ``torch.profiler`` trace
(``DeviceProfiler.request_xprof``); this tracer answers the host-side
question a device trace doesn't —
where Python time goes between program launches (data wait, dispatch,
queue drain, serve batching).

Beyond the ``with``-scoped form there are TRACKED spans
(:meth:`SpanTracer.begin` -> :class:`Span`), the request-tracing
primitive: a span opened on one thread may be ENDED on any other —
a serving request's decode phase opens on the scheduler thread and
closes on whichever thread retires the request (a watchdog-recovery
thread included).  The pre-tracked design orphaned exactly that case:
a span whose closing edge ran on a different thread was simply never
flushed, so every watchdog-recovered request lost its trace.  Tracked
spans also carry an optional OWNER binding (``bound=True``): a bound
span dies with its opening thread, and ``end_owned_by(tid)`` flushes
all of a superseded thread's bound spans (close-on-owner-death) — how
a hung decode dispatch's tick span still reaches the trace file, with
an ``error`` arg naming the recovery instead of vanishing.

Request-scoped tracing rides on one convention: spans that belong to a
request carry ``trace=<id>`` in their args (the id is minted at
``ServingFleet.submit`` and flows through every component that touches
the request).  ``events_for_trace(id)`` / ``export_chrome_trace(path,
trace_id=id)`` then emit ONE cross-component tree per request.

CROSS-WORKER traces: every closed event carries a
process-monotonic ``seq`` (the beacon-dedup key) and a wall-clock
``wall`` stamp (the only cross-host-comparable time — ``ts`` is
relative to each tracer's own ``perf_counter`` origin and MUST NOT be
compared across processes).  :meth:`SpanTracer.trace_events` is the
beacon tap — the trace-tagged tail ``telemetry.MetricsBeacon`` ships
beside the metric snapshot — and :class:`FleetTraceStore` is the
aggregator-side store that dedupes fragments by ``(host, trace, pid, seq)`` and
stitches N hosts' fragments into ONE submit->retire tree per trace id
(containment nesting within a host, wall-clock ordering across
hosts, explicit orphan policy for fragments whose root never arrived).

Thread-safe: the event buffer is a bounded ``deque`` (appends are
atomic), the tracked-span table mutates only under ``self._lock``,
each span records its opening thread's id, and a long-lived serving
process can't grow either without end.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Dict, Iterator, List, Optional

log = logging.getLogger("deeplearning4j_torch")


class Span:
    """One tracked in-flight span (see :meth:`SpanTracer.begin`).

    ``end()`` is idempotent and callable from ANY thread — the closing
    edge of a request phase legitimately runs on a different thread
    than the opening edge (scheduler vs. watchdog-recovery).  All
    bookkeeping lives in the tracer; the span itself is an immutable
    handle."""

    __slots__ = ("name", "args", "ts", "tid", "bound", "owner",
                 "_tracer", "_sid")

    def __init__(self, tracer, sid, name, ts, tid, bound, owner, args):
        self._tracer = tracer
        self._sid = sid
        self.name = name
        self.ts = ts
        self.tid = tid
        self.bound = bound
        self.owner = owner
        self.args = args

    def end(self, **extra) -> None:
        """Record the complete event (first call wins; later calls and
        calls on a no-op span are ignored)."""
        if self._tracer is not None:
            self._tracer._end(self._sid, extra)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, etype, exc, tb) -> bool:
        self.end(**({"error": etype.__name__} if etype else {}))
        return False


#: the disabled-tracer span: every method is a no-op
_NULL_SPAN = Span(None, -1, "", 0.0, 0, False, None, {})


class SpanTracer:
    """Record nested timed spans; export them for trace viewers.

    >>> tracer = SpanTracer()
    >>> with tracer.span("serve/batch", size=4):
    ...     with tracer.span("serve/forward"):
    ...         pass
    >>> sp = tracer.begin("request/decode", trace="r-1")   # tracked
    >>> sp.end(tokens=64)                                  # any thread
    >>> tracer.export_jsonl("trace.jsonl")
    """

    def __init__(self, max_events: int = 65536, enabled: bool = True):
        self.enabled = enabled
        self._events: collections.deque = collections.deque(
            maxlen=max_events)
        self._t0 = time.perf_counter_ns()
        self._lock = threading.Lock()
        self._seq = itertools.count()
        self._eseq = itertools.count()   # closed-EVENT seq (beacon dedup)
        self._open: Dict[int, Span] = {}

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0) / 1e3

    # -- tracked spans --------------------------------------------------
    def begin(self, name: str, bound: bool = False, owner=None,
              **args) -> Span:
        """Open a tracked span.  ``bound=True`` ties its lifetime to
        an OWNER: :meth:`end_owned_by` flushes it when that owner is
        superseded (hung dispatch, watchdog takeover).  ``owner``
        defaults to the opening thread's ident, but long-lived
        schedulers should pass a per-INCARNATION token (e.g. ``(id(
        self), epoch)``) — CPython recycles thread idents of dead
        threads, so a raw tid can collide with an unrelated thread
        started after the owner died.  Unbound spans outlive threads
        — a request phase ends wherever the request retires."""
        if not self.enabled:
            return _NULL_SPAN
        if bound and owner is None:
            owner = threading.get_ident()
        sp = Span(self, next(self._seq), name, self._now_us(),
                  threading.get_ident(), bound, owner, dict(args))
        with self._lock:
            self._open[sp._sid] = sp
        return sp

    def _end(self, sid: int, extra: Dict) -> None:
        with self._lock:
            sp = self._open.pop(sid, None)
        if sp is None:
            return                       # already ended (idempotent)
        args = dict(sp.args, **extra) if extra else sp.args
        # seq is the cross-worker dedup key (a beacon may deliver the
        # same tail any number of times); wall is the ONLY time base
        # comparable across hosts — ts is relative to this tracer's
        # private perf_counter origin
        self._events.append({
            "name": sp.name, "ph": "X", "ts": sp.ts,
            "dur": self._now_us() - sp.ts,
            "pid": os.getpid(), "tid": sp.tid, "args": args,
            "seq": next(self._eseq), "wall": time.time(),
        })

    def end_owned_by(self, owner, **extra) -> int:
        """Close-on-owner-death: end every OPEN BOUND span whose
        ``owner`` matches (watchdog recovery calls this with the
        superseded scheduler's incarnation token so its in-flight
        tick span flushes instead of orphaning).  Unbound (request)
        spans are left open — the recovered request's retire path
        still closes them into a complete trace.  Returns the number
        flushed."""
        if owner is None:
            return 0
        with self._lock:
            victims = [s._sid for s in self._open.values()
                       if s.bound and s.owner == owner]
        for sid in victims:
            self._end(sid, extra)
        return len(victims)

    def open_spans(self) -> List[Span]:
        """The currently-open tracked spans (tests / leak checks)."""
        with self._lock:
            return list(self._open.values())

    # -- scoped spans ---------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, owner=None, **args) -> Iterator[None]:
        """Time a block; records one complete ("X") event on exit.
        Exceptions propagate; the span still records with an
        ``"error"`` arg so a trace shows where a request died.
        Implemented over a BOUND tracked span (``owner`` as in
        :meth:`begin`), so a thread that hangs inside the block can
        still have the span flushed by :meth:`end_owned_by`."""
        if not self.enabled:
            yield
            return
        sp = self.begin(name, bound=True, owner=owner, **args)
        try:
            yield
        except BaseException as e:
            sp.end(error=type(e).__name__)
            raise
        finally:
            sp.end()

    def _snapshot_events(self) -> List[Dict]:
        """Copy the event buffer safely: deque APPENDS are atomic but
        ITERATION over a deque mutated mid-walk raises RuntimeError —
        and the callers here include the beacon thread, which must
        never die because a scheduler closed a span mid-copy."""
        for _ in range(8):
            try:
                return list(self._events)
            except RuntimeError:
                continue             # mutated mid-iteration: retry
        # pathological churn: index-walk instead — indexing a deque
        # never raises the mutation error (worst case a rotated entry
        # repeats or skips, which the seq-keyed consumers tolerate)
        out: List[Dict] = []
        for i in range(len(self._events)):
            try:
                out.append(self._events[i])
            except IndexError:
                break
        return out

    def events(self) -> List[Dict]:
        return self._snapshot_events()

    def events_for_trace(self, trace_id: str) -> List[Dict]:
        """Every recorded event carrying ``trace=<trace_id>`` in its
        args — ONE request's cross-component tree, whatever threads
        and components its phases ran on."""
        return [ev for ev in self._snapshot_events()
                if ev["args"].get("trace") == trace_id]

    def trace_events(self, limit: Optional[int] = None) -> List[Dict]:
        """The beacon tap: every CLOSED event carrying a ``trace`` arg
        (request-scoped spans only — ``serve/tick`` and friends stay
        host-local), most recent ``limit``.  Spans flushed by
        :meth:`end_owned_by` (watchdog recovery) go through the same
        ``_end`` path, so a recovered request's fragments reach the
        beacon stream exactly like normally-retired ones.  Duplicate
        delivery is the receiver's problem: ``FleetTraceStore``
        dedupes on ``(host, trace, pid, seq)``."""
        evs = [ev for ev in self._snapshot_events()
               if "trace" in ev["args"]]
        if limit is not None and len(evs) > limit:
            evs = evs[-int(limit):]
        return evs

    def clear(self) -> None:
        self._events.clear()
        with self._lock:
            self._open.clear()

    def export_jsonl(self, path: str,
                     trace_id: Optional[str] = None) -> str:
        """One Chrome trace event per line (``trace_id`` filters to one
        request's tree).  Perfetto/catapult accept newline-delimited
        event objects; ``export_chrome_trace`` writes the strict
        ``{"traceEvents": [...]}`` envelope instead."""
        d = os.path.dirname(str(path))
        if d:
            os.makedirs(d, exist_ok=True)
        evs = (self.events() if trace_id is None
               else self.events_for_trace(trace_id))
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
        return str(path)

    def export_chrome_trace(self, path: str,
                            trace_id: Optional[str] = None) -> str:
        d = os.path.dirname(str(path))
        if d:
            os.makedirs(d, exist_ok=True)
        evs = (self.events() if trace_id is None
               else self.events_for_trace(trace_id))
        with open(path, "w") as f:
            json.dump({"traceEvents": evs,
                       "displayTimeUnit": "ms"}, f)
        return str(path)


#: containment-nesting slack, in the tracer's microsecond time base —
#: a child's recorded bounds can exceed its parent's by scheduler
#: jitter between the two ``_end`` timestamps
_NEST_EPS_US = 1e-3


class FleetTraceStore:
    """Aggregator-side cross-worker trace store.

    N hosts beacon their closed request-scoped spans
    (:meth:`SpanTracer.trace_events`); this store dedupes and groups
    them by trace id, and :meth:`tree` stitches the per-host fragments
    into ONE submit->retire tree:

    * **dedup** — the push transport may deliver any tail any number
      of times; events are keyed ``(host, trace, pid, seq)`` and ingested once (pid = publisher incarnation: a restarted worker re-serving a trace is never deduped against its predecessor);
    * **nesting** — WITHIN a host, spans nest by interval containment
      in that host's private ``ts`` base (the ``with``-stack
      guarantee the Chrome viewers rely on, reconstructed);
    * **cross-host merge** — a fragment from another host (a
      migrated/handed-off request's local residence, rooted at its
      ``request/handoff`` span) attaches under the origin host's
      ``request`` root, ordered by the wall clock — NEVER by ``ts``,
      which is not comparable across processes;
    * **orphan policy** — fragments whose trace has no ``request``
      root yet (the root host's beacon lost, late, or never coming)
      stay queryable as ``orphans`` with ``complete=False``; the root
      arriving later (out-of-order delivery) promotes them into the
      tree on the next :meth:`tree` call — assembly is pure and
      re-runs per query, so arrival order can never corrupt a trace.

    Bounded THREE ways (an aggregator outlives every request it has
    ever seen): at most ``max_spans`` spans per trace, at most
    ``max_traces`` traces total (oldest-insertion evicted), and —
    at most ``max_retired`` RETIRED traces (a trace whose
    ``request`` root arrived with a terminal ``outcome`` arg is
    complete; under sustained traffic these are the unbounded
    population, and they evict LRU BY RETIRE TIME well before the
    capacity bound would thrash live traces).  Every eviction counts
    into ``fleet_trace_store_evicted_total`` on the fleet scrape."""

    #: the root-span name ``ServingFleet.submit`` mints
    ROOT = "request"
    #: the local root of a fragment that CONTINUES another host's trace
    HANDOFF = "request/handoff"

    def __init__(self, max_traces: int = 512, max_spans: int = 512,
                 max_retired: Optional[int] = None):
        self.max_traces = int(max_traces)
        self.max_spans = int(max_spans)
        # default: half the capacity — retired traces must never be
        # able to crowd out the live ones the capacity bound protects
        self.max_retired = (int(max_retired) if max_retired is not None
                            else max(1, self.max_traces // 2))
        if not 0 < self.max_retired <= self.max_traces:
            raise ValueError(
                f"need 0 < max_retired ({self.max_retired}) <= "
                f"max_traces ({self.max_traces})")
        self._lock = threading.Lock()
        # trace -> retire wall time, in RETIREMENT-ARRIVAL order (the
        # LRU the retention cap evicts from); eviction tally for the
        # fleet scrape counter
        self._retired: "collections.OrderedDict[str, float]" = \
            collections.OrderedDict()
        self._evicted = 0
        # host -> trace -> {seq}: keyed per trace so evicting a trace
        # prunes its dedup state too — the store stays bounded however
        # long the aggregator lives (an evicted trace's tail still in
        # some beacon may re-ingest as a fresh trace; bounded churn,
        # never unbounded growth)
        self._seen: Dict[str, Dict[str, set]] = {}
        self._traces: "collections.OrderedDict[str, List[Dict]]" = \
            collections.OrderedDict()

    # -- ingest --------------------------------------------------------
    def ingest(self, host: str, events) -> int:
        """Fold one host's trace-event tail in; returns how many were
        NEW (idempotent under duplicate beacon delivery)."""
        host = str(host)
        n_new = 0
        with self._lock:
            seen = self._seen.setdefault(host, {})
            for ev in events or ():
                trace = ev.get("args", {}).get("trace")
                if trace is None:
                    continue
                # seqs are deduped per (host, trace, pid): seq spaces
                # are per-TRACER, and a restarted worker — new pid,
                # possibly the SAME stable host name, possibly
                # re-serving the SAME handed-off trace — restarts at
                # 0; its fragments must not be deduped against a
                # predecessor incarnation's seqs.  (Two tracers in
                # ONE process sharing a trace id still collide —
                # a process has one default tracer, so that shape
                # only arises in synthetic tests.)
                seq = ev.get("seq")
                if seq is None:       # pre-seq publisher: best-effort
                    seq = (ev.get("name"), ev.get("ts"), ev.get("tid"))
                key = (ev.get("pid"), seq)
                tseen = seen.setdefault(trace, set())
                if key in tseen:
                    continue
                tseen.add(key)
                spans = self._traces.get(trace)
                if spans is None:
                    spans = self._traces[trace] = []
                    while len(self._traces) > self.max_traces:
                        old = next(iter(self._traces))
                        self._evict_locked(old)
                if len(spans) < self.max_spans:
                    spans.append(dict(ev, host=host))
                    n_new += 1
                if ev.get("name") == self.ROOT \
                        and "outcome" in ev.get("args", {}):
                    # the submit-minted root closed with a terminal
                    # outcome: the trace is RETIRED — enter (or
                    # refresh, under duplicate delivery) the
                    # retention LRU and enforce its cap
                    self._retired[trace] = float(ev.get("wall", 0.0))
                    self._retired.move_to_end(trace)
                    while len(self._retired) > self.max_retired:
                        old = next(iter(self._retired))
                        self._evict_locked(old)
        return n_new

    def _evict_locked(self, trace: str) -> None:
        self._traces.pop(trace, None)
        self._retired.pop(trace, None)
        for hseen in self._seen.values():
            hseen.pop(trace, None)
        self._evicted += 1
        log.debug("FleetTraceStore evicted trace %s", trace)

    # -- query ---------------------------------------------------------
    def trace_ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)

    def events(self, trace_id: str) -> List[Dict]:
        with self._lock:
            return [dict(ev) for ev in self._traces.get(trace_id, ())]

    def summary(self) -> Dict:
        """Store-level stats for the fleet scrape: trace/span counts
        and how many traces are ROOTED (their ``request`` root has
        arrived).  Deliberately weaker than :meth:`tree`'s
        ``complete`` — which additionally demands zero orphan
        fragments and is O(spans^2) per trace, too heavy to recompute
        for every trace on every scrape."""
        with self._lock:
            traces = {t: list(evs) for t, evs in self._traces.items()}
            retired = len(self._retired)
            evicted = self._evicted
        rooted = sum(
            1 for evs in traces.values()
            if any(ev["name"] == self.ROOT for ev in evs))
        return {"traces": len(traces), "rooted": rooted,
                "spans": sum(len(evs) for evs in traces.values()),
                "retired": retired, "evicted": evicted}

    def tree(self, trace_id: str) -> Dict:
        """Stitch one trace's fragments into a submit->retire tree.

        Returns ``{"trace", "root", "orphans", "hosts", "spans",
        "complete"}``; ``root`` is None (and every fragment an
        orphan) while the ``request`` root has not arrived — the
        missing-parent policy: orphans are reported, never guessed
        into a fabricated hierarchy."""
        evs = self.events(trace_id)
        hosts = sorted({ev["host"] for ev in evs})
        # per-host containment forests (ts bases are host-private)
        top_by_host: Dict[str, List[Dict]] = {}
        for host in hosts:
            top_by_host[host] = _containment_forest(
                [ev for ev in evs if ev["host"] == host])
        roots = [n for tops in top_by_host.values() for n in tops
                 if n["name"] == self.ROOT]
        if len(roots) != 1:
            orphans = sorted(
                (n for tops in top_by_host.values() for n in tops),
                key=lambda n: n["wall"])
            return {"trace": trace_id, "root": None, "orphans": orphans,
                    "hosts": hosts, "spans": len(evs),
                    "complete": False}
        root = roots[0]
        orphans = []
        for host, tops in top_by_host.items():
            for node in tops:
                if node is root:
                    continue
                if host == root["host"]:
                    # same host but outside the root's interval: a
                    # fragment the root legitimately cannot own
                    orphans.append(node)
                else:
                    root["children"].append(node)
        root["children"].sort(key=lambda n: n["wall"])
        return {"trace": trace_id, "root": root, "orphans": orphans,
                "hosts": hosts, "spans": len(evs),
                "complete": not orphans}

    def render_json(self, trace_id: Optional[str] = None) -> str:
        """The ``/traces`` endpoint body: the store summary + trace
        ids, or ONE stitched tree when ``trace_id`` names it."""
        if trace_id is not None:
            return json.dumps(self.tree(trace_id))
        doc = dict(self.summary())
        doc["trace_ids"] = self.trace_ids()
        return json.dumps(doc)


def _containment_forest(evs: List[Dict]) -> List[Dict]:
    """Nest one host's events by interval containment; returns the
    top-level nodes.  Parent = the SMALLEST enclosing interval — the
    ``with``-stack structure the spans were recorded under."""
    nodes = [{"name": ev["name"], "host": ev["host"], "ts": ev["ts"],
              "dur": ev["dur"], "wall": ev.get("wall", 0.0),
              "args": dict(ev.get("args", {})), "children": []}
             for ev in evs]
    for i, node in enumerate(nodes):
        parent = None
        for j, cand in enumerate(nodes):
            if j == i:
                continue
            encloses = (cand["ts"] - _NEST_EPS_US <= node["ts"]
                        and node["ts"] + node["dur"]
                        <= cand["ts"] + cand["dur"] + _NEST_EPS_US)
            # identical intervals (duration tie): earlier-ingested
            # wins as parent — a symmetric rule here would cycle
            bigger = (cand["dur"] > node["dur"]
                      or (cand["dur"] == node["dur"] and j < i))
            if encloses and bigger:
                if parent is None or cand["dur"] < parent["dur"]:
                    parent = cand
        node["_parent"] = parent
    tops: List[Dict] = []
    for node in nodes:
        parent = node.pop("_parent")
        if parent is None:
            tops.append(node)
        else:
            parent["children"].append(node)
    for node in nodes:
        node["children"].sort(key=lambda n: n["ts"])
    tops.sort(key=lambda n: n["ts"])
    return tops
