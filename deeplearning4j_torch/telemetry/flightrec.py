"""Per-host flight recorder + crash-forensics postmortem bundles (port of
``deeplearning4j_tpu/telemetry/flightrec.py``).

When a replica dies, the only forensic record used to be whatever
scrape happened to run last — counters say HOW MUCH, never WHAT
HAPPENED LAST.  This module is the black box: a lock-cheap bounded
ring of structured events fed by the hot decision sites the stack
already has (admission/dispatch/placement, allocator spill/fetch,
watchdog transitions, migrations, scale actions), plus the bundle
writer that freezes the ring — with the tracer's OPEN spans, a final
metric snapshot and the SLO/alert state — into one atomic postmortem
document a later process can render as a timeline.

* **ring** — :meth:`FlightRecorder.record` appends one dict to a
  bounded ``collections.deque`` (appends are atomic under the GIL; no
  lock on the hot path) stamped with a process-monotonic ``seq``, a
  wall clock and a monotonic clock.  Overflow drops the OLDEST events
  — the last N decisions before a crash are exactly what a postmortem
  needs;

* **bundles** — :meth:`request_dump` (armed by :meth:`install_dump`)
  writes ``<shared_dir>/_postmortem/<host>-<pid>-<n>.json`` by an
  atomic write-and-rename — a reader sees a complete
  bundle or none.  Dump triggers in-tree: the decode server's
  watchdog recovery, ``ServingFleet.kill`` (chaos), cooperative
  preemption, and any explicit call;

* **black box persistence** — a SIGKILL runs no handlers, so
  ``install_dump(..., persist_interval_s=...)`` starts a daemon that
  periodically publishes the CURRENT ring + open spans to
  ``_flightrec/<host>.json`` (same atomic publish).  After the kill,
  :func:`salvage_bundles` promotes each black-box file whose
  (host, pid) never produced a real bundle into a
  ``reason="salvaged: ..."`` postmortem — the victim's last persisted
  events and still-open spans survive their process;

* **pre-crash metric history** — every bundle and black
  box carries ``history``: the last ``history_s`` seconds of the
  process time-series store (``telemetry.get_tsdb()`` unless an
  explicit store is armed with ``install_dump(tsdb=...)``), downsampled
  per series, so the postmortem shows each metric's TRAJECTORY into the
  crash, not one final value;

* **retention** — the shared dir must not grow without bound across
  chaos drills and real incidents: ``install_dump(max_bundles=...,
  max_bundle_age_s=...)`` caps ``_postmortem/`` and ``_flightrec/``
  by count and age (oldest evicted first, one atomic unlink each,
  counted by ``postmortem_bundles_evicted_total``), applied after
  every bundle write and black-box persist; :func:`salvage_bundles`
  accepts the same caps so salvage respects the rotation policy.

The recorder's own traffic is observable
(``flight_events_total{kind=}``, ``postmortem_bundles_total``), and
``record()`` stays cheap enough for per-request sites: one dict, one
deque append, one counter inc.
"""
from __future__ import annotations

import itertools
import json
import logging
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

log = logging.getLogger("deeplearning4j_torch")


def _atomic_publish_json(path: str, doc: dict) -> None:
    """Publish ``doc`` at ``path`` atomically (write-to-temp +
    ``os.replace``): a concurrent reader sees either the previous
    complete document or this one, never a torn write.  A private copy
    of the reference's ``resilience.coordination.atomic_publish_json``
    (the port has no coordination module yet)."""
    path = str(path)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    # pid AND thread id: two threads of one process publishing the same
    # path must not interleave writes into one temp file
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)

#: bundle subdirectory under the shared dir (beside ``_telemetry``
#: and ``_rendezvous``, never inside them)
BUNDLE_DIRNAME = "_postmortem"
#: black-box ring snapshots (periodic persistence for SIGKILL cases)
BLACKBOX_DIRNAME = "_flightrec"


def _default_host_id() -> str:
    return f"{os.uname().nodename}-{os.getpid()}"


class FlightRecorder:
    """Bounded ring of structured events + the postmortem bundle
    writer.

    >>> fr = FlightRecorder(capacity=4096)
    >>> fr.record("dispatch", replica=1, reason="affinity")
    >>> fr.install_dump(shared_dir, host="host000")
    >>> fr.request_dump("watchdog: stuck tick")   # -> bundle path

    ``record`` is safe from any thread without taking the recorder's
    lock (deque appends are atomic); only the dump CONFIGURATION is
    lock-guarded.  ``enabled=False`` turns every method into a no-op
    (capacity stays allocated)."""

    def __init__(self, capacity: int = 4096, enabled: bool = True):
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = bool(enabled)
        self._events: deque = deque(maxlen=self.capacity)
        self._seq = itertools.count()
        self._dump_seq = itertools.count()
        self._lock = threading.Lock()
        self._cfg: Optional[dict] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._ctr = None             # lazy: telemetry imports this
        self._bundles = None         # module, not the reverse

    # -- the ring ------------------------------------------------------
    def record(self, kind: str, **fields) -> None:
        """Append one event.  ``fields`` must be JSON-serializable
        (ints/floats/strings — the hot sites pass ids and labels, not
        arrays)."""
        if not self.enabled:
            return
        ev = {"seq": next(self._seq), "wall": time.time(),
              "ts": time.monotonic(), "kind": str(kind)}
        ev.update(fields)
        self._events.append(ev)
        ctr = self._ctr
        if ctr is None:
            try:
                from deeplearning4j_torch import telemetry
                ctr = self._ctr = telemetry.counter(
                    "flight_events_total",
                    "structured events recorded into the per-host "
                    "flight-recorder ring, by kind",
                    labelnames=("kind",))
            except Exception:     # partially-imported package: the
                return            # ring keeps the event regardless
        ctr.labels(kind=str(kind)).inc()

    def events(self, last: Optional[int] = None) -> List[Dict]:
        """Snapshot of the ring, oldest first (``last`` bounds the
        tail).  Deque iteration can raise under concurrent append —
        retry, then index-walk (the tracer's discipline)."""
        out = None
        for _ in range(8):
            try:
                out = list(self._events)
                break
            except RuntimeError:
                continue
        if out is None:
            out = []
            for i in range(len(self._events)):
                try:
                    out.append(self._events[i])
                except IndexError:
                    break
        if last is not None and len(out) > last:
            out = out[-int(last):]
        return out

    def clear(self) -> None:
        self._events.clear()

    # -- bundles -------------------------------------------------------
    def install_dump(self, directory, host: Optional[str] = None,
                     registry=None, tracer=None, alerts=None,
                     persist_interval_s: Optional[float] = None,
                     tsdb=None, history_s: float = 300.0,
                     max_bundles: Optional[int] = 64,
                     max_bundle_age_s: Optional[float] = None
                     ) -> "FlightRecorder":
        """Arm bundle writing: ``directory`` is the shared dir (the
        checkpoint/beacon dir is the natural choice), ``registry`` /
        ``tracer`` default to the process-wide ones at dump time,
        ``alerts`` is an optional :class:`~.slo.AlertEngine` whose
        state rides in every bundle.  ``persist_interval_s`` starts
        the black-box daemon (periodic ring snapshots a SIGKILL
        cannot suppress).  ``tsdb`` is the time-series store whose
        last ``history_s`` seconds ride in every bundle as
        pre-crash metric history (the process-wide store by
        default); ``max_bundles`` / ``max_bundle_age_s`` cap the
        bundle and black-box dirs by count and age after every
        write (``None`` disables that axis)."""
        host = str(host) if host is not None else _default_host_id()
        if os.sep in host:
            raise ValueError(f"host {host!r} must be a plain name")
        interval = (float(persist_interval_s)
                    if persist_interval_s else None)
        if interval is not None and interval <= 0:
            raise ValueError("persist_interval_s must be > 0")
        history_s = float(history_s)
        if history_s <= 0:
            raise ValueError("history_s must be > 0")
        max_bundles = None if max_bundles is None else int(max_bundles)
        if max_bundles is not None and max_bundles < 1:
            # 0 would evict the bundle a crash just wrote — the one
            # file the whole module exists to keep
            raise ValueError("max_bundles must be >= 1 (or None)")
        max_bundle_age_s = (None if max_bundle_age_s is None
                            else float(max_bundle_age_s))
        if max_bundle_age_s is not None and max_bundle_age_s <= 0:
            raise ValueError("max_bundle_age_s must be > 0 (or None)")
        with self._lock:
            self._cfg = {"directory": str(directory), "host": host,
                         "registry": registry, "tracer": tracer,
                         "alerts": alerts, "tsdb": tsdb,
                         "history_s": history_s,
                         "max_bundles": max_bundles,
                         "max_bundle_age_s": max_bundle_age_s}
            alive = (self._thread is not None
                     and self._thread.is_alive())
            if interval is not None and alive:
                # a NEW cadence replaces the running daemon — the
                # old interval silently sticking (a 50ms chaos-drill
                # cadence surviving into production) would hammer
                # the shared dir forever
                self._stop.set()
                self._thread = None
                alive = False
        if interval is not None and not alive:
            # a FRESH stop event re-arms after a close()/uninstall
            # (the old set() event would end the new daemon's first
            # wait and silently kill the black box); the thread
            # closes over ITS OWN event, so a concurrent re-arm can
            # never steal a running loop's stop signal
            stop = threading.Event()
            thread = threading.Thread(
                target=self._persist_loop, args=(interval, stop),
                name="dl4j-torch-flightrec", daemon=True)
            with self._lock:
                self._stop = stop
                self._thread = thread
            thread.start()
        return self

    def uninstall_dump(self) -> None:
        """Disarm bundle writing AND stop the black-box daemon —
        scoped chaos drills and tests must not leave the
        process-default recorder pointed at a dead directory or a
        stray daemon spinning against it."""
        with self._lock:
            self._cfg = None
            self._stop.set()
            self._thread = None

    def _bundle_doc(self, cfg: dict, reason: str) -> dict:
        registry = cfg.get("registry")
        tracer = cfg.get("tracer")
        alerts = cfg.get("alerts")
        if registry is None or tracer is None:
            from deeplearning4j_torch import telemetry
            registry = registry or telemetry.get_registry()
            tracer = tracer or telemetry.get_tracer()
        open_spans = [{"name": sp.name, "ts": sp.ts, "tid": sp.tid,
                       "bound": sp.bound, "args": dict(sp.args)}
                      for sp in tracer.open_spans()]
        doc = {"kind": "postmortem", "reason": str(reason),
               "host": cfg["host"], "pid": os.getpid(),
               "t": time.time(), "events": self.events(),
               "open_spans": open_spans,
               "metrics": registry.snapshot()}
        try:
            doc["slo"] = alerts.state() if alerts is not None else None
        except Exception:            # a torn engine must not cost the
            doc["slo"] = None        # bundle its events
        try:
            tsdb = cfg.get("tsdb")
            if tsdb is None:
                from deeplearning4j_torch import telemetry
                tsdb = telemetry.get_tsdb()
            doc["history"] = tsdb.dump_recent(
                window_s=cfg.get("history_s", 300.0))
        except Exception:            # same discipline as slo: history
            doc["history"] = None    # must not cost the bundle
        return doc

    def _prune(self, cfg: dict) -> None:
        try:
            prune_bundles(cfg["directory"], cfg.get("max_bundles"),
                          cfg.get("max_bundle_age_s"))
        except Exception:            # retention is best-effort; the
            log.exception(           # bundle already landed
                "flight recorder: bundle prune failed")

    def request_dump(self, reason: str, error: Optional[str] = None
                     ) -> Optional[str]:
        """Write one postmortem bundle NOW; returns its path, or None
        when no dump dir is installed (the hot sites call this
        unconditionally — unconfigured processes pay a lock peek).
        Never raises: a postmortem writer that crashes its caller
        would be the worst bug in the file."""
        with self._lock:
            cfg = self._cfg
        if cfg is None or not self.enabled:
            return None
        try:
            doc = self._bundle_doc(cfg, reason)
            if error is not None:
                doc["error"] = str(error)
            path = os.path.join(
                cfg["directory"], BUNDLE_DIRNAME,
                f"{cfg['host']}-{os.getpid()}-"
                f"{next(self._dump_seq)}.json")
            _atomic_publish_json(path, doc)
            if self._bundles is None:
                from deeplearning4j_torch import telemetry
                self._bundles = telemetry.counter(
                    "postmortem_bundles_total",
                    "crash-forensics bundles this process published "
                    "(watchdog trips, chaos kills, preemptions, "
                    "explicit dumps)")
            self._bundles.inc()
            self._prune(cfg)
            log.warning("flight recorder: postmortem bundle %s (%s)",
                        path, reason)
            return path
        except Exception:
            log.exception("flight recorder: bundle write failed (%s)",
                          reason)
            return None

    # -- black box persistence ----------------------------------------
    def _persist_once(self) -> Optional[str]:
        with self._lock:
            cfg = self._cfg
        if cfg is None:
            return None
        doc = self._bundle_doc(cfg, "blackbox")
        path = os.path.join(cfg["directory"], BLACKBOX_DIRNAME,
                            f"{cfg['host']}.json")
        _atomic_publish_json(path, doc)
        self._prune(cfg)
        return path

    def _persist_loop(self, interval: float,
                      stop: threading.Event) -> None:
        while not stop.wait(interval):
            try:
                self._persist_once()
            except Exception:        # a shared-dir flake must never
                log.exception(       # kill the black box for good
                    "flight recorder: black-box persist failed")

    def close(self) -> None:
        """Stop the black-box daemon (one final persist included)."""
        with self._lock:
            stop = self._stop
            thread = self._thread
            self._thread = None
        stop.set()
        if thread is not None:
            thread.join(timeout=5)
            try:
                self._persist_once()
            except Exception:
                log.exception("flight recorder: final persist failed")


def list_bundles(directory) -> List[str]:
    """Postmortem bundle paths under ``directory``, oldest first."""
    bdir = os.path.join(str(directory), BUNDLE_DIRNAME)
    try:
        names = os.listdir(bdir)
    except OSError:
        return []
    paths = [os.path.join(bdir, n) for n in names
             if n.endswith(".json")]
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))


def load_bundle(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _prune_dir(dirpath: str, max_count: Optional[int],
               max_age_s: Optional[float],
               now: Optional[float] = None) -> List[str]:
    """Evict ``.json`` files beyond the count cap or older than the
    age cap, OLDEST first (mtime order — the same order
    :func:`list_bundles` presents).  Each eviction is one unlink, so
    a concurrent reader sees complete files or none; a file another
    process already removed is skipped, never an error."""
    if max_count is None and max_age_s is None:
        return []
    try:
        names = os.listdir(dirpath)
    except OSError:
        return []
    entries = []
    for name in names:
        if not name.endswith(".json"):
            continue
        path = os.path.join(dirpath, name)
        try:
            entries.append((os.path.getmtime(path), path))
        except OSError:
            continue                 # raced with another pruner
    entries.sort()
    now = time.time() if now is None else float(now)
    doomed = []
    if max_age_s is not None:
        cutoff = now - max_age_s
        doomed += [e for e in entries if e[0] < cutoff]
        entries = [e for e in entries if e[0] >= cutoff]
    if max_count is not None and len(entries) > max_count:
        doomed += entries[:len(entries) - max_count]
    removed: List[str] = []
    for _, path in doomed:
        try:
            os.remove(path)
            removed.append(path)
        except OSError:
            continue
    return removed


def prune_bundles(directory, max_bundles: Optional[int] = 64,
                  max_age_s: Optional[float] = None) -> List[str]:
    """Cap ``_postmortem/`` and ``_flightrec/`` under ``directory``
    by count and age; returns the evicted paths (oldest-first per
    dir).  Every eviction counts into
    ``postmortem_bundles_evicted_total`` — silent rotation would
    read as bundles that never happened."""
    directory = str(directory)
    removed: List[str] = []
    for sub in (BUNDLE_DIRNAME, BLACKBOX_DIRNAME):
        removed += _prune_dir(os.path.join(directory, sub),
                              max_bundles, max_age_s)
    if removed:
        try:
            from deeplearning4j_torch import telemetry
            telemetry.counter(
                "postmortem_bundles_evicted_total",
                "postmortem bundles and black-box snapshots evicted "
                "by the retention policy (count/age caps)"
            ).inc(len(removed))
        except Exception:
            pass                     # partially-imported package
        log.info("flight recorder: retention evicted %d file(s) "
                 "under %s", len(removed), directory)
    return removed


def salvage_bundles(directory, max_bundles: Optional[int] = None,
                    max_age_s: Optional[float] = None) -> List[str]:
    """Promote black-box ring snapshots whose (host, pid) never wrote
    a real bundle into ``reason="salvaged: ..."`` postmortems — the
    SIGKILL path: the victim could not dump, but its black-box daemon
    left the last persisted ring + open spans behind.  Idempotent
    (an already-salvaged (host, pid) is skipped); returns the NEW
    bundle paths.  ``max_bundles`` / ``max_age_s`` apply the same
    rotation policy as the writer AFTER salvage, so a salvage sweep
    respects the retention caps instead of resurrecting evicted
    history past them."""
    directory = str(directory)
    covered = set()
    for path in list_bundles(directory):
        try:
            doc = load_bundle(path)
            covered.add((doc.get("host"), doc.get("pid")))
        except (OSError, ValueError):
            continue
    bbdir = os.path.join(directory, BLACKBOX_DIRNAME)
    try:
        names = sorted(os.listdir(bbdir))
    except OSError:
        names = []       # no black boxes; retention below still runs
    out: List[str] = []
    for name in names:
        if not name.endswith(".json"):
            continue
        try:
            doc = load_bundle(os.path.join(bbdir, name))
        except (OSError, ValueError):
            continue                 # mid-replace: next pass gets it
        key = (doc.get("host"), doc.get("pid"))
        if key in covered:
            continue
        doc["reason"] = f"salvaged: {doc.get('reason', 'blackbox')}"
        doc["salvaged"] = True
        path = os.path.join(directory, BUNDLE_DIRNAME,
                            f"{doc.get('host', 'unknown')}-"
                            f"{doc.get('pid', 0)}-salvaged.json")
        _atomic_publish_json(path, doc)
        out.append(path)
    if max_bundles is not None or max_age_s is not None:
        prune_bundles(directory, max_bundles, max_age_s)
    return out
