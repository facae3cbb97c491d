"""Continuous per-device profiling on the metric plane (port of
``deeplearning4j_tpu/telemetry/profiling.py``).

The host-side registry answers "where does PYTHON time go"; a device
trace answers "where does DEVICE time go" — but its files are
host-local and a scrape never sees them.  This module is the bridge: a
LOW-OVERHEAD sampling profiler wraps the
hot dispatch sites (decode tick, speculative verify pass, prefill
chunk, optimizer step) with device-time measurement and folds samples
into ordinary registry families
(``fleet_device_phase_seconds{device=,phase=}``, the reference's names).

* **measurement** — :meth:`DeviceProfiler.measure` times a block.  On a
  CUDA device label it records a CUDA event pair around the block and,
  when the block is sampled, waits on the closing event: the sample is
  the device time between the two events (the block's enqueued work),
  where the reference blocks until its outputs are ready.  Sites that
  already sync (the decode tick's host poll) pay nothing extra; async
  sites (prefill) pay the wait only when sampled — 1-in-``every``
  dispatches, the rest stay fully async.  On the CPU (operations run
  synchronously) the sample is ``time.perf_counter`` around the block;
* **fold** — samples land in the per-``(device, phase)`` histogram;
  :meth:`top_ops` ranks phases by cumulative device seconds (count,
  total, p50/p99) — the top-K op summary a fleet dashboard shows;
* **on-demand capture** — :meth:`request_xprof` arms a real
  ``torch.profiler`` trace around the next N sampled dispatches,
  exported as a Chrome trace under ``log_dir``.  The RAW trace stays a
  host-local artifact; its SUMMARY (file count, bytes, captured wall
  seconds) lands in the ``fleet_xprof_*`` series (the reference's
  names).

Thread-safe: the sampling counters and the capture arm/active state
mutate only under their locks; the registry families carry their own
per-child locks.  Constructing a profiler (and ``observe``) never
initializes CUDA.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Dict, List, Optional

from deeplearning4j_torch.telemetry.registry import MetricsRegistry

log = logging.getLogger("deeplearning4j_torch")

#: the in-tree instrumented phases (callers may add their own)
PHASES = ("decode_tick", "verify", "prefill", "optimizer_step")


def _device_label() -> str:
    """``type:index`` of the default device: ``cuda:0`` when a card is
    visible, else ``cpu:0``."""
    import torch
    return "cuda:0" if torch.cuda.is_available() else "cpu:0"


class _Measure:
    """The handle :meth:`DeviceProfiler.measure` yields.  ``sampled``
    tells the site whether THIS dispatch is being timed.  ``ready`` is
    the reference's hook for async sites; here the closing CUDA event
    of a sampled block already waits for the block's work, so it only
    records that the site handed its output over."""

    __slots__ = ("sampled",)

    def __init__(self, sampled: bool):
        self.sampled = sampled

    def ready(self, tree) -> None:
        del tree                     # timed by the closing event


class DeviceProfiler:
    """Sampling device-time profiler feeding the fleet metric plane.

    >>> prof = telemetry.get_profiler()
    >>> with prof.measure("decode_tick"):
    ...     out = dispatch(...)      # site already host-syncs
    >>> with prof.measure("prefill") as m:
    ...     out = dispatch(...)
    ...     m.ready(out)             # sync only when sampled
    >>> prof.request_xprof("/tmp/xprof", dispatches=3)   # on demand
    >>> prof.top_ops(k=3)            # ranked device-time summary
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 sample_every: int = 1):
        if registry is None:
            from deeplearning4j_torch import telemetry
            registry = telemetry.get_registry()
        self.registry = registry
        self.sample_every = max(1, int(sample_every))
        self._lock = threading.Lock()
        self._calls: Dict[str, int] = {}
        self._device: Optional[str] = None
        # XProf arm/active state under its OWN lock: start_trace can
        # take long (profiler backend init) and must never run under
        # — or make anyone wait on — the sampling lock every
        # measure() takes on the hot path
        self._xprof_lock = threading.Lock()
        self._xprof_dir: Optional[str] = None     # armed target
        self._xprof_starting = False              # claim flag
        self._xprof_active_dir: Optional[str] = None
        self._xprof_trace = None
        self._xprof_left = 0
        self._xprof_t0: Optional[float] = None
        self._hist = registry.histogram(
            "fleet_device_phase_seconds",
            "sampled device time per dispatch phase (dispatch -> "
            "host-sync complete): decode_tick, verify (speculative "
            "draft+verification), prefill (admission chunk), "
            "optimizer_step — the per-device timing the fleet scrape "
            "aggregates {host=,device=,phase=}",
            labelnames=("device", "phase"))
        self._skipped = registry.counter(
            "fleet_device_phase_skipped_total",
            "dispatches the sampling profiler let pass unmeasured "
            "(1-in-N sampling keeps async sites async)",
            labelnames=("phase",))
        self._xprof_captures = registry.counter(
            "fleet_xprof_captures_total",
            "on-demand torch.profiler trace captures completed on this "
            "host (the raw trace stays local; this summary beacons)")
        self._xprof_bytes = registry.gauge(
            "fleet_xprof_capture_bytes",
            "total bytes the last XProf capture wrote under its "
            "log_dir")
        self._xprof_files = registry.gauge(
            "fleet_xprof_capture_files",
            "files the last XProf capture wrote (trace shards, "
            "xplane protos)")
        self._xprof_seconds = registry.gauge(
            "fleet_xprof_capture_seconds",
            "wall seconds the last XProf capture window spanned")

    # -- measurement ---------------------------------------------------
    def device(self) -> str:
        with self._lock:
            if self._device is None:
                self._device = _device_label()
            return self._device

    @contextlib.contextmanager
    def measure(self, phase: str, every: Optional[int] = None,
                devices=None):
        """Time one dispatch of ``phase`` (1-in-``every`` sampling;
        defaults to the profiler-wide rate).  An armed XProf capture
        forces sampling so the capture window is always timed.

        ``devices``: an iterable of ``type:index`` labels the sample
        folds into (None: the default device's label).  The first label
        picks the clock: a ``cuda`` label times the block with a CUDA
        event pair on that device, any other ``time.perf_counter``."""
        phase = str(phase)
        every = self.sample_every if every is None else max(1, int(every))
        with self._lock:
            n = self._calls.get(phase, 0) + 1
            self._calls[phase] = n
        capturing = self._xprof_participate()
        sampled = capturing or (n % every == 0)
        m = _Measure(sampled)
        labels = list(devices) if devices else [self.device()]
        events = None
        if sampled and labels[0].startswith("cuda"):
            import torch
            with torch.cuda.device(labels[0]):
                events = (torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True))
                events[0].record()
        t0 = time.perf_counter() if sampled else 0.0
        try:
            yield m
        finally:
            if sampled:
                if events is not None:
                    import torch
                    with torch.cuda.device(labels[0]):
                        events[1].record()
                    events[1].synchronize()
                    dt = events[0].elapsed_time(events[1]) / 1e3
                else:
                    dt = time.perf_counter() - t0
                for dev in labels:
                    self.observe(phase, dt, device=dev)
            else:
                self._skipped.labels(phase=phase).inc()
            if capturing:
                self._xprof_end()

    def observe(self, phase: str, seconds: float,
                device: Optional[str] = None) -> None:
        """Fold one device-time sample (the ``measure`` sink; also the
        direct entry for sites that time themselves)."""
        self._hist.labels(device=device or self.device(),
                          phase=str(phase)).observe(float(seconds))

    # -- summaries -----------------------------------------------------
    def top_ops(self, k: Optional[int] = None) -> List[dict]:
        """Phases ranked by cumulative device seconds across devices —
        the top-K summary ("which op class owns this device").  Reads
        the SAME histogram family the scrape exposes, so the local
        answer and the fleet answer can never disagree."""
        out = []
        for lv, child in self._hist._items():
            device, phase = lv
            _u, _c, total, count = child.state()
            if not count:
                continue
            out.append({"device": device, "phase": phase,
                        "seconds": total, "samples": count,
                        "p50": child.percentile(0.50),
                        "p99": child.percentile(0.99)})
        out.sort(key=lambda d: d["seconds"], reverse=True)
        return out if k is None else out[:int(k)]

    # -- on-demand trace capture --------------------------------------
    def request_xprof(self, log_dir, dispatches: int = 1) -> None:
        """Arm a ``torch.profiler`` trace capture around the next
        ``dispatches`` measured dispatches (any phase).  Idempotent
        while armed/active: a second request before the first capture
        finishes is ignored (one capture at a time — captures are
        heavyweight by design, which is why they are on-demand while
        the sampling histograms are continuous)."""
        with self._xprof_lock:
            if (self._xprof_dir is not None or self._xprof_starting
                    or self._xprof_t0 is not None):
                log.warning("DeviceProfiler: XProf capture already "
                            "armed/active; ignoring request")
                return
            self._xprof_dir = str(log_dir)
            self._xprof_left = max(1, int(dispatches))

    def xprof_armed(self) -> bool:
        with self._xprof_lock:
            return (self._xprof_dir is not None or self._xprof_starting
                    or self._xprof_t0 is not None)

    def _xprof_participate(self) -> bool:
        """Join the capture window: the FIRST measured dispatch after
        arming claims the start and runs ``start_trace`` OUTSIDE the
        locks (it can take long — other dispatch threads must never
        queue behind it; they simply don't participate until the
        trace is live).  Returns True while this dispatch is inside
        the window — the caller must balance with ``_xprof_end``."""
        with self._xprof_lock:
            if self._xprof_t0 is not None:
                return True               # window already open
            if self._xprof_dir is None or self._xprof_starting:
                return False
            log_dir = self._xprof_dir     # claim the start
            self._xprof_dir = None
            self._xprof_starting = True
        try:
            import torch
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            trace = torch.profiler.profile(activities=acts)
            trace.__enter__()
        except Exception:
            log.exception("DeviceProfiler: start_trace failed; "
                          "disarming the capture")
            with self._xprof_lock:
                self._xprof_starting = False
            return False
        with self._xprof_lock:
            self._xprof_starting = False
            self._xprof_active_dir = log_dir
            self._xprof_trace = trace
            self._xprof_t0 = time.perf_counter()
        return True

    def _xprof_end(self) -> None:
        with self._xprof_lock:
            if self._xprof_t0 is None:
                return
            self._xprof_left -= 1
            if self._xprof_left > 0:
                return
            log_dir = self._xprof_active_dir
            t0 = self._xprof_t0
            trace = self._xprof_trace
            self._xprof_active_dir = None
            self._xprof_trace = None
            self._xprof_t0 = None
        try:
            trace.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            trace.export_chrome_trace(os.path.join(
                log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))
        except Exception:
            log.exception("DeviceProfiler: stop_trace failed")
            return
        self._summarize_capture(log_dir, time.perf_counter() - t0)

    def _summarize_capture(self, log_dir: str, wall_s: float) -> None:
        """The part of a capture that is scraped: walk the trace dir and
        publish size/shape gauges (the raw artifact stays local)."""
        n_files = 0
        n_bytes = 0
        for root, _dirs, files in os.walk(log_dir):
            for name in files:
                n_files += 1
                try:
                    n_bytes += os.path.getsize(os.path.join(root, name))
                except OSError:
                    pass
        self._xprof_captures.inc()
        self._xprof_bytes.set(n_bytes)
        self._xprof_files.set(n_files)
        self._xprof_seconds.set(wall_s)
        log.info("DeviceProfiler: XProf capture -> %s (%d files, %d "
                 "bytes, %.3gs window)", log_dir, n_files, n_bytes,
                 wall_s)
