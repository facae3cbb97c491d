"""Training observability: stats stream, storage, static report, profiler
hook (port of ``deeplearning4j_tpu.ui``).

* ``StatsListener`` → ``StatsStorage`` (in-memory or jsonl) plus a
  dependency-free static HTML report (``render_report``) in place of
  the reference's Vert.x web UI.
* profiling → ``ProfilerListener`` driving ``torch.profiler`` over an
  iteration window (a Chrome trace).
* fleet metrics/tracing live in ``deeplearning4j_torch.telemetry``;
  ``TelemetryListener`` is re-exported here so ``set_listeners`` users
  find it next to ``StatsListener``, and ``render_report`` tabulates its
  snapshots.
"""
from deeplearning4j_torch.ui.stats import (
    FileStatsStorage, InMemoryStatsStorage, ProfilerListener, StatsListener,
    StatsStorage)
from deeplearning4j_torch.ui.report import render_report
from deeplearning4j_torch.telemetry import TelemetryListener

__all__ = ["StatsListener", "StatsStorage", "InMemoryStatsStorage",
           "FileStatsStorage", "ProfilerListener", "TelemetryListener",
           "render_report"]
