"""StatsListener / StatsStorage / ProfilerListener (port of
``deeplearning4j_tpu/ui/stats.py``).

Parity: ``org.deeplearning4j.ui.stats.StatsListener`` persisting into
``StatsStorage`` (``InMemoryStatsStorage`` / ``FileStatsStorage``).  The
record schema is one flat JSON object per iteration — loss, timing,
throughput, and (optionally) per-layer parameter/update summaries
(mean/std/absmax — the histograms DL4J's UI charts, reduced to the
moments that matter).  Parameter summaries read the port's parameter
tree (``utils.trees.iter_leaves``: the same sorted-key order and
``layer/name`` paths as the reference's tree walk).  ``ProfilerListener``
drives ``torch.profiler`` over the same iteration window and writes a
Chrome trace into ``log_dir``.
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.utils.trees import iter_leaves


class StatsStorage:
    """Append-only store of per-iteration records."""

    def put(self, record: Dict[str, Any]) -> None:
        raise NotImplementedError

    def records(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class InMemoryStatsStorage(StatsStorage):
    """``InMemoryStatsStorage``."""

    def __init__(self):
        self._records: List[Dict[str, Any]] = []

    def put(self, record):
        self._records.append(record)

    def records(self):
        return list(self._records)


class FileStatsStorage(StatsStorage):
    """``FileStatsStorage`` — one JSON object per line (jsonl), readable
    while training runs (tail -f replaces the web UI's live stream)."""

    def __init__(self, path: str):
        self.path = str(path)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)

    def put(self, record):
        with open(self.path, "a") as f:
            f.write(json.dumps(record) + "\n")

    def records(self):
        if not os.path.exists(self.path):
            return []
        with open(self.path) as f:
            return [json.loads(line) for line in f if line.strip()]


def _leaf_summary(arr) -> Dict[str, float]:
    a = arr.detach().float().cpu().numpy()
    return {"mean": float(a.mean()), "std": float(a.std()),
            "absmax": float(np.abs(a).max())}


class StatsListener(TrainingListener):
    """Streams one structured record per iteration into a StatsStorage.

    ``collect_param_stats`` adds per-layer parameter summaries to every
    ``param_stats_frequency``-th EMITTED record (so it composes with any
    ``frequency`` value; device->host transfer of the whole param tree —
    keep it sparse in production, exactly the guidance DL4J's docs gave
    for StatsListener histograms)."""

    def __init__(self, storage: StatsStorage, frequency: int = 1,
                 collect_param_stats: bool = False,
                 param_stats_frequency: int = 50):
        self.storage = storage
        self.frequency = max(1, int(frequency))
        self.collect_param_stats = collect_param_stats
        self.param_stats_frequency = max(1, int(param_stats_frequency))
        self._last_t: Optional[float] = None
        self._emitted = 0

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency:
            self._last_t = time.perf_counter()
            return
        now = time.perf_counter()
        rec: Dict[str, Any] = {
            "iteration": iteration,
            "epoch": epoch,
            "loss": float(score),
            "timestamp": time.time(),
            "batch_size": int(getattr(model, "last_batch_size", 0) or 0),
        }
        if self._last_t is not None:
            dt = now - self._last_t
            rec["iter_seconds"] = round(dt, 6)
            if rec["batch_size"] and dt > 0:
                rec["examples_per_sec"] = round(rec["batch_size"] / dt, 2)
        self._last_t = now
        if (self.collect_param_stats
                and self._emitted % self.param_stats_frequency == 0):
            rec["params"] = {"/".join(path): _leaf_summary(leaf)
                             for path, leaf in iter_leaves(model.params_tree)}
        self._emitted += 1
        self.storage.put(rec)


class ProfilerListener(TrainingListener):
    """Captures a ``torch.profiler`` trace (host ops, and the card's
    kernels when it has one) for iterations [start_iteration,
    start_iteration + n_iterations) and writes it as a Chrome trace,
    ``<log_dir>/trace_<start>.json`` (``trace_path``) — the trace that
    replaces ``OpProfiler`` wall-time tables.  ``profile`` keeps the
    finished profiler, whose ``key_averages()`` give kernel times by
    name."""

    def __init__(self, log_dir: str, start_iteration: int = 10,
                 n_iterations: int = 5):
        self.log_dir = str(log_dir)
        self.start = int(start_iteration)
        self.n = int(n_iterations)
        self._active = False
        self.profile = None
        self.trace_dir: Optional[str] = None
        self.trace_path: Optional[str] = None

    def iteration_done(self, model, iteration, epoch, score):
        if iteration == self.start and not self._active:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profile = torch.profiler.profile(activities=acts)
            self.profile.start()
            self._active = True
        elif self._active and iteration >= self.start + self.n:
            self._stop(model)

    def on_epoch_end(self, model, epoch):
        if self._active:  # training ended mid-window
            self._stop(model)

    def _stop(self, model):
        if getattr(model, "device", None) is not None and \
                torch.device(model.device).type == "cuda":
            torch.cuda.synchronize(model.device)
        self.profile.stop()
        self._active = False
        os.makedirs(self.log_dir, exist_ok=True)
        path = os.path.join(self.log_dir, f"trace_{self.start}.json")
        self.profile.export_chrome_trace(path)
        self.trace_dir, self.trace_path = self.log_dir, path
