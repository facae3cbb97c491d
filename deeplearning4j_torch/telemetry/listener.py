"""TelemetryListener (port of ``deeplearning4j_tpu/telemetry/listener.py``)
— one-line bridge from the ``TrainingListener``
bus into the metrics registry.

``net.set_listeners(TelemetryListener(...))`` gives any existing fit
loop the registry series (loss gauge, step-time histogram, examples/s,
MFU) without touching its code; the structural fit-loop metrics
(data-wait vs step dispatch, iteration/epoch counters) are emitted by
``optimize.fit_loop`` itself and fire even without a listener.
"""
from __future__ import annotations

import time
from typing import Optional

from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.telemetry.registry import MetricsRegistry

# The MFU denominator default — the H100 SXM's dense bf16 tensor-core
# peak, the figure the port's MFU numbers divide by.
H100_PEAK_FLOPS = 989e12


class TelemetryListener(TrainingListener):
    """Stream per-iteration training telemetry into a registry.

    ``flops_per_example`` (fwd+bwd FLOPs for ONE example — e.g.
    ``zoo.Bert.flops_per_token_train() * seq_len``) turns measured
    examples/sec into the ``mfu`` gauge against ``peak_flops``; without
    it the gauge is left untouched (never a made-up number).

    ``storage`` (any object with ``put(record)``, the reference's
    ``ui.StatsStorage`` shape) receives one registry snapshot record
    per epoch (``{"type": "telemetry_snapshot", ...}``)."""

    def __init__(self, registry: Optional[MetricsRegistry] = None,
                 storage=None, flops_per_example: Optional[float] = None,
                 peak_flops: float = H100_PEAK_FLOPS):
        if registry is None:
            from deeplearning4j_torch import telemetry
            registry = telemetry.get_registry()
        self.registry = registry
        self.storage = storage
        self.flops_per_example = flops_per_example
        self.peak_flops = float(peak_flops)
        self._loss = registry.gauge(
            "train_loss", "last training loss (host-read)")
        self._ex_per_sec = registry.gauge(
            "train_examples_per_sec", "examples/sec over the last iteration")
        self._mfu = registry.gauge(
            "mfu", "model FLOPs utilization vs peak_flops (needs "
            "flops_per_example)")
        self._step_s = registry.histogram(
            "train_step_seconds",
            "wall time between iteration_done events")
        self._last_t: Optional[float] = None

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        self._loss.set(float(score))
        if self._last_t is not None:
            dt = now - self._last_t
            self._step_s.observe(dt)
            bs = int(getattr(model, "last_batch_size", 0) or 0)
            if bs and dt > 0:
                eps = bs / dt
                self._ex_per_sec.set(eps)
                if self.flops_per_example:
                    self._mfu.set(eps * self.flops_per_example
                                  / self.peak_flops)
        self._last_t = now

    def on_epoch_end(self, model, epoch):
        if self.storage is not None:
            rec = {"type": "telemetry_snapshot", "epoch": epoch}
            rec.update(self.registry.snapshot())
            self.storage.put(rec)
