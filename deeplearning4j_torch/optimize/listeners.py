"""Training listeners (port of ``deeplearning4j_tpu/optimize/listeners.py``:
``TrainingListener``, ``ScoreIterationListener``, ``PerformanceListener``,
``CollectScoresListener``).

The listener bus fires on the host between steps; the loss arrives as a
0-d device tensor whose read (``float(score)``) is the only sync point,
so a listener that ignores the loss never blocks the card.
"""
from __future__ import annotations

import logging
import time
from typing import List, Optional

log = logging.getLogger("deeplearning4j_torch")


class TrainingListener:
    """Event protocol (subset of DL4J's)."""

    def iteration_done(self, model, iteration: int, epoch: int, score) -> None:
        pass

    def on_epoch_start(self, model, epoch: int) -> None:
        pass

    def on_epoch_end(self, model, epoch: int) -> None:
        pass


class ScoreIterationListener(TrainingListener):
    """Log score every N iterations (``ScoreIterationListener``)."""

    def __init__(self, print_iterations: int = 10):
        self.print_iterations = max(1, int(print_iterations))

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.print_iterations == 0:
            log.info("Score at iteration %d is %s", iteration, float(score))


class PerformanceListener(TrainingListener):
    """Throughput reporting (``PerformanceListener``): examples/sec,
    iterations/sec, averaged over the reporting window."""

    def __init__(self, frequency: int = 100, report_batch: bool = True):
        self.frequency = max(1, int(frequency))
        self.report_batch = report_batch
        self._t0: Optional[float] = None
        self._examples = 0
        self._iters = 0

    def iteration_done(self, model, iteration, epoch, score):
        now = time.perf_counter()
        self._examples += getattr(model, "last_batch_size", 0)
        self._iters += 1
        if self._t0 is None:
            self._t0 = now
            self._examples = 0
            self._iters = 0
            return
        if self._iters >= self.frequency:
            dt = now - self._t0
            log.info(
                "iter %d (epoch %d): %.1f iters/sec, %.1f examples/sec, "
                "score %s", iteration, epoch, self._iters / dt,
                self._examples / dt, float(score))
            self._t0 = now
            self._examples = 0
            self._iters = 0


class CollectScoresListener(TrainingListener):
    """Collect (iteration, score) pairs in memory
    (``CollectScoresIterationListener``)."""

    def __init__(self, frequency: int = 1):
        self.frequency = max(1, int(frequency))
        self.scores: List[tuple] = []

    def iteration_done(self, model, iteration, epoch, score):
        if iteration % self.frequency == 0:
            self.scores.append((iteration, float(score)))
