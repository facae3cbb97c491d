"""Training listeners (port of ``deeplearning4j_tpu/optimize/listeners.py``:
``TrainingListener``, ``ScoreIterationListener``, ``PerformanceListener``,
``CollectScoresListener``, ``TimeIterationListener``,
``EvaluativeListener`` and the zip ``CheckpointListener``; the full
training-state checkpointer that ``fit(resume=True)`` reads is
``parallel.checkpoint.CheckpointListener``).

The listener bus fires on the host between steps; the loss arrives as a
0-d device tensor whose read (``float(score)``) is the only sync point,
so a listener that ignores the loss never blocks the card.
"""
from __future__ import annotations

import logging
import os
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


class TimeIterationListener(TrainingListener):
    """ETA logging (``TimeIterationListener``)."""

    def __init__(self, total_iterations: int, frequency: int = 100):
        self.total = total_iterations
        self.frequency = max(1, int(frequency))
        self._start = time.perf_counter()
        self._count = 0

    def iteration_done(self, model, iteration, epoch, score):
        self._count += 1
        if self._count % self.frequency == 0:
            elapsed = time.perf_counter() - self._start
            rate = self._count / elapsed
            remaining = (self.total - self._count) / max(rate, 1e-9)
            log.info("iteration %d/%d, ETA %.1fs", self._count, self.total,
                     remaining)


class EvaluativeListener(TrainingListener):
    """Periodic evaluation on a held-out iterator (``EvaluativeListener``),
    through the model's ``evaluate``."""

    def __init__(self, iterator, frequency: int = 1, unit: str = "epoch"):
        self.iterator = iterator
        self.frequency = max(1, int(frequency))
        self.unit = unit  # 'epoch' | 'iteration'
        self.last_evaluation = None

    def _run(self, model):
        self.iterator.reset()
        self.last_evaluation = model.evaluate(self.iterator)
        log.info("Evaluation:\n%s", self.last_evaluation.stats())

    def iteration_done(self, model, iteration, epoch, score):
        if self.unit == "iteration" and iteration % self.frequency == 0:
            self._run(model)

    def on_epoch_end(self, model, epoch):
        if self.unit == "epoch" and (epoch + 1) % self.frequency == 0:
            self._run(model)


class CheckpointListener(TrainingListener):
    """Periodic model zips with keep-last-K rotation (DL4J
    ``CheckpointListener``: every N epochs/iterations, keepLast), written
    by ``utils.model_serializer.write_model`` with the updater state."""

    def __init__(self, directory, every_n_epochs: Optional[int] = None,
                 every_n_iterations: Optional[int] = None, keep_last: int = 3):
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.every_n_epochs = every_n_epochs
        self.every_n_iterations = every_n_iterations
        self.keep_last = keep_last
        self._saved: List[str] = []

    def _save(self, model, tag: str):
        from deeplearning4j_torch.utils.model_serializer import write_model
        path = os.path.join(self.directory, f"checkpoint_{tag}.zip")
        write_model(model, path, save_updater=True)
        self._saved.append(path)
        while len(self._saved) > self.keep_last:
            old = self._saved.pop(0)
            if os.path.exists(old):
                os.remove(old)
        log.info("Checkpoint saved: %s", path)

    def iteration_done(self, model, iteration, epoch, score):
        if self.every_n_iterations and iteration > 0 \
                and iteration % self.every_n_iterations == 0:
            self._save(model, f"iter_{iteration}")

    def on_epoch_end(self, model, epoch):
        if self.every_n_epochs and (epoch + 1) % self.every_n_epochs == 0:
            self._save(model, f"epoch_{epoch}")
