"""Bad-step policy: NaN/Inf loss handling for long training runs (port of
``deeplearning4j_tpu/resilience/policy.py``).

The solver already refuses to APPLY a non-finite update: it selects the
old parameters and optimizer state on the device when the loss or a
gradient is not finite (``optimize.solver``), and it takes the learning
rate scale ``model._lr_backoff``.  What is left is policy, on the host:
how hard to back off the learning rate, when a bad step is a blip and
when a divergence, and when to roll back to the last checkpoint.
"""
from __future__ import annotations

import logging
import math

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.optimize.listeners import TrainingListener

log = logging.getLogger("deeplearning4j_torch")

_SKIPPED = telemetry.counter(
    "bad_steps_skipped_total",
    "train steps with non-finite loss whose update was skipped")
_ROLLED_BACK = telemetry.counter(
    "bad_steps_rolled_back_total",
    "checkpoint rollbacks triggered by consecutive bad steps")
_BACKOFF = telemetry.gauge(
    "train_lr_backoff_scale",
    "current bad-step LR multiplier (1.0 = no backoff)")


class BadStepPolicy(TrainingListener):
    """Listener implementing skip-with-LR-backoff and rollback-after-K.

    * every non-finite loss: the (already skipped) step is counted and
      the LR scale the solver takes (``model._lr_backoff``) is
      multiplied by ``backoff`` (floored at ``min_scale``);
    * ``recover_after`` consecutive finite steps double the scale back
      toward 1.0;
    * ``max_consecutive`` bad steps in a row: roll the parameters (and
      optimizer and model state) back to the newest checkpoint of
      ``checkpoint`` (a ``parallel.CheckpointListener``) and keep
      training at the backed-off LR; counters, the batch stream and the
      RNG keep moving FORWARD (``restore_params_into``).  Without a
      checkpoint to roll back to, raise ``FloatingPointError``.

    >>> ck = CheckpointListener(dir, save_every_n_iterations=100)
    >>> model.set_listeners(ck, BadStepPolicy(checkpoint=ck))
    """

    def __init__(self, max_consecutive: int = 3, backoff: float = 0.5,
                 min_scale: float = 1 / 64, recover_after: int = 10,
                 checkpoint=None):
        if not 0 < backoff < 1:
            raise ValueError("backoff must be in (0, 1)")
        self.max_consecutive = max(1, int(max_consecutive))
        self.backoff = float(backoff)
        self.min_scale = float(min_scale)
        self.recover_after = max(1, int(recover_after))
        self.checkpoint = checkpoint
        self.consecutive_bad = 0
        self._good_streak = 0

    def iteration_done(self, model, iteration, epoch, loss):
        # one device -> host read of the loss, as a score listener makes
        finite = math.isfinite(float(loss))
        scale = float(getattr(model, "_lr_backoff", 1.0))
        if finite:
            self.consecutive_bad = 0
            self._good_streak += 1
            if scale < 1.0 and self._good_streak >= self.recover_after:
                self._good_streak = 0
                model._lr_backoff = min(1.0, scale * 2.0)
                _BACKOFF.set(model._lr_backoff)
            return
        self._good_streak = 0
        self.consecutive_bad += 1
        _SKIPPED.inc()
        model._lr_backoff = max(self.min_scale, scale * self.backoff)
        _BACKOFF.set(model._lr_backoff)
        log.warning(
            "non-finite loss at iteration %d (%d consecutive); update "
            "skipped, LR scale -> %.4g", iteration,
            self.consecutive_bad, model._lr_backoff)
        if self.consecutive_bad < self.max_consecutive:
            return
        step = (self.checkpoint.restore_params_into(model)
                if self.checkpoint is not None else None)
        if step is None:
            raise FloatingPointError(
                f"{self.consecutive_bad} consecutive non-finite losses "
                f"and no checkpoint to roll back to (attach a "
                f"CheckpointListener via BadStepPolicy(checkpoint=...))")
        self.consecutive_bad = 0
        _ROLLED_BACK.inc()
        log.warning("rolled back to checkpoint step %d after "
                    "%d consecutive bad steps", step,
                    self.max_consecutive)
