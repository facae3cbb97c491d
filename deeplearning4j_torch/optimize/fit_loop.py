"""The epoch/iteration loop (port of
``deeplearning4j_tpu/optimize/fit_loop.py``, ``run_fit``).

Epoch listeners, iteration listeners firing BEFORE the counter
increments (so a checkpoint taken there records the step it was taken
at), ``batch_in_epoch``, and the structural series
``train_{iterations,epochs,examples}_total``, ``train_data_wait_seconds``
and ``train_step_dispatch_seconds`` under the reference's names, and the
``DL4J_TPU_SANITIZE=nan`` loss check (``analysis.sanitize``).  Not
ported yet (ROADMAP): ``resume=True`` and ``CheckpointListener``, the
fault-injection and preemption sites, truncated BPTT, and the
``train/step`` span — each raises or is absent, never faked.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.analysis import sanitize as _sanitize

_ITERS = telemetry.counter(
    "train_iterations_total", "optimizer steps driven by run_fit")
_EPOCHS = telemetry.counter("train_epochs_total", "completed epochs")
_EXAMPLES = telemetry.counter(
    "train_examples_total", "examples consumed from the iterator")
_DATA_WAIT = telemetry.histogram(
    "train_data_wait_seconds",
    "host wall time blocked on the data iterator per batch")
_STEP_TIME = telemetry.histogram(
    "train_step_dispatch_seconds",
    "host wall time in step_fn per batch (eager launch + listener sync, "
    "not device completion)")


def run_fit(model, iterator, n_epochs: int,
            step_fn: Optional[Callable] = None,
            reset_target=None, resume: bool = False) -> Optional[float]:
    """Drive ``step_fn(batch_dict) -> loss`` over ``iterator`` for
    ``n_epochs``.  ``model`` supplies listeners, counters and
    ``_batch_dict``; ``reset_target`` is the iterator reset at epoch end
    (the unwrapped one when async prefetch is stacked on top).  Without
    ``step_fn`` the model's own solver step runs.  Returns the last loss
    as a float (one host sync, at the end)."""
    if resume:
        raise NotImplementedError(
            "fit(resume=True) needs CheckpointListener, which is not ported "
            "to deeplearning4j_torch yet")
    if getattr(model.conf, "backprop_type", "standard") == "truncated_bptt":
        raise NotImplementedError(
            "truncated BPTT comes with the recurrent slice of the port")

    if step_fn is None:
        def step_fn(batch):
            (model.params_tree, model.opt_state, model.state_tree,
             loss) = model._solver.step(
                model.params_tree, model.opt_state, model.state_tree,
                model.iteration_count, batch, model._rng.next_key(),
                lr_scale=getattr(model, "_lr_backoff", 1.0))
            return loss

    last_loss = None
    for _ in range(n_epochs):
        for lst in model.listeners:
            lst.on_epoch_start(model, model.epoch_count)
        data_it = iter(iterator)
        model.batch_in_epoch = 0
        while True:
            t_fetch = time.perf_counter()
            try:
                ds = next(data_it)
            except StopIteration:
                break
            _DATA_WAIT.observe(time.perf_counter() - t_fetch)
            model.last_batch_size = ds.num_examples()
            _EXAMPLES.inc(model.last_batch_size)
            t_step = time.perf_counter()
            loss = step_fn(model._batch_dict(ds))
            if _sanitize.active("nan"):
                # DL4J_TPU_SANITIZE=nan — one device sync per step (the
                # solver keeps the params on a bad step, but the loss
                # still reports NaN)
                _sanitize.check_finite(
                    "train/loss", loss,
                    detail=f"iteration {model.iteration_count}")
            last_loss = loss
            # batch_in_epoch counts COMPLETED batches, advanced before the
            # listeners fire
            model.batch_in_epoch += 1
            for lst in model.listeners:
                lst.iteration_done(model, model.iteration_count,
                                   model.epoch_count, loss)
            _STEP_TIME.observe(time.perf_counter() - t_step)
            _ITERS.inc()
            model.iteration_count += 1
        # incremented BEFORE epoch listeners: "N epochs completed"
        model.epoch_count += 1
        model.batch_in_epoch = 0
        _EPOCHS.inc()
        for lst in model.listeners:
            lst.on_epoch_end(model, model.epoch_count - 1)
        (reset_target if reset_target is not None else iterator).reset()
    return None if last_loss is None else float(last_loss)
