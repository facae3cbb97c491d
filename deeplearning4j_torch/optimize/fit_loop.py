"""The epoch/iteration loop (port of
``deeplearning4j_tpu/optimize/fit_loop.py``, ``run_fit``).

Epoch listeners, iteration listeners firing BEFORE the counter
increments (so a checkpoint taken there records the step it was taken
at), ``batch_in_epoch``, the ``train/step`` span, and the structural
series ``train_{iterations,epochs,examples}_total``,
``train_data_wait_seconds`` and ``train_step_dispatch_seconds`` under the
reference's names, and the ``DL4J_TPU_SANITIZE=nan`` loss check
(``analysis.sanitize``).

Truncated BPTT (``backprop_type == "truncated_bptt"``) splits each batch
along time into ``tbptt_fwd_length`` chunks, one optimizer step each;
the recurrent carry flows across the chunks of a batch (the solver
detaches it, so gradients stop at the chunk boundary) and is cleared
after every batch.  ``batch_in_epoch`` advances with a batch's LAST
chunk and preemption is polled there only, so a checkpoint always
stores a batch position its step counter agrees with.

Fault tolerance rides the same loop:

* ``resume=True`` restores the newest checkpoint of the attached
  ``parallel.CheckpointListener`` and fast-forwards the iterator to the
  exact batch, so a restarted process replays nothing and skips nothing;
* a SIGTERM/SIGINT (``resilience.PreemptionGuard``) is polled at batch
  boundaries: the loop forces one final checkpoint save + wait, then
  unwinds with ``TrainingPreempted``;
* the fault injector's training sites live here (step exceptions and
  NaN-poisoned batches per chunk, data stalls per batch, simulated
  preemption), so injected faults traverse the code real ones would.
"""
from __future__ import annotations

import logging
import time
from typing import Callable, Optional

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.analysis import sanitize as _sanitize
from deeplearning4j_torch.resilience import faults as _faults
from deeplearning4j_torch.resilience import preemption as _preemption
from deeplearning4j_torch.resilience.errors import TrainingPreempted

log = logging.getLogger("deeplearning4j_torch")

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
    "host wall time in step_fn per step, a batch or its tBPTT chunk "
    "(eager launch + listener sync, not device completion)")


def _checkpoint_listener(model):
    """The first ``parallel.CheckpointListener`` attached to the model,
    or None (imported here: the parallel package imports this module)."""
    from deeplearning4j_torch.parallel.checkpoint import CheckpointListener
    for lst in model.listeners:
        if isinstance(lst, CheckpointListener):
            return lst
    return None


def _preemption_save(ck, model) -> Optional[int]:
    """Force the final pre-exit checkpoint: save at the just-completed
    iteration (unless a periodic hook this step already did) and BLOCK
    until the write lands.  Returns the newest step on disk (None
    without a checkpointer: the state is lost)."""
    if ck is None:
        log.warning("preempted with no CheckpointListener attached — "
                    "training state is NOT saved")
        return None
    label = model.iteration_count - 1
    try:
        if label >= 0 and label not in ck.ckpt.all_steps():
            ck.ckpt.save(label, ck._state(model), force=True)
        # wait() can also raise an EARLIER async write's failure — that
        # must not mask TrainingPreempted (resume falls back to the
        # newest checkpoint that did land)
        ck.ckpt.wait()
    except Exception:
        log.exception("forced preemption checkpoint at step %d failed; "
                      "resume will use the previous one", label)
    steps = ck.ckpt.all_steps()
    return steps[-1] if steps else None


def run_fit(model, iterator, n_epochs: int,
            step_fn: Optional[Callable] = None,
            reset_target=None, resume: bool = False) -> Optional[float]:
    """Drive ``step_fn(batch_dict) -> loss`` over ``iterator`` for
    ``n_epochs``.  ``model`` supplies listeners, counters and
    ``_batch_dict``; ``reset_target`` is the iterator reset at epoch end
    (the unwrapped one when async prefetch is stacked on top).  Without
    ``step_fn`` the model's own solver step runs.  Returns the last loss
    as a float (one host sync, at the end).

    ``resume=True`` restores the newest checkpoint of the attached
    ``CheckpointListener`` (params, optimizer state, counters, RNG
    position), puts an iterator that has ``set_epoch`` at the restored
    epoch's order, and fast-forwards it past the batches the
    checkpointed epoch already consumed.  In resume mode ``n_epochs`` is
    the TOTAL epoch target, not an increment: a run preempted in epoch 3
    of 5 resumes for the remaining 2."""
    if step_fn is None:
        def step_fn(batch):
            (model.params_tree, model.opt_state, model.state_tree,
             loss) = model._solver.step(
                model.params_tree, model.opt_state, model.state_tree,
                model.iteration_count, batch, model._rng.next_key(),
                lr_scale=getattr(model, "_lr_backoff", 1.0))
            return loss

    skip_batches = 0
    if resume:
        ck = _checkpoint_listener(model)
        if ck is None:
            raise ValueError("resume=True requires a CheckpointListener "
                             "(deeplearning4j_torch.parallel) among "
                             "model.listeners")
        step = ck.restore_into(model)
        if step is not None:
            skip_batches = int(getattr(model, "batch_in_epoch", 0))
            # an iterator whose order changes from epoch to epoch (a
            # rolling RNG, a per-epoch shuffle) starts at the restored
            # epoch's order, not at its first epoch's
            set_epoch = getattr(reset_target if reset_target is not None
                                else iterator, "set_epoch", None)
            if set_epoch is not None:
                set_epoch(model.epoch_count)
            _preemption.RESUMES.inc()
            log.info("resumed from checkpoint step %d (epoch %d, "
                     "%d batches into it)", step, model.epoch_count,
                     skip_batches)
        if model.epoch_count >= n_epochs:
            return None
        epochs_to_run = n_epochs - model.epoch_count
    else:
        epochs_to_run = n_epochs

    tbptt_len = (model.conf.tbptt_fwd_length
                 if getattr(model.conf, "backprop_type", "standard")
                 == "truncated_bptt" else 0)
    last_loss = None
    tracer = telemetry.get_tracer()
    for _ in range(epochs_to_run):
        for lst in model.listeners:
            lst.on_epoch_start(model, model.epoch_count)
        data_it = iter(iterator)
        try:
            if skip_batches:
                # resumed mid-epoch: fast-forward past the batches the
                # checkpointed position already consumed
                for _ in range(skip_batches):
                    try:
                        next(data_it)
                    except StopIteration:
                        break
                skip_batches = 0
            else:
                model.batch_in_epoch = 0
            last_loss = _run_epoch(model, data_it, step_fn, tracer,
                                   last_loss, tbptt_len)
        finally:
            # an unwinding fit (preemption, a step failure) stops the
            # async prefetch thread now, not when the traceback dies
            close = getattr(data_it, "close", None)
            if close is not None:
                close()
        # incremented BEFORE epoch listeners: "N epochs completed", so a
        # checkpoint taken in on_epoch_end resumes exactly
        model.epoch_count += 1
        model.batch_in_epoch = 0
        _EPOCHS.inc()
        for lst in model.listeners:
            lst.on_epoch_end(model, model.epoch_count - 1)
        (reset_target if reset_target is not None else iterator).reset()
    return None if last_loss is None else float(last_loss)


def _run_epoch(model, data_it, step_fn, tracer, last_loss, tbptt_len):
    """The batches of one epoch, each in ``tbptt_len`` chunks (the whole
    batch when 0); returns the last loss (a tensor)."""
    while True:
        t_fetch = time.perf_counter()
        _faults.maybe_stall("data_stall", model.iteration_count)
        try:
            ds = next(data_it)
        except StopIteration:
            return last_loss
        _DATA_WAIT.observe(time.perf_counter() - t_fetch)
        model.last_batch_size = ds.num_examples()
        _EXAMPLES.inc(model.last_batch_size)
        chunks = model._tbptt_chunks(ds, tbptt_len) if tbptt_len else [ds]
        for ci, chunk in enumerate(chunks):
            last = ci == len(chunks) - 1
            last_loss = _run_step(model, chunk, step_fn, tracer, last)
            # act on preemption only at BATCH boundaries (with a
            # coordinator installed the poll agrees across ranks, so
            # every rank's forced save carries the same step label): a
            # save mid-batch would store a step counter the
            # batch-granular batch_in_epoch cannot express
            if last and _preemption.poll_preemption():
                _preemption.PREEMPTIONS.inc()
                final = _preemption_save(_checkpoint_listener(model), model)
                raise TrainingPreempted(final)
        # the carry flows ACROSS the chunks of one batch (that is the
        # point of truncated BPTT) but never across batches
        if model._has_rnn():
            model.rnn_clear_previous_state()


def _run_step(model, chunk, step_fn, tracer, last_chunk):
    """One optimizer step on one chunk (a whole batch without tBPTT),
    its listeners and counters; returns the loss (a tensor)."""
    t_step = time.perf_counter()
    batch = _faults.corrupt_batch(model.iteration_count,
                                  model._batch_dict(chunk))
    _faults.maybe_fail("step_exception", model.iteration_count)
    with tracer.span("train/step", iteration=model.iteration_count):
        loss = step_fn(batch)
    if _sanitize.active("nan"):
        # DL4J_TPU_SANITIZE=nan — one device sync per step (the solver
        # keeps the params on a bad step, but the loss still reports NaN)
        _sanitize.check_finite("train/loss", loss,
                               detail=f"iteration {model.iteration_count}")
    # batch_in_epoch counts COMPLETED batches, advanced with a batch's
    # last chunk before the listeners fire, so a checkpoint taken in
    # iteration_done stores a batch position consistent with its step
    # counter
    if last_chunk:
        model.batch_in_epoch = getattr(model, "batch_in_epoch", 0) + 1
    for lst in model.listeners:
        lst.iteration_done(model, model.iteration_count, model.epoch_count,
                           loss)
    _STEP_TIME.observe(time.perf_counter() - t_step)
    _ITERS.inc()
    model.iteration_count += 1
    # chaos site: simulated SIGTERM after iteration N
    if _faults.fires("preempt", model.iteration_count - 1):
        _preemption.request_preemption()
    return loss
