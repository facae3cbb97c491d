"""Training-state checkpoints with keep-K rotation and async writes (port
of ``deeplearning4j_tpu/parallel/checkpoint.py``).

``ShardedCheckpointer`` saves the FULL training state — params,
optimizer state, model state, counters, the RNG position — so that
``fit(resume=True)`` continues a killed run exactly; ``CheckpointListener``
is DL4J's ``CheckpointListener`` surface on it (every N iterations or
epochs, keep-last-K).  The reference writes through orbax, a JAX
library; the port writes its own format, read with numpy alone:

* one directory per step, ``<step>/``, holding ``state.npz`` (every
  array leaf of the state tree, keyed by its tree path, e.g.
  ``params/layer_0/W``, ``opt_state/m/layer_0/W``) and ``meta.json``
  (the scalar leaves — counters, the RNG position — the paths of empty
  subtrees, the dtypes of leaves numpy cannot hold, and the metrics).
  A bfloat16 leaf is stored as its raw 16-bit pattern with its dtype
  recorded, never cast;
* written into ``<step>.tmp/`` and committed with ``os.replace``, so a
  process killed mid-write leaves the previous steps intact and no
  partial step (what orbax's commit gives).  Nothing is fsynced: a
  commit survives the process, not the machine's power;
* async: ``save`` copies every leaf to the host before it returns (the
  solver updates parameters in place, so a writer that still held live
  tensors would write a later step's values), then a writer thread
  writes; ``wait()`` joins it and raises its failure.

The port does not read orbax checkpoints; across packages the two are
held to the same step labels, counters and trajectories, not bytes.
The ``world_<step>.json`` sidecar records world, processes, devices and
the optimizer state's layout (``opt_layout``: "layers" or "pipe", and
the pipelined run ``pipe_run``).  A checkpoint saved by a pipeline
trainer restores into a plain one and the reverse (ELASTIC restore,
``parallel.elastic``): the template is re-laid into the saved layout,
the step read, and the optimizer state re-laid back — byte-preserving
per layer.  A lost sidecar degrades only the world comparison: the
saved layout is read off the array paths.
"""
from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.nn.conf.layers_recurrent import strip_rnn_carry
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.parallel import elastic as _elastic
from deeplearning4j_torch.resilience import faults as _faults

log = logging.getLogger("deeplearning4j_torch")

_SAVES = telemetry.counter(
    "checkpoint_saves_total", "sharded checkpoint saves initiated")
_FAILURES = telemetry.counter(
    "checkpoint_failures_total",
    "periodic checkpoint saves that raised (training continued)")

_ARRAYS = "state.npz"
_META = "meta.json"
_SCALARS = (int, float, bool, str, type(None), list, tuple)


def _host_leaf(t: torch.Tensor):
    """(numpy copy, dtype name or None): a host COPY of ``t`` (a CPU
    tensor's ``.numpy()`` would alias the live, in-place-updated leaf);
    bfloat16, which numpy lacks, comes back as its raw 16-bit pattern."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), "bfloat16"
    return t.numpy(), None


def _walk(tree, path=()):
    """Yield (path, leaf) with ``{}`` for an empty subtree — the spec both
    the writer and the restore template use."""
    if isinstance(tree, dict):
        if not tree and path:
            yield path, {}
        for k in sorted(tree):
            if "/" in str(k):
                raise ValueError(f"tree key {k!r} contains '/'")
            yield from _walk(tree[k], path + (str(k),))
    else:
        yield path, tree


def _snapshot(state) -> tuple:
    """(arrays, meta) of a state tree, every array copied to the host."""
    arrays: Dict[str, np.ndarray] = {}
    meta = {"scalars": {}, "empty": [], "raw_dtypes": {}}
    for path, leaf in _walk(state):
        key = "/".join(path)
        if isinstance(leaf, dict):
            meta["empty"].append(key)
        elif isinstance(leaf, torch.Tensor):
            arrays[key], raw = _host_leaf(leaf)
            if raw is not None:
                meta["raw_dtypes"][key] = raw
        elif isinstance(leaf, np.ndarray):
            arrays[key] = np.array(leaf)
        elif isinstance(leaf, _SCALARS):
            meta["scalars"][key] = (list(leaf) if isinstance(leaf, tuple)
                                    else leaf)
        else:
            raise TypeError(f"checkpoint leaf {key!r} of type "
                            f"{type(leaf).__name__} is not a tensor, an "
                            f"array or a JSON scalar")
    return arrays, meta


def _rebuild(like, arrays, meta):
    """The saved step in the structure of ``like``: every path of
    ``like`` must be saved and nothing else (as orbax's restore against
    a template); a tensor leaf comes back with ``like``'s dtype on its
    device, and its shape and dtype must match."""
    saved = (set(arrays) | set(meta["scalars"]) | set(meta["empty"]))
    want = {"/".join(p) for p, _ in _walk(like)}
    if saved != want:
        raise ValueError(
            f"checkpoint does not match the restore template: missing "
            f"{sorted(want - saved)[:6]}, unexpected "
            f"{sorted(saved - want)[:6]}")

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, path + (str(k),)) for k, v in node.items()}
        key = "/".join(path)
        if not isinstance(node, (torch.Tensor, np.ndarray)):
            if key not in meta["scalars"]:
                raise ValueError(f"checkpoint leaf {key!r} is an array "
                                 f"where the template has a scalar")
            return meta["scalars"][key]
        if key not in arrays:
            raise ValueError(f"checkpoint leaf {key!r} is a scalar where "
                             f"the template has an array")
        arr = arrays[key]
        if tuple(arr.shape) != tuple(node.shape):
            raise ValueError(f"checkpoint leaf {key!r}: shape {arr.shape}, "
                             f"template {tuple(node.shape)}")
        if isinstance(node, np.ndarray):
            return arr
        t = torch.from_numpy(arr)
        raw = meta["raw_dtypes"].get(key)
        if raw is not None:
            t = t.view(getattr(torch, raw))
        if t.dtype != node.dtype:
            raise ValueError(f"checkpoint leaf {key!r}: dtype {t.dtype}, "
                             f"template {node.dtype}")
        return t.to(node.device)

    return build(like, ())


class ShardedCheckpointer:
    """``save(step, state)`` / ``restore_latest(like)`` with keep-K
    rotation and async writes (one write in flight; a step directory
    appears only once complete)."""

    def __init__(self, directory, keep_last: Optional[int] = 3,
                 async_save: bool = True, world: Optional[int] = None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep_last = None if keep_last is None else max(1, int(keep_last))
        self.async_save = bool(async_save)
        # the LOGICAL world size recorded beside every save (default:
        # the process count)
        self.world = None if world is None else int(world)
        self._lock = threading.Lock()
        self._writer: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None
        #: the newest committed save's cost: host copy and write seconds,
        #: bytes on disk
        self.last_save: Dict[str, Any] = {}
        # a step left half-written by a killed process never committed
        for p in self.directory.glob("*.tmp"):
            if p.is_dir():
                shutil.rmtree(p, ignore_errors=True)
            else:
                p.unlink(missing_ok=True)

    # -- world sidecar ------------------------------------------------
    def _world_path(self, step: int) -> Path:
        return self.directory / f"world_{int(step)}.json"

    @staticmethod
    def _processes() -> int:
        dist = torch.distributed
        return (dist.get_world_size()
                if dist.is_available() and dist.is_initialized() else 1)

    def _world_meta(self, state: Any = None) -> dict:
        processes = self._processes()
        meta = {"world": self.world if self.world is not None
                else processes,
                "processes": processes,
                "devices": torch.cuda.device_count()
                if torch.cuda.is_available() else 1}
        opt = state.get("opt_state") if isinstance(state, dict) else None
        layout = _elastic.opt_layout(opt)
        if layout is not None:
            meta["opt_layout"] = layout
        if layout == "pipe":
            run = _elastic.find_pipe_run(opt)
            if run is not None:
                meta["pipe_run"] = list(run)
        return meta

    def world_at(self, step) -> Optional[dict]:
        """The world/layout metadata recorded when ``step`` was saved
        (``{"world", "processes", "devices", "opt_layout", ...}``), or
        None."""
        if step is None:
            return None
        try:
            with open(self._world_path(step)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    # -- steps ----------------------------------------------------------
    def _committed(self) -> List[int]:
        return sorted(int(p.name) for p in self.directory.iterdir()
                      if p.is_dir() and p.name.isdigit())

    def all_steps(self) -> List[int]:
        """The steps kept: committed ones and the one being written, the
        newest ``keep_last``, ascending (rotation on disk follows the
        write's commit).  The write in flight is read BEFORE the
        directory: the writer commits, rotates and only then clears it, so
        a write that lands between the two reads is listed either way (the
        other order could list the directory before the commit and then
        find nothing pending, and miss the step orbax lists)."""
        with self._lock:
            pending = self._pending
        steps = set(self._committed())
        if pending is not None:
            steps.add(pending)
        steps = sorted(steps)
        return steps if self.keep_last is None else steps[-self.keep_last:]

    def save(self, step: int, state: Any, metrics: Optional[dict] = None,
             force: bool = False):
        """Save ``state`` under the label ``step``.  Every leaf is copied
        to the host before this returns; the write runs on a thread when
        ``async_save``.  ``force`` is the reference's orbax flag (bypass
        its save-interval policy): every save here is taken."""
        # chaos site: a failed write for THIS step label
        _faults.maybe_fail("checkpoint_fail", int(step))
        self.wait()     # one write in flight; an earlier failure raises
        step = int(step)
        if step in self._committed():
            raise ValueError(f"checkpoint step {step} already exists in "
                             f"{self.directory}")
        _SAVES.inc()
        t0 = time.perf_counter()
        arrays, meta = _snapshot(state)
        meta["step"], meta["metrics"] = step, metrics
        host_s = time.perf_counter() - t0
        if self._processes() == 1 or torch.distributed.get_rank() == 0:
            # best-effort sidecar (tiny, atomic by rename)
            try:
                tmp = self._world_path(step).with_suffix(".tmp")
                tmp.write_text(json.dumps(self._world_meta(state)))
                os.replace(tmp, self._world_path(step))
            except OSError:
                log.exception("world sidecar write for step %d failed",
                              step)
        with self._lock:
            self._pending = step
        if self.async_save:
            self._writer = threading.Thread(
                target=self._write, args=(step, arrays, meta, host_s),
                name=f"checkpoint-write-{step}", daemon=True)
            self._writer.start()
        else:
            self._write(step, arrays, meta, host_s)
            self.wait()

    def _write(self, step, arrays, meta, host_s):
        tmp = self.directory / f"{step}.tmp"
        try:
            t0 = time.perf_counter()
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            np.savez(tmp / _ARRAYS, **arrays)
            (tmp / _META).write_text(json.dumps(meta))
            n_bytes = sum(p.stat().st_size for p in tmp.iterdir())
            os.replace(tmp, self.directory / str(step))
            self.last_save = {"step": step, "host_copy_s": host_s,
                              "write_s": time.perf_counter() - t0,
                              "bytes": n_bytes}
            self._rotate()
        except BaseException as e:
            shutil.rmtree(tmp, ignore_errors=True)
            self._error = e
        finally:
            with self._lock:
                self._pending = None

    def _rotate(self):
        if self.keep_last is None:
            return
        steps = self._committed()
        for old in steps[:max(0, len(steps) - self.keep_last)]:
            self.delete_step(old)

    def _join(self):
        writer = self._writer
        if writer is not None:
            writer.join()
            self._writer = None

    def wait(self):
        """Block until the write in flight lands; raise its failure."""
        self._join()
        err, self._error = self._error, None
        if err is not None:
            raise err

    def restore_latest(self, like: Any):
        """Restore the newest committed step into the structure of
        ``like`` (tensor leaves on ``like``'s devices).  Returns (step,
        state), or (None, None) when no checkpoint exists.  A write in
        flight is waited for; its failure stays for ``wait()``."""
        self._join()
        steps = self._committed()
        if not steps:
            return None, None
        step = steps[-1]
        d = self.directory / str(step)
        meta = json.loads((d / _META).read_text())
        with np.load(d / _ARRAYS, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
        try:
            return step, _rebuild(like, arrays, meta)
        except ValueError as orig:
            # ELASTIC: a differently-shaped trainer saved this step (a
            # pipeline's stacked optimizer state vs per-layer): read it
            # in the saved layout, then re-lay it into ``like``'s
            alt = self._alternate_template(like, step, arrays)
            if alt is None:
                raise
            try:
                state = _rebuild(alt, arrays, meta)
            except ValueError:
                raise orig
            converted = _elastic.convert_opt_layout(state["opt_state"],
                                                    like["opt_state"])
            if converted is None:
                raise orig
            state["opt_state"] = converted
            log.info("elastic restore at step %d: optimizer state re-laid "
                     "from the saved %r layout into %r (saved world=%s)",
                     step, self._saved_opt_layout(step, arrays)[0],
                     _elastic.opt_layout(like["opt_state"]),
                     (self.world_at(step) or {}).get("world"))
            return step, state

    def _saved_opt_layout(self, step: int, arrays: Dict[str, np.ndarray]):
        """``(layout, pipe_run)`` of the optimizer state saved at
        ``step``: from the sidecar, else from the saved array paths (a
        lost sidecar never strands a cross-layout restore)."""
        meta = self.world_at(step) or {}
        layout = meta.get("opt_layout")
        if layout is not None:
            run = meta.get("pipe_run")
            return layout, (tuple(int(v) for v in run) if run else None)
        tree: dict = {}
        for key, arr in arrays.items():
            parts = key.split("/")
            if parts[0] != "opt_state":
                continue
            node = tree
            for p in parts[1:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = arr
        layout = _elastic.opt_layout(tree)
        run = _elastic.find_pipe_run(tree) if layout == "pipe" else None
        return layout, run

    def _alternate_template(self, like: Any, step: int, arrays):
        """A restore template in the SAVED optimizer layout, re-laid from
        ``like``'s own — or None when no cross-layout restore applies."""
        if not isinstance(like, dict) or "opt_state" not in like:
            return None
        mine = _elastic.opt_layout(like["opt_state"])
        saved, run = self._saved_opt_layout(step, arrays)
        if mine == "pipe" and saved != "pipe":
            return {**like,
                    "opt_state": _elastic.pipe_to_layers(like["opt_state"])}
        if mine == "layers" and saved == "pipe" and run:
            lo, hi = run
            return {**like,
                    "opt_state": _elastic.layers_to_pipe(
                        like["opt_state"], int(lo), int(hi))}
        return None

    def delete_step(self, step: int):
        """Drop one checkpoint step and its sidecar."""
        shutil.rmtree(self.directory / str(int(step)), ignore_errors=True)
        self._world_path(step).unlink(missing_ok=True)

    def close(self):
        self.wait()


class CheckpointListener(TrainingListener):
    """Every-N-iterations / every-N-epochs checkpointing listener — the
    DL4J ``CheckpointListener`` surface on :class:`ShardedCheckpointer`,
    and what ``fit(resume=True)`` restores from.

    The model state is saved WITHOUT recurrent carries (``rnn_*``): a
    carry is batch-sized, a fresh model has none, and ``run_fit`` clears
    it at every batch boundary anyway.  Resume is batch-granular: a run
    preempted at a batch boundary (where the preemption poll sits), in
    any epoch, resumes equal to the uninterrupted run when its iterator
    is rebuilt as before (``run_fit`` puts an iterator with
    ``set_epoch`` at the restored epoch's order); a periodic save that
    falls mid-batch (between two tBPTT chunks) resumes from that batch's
    start, with the params of the chunks already taken."""

    def __init__(self, directory,
                 save_every_n_iterations: Optional[int] = None,
                 save_every_n_epochs: Optional[int] = None,
                 keep_last: int = 3, async_save: bool = True,
                 world: Optional[int] = None):
        self.ckpt = ShardedCheckpointer(directory, keep_last=keep_last,
                                        async_save=async_save, world=world)
        self.every_iter = save_every_n_iterations
        self.every_epoch = save_every_n_epochs
        self.world_at = self.ckpt.world_at
        # the last step label this listener saved: an epoch boundary on
        # an every-N iteration must not save the same label twice
        self._last_saved_step: Optional[int] = None

    def _state(self, model, completed_iterations=None):
        # counters.iteration stores ITERATIONS COMPLETED: listeners fire
        # after the update for `iteration` lands but before the counter
        # increments, so resuming with the raw counter would redo that
        # step on post-step params
        it = (completed_iterations if completed_iterations is not None
              else model.iteration_count)
        hook = getattr(model, "_param_sync_hook", None)
        if hook is not None:   # lazily-synced trainer-owned params
            hook()
            sync_opt = getattr(hook, "sync_opt", None)
            if sync_opt is not None:
                # a mesh trainer's live optimizer state is its own (the
                # pipeline's pipe-structured tree, TP shards): capture it
                sync_opt()
        state = {"params": model.params_tree,
                 "opt_state": model.opt_state,
                 "model_state": strip_rnn_carry(model.state_tree),
                 "counters": {"iteration": it,
                              "epoch": model.epoch_count,
                              # completed batches of the current epoch:
                              # resume fast-forwards past exactly these
                              "batch_in_epoch": int(getattr(
                                  model, "batch_in_epoch", 0))}}
        rng = getattr(model, "_rng", None)
        if rng is not None:
            # the key stream's position, so resumed dropout masks match
            # the uninterrupted run's draw for draw
            state["rng"] = rng.state()
        return state

    def _try_save(self, step: int, state, metrics=None, force=False):
        """Periodic saves are best-effort: a failed write costs recovery
        granularity (``checkpoint_failures_total``), not the run.
        Returns True when the save was initiated."""
        try:
            self.ckpt.save(step, state, metrics=metrics, force=force)
            return True
        except Exception:
            _FAILURES.inc()
            log.exception("checkpoint save at step %d failed; training "
                          "continues (previous checkpoints intact)", step)
            return False

    def iteration_done(self, model, iteration, epoch, loss):
        if self.every_iter and iteration > 0 and \
                iteration % self.every_iter == 0:
            # step label = the iteration the checkpoint was taken at; the
            # stored counter = iteration + 1 (completed)
            if self._try_save(iteration, self._state(model, iteration + 1),
                              metrics={"loss": float(loss)}):
                self._last_saved_step = iteration

    def on_epoch_end(self, model, epoch):
        if self.every_epoch and (epoch + 1) % self.every_epoch == 0 \
                and model.iteration_count > 0:
            # the iteration path's labelling: step = last completed
            # iteration, stored counter = step + 1
            step = model.iteration_count - 1
            # already saved by the iteration hook, or on disk from a run
            # before a preemption
            if step == self._last_saved_step or step in self.ckpt.all_steps():
                return
            if self._try_save(step, self._state(model)):
                self._last_saved_step = step

    @staticmethod
    def _apply_trees(model, state):
        """Overwrite the model's trees from a restored checkpoint and
        disarm a mesh trainer's deferred sync (``parallel.trainer``'s hook
        protocol): its next step rebuilds its storage from these trees."""
        model.params_tree = state["params"]
        model.opt_state = state["opt_state"]
        model.state_tree = state["model_state"]
        discard = getattr(getattr(model, "_param_sync_hook", None),
                          "discard_pending", None)
        if discard is not None:
            discard()

    def restore_params_into(self, model):
        """Restore ONLY the parameter, optimizer and model-state trees from
        the newest checkpoint, leaving counters, batch position and the
        RNG stream where they are — the rollback primitive: training
        resumes from the last good weights but keeps moving FORWARD
        through the data.  Returns the restored step or None."""
        step, state = self.ckpt.restore_latest(self._state(model))
        if step is None:
            return None
        self._apply_trees(model, state)
        return step

    def restore_into(self, model):
        """Resume a model in place from the newest checkpoint; returns the
        restored step or None."""
        like = self._state(model)
        try:
            step, state = self.ckpt.restore_latest(like)
        except ValueError:
            # a checkpoint written before the resilience layer lacks the
            # rng leaf and the batch_in_epoch counter: resume it
            # epoch-aligned with a fresh stream
            legacy = {k: v for k, v in like.items() if k != "rng"}
            legacy["counters"] = {
                k: v for k, v in like["counters"].items()
                if k != "batch_in_epoch"}
            step, state = self.ckpt.restore_latest(legacy)
            log.warning("restored a pre-resilience checkpoint (step %s):"
                        " no rng/batch position — resume is epoch-"
                        "aligned, not batch-exact", step)
        if step is None:
            return None
        self._apply_trees(model, state)
        model.iteration_count = int(state["counters"]["iteration"])
        model.epoch_count = int(state["counters"]["epoch"])
        model.batch_in_epoch = int(
            state["counters"].get("batch_in_epoch", 0))
        if "rng" in state and getattr(model, "_rng", None) is not None:
            model._rng.set_state(state["rng"])
        return step
