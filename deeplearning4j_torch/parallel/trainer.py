"""Sharded trainer: one training step over a device mesh (port of
``deeplearning4j_tpu/parallel/trainer.py``).

The reference jits one step over a ``Mesh`` and lets GSPMD insert the
collectives.  The port runs the same step eagerly and does each
collective itself:

* **data** (DP): the global batch splits into one row block per data
  shard; each shard runs the forward on its rows with its own replica of
  the parameters, under ``runtime.spmd``'s shard context (the loss
  normalised by the GLOBAL batch, batch-norm statistics summed over the
  shards — sync-BN, as GSPMD computes them — dropout drawn for the
  global shape).  One backward over the summed shard losses gives every
  replica its gradient; the gradients are summed over the shards (then
  over the processes, ``torch.distributed``), the updater runs once on
  the sum, and the new parameters are copied to every replica;
* **model** (TP): Megatron's rules — dense ``W`` and ``Wqkv``/``W1``
  split by columns, ``Wo``/``W2`` by rows, sequence embeddings by vocab
  rows; fused-gate recurrent kernels and conv kernels stay replicated.
  A split parameter lives as one shard per model-axis device (and so
  does its optimizer state).  In the forward it is a
  ``parallel.mesh.TpLeaf``:
  ``x @ W`` runs each shard's product on its device and concatenates the
  column shards, or adds the row shards' partial products; an embedding
  lookup adds each vocab shard's masked rows; any other use gathers the
  shards first;
* **pipeline** (PP): the longest run of conf-identical
  ``TransformerEncoderBlock``s splits into stages, each stage's blocks on
  its device, run by the GPipe schedule (``parallel.pipeline``); the
  model's own tree is refreshed lazily through ``_param_sync_hook``.

A mesh may repeat a device (``[cuda:0] * 2``): every shard still holds
tensors of its own.

A mesh may span processes (built over ``distributed.global_devices()``):
any axis may then cross a process boundary, and each process stores only
its own shards and their optimizer state.  Along the ``model`` axis the
``TpLeaf`` collectives cross the processes (Megatron's pairs,
``parallel.mesh``); along ``pipeline`` each process runs its stage and
hands activations on and gradients back point to point
(``pipeline.gpipe_stage``), the last stage broadcasting the loss; along
``data`` the gradients and the loss are summed over the data group only
(every model and pipeline rank of a data row computes its own shards'
gradients whole).  Every sum runs in coordinate order, so every rank —
and the one-process mesh — adds alike.  Reading the model's tree
(``sync_model``, a checkpoint) gathers every shard: a collective, called
on every rank at the same point.

``fit`` drives ``optimize.fit_loop.run_fit`` with this trainer's step,
so tBPTT, listeners, checkpoints and ``resume=True`` work as on one
device.
"""
from __future__ import annotations

import logging
import weakref
from typing import Dict, List, Optional

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.nn.conf.base import apply_layer
from deeplearning4j_torch.optimize.fit_loop import run_fit
from deeplearning4j_torch.optimize.solver import (apply_updates_if,
                                                  finite_step_ok,
                                                  normalize_gradients,
                                                  select_step)
from deeplearning4j_torch.parallel import distributed, elastic
from deeplearning4j_torch.parallel.mesh import (MeshConfig, P,
                                                PartitionSpec, TpLeaf,
                                                _own_copy)
from deeplearning4j_torch.parallel.pipeline import (_PIPE_BUBBLE,
                                                    check_pipeline,
                                                    gpipe_schedule,
                                                    gpipe_stage)
from deeplearning4j_torch.resilience.errors import ElasticWorldError
from deeplearning4j_torch.runtime import spmd
from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves

log = logging.getLogger("deeplearning4j_torch")

_STEPS = telemetry.counter(
    "sharded_steps_total", "compiled mesh steps dispatched",
    labelnames=("worker",))

#: optimizer-step device-time sampling rate: 1-in-N steps pays a sync
_PROFILE_STEP_EVERY = 4

_TP = "__tp"            # key prefix of a tensor-parallel shard in storage


def _tp_shardable_layers(model) -> dict:
    """Per-layer tensor-parallel rules: layer key -> {param: kind}, kind
    'col' (split by columns) or 'row' (by rows) — Megatron-style.  Dense
    'W' by columns; transformer blocks Wqkv/W1 by columns and W2/Wo by
    rows; sequence embeddings by vocab rows.  Recurrent fused-gate
    kernels and conv HWIO kernels replicate."""
    from deeplearning4j_torch.nn.conf.layers_core import DenseLayer
    from deeplearning4j_torch.nn.conf.layers_transformer import (
        EmbeddingSequenceLayer, TransformerEncoderBlock)
    rules = {}
    for name, ly in model._named_layers():
        if isinstance(ly, TransformerEncoderBlock):
            rules[name] = {"Wqkv": "col", "W1": "col",
                           "W2": "row", "Wo": "row"}
        elif isinstance(ly, EmbeddingSequenceLayer):
            rules[name] = {"W": "row"}
        elif isinstance(ly, DenseLayer) and not getattr(ly, "IS_RNN",
                                                        False):
            rules[name] = {"W": "col"}
    return rules


def _rule(path, shardable: dict) -> Optional[str]:
    """The TP rule of a leaf by its tree path: the second-to-last key is
    the owning layer (params and optimizer trees alike)."""
    keys = [str(k) for k in path]
    layer = keys[-2] if len(keys) >= 2 else None
    return shardable.get(layer, {}).get(keys[-1]) if keys else None


def _param_kind(path, shape, tp: int, shardable: dict) -> Optional[str]:
    """'col', 'row' or None for one leaf: its rule, where the split axis
    divides over ``tp``."""
    kind = _rule(path, shardable)
    if tp > 1 and kind and len(shape) == 2:
        if kind == "col" and shape[-1] % tp == 0:
            return "col"
        if kind == "row" and shape[0] % tp == 0:
            return "row"
    return None


def _param_spec(path, shape, tp: int, shardable: dict) -> PartitionSpec:
    kind = _param_kind(path, shape, tp, shardable)
    if kind == "col":
        return P(None, "model")
    if kind == "row":
        return P("model", None)
    return P()


def _find_block_run(model):
    """Longest run of conf-identical TransformerEncoderBlocks in an MLN's
    layer list — the sub-stack MeshConfig.pipeline shards.  Returns (lo,
    hi) or None."""
    import dataclasses
    from deeplearning4j_torch.nn.conf.layers_transformer import (
        TransformerEncoderBlock)
    layers = getattr(model, "layers", None)
    if layers is None:
        return None
    best, i = None, 0
    while i < len(layers):
        if isinstance(layers[i], TransformerEncoderBlock):
            ref = dataclasses.asdict(layers[i])
            j = i
            while j < len(layers) and \
                    isinstance(layers[j], TransformerEncoderBlock) and \
                    dataclasses.asdict(layers[j]) == ref:
                j += 1
            if best is None or j - i > best[1] - best[0]:
                best = (i, j)
            i = j
        else:
            i += 1
    return best if best is not None and best[1] - best[0] >= 2 else None


def _is_tp_node(node) -> bool:
    return isinstance(node, dict) and bool(node) and \
        all(str(k).startswith(_TP) for k in node)


def _tp_shards(node) -> List[torch.Tensor]:
    """A TP node's shards in coordinate order (this process's alone when
    the model axis crosses processes)."""
    return [node[k] for k in sorted(node, key=lambda k: int(k[len(_TP):]))]


_ABSENT = object()      # a leaf another pipeline stage's process holds


class _SumBoth(torch.autograd.Function):
    """A differentiable sum over a process group: the sum forward and
    backward (batch norm's statistics over the data group)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.sum(t.contiguous())

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum(g.contiguous()), None


class ShardedTrainer:
    """Drives a MultiLayerNetwork/ComputationGraph's training step over a
    mesh.  ``fit_batch`` is the hot path; ``fit`` drives an iterator like
    ``ParallelWrapper.fit`` did.

    ``MeshConfig.pipeline > 1`` (an MLN with a homogeneous
    TransformerEncoderBlock run) swaps the middle of the step for the
    GPipe schedule; DP and TP compose on the other axes.  The model's
    own tree is refreshed after every ``fit`` and lazily (on first read)
    after ``fit_batch``."""

    def __init__(self, model, mesh_conf: Optional[MeshConfig] = None,
                 devices=None, n_micro: int = 4):
        self.model = model
        self.mesh_conf = mesh_conf or MeshConfig.data_parallel()
        self.mesh = self.mesh_conf.build(devices)
        self.tp = self.mesh_conf.model
        self.n_micro = n_micro
        self._procs = distributed.process_count()
        self._proc = distributed.process_index()
        self._init_axes()
        self._step_counter = _STEPS.labels(worker=self._proc)
        model._check_init()
        model._build_solver(alloc_opt_state=False)
        self.solver = model._solver
        self._updater = self.solver.updater
        self._shardable = _tp_shardable_layers(model) if self.tp > 1 \
            else {}
        self._pipe = None
        if self.mesh_conf.pipeline > 1:
            self._init_pipelined()
        else:
            self._param_shardings = self._spec_tree(model.params_tree)
        if model.opt_state is None and self._pipe is None:
            model.opt_state = self.solver.init_opt_state(model.params_tree)
        self._restack()
        self._install_hook()

    # -- placement -------------------------------------------------------
    def _init_axes(self):
        """This process's coordinates and, on a mesh that spans processes,
        the process group of each axis that crosses them."""
        mesh = self.mesh
        groups = distributed.mesh_groups(mesh)    # collective
        self._dist = mesh.spans_processes
        self._dcoords = mesh.local_coords("data")
        self._mcoords = mesh.local_coords("model")
        self._scoords = mesh.local_coords("pipeline")
        self._gd = groups.get("data")
        self._gm = groups.get("model")
        self._gp = groups.get("pipeline")
        self._gall = groups.get("*")
        self.n_data = len(self._dcoords)
        if self._dist:
            if self._proc not in set(mesh.owners.reshape(-1).tolist()):
                raise ValueError(f"process {self._proc} holds no "
                                 f"coordinate of the mesh {mesh}")
            if (self._gm or self._gp) and self.n_data > 1:
                raise ValueError(
                    "a mesh whose model or pipeline axis crosses "
                    "processes holds one data coordinate per process")
            for name, g, held in (("model", self._gm, self._mcoords),
                                  ("pipeline", self._gp, self._scoords)):
                if g is not None and len(held) != 1:
                    raise ValueError(f"the {name} axis crosses processes "
                                     "with one coordinate each")
            self._data_total = self.mesh_conf.data
        else:
            # a mesh of this process's devices: the data axis repeats
            # over the processes of the job
            self._data_total = self.n_data * self._procs

    def _data_index(self, r: int) -> int:
        """The global data shard of local data shard ``r``."""
        if self._dist:
            return self._dcoords[r]
        return self._proc * self.n_data + r

    def _spec_tree(self, tree):
        """PartitionSpec per leaf: the placement record (the reference's
        ``_param_shardings``)."""
        out = {}
        for path, leaf in iter_leaves(tree):
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = _param_spec(path, tuple(leaf.shape), self.tp,
                                         self._shardable)
        return out

    def _stage_of(self, path) -> int:
        """The pipeline stage of a storage leaf (0 without a pipeline)."""
        if self._pipe is None:
            return 0
        keys = [str(k) for k in path]
        for i, k in enumerate(keys[:-1]):
            if k == "pre":
                return 0
            if k == "post":
                return self.mesh_conf.pipeline - 1
            if k == "run":
                lo, hi = self._pipe
                idx = int(keys[i + 1].split("_")[1])
                return (idx - lo) // ((hi - lo) // self.mesh_conf.pipeline)
        return 0

    def _device(self, r: int, c: Optional[int] = None,
                stage: Optional[int] = None):
        """The device of local data shard ``r`` at model coordinate ``c``
        and pipeline stage ``stage`` (default: this process's first)."""
        return self.mesh.device(
            data=self._dcoords[r],
            model=self._mcoords[0] if c is None else c,
            pipeline=self._scoords[0] if stage is None else stage)

    def _layout(self, tree, r: int, alias: bool = False):
        """A logical tree (per-layer, or the pipeline's {pre, run, post})
        in storage layout for data shard ``r``: a TP leaf becomes
        ``{"__tp0": shard, ...}`` on its model-axis devices, every leaf
        sits on its stage's device in storage of its own (``alias``: a
        leaf already there stays the same tensor).  On a mesh that spans
        processes only this process's shards and stages are kept."""
        def build(node, path):
            if isinstance(node, dict):
                out = {k: build(v, path + (k,)) for k, v in node.items()}
                return {k: v for k, v in out.items() if v is not _ABSENT}
            if not isinstance(node, torch.Tensor):
                return node
            stage = self._stage_of(path)
            if stage not in self._scoords:
                return _ABSENT
            kind = _param_kind(path, tuple(node.shape), self.tp,
                               self._shardable)
            if kind is None:
                dev = self._device(r, stage=stage)
                return node.to(dev) if alias else _own_copy(node, dev)
            parts = torch.chunk(node, self.tp, dim=-1 if kind == "col"
                                else 0)
            return {f"{_TP}{c}": _own_copy(parts[c].contiguous(),
                                           self._device(r, c, stage))
                    for c in self._mcoords}
        return build(tree, ())

    def _logical(self, tree, device):
        """Storage layout -> logical tree on ``device`` (TP shards
        concatenated; every process's shards on a mesh that spans
        processes — a collective)."""
        if self._dist:
            return self._gather_logical(tree, device)

        def build(node, path):
            if _is_tp_node(node):
                shards = [s.to(device) for s in _tp_shards(node)]
                dim = -1 if _rule(path, self._shardable) == "col" else 0
                return torch.cat(shards, dim)
            if isinstance(node, dict):
                return {k: build(v, path + (k,)) for k, v in node.items()}
            return node.to(device) if isinstance(node, torch.Tensor) \
                else node
        return build(tree, ())

    def _gather_logical(self, tree, device):
        """The logical tree of a storage tree whose shards and stages lie
        on several processes: the data-row-0 processes contribute their
        leaves (one all-gather over the mesh's processes), TP shards are
        concatenated in coordinate order, and the result takes this
        process's skeleton (every layer key, empty subtrees kept)."""
        import torch.distributed as dist
        mine = {}
        if self._dcoords[0] == 0:
            mine = {path: leaf.detach().to("cpu", copy=True)
                    for path, leaf in iter_leaves(tree)
                    if isinstance(leaf, torch.Tensor)}
        every = [None] * self._gall.size
        dist.all_gather_object(every, mine, group=self._gall.pg)
        pieces, whole = {}, {}
        for got in every:
            for path, t in got.items():
                if str(path[-1]).startswith(_TP):
                    c = int(str(path[-1])[len(_TP):])
                    pieces.setdefault(path[:-1], {})[c] = t
                else:
                    whole[path] = t
        for path, parts in pieces.items():
            dim = -1 if _rule(path, self._shardable) == "col" else 0
            whole[path] = torch.cat([parts[c] for c in sorted(parts)], dim)
        out = map_leaves(lambda _: None, tree)
        for path, t in whole.items():
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t.to(device)
        return out

    # -- pipeline --------------------------------------------------------
    def _init_pipelined(self):
        from deeplearning4j_torch.nn.conf.layers_core import (
            BaseOutputLayerConf)
        model, S = self.model, self.mesh_conf.pipeline
        run = _find_block_run(model)
        if run is None:
            raise ValueError(
                "MeshConfig.pipeline > 1 needs a MultiLayerNetwork "
                "with a run of >= 2 conf-identical "
                "TransformerEncoderBlocks to shard into stages")
        lo, hi = run
        if (hi - lo) % S:
            raise ValueError(f"{hi - lo} pipelined blocks do not divide "
                             f"over {S} stages")
        if getattr(model.conf, "frozen_layers", None):
            raise ValueError("pipeline path does not support frozen "
                             "layers yet")
        if model.conf.backprop_type != "standard":
            raise ValueError("pipeline path supports standard backprop "
                             "only (no tBPTT)")
        if not isinstance(model.layers[-1], BaseOutputLayerConf):
            raise ValueError("last layer must be an output layer")
        if getattr(model.layers[lo], "dropout", 0):
            log.warning("pipelined blocks run without dropout "
                        "(configured rate %.3g)",
                        model.layers[lo].dropout)
        self._pipe = (lo, hi)
        _PIPE_BUBBLE.set((S - 1) / (S - 1 + self.n_micro))

    def _pipe_split(self, per_layer: dict) -> dict:
        """Per-layer tree -> the pipeline's logical {pre, run, post}."""
        lo, hi = self._pipe
        n = len(self.model.layers)
        return {"pre": {f"layer_{i}": per_layer[f"layer_{i}"]
                        for i in range(lo)},
                "run": {f"layer_{i}": per_layer[f"layer_{i}"]
                        for i in range(lo, hi)},
                "post": {f"layer_{i}": per_layer[f"layer_{i}"]
                         for i in range(hi, n)}}

    @staticmethod
    def _run_to_blocks(tree):
        """The trainer's {pre, run, post} -> the canonical pipe layout
        {pre, blocks (each leaf stacked over the run), post}, wherever it
        nests (optimizer states hold it under updater keys)."""
        if isinstance(tree, dict):
            if set(tree) == {"pre", "run", "post"}:
                idx = sorted(int(k.split("_")[1]) for k in tree["run"])
                stacked = map_leaves(elastic.stack_leaves,
                                     *[tree["run"][f"layer_{i}"]
                                       for i in idx])
                return {"pre": tree["pre"], "blocks": stacked,
                        "post": tree["post"]}
            return {k: ShardedTrainer._run_to_blocks(v)
                    for k, v in tree.items()}
        return tree

    @staticmethod
    def _blocks_to_run(tree):
        """Inverse of :meth:`_run_to_blocks`."""
        if isinstance(tree, dict):
            if elastic.is_pipe_layout(tree):
                lo, hi = elastic.pipe_run(tree)
                flat = elastic.unstack_pipe(tree)
                return {"pre": tree["pre"],
                        "run": {f"layer_{i}": flat[f"layer_{i}"]
                                for i in range(lo, hi)},
                        "post": tree["post"]}
            return {k: ShardedTrainer._blocks_to_run(v)
                    for k, v in tree.items()}
        return tree

    # -- storage ---------------------------------------------------------
    def _restack(self):
        """(Re)build the trainer's parameter and optimizer storage from
        the model's trees — at init, and before the next step after an
        external restore overwrote them (``fit(resume=True)``, a
        rollback).  Without TP or a pipeline the storage IS the model's
        own tree (data shard 0 is the master); otherwise a copy laid out
        by shard, and the model's tree is refreshed lazily."""
        m = self.model
        self._aliased = self._pipe is None and not self._shardable
        dev0 = self._device(0)
        # the model state (batch-norm statistics) lives where data shard
        # 0 runs; an aliased master tree puts the model there too
        m.state_tree = map_leaves(
            lambda t: t.to(dev0) if isinstance(t, torch.Tensor) else t,
            m.state_tree)
        if self._aliased:
            m.device = dev0
        logical = (self._pipe_split(m.params_tree) if self._pipe
                   else m.params_tree)
        self._store = [self._layout(logical, 0, alias=self._aliased)]
        if self._aliased:
            m.params_tree = self._store[0]
        if self._pipe is not None or self._shardable:
            fresh = self._updater.init_state(self._store[0])
            restored = self._restored_opt(m.opt_state, fresh)
            self._opt = restored if restored is not None else fresh
        else:
            if m.opt_state is None:
                m.opt_state = self.solver.init_opt_state(m.params_tree)
            self._opt = self._layout(m.opt_state, 0, alias=True)
            m.opt_state = self._opt
        self._store += [self._layout(logical, r)
                        for r in range(1, self.n_data)]
        masks = self.solver.trainable_tree
        decay = self.solver.decay_tree
        if self._pipe is not None:
            self._trainable = self._decay = None
        else:
            self._trainable = (None if masks is None
                               else self._expand_like(masks))
            self._decay = (None if decay is None
                           else self._expand_like(decay))
        self._model_stale = False
        self._restack_needed = False

    def _expand_like(self, tree):
        """A per-leaf tree (masks, decay rates) in storage layout."""
        def build(node, path):
            if isinstance(node, dict):
                return {k: build(v, path + (k,)) for k, v in node.items()}
            shape = tuple(self._leaf(self.model.params_tree, path).shape)
            if _param_kind(path, shape, self.tp, self._shardable) is None:
                return node
            return {f"{_TP}{c}": (node.to(self._device(0, c))
                                  if isinstance(node, torch.Tensor)
                                  else node) for c in self._mcoords}
        return build(tree, ())

    @staticmethod
    def _leaf(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def _restored_opt(self, restored, fresh):
        """A restored optimizer state (logical, per-layer or pipe layout)
        in storage layout, or None when its structure does not fit
        ``fresh``'s (a fresh state is used then)."""
        if restored is None:
            return None
        if self._pipe is not None:
            # the pipe template's structure and shapes, no data
            canon = self._run_to_blocks(
                self._updater.init_state(map_leaves(
                    lambda t: t.to("meta"),
                    self._pipe_split(self.model.params_tree)))
                if self._dist else
                self._logical(fresh, torch.device("meta")))
            if elastic.opt_layout(restored) == "layers":
                converted = elastic.convert_opt_layout(restored, canon)
                if converted is None:
                    return None
                log.info("restacking restored per-layer optimizer state "
                         "into the %d-stage pipeline layout",
                         self.mesh_conf.pipeline)
                restored = converted
            restored = self._blocks_to_run(restored)
        laid = self._layout(restored, 0)
        if [p for p, _ in iter_leaves(laid)] != \
                [p for p, _ in iter_leaves(fresh)]:
            return None
        return laid

    def sync_model(self):
        """Write the trained parameters back into the model's own tree
        (copies) so ``output``/serialization see them.  Lazy: a no-op
        unless a step ran since the last sync."""
        if not self._model_stale:
            return
        self._model_stale = False
        if self._aliased:
            return
        m = self.model
        dev = m.device
        logical = self._logical(self._store[0], dev)
        if self._pipe is not None:
            logical = {**logical["pre"], **logical["run"],
                       **logical["post"]}
        m.params_tree = map_leaves(
            lambda t: t.detach().clone(), logical)

    def _sync_opt(self):
        """The checkpoint-capture protocol: the live optimizer state (in
        storage layout) into ``model.opt_state`` — logical per-layer, or
        the canonical pipe layout for a pipeline trainer."""
        if self._aliased:
            return
        logical = self._logical(self._opt, self.model.device)
        if self._pipe is not None:
            logical = self._run_to_blocks(logical)
        self.model.opt_state = map_leaves(lambda t: t.detach().clone(),
                                          logical)

    def _install_hook(self):
        wr = weakref.ref(self)

        def _hook():
            tr = wr()
            if tr is not None:
                tr.sync_model()

        def _discard_pending():
            # an external restore overwrote the model's trees: drop any
            # deferred sync and rebuild the storage from them before the
            # next step
            tr = wr()
            if tr is not None:
                tr._model_stale = False
                tr._restack_needed = True

        def _sync_opt():
            tr = wr()
            if tr is not None:
                tr._sync_opt()

        _hook.discard_pending = _discard_pending
        _hook.sync_opt = _sync_opt
        self.model._param_sync_hook = _hook

    # -- the step ----------------------------------------------------------
    def _shard_batch(self, batch: dict) -> List[dict]:
        """This process's data shards of a GLOBAL batch (every process
        feeds the identical global batch; process p keeps rows
        [p*B/P, (p+1)*B/P) and splits them over its data shards).
        Returns one batch dict per local data shard, on its device."""
        shards = self._data_total

        def split(v, r, dev):
            if isinstance(v, dict):
                return {k: split(x, r, dev) for k, x in v.items()}
            t = v if isinstance(v, torch.Tensor) else \
                torch.as_tensor(np.asarray(v))
            if t.dtype == torch.float64:
                t = t.float()
            if shards > 1 and t.ndim >= 1:
                if t.shape[0] % shards:
                    raise ElasticWorldError(
                        f"global batch of {t.shape[0]} examples does not "
                        f"divide over data={shards} — a shrunk/grown "
                        "fleet keeps the GLOBAL batch size by resizing "
                        "per-rank microbatches, which only works in "
                        "whole examples")
                n = t.shape[0] // shards
                k = self._data_index(r)
                t = t[k * n:(k + 1) * n]
            return t.to(dev)
        return [split(batch, r, self._device(r)) for r in
                range(self.n_data)]

    def _live(self, store):
        """(forward tree, autograd leaves) of one shard's storage."""
        leaves = []

        def build(node, path):
            if _is_tp_node(node):
                shards = [s.detach().requires_grad_(True)
                          for s in _tp_shards(node)]
                leaves.extend(shards)
                return TpLeaf(shards, _rule(path, self._shardable),
                              self._gm)
            if isinstance(node, dict):
                return {k: build(node[k], path + (k,))
                        for k in sorted(node)}
            leaf = node.detach().requires_grad_(True)
            leaves.append(leaf)
            return leaf
        return build(store, ()), leaves

    @staticmethod
    def _flat(store) -> List[torch.Tensor]:
        return [t for _, t in iter_leaves(store)]

    def _shard_states(self, state, n_rows):
        """The model state per data shard: recurrent carries (``rnn_*``,
        batch-sized) split by rows, everything else replicated."""
        out = []
        for r in range(self.n_data):
            dev = self._device(r)

            def build(node, key=""):
                if isinstance(node, dict):
                    return {k: build(v, k) for k, v in node.items()}
                if key.startswith("rnn_") and node.shape[0] == \
                        n_rows * self.n_data:
                    return node[r * n_rows:(r + 1) * n_rows].to(dev)
                return node if r == 0 else _own_copy(node, dev)
            out.append(build(state))
        return out

    def _merge_states(self, states):
        """Shard 0's new state, recurrent carries concatenated back."""
        def build(nodes, key=""):
            if isinstance(nodes[0], dict):
                return {k: build([n[k] for n in nodes], k)
                        for k in nodes[0]}
            if key.startswith("rnn_") and len(nodes) > 1:
                return torch.cat([n.to(nodes[0].device) for n in nodes])
            return nodes[0]
        return build(states)

    def _process_sum(self, tensors):
        """Differentiable sum over the processes of the data axis (batch
        norm's sums)."""
        if self._dist:
            return [_SumBoth.apply(t, self._gd) for t in tensors]
        import torch.distributed.nn.functional as dfn
        return [dfn.all_reduce(t) for t in tensors]

    def _data_sum(self, tensors: List[torch.Tensor]) -> List[torch.Tensor]:
        """Sum over the data group of a mesh that spans processes, one
        flat bucket per dtype, in data-coordinate order."""
        if self._gd is None:
            return list(tensors)
        out = list(tensors)
        by_dtype = {}
        for i, t in enumerate(tensors):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = self._gd.sum(torch.cat(
                [tensors[i].reshape(-1).to(tensors[idx[0]].device)
                 for i in idx]))
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view_as(tensors[i]) \
                    .to(tensors[i].device)
                off += n
        return out

    def _forward_backward(self, shards: List[dict], rng, pipe: bool):
        """Every data shard's forward (in lockstep threads), one backward
        over their summed losses; returns (loss, grads per storage leaf
        summed over shards and processes, new model state)."""
        m = self.model
        n_rows = next(t for _, t in iter_leaves(shards[0])
                      if isinstance(t, torch.Tensor)).shape[0]
        total = n_rows * self._data_total
        group = spmd.Lockstep(self.n_data)
        lives = [self._live(s) for s in self._store]
        if pipe and self._gp is not None:
            return self._pipe_stage_step(lives[0], shards[0], n_rows)
        states = (None if pipe else
                  self._shard_states(m.state_tree, n_rows))
        psum = (self._process_sum if (self._gd is not None if self._dist
                                      else self._procs > 1) else None)

        def body(r):
            info = spmd.ShardRows(
                rank=r, offset=self._data_index(r) * n_rows,
                rows=n_rows, total=total,
                lead=self._data_index(r) == 0, group=group,
                process_sum=psum)

            def run():
                with spmd.shard_scope(info), torch.enable_grad():
                    if pipe:
                        return self._pipe_loss(lives[r][0], shards[r], r)
                    return m._score_batch(lives[r][0], states[r],
                                          shards[r], rng, True)
            return run

        outs = group.run([body(r) for r in range(self.n_data)])
        dev0 = self._device(0)
        losses = [o if pipe else o[0] for o in outs]
        loss = losses[0].to(dev0)
        for l in losses[1:]:
            loss = loss + l.to(dev0)
        obj = loss if self.solver.minimize else -loss
        leaves = [lf for _, lvs in lives for lf in lvs]
        with torch.enable_grad():
            grads = torch.autograd.grad(obj, leaves, allow_unused=True)
        n_leaf = len(lives[0][1])
        master = self._flat(self._store[0])
        summed = []
        for i in range(n_leaf):
            acc = None
            for r in range(self.n_data):
                g = grads[r * n_leaf + i]
                if g is None:
                    g = torch.zeros_like(lives[r][1][i])
                g = g.to(master[i].device)
                acc = g if acc is None else acc + g
            summed.append(acc)
        loss = loss.detach()
        if self._dist:
            summed = self._data_sum(summed)
            loss = self._data_sum([loss])[0]
        elif distributed.group_live():
            # the gradient all-reduce after the local shard sum (a joined
            # process group of one world still takes it: the collective
            # path is the same)
            summed = distributed.all_reduce_sum_tensors(summed)
            loss = distributed.all_reduce_sum_tensors([loss])[0]
        new_state = None if pipe else self._merge_states(
            [map_leaves(torch.Tensor.detach, o[1]) for o in outs])
        return loss, summed, new_state

    def _pipe_stage_step(self, live, batch, n_rows):
        """This process's pipeline stage of one step when the pipeline
        axis crosses processes: stage 0 runs the pre layers, every stage
        its blocks under ``gpipe_stage`` (activations on to the next
        stage's process), the last stage the rest and the loss; the
        backward runs from the last stage down, each stage receiving its
        outputs' gradients and sending its inputs' back.  Each stage adds
        its own layers' regularization.  Returns (loss, grads, None)
        with the loss broadcast from the last stage and everything
        summed over the data group."""
        m = self.model
        lo, hi = self._pipe
        gp, S = self._gp, self.mesh_conf.pipeline
        s = gp.index
        layers, confs = m.layers, m.conf
        tree, leaves = live
        params = {**tree["pre"], **tree["run"], **tree["post"]}
        cd, state0, dev = m._compute_dtype, m.state_tree, self._device(0)
        per = (hi - lo) // S
        check_pipeline(hi - lo, S, n_rows, self.n_micro)
        sign = 1.0 if self.solver.minimize else -1.0

        def outer(i, x):
            pre = confs.preprocessors[i]
            if pre is not None:
                x = pre(x)
            return apply_layer(layers[i], params[f"layer_{i}"],
                               state0[f"layer_{i}"], x, compute_dtype=cd,
                               training=False, rng=None)[0]

        def stage(h):
            for i in range(lo + s * per, lo + (s + 1) * per):
                h = layers[i].apply(params[f"layer_{i}"], h,
                                    compute_dtype=cd, training=False)
            return h

        info = spmd.ShardRows(rank=0, offset=self._data_index(0) * n_rows,
                              rows=n_rows, total=n_rows * self._data_total,
                              lead=self._data_index(0) == 0)
        with spmd.shard_scope(info), torch.enable_grad():
            x = None
            if s == 0:
                x = batch["features"].to(dev)
                for i in range(lo):
                    x = outer(i, x)
            ins, outs = gpipe_stage(stage, gp, x, self.n_micro, dev)
            reg = spmd.regularization_share(m._regularization_score(params))
            if s == S - 1:
                x = torch.cat(outs, 0)
                for i in range(hi, len(layers) - 1):
                    x = outer(i, x)
                pre = confs.preprocessors[-1]
                if pre is not None:
                    x = pre(x)
                last = f"layer_{len(layers) - 1}"
                z = layers[-1].pre_output(params[last], x, cd)
                scores = layers[-1].per_example_score(
                    batch["labels"].to(z.device), z, None, head_input=x,
                    params=params[last])
                loss = spmd.batch_mean(scores)
                obj = sign * (loss + reg)
            else:
                # the surrogate whose gradient is the received one
                obj = sum((o.float() * gp.recv(s + 1, dev).float()).sum()
                          for o in outs) + sign * reg
                loss = torch.zeros((), dtype=torch.float32, device=dev)
        with torch.enable_grad():
            grads = torch.autograd.grad(obj, leaves + ins,
                                        allow_unused=True)
        for g, h in zip(grads[len(leaves):], ins):
            gp.send(torch.zeros_like(h) if g is None else g, s - 1)
        grads = [torch.zeros_like(lf) if g is None else g
                 for g, lf in zip(grads[:len(leaves)], leaves)]
        loss = gp.broadcast(loss.detach().float().reshape(1), S - 1)
        reg_t = torch.as_tensor(reg, dtype=torch.float32, device=dev)
        loss = (loss + gp.sum(reg_t.detach().reshape(1)))[0]
        grads = self._data_sum(grads)
        loss = self._data_sum([loss])[0]
        return loss, grads, None

    def _broadcast(self):
        """The updated master parameters into every other data shard's
        replica (in place)."""
        if self.n_data == 1:
            return
        master = self._flat(self._store[0])
        with torch.no_grad():
            for r in range(1, self.n_data):
                for dst, src in zip(self._flat(self._store[r]), master):
                    dst.copy_(src)

    @staticmethod
    def _unflatten(like, flat):
        """``flat`` (in ``iter_leaves`` order) in the structure of
        ``like``, empty subtrees (layers without parameters) kept."""
        it = iter(flat)

        def build(node):
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            return next(it)
        return build(like)

    def _step_dict(self, batch: dict):
        """Run one sharded step on a prepared batch dict WITHOUT touching
        the model's iteration counters (the step counter DOES advance)."""
        m = self.model
        tracer = telemetry.get_tracer()
        if self._restack_needed:
            self._restack()
        pipe = self._pipe is not None
        if pipe and ("features_mask" in batch or "labels_mask" in batch):
            raise ValueError("pipeline path does not support masked "
                             "batches yet")
        if pipe:
            batch = {"features": batch["features"],
                     "labels": batch["labels"]}
        shards = self._shard_batch(batch)
        if self._aliased and m.params_tree is not self._store[0]:
            self._restack()
        prof = telemetry.get_profiler()
        span = "train/pipeline_step" if pipe else "train/sharded_step"
        with prof.measure("optimizer_step",
                          every=_PROFILE_STEP_EVERY) as pm:
            with tracer.span(span, mesh=str(self.mesh.shape)):
                rng = None if pipe else m._rng.next_key()
                loss, grads, new_state = self._forward_backward(
                    shards, rng, pipe)
                gtree = self._unflatten(self._store[0], grads)
                lr_scale = float(getattr(m, "_lr_backoff", 1.0))
                if pipe:
                    self._pipe_update(gtree, loss, m.iteration_count,
                                      lr_scale)
                else:
                    _, _, state, loss = self.solver.apply_grads(
                        self._store[0], self._opt, m.state_tree,
                        new_state, gtree, loss, m.iteration_count,
                        lr_scale, trainable_tree=self._trainable,
                        decay_tree=self._decay,
                        normalize=self._normalize)
                    m.state_tree = state
                self._broadcast()
            pm.ready(loss)
        if not self._aliased:
            self._model_stale = True
        self._step_counter.inc()
        return loss

    def _normalize(self, grads):
        """Gradient normalization on the LOGICAL gradients (a per-layer
        norm must see the whole leaf, not one shard)."""
        kind = self.solver.grad_normalization
        if not kind or kind == "none":
            return grads
        if not self._shardable and not self._dist:
            return normalize_gradients(grads, kind,
                                       self.solver.grad_norm_threshold)
        logical = self._logical(grads, self._device(0))
        normed = normalize_gradients(logical, kind,
                                     self.solver.grad_norm_threshold)
        return self._layout(normed, 0, alias=True)

    def _pipe_update(self, grads, loss, it, lr_scale):
        """The reference's pipelined step after the backward: the bad-step
        guard, the updater and the in-place update."""
        with torch.no_grad():
            ok = finite_step_ok(loss, grads)
            updates, new_opt = self._updater.update(grads, self._opt,
                                                    self._store[0], it)
            apply_updates_if(ok, self._store[0], updates, lr_scale)
            new_opt = self._updater.finalize(new_opt, self._store[0])
            select_step(ok, new_opt, self._opt)

    def _pipe_loss(self, live, batch, r):
        """One data shard's pipelined forward: the pre layers on stage 0,
        the block run by the GPipe schedule over the stages, the rest and
        the loss on the last stage."""
        m = self.model
        lo, hi = self._pipe
        S = self.mesh_conf.pipeline
        layers, confs = m.layers, m.conf
        params = {**live["pre"], **live["run"], **live["post"]}
        cd = m._compute_dtype
        state0 = m.state_tree

        def outer(i, x):
            pre = confs.preprocessors[i]
            if pre is not None:
                x = pre(x)
            return apply_layer(layers[i], params[f"layer_{i}"],
                               state0[f"layer_{i}"], x, compute_dtype=cd,
                               training=False, rng=None)[0]

        x, labels = batch["features"], batch["labels"]
        x = x.to(self._device(r, stage=0))
        for i in range(lo):
            x = outer(i, x)
        per = (hi - lo) // S
        check_pipeline(hi - lo, S, x.shape[0], self.n_micro)
        devs = [self._device(r, stage=s) for s in range(S)]

        def stage(s, h):
            for i in range(lo + s * per, lo + (s + 1) * per):
                h = layers[i].apply(params[f"layer_{i}"], h,
                                    compute_dtype=cd, training=False)
            return h
        x = gpipe_schedule([lambda h, s=s: stage(s, h) for s in range(S)],
                           devs, x, self.n_micro)
        for i in range(hi, len(layers) - 1):
            x = outer(i, x)
        pre = confs.preprocessors[-1]
        if pre is not None:
            x = pre(x)
        last = f"layer_{len(layers) - 1}"
        out_layer = layers[-1]
        z = out_layer.pre_output(params[last], x, cd)
        scores = out_layer.per_example_score(labels.to(z.device), z, None,
                                             head_input=x,
                                             params=params[last])
        reg = m._regularization_score(params)
        return spmd.batch_mean(scores) + spmd.regularization_share(reg)

    def _step_batch(self, features, labels, features_mask=None,
                    labels_mask=None):
        m = self.model
        batch = {"features": m._tensor(features),
                 "labels": m._tensor(labels)}
        if features_mask is not None:
            batch["features_mask"] = m._tensor(features_mask)
        if labels_mask is not None:
            batch["labels_mask"] = m._tensor(labels_mask)
        return self._step_dict(batch)

    def fit_batch(self, features, labels, features_mask=None,
                  labels_mask=None):
        """One global step: shard the batch, step, return the loss (a
        0-d tensor).  On the pipeline or TP path the model's own tree
        syncs LAZILY (when ``output``/serialization next reads it)."""
        loss = self._step_batch(features, labels, features_mask,
                                labels_mask)
        self.model.iteration_count += 1
        return loss

    def fit(self, iterator, n_epochs: int = 1, resume: bool = False):
        """Drive an iterator through the sharded step — the shared epoch
        loop (``run_fit``), so tBPTT, MultiDataSet batches, listeners,
        counters and ``resume=True`` agree with the model's own fit."""
        out = run_fit(self.model, iterator, n_epochs, self._step_dict,
                      resume=resume)
        self.sync_model()
        return out

    @property
    def param_shardings(self) -> Dict:
        return self._param_shardings
