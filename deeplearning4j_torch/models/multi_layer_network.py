"""MultiLayerNetwork: the sequential-stack model (port of
``deeplearning4j_tpu/models/multi_layer_network.py``: ``init``,
``output``, ``feed_forward``, ``score``, ``fit``, ``evaluate*``, the
parameter views, ``clone`` and ``save``/``load``).

``params_tree`` keeps the reference's shape — ``{"layer_i": {name:
tensor}}`` with the same names and ``x @ W`` layouts — as plain
dictionaries of f32 master tensors on ``self.device``, so a checkpoint or
a JAX ``params_tree`` carries over leaf by leaf; ``opt_state`` mirrors
the reference's updater state the same way.  ``fit`` drives one eager
``Solver.step`` per minibatch (forward, loss, autograd backward, updater,
in-place update) through ``optimize.fit_loop.run_fit``; with a bfloat16
``compute_dtype`` every matmul runs in bf16 on the f32 master weights.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.data.iterator import (AsyncDataSetIterator,
                                                DataSetIterator,
                                                ListDataSetIterator)
from deeplearning4j_torch.eval import (Evaluation, RegressionEvaluation,
                                       ROCMultiClass)
from deeplearning4j_torch.nn.conf.base import BaseLayerConf
from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_torch.nn.conf.layers_core import BaseOutputLayerConf
from deeplearning4j_torch.optimize.fit_loop import run_fit
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.optimize.solver import Solver
from deeplearning4j_torch.optimize.updaters import updater_from_dict
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.dtype import canonical_dtype
from deeplearning4j_torch.runtime.rng import RngKeyManager, split
from deeplearning4j_torch.utils.trees import (get_path, iter_leaves,
                                              map_leaves, set_path)

log = logging.getLogger("deeplearning4j_torch")


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: Sequence[BaseLayerConf] = conf.layers
        self.params_tree = None
        self.state_tree = None
        self.opt_state = None
        self.listeners: List[TrainingListener] = []
        self.iteration_count = 0
        self.epoch_count = 0
        self.batch_in_epoch = 0
        self.last_batch_size = 0
        self.device: Optional[torch.device] = None
        self._rng = RngKeyManager(conf.global_conf.seed)
        self._dtype = canonical_dtype(conf.global_conf.dtype)
        cd = getattr(conf.global_conf, "compute_dtype", None)
        self._compute_dtype = canonical_dtype(cd) if cd else torch.float32
        self._solver: Optional[Solver] = None

    # ------------------------------------------------------------------
    # Initialization
    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None,
             device="cuda") -> "MultiLayerNetwork":
        """Initialize parameters on ``device`` from an explicit generator
        seeded with ``seed`` (default: the configuration's seed).  The
        values differ from the JAX package's for the same seed; carry
        weights across with ``utils.convert.load_numpy_params``."""
        dev = resolve_device(device)
        if seed is not None:
            self._rng.reset(seed)
        seed = self.conf.global_conf.seed if seed is None else seed
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.params_tree = {f"layer_{i}": ly.init(gen, self._dtype, dev)
                            for i, ly in enumerate(self.layers)}
        self.state_tree = {f"layer_{i}": {} for i in range(len(self.layers))}
        self.opt_state = None        # built at the first fit
        self.device = dev
        return self

    def _check_init(self):
        if self.params_tree is None:
            self.init()

    # ------------------------------------------------------------------
    # Forward / score
    # ------------------------------------------------------------------
    def _forward_layers(self, params, state, x, training, rng, upto=None,
                        mask=None):
        """Run layers [0, upto); returns (activation, state tree).  ``mask``
        is the features mask ([b, t] for sequences) handed to mask-aware
        layers (``USES_MASK``); ``rng`` (an integer key) is split into one
        key per layer for dropout."""
        n = len(self.layers) if upto is None else upto
        keys = split(rng, n) if rng is not None else [None] * n
        for i in range(n):
            ly = self.layers[i]
            pre = self.conf.preprocessors[i]
            if pre is not None:
                x = pre(x)
            kwargs = {"mask": mask} if getattr(ly, "USES_MASK", False) \
                else {}
            x = ly.apply(params[f"layer_{i}"], x,
                         compute_dtype=self._compute_dtype,
                         training=training, rng=keys[i], **kwargs)
        return x, dict(state)

    def _regularization_score(self, params):
        reg = 0.0
        for i, ly in enumerate(self.layers):
            l1, l2 = ly.l1 or 0.0, ly.l2 or 0.0
            if not (l1 or l2):
                continue
            for name in ly.regularized_param_names():
                w = get_path(params[f"layer_{i}"], name)
                if w is None:
                    continue
                if l1:
                    reg = reg + l1 * torch.sum(torch.abs(w))
                if l2:
                    # DL4J L2Regularization score: 0.5 * l2 * sum(w^2)
                    reg = reg + 0.5 * l2 * torch.sum(torch.square(w))
        return reg

    def _score_batch(self, params, state, batch, rng, training):
        """Mean per-example loss + regularization (DL4J ``score()``);
        returns (loss, state tree)."""
        labels = batch["labels"]
        lmask = batch.get("labels_mask")
        out_layer = self.layers[-1]
        if not isinstance(out_layer, BaseOutputLayerConf):
            raise ValueError("Last layer must be an output/loss layer for "
                             "fit()")
        h, new_state = self._forward_layers(
            params, state, batch["features"], training, rng,
            upto=len(self.layers) - 1, mask=batch.get("features_mask"))
        pre = self.conf.preprocessors[-1]
        if pre is not None:
            h = pre(h)
        z = out_layer.pre_output(params[f"layer_{len(self.layers) - 1}"], h,
                                 self._compute_dtype)
        scores = out_layer.per_example_score(labels, z, lmask)
        if lmask is not None:
            loss = scores.sum() / torch.clamp(lmask.sum(), min=1.0)
        else:
            loss = scores.mean()
        return loss + self._regularization_score(params), new_state

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _trainable_mask(self):
        """0/1 mask tree from ``conf.frozen_layers`` (0-d tensors), or
        None when nothing is frozen."""
        frozen = set(getattr(self.conf, "frozen_layers", ()) or ())
        if not frozen:
            return None
        return {f"layer_{i}": map_leaves(
                    lambda p, i=i: torch.tensor(0.0 if i in frozen else 1.0,
                                                device=p.device),
                    self.params_tree[f"layer_{i}"])
                for i in range(len(self.layers))}

    def _build_solver(self):
        if self._solver is not None:
            return
        decay_tree = map_leaves(lambda _: 0.0, self.params_tree)
        any_decay = False
        for i, ly in enumerate(self.layers):
            wd = ly.weight_decay or 0.0
            if wd:
                any_decay = True
                for name in ly.regularized_param_names():
                    if get_path(decay_tree[f"layer_{i}"], name) is not None:
                        set_path(decay_tree[f"layer_{i}"], name, wd)
        # built here, not at construction: a checkpoint whose updater is
        # not ported yet still loads and serves
        self._solver = Solver(
            score_fn=self._score_batch,
            updater=updater_from_dict(self.conf.global_conf.updater),
            grad_normalization=self.conf.grad_normalization,
            grad_norm_threshold=self.conf.grad_norm_threshold,
            minimize=self.conf.global_conf.minimize,
            decay_tree=decay_tree if any_decay else None,
            trainable_tree=self._trainable_mask(),
        )
        if self.opt_state is None:
            self.opt_state = self._solver.init_opt_state(self.params_tree)

    def _batch_dict(self, ds: DataSet):
        """A DataSet's arrays as tensors on the net's device (float64 ->
        float32, as the reference's ``jnp.asarray`` gives)."""
        def dev(a):
            t = torch.as_tensor(np.asarray(a), device=self.device)
            return t.float() if t.dtype == torch.float64 else t
        b = {"features": dev(ds.features), "labels": dev(ds.labels)}
        if ds.labels_mask is not None:
            b["labels_mask"] = dev(ds.labels_mask)
        if ds.features_mask is not None:
            b["features_mask"] = dev(ds.features_mask)
        return b

    def fit(self, data: Union[DataSet, DataSetIterator], n_epochs: int = 1,
            async_prefetch: bool = True, resume: bool = False):
        """Train (DL4J ``fit(DataSetIterator, numEpochs)`` /
        ``fit(DataSet)``).  An iterator is wrapped in async prefetch, as
        DL4J wraps it in ``AsyncDataSetIterator``; a single DataSet is
        not (nothing to overlap).  Returns the last loss."""
        self._check_init()
        self._build_solver()
        if isinstance(data, DataSet):
            iterator: DataSetIterator = ListDataSetIterator([data])
            async_prefetch = False
        else:
            iterator = data
        wrapped = (AsyncDataSetIterator(iterator)
                   if async_prefetch and not isinstance(
                       iterator, AsyncDataSetIterator)
                   else iterator)
        return run_fit(self, wrapped, n_epochs, reset_target=iterator,
                       resume=resume)

    # ------------------------------------------------------------------
    # Inference / scoring
    # ------------------------------------------------------------------
    @torch.no_grad()
    def output(self, x, training: bool = False, features_mask=None):
        """Forward pass returning final-layer activations (DL4J
        ``output(INDArray[, featuresMask])``) as a tensor on
        ``self.device``; ``training=True`` applies dropout."""
        self._check_init()
        x = torch.as_tensor(x, device=self.device)
        if features_mask is not None:
            features_mask = torch.as_tensor(features_mask,
                                            device=self.device)
        rng = self._rng.next_key() if training else None
        return self._forward_layers(self.params_tree, self.state_tree, x,
                                    training, rng, mask=features_mask)[0]

    @torch.no_grad()
    def feed_forward(self, x, training: bool = False) -> List[torch.Tensor]:
        """All per-layer activations, the input first (DL4J
        ``feedForward``); no features mask, as in the reference."""
        self._check_init()
        x = torch.as_tensor(x, device=self.device)
        acts = [x]
        rng = self._rng.next_key() if training else None
        keys = (split(rng, len(self.layers)) if rng is not None
                else [None] * len(self.layers))
        for i, ly in enumerate(self.layers):
            pre = self.conf.preprocessors[i]
            if pre is not None:
                x = pre(x)
            x = ly.apply(self.params_tree[f"layer_{i}"], x,
                         compute_dtype=self._compute_dtype,
                         training=training, rng=keys[i])
            acts.append(x)
        return acts

    @torch.no_grad()
    def score(self, ds: DataSet) -> float:
        """Loss on a dataset without updating (DL4J ``score(DataSet)``)."""
        self._check_init()
        loss, _ = self._score_batch(self.params_tree, self.state_tree,
                                    self._batch_dict(ds), None, False)
        return float(loss)

    def _host_output(self, x, features_mask=None) -> np.ndarray:
        """``output`` as a host numpy array (what the evaluators take)."""
        out = self.output(x, features_mask=features_mask)
        if out.dtype == torch.bfloat16:
            out = out.float()
        return out.cpu().numpy()

    def evaluate(self, iterator: DataSetIterator,
                 top_n: int = 1) -> Evaluation:
        """(DL4J ``evaluate(DataSetIterator)``); each batch's features
        mask goes to ``output``."""
        self._check_init()
        ev = Evaluation(top_n=top_n)
        for ds in iterator:
            ev.eval(ds.labels, self._host_output(ds.features,
                                                 ds.features_mask),
                    ds.labels_mask)
        iterator.reset()
        return ev

    def evaluate_regression(self, iterator) -> RegressionEvaluation:
        self._check_init()
        ev = RegressionEvaluation()
        for ds in iterator:
            ev.eval(ds.labels, self._host_output(ds.features),
                    ds.labels_mask)
        iterator.reset()
        return ev

    def evaluate_roc(self, iterator, exact: bool = True) -> ROCMultiClass:
        self._check_init()
        roc = ROCMultiClass(exact=exact)
        for ds in iterator:
            roc.eval(ds.labels, self._host_output(ds.features),
                     ds.labels_mask)
        iterator.reset()
        return roc

    # ------------------------------------------------------------------
    # Parameter access (DL4J flattened-vector views)
    # ------------------------------------------------------------------
    def _leaf_order(self):
        """((path...), leaf) pairs, layer-major then name-sorted."""
        for i in range(len(self.layers)):
            for path, leaf in iter_leaves(self.params_tree[f"layer_{i}"]):
                yield (f"layer_{i}",) + path, leaf

    def params(self) -> np.ndarray:
        """One flattened host vector, layer-major then name-sorted — the
        DL4J ``params()`` view."""
        self._check_init()
        parts = [leaf.detach().float().cpu().numpy().reshape(-1)
                 for _, leaf in self._leaf_order()]
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.float32))

    @torch.no_grad()
    def set_params(self, vector: np.ndarray):
        """Write a flattened vector back into the leaves, in place."""
        self._check_init()
        vector = np.asarray(vector)
        leaves = list(self._leaf_order())
        total = sum(leaf.numel() for _, leaf in leaves)
        if total != vector.size:
            raise ValueError(f"Expected {total} values, got {vector.size}")
        off = 0
        for _, leaf in leaves:
            n = leaf.numel()
            leaf.copy_(torch.from_numpy(np.array(
                vector[off:off + n].reshape(tuple(leaf.shape)))))
            off += n

    def num_params(self) -> int:
        self._check_init()
        return sum(leaf.numel() for _, leaf in self._leaf_order())

    def set_listeners(self, *listeners: TrainingListener):
        self.listeners = list(listeners)

    def add_listeners(self, *listeners: TrainingListener):
        self.listeners.extend(listeners)

    def clone(self) -> "MultiLayerNetwork":
        """A new network on the same device with a copy of the
        configuration, parameters, state and counters (not the updater
        state, as in the reference).  The tensors are copies: ``fit``
        updates parameters in place."""
        m = MultiLayerNetwork(MultiLayerConfiguration.from_dict(
            self.conf.to_dict()))
        if self.params_tree is not None:
            m.params_tree = map_leaves(torch.clone, self.params_tree)
            m.state_tree = map_leaves(torch.clone, self.state_tree)
        m.device = self.device
        m.iteration_count = self.iteration_count
        m.epoch_count = self.epoch_count
        return m

    def save(self, path, save_updater: bool = True):
        """The reference's checkpoint zip (``utils.model_serializer``)."""
        from deeplearning4j_torch.utils.model_serializer import write_model
        write_model(self, path, save_updater=save_updater)

    @staticmethod
    def load(path, load_updater: bool = True,
             device="cuda") -> "MultiLayerNetwork":
        """Restore a checkpoint zip (either package's) onto ``device``."""
        from deeplearning4j_torch.utils.model_serializer import restore_model
        return restore_model(path, device=device, load_updater=load_updater)

    def summary(self) -> str:
        """Layer table (DL4J ``summary()``)."""
        self._check_init()
        rows = [f"{'idx':<4} {'name':<22} {'type':<24} {'#params':>10}"]
        total = 0
        for i, ly in enumerate(self.layers):
            n = sum(a.numel() for _, a in
                    iter_leaves(self.params_tree[f"layer_{i}"]))
            total += n
            rows.append(f"{i:<4} {(ly.name or f'layer_{i}'):<22} "
                        f"{type(ly).__name__:<24} {n:>10}")
        rows.append(f"Total params: {total}")
        return "\n".join(rows)
