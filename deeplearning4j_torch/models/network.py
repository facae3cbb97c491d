"""What the two network classes share (``MultiLayerNetwork`` and
``ComputationGraph``; the reference spells it out in both).

A network keeps ``params_tree`` and ``state_tree`` as dictionaries keyed
by a tree key per layer (``layer_i`` in a stack, the vertex name in a
graph) and names its layers through ``_named_layers()``; the flattened
parameter view follows ``_leaf_order()``.  On that this class builds the
solver (weight decay, frozen layers), ``fit``, the recurrent-state
handling of truncated BPTT, regularization, batch tensors, the
evaluators, the parameter vector, listeners, ``clone`` and ``save``.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from deeplearning4j_torch.data.dataset import (DataSet, MultiDataSet,
                                               tbptt_segments)
from deeplearning4j_torch.data.iterator import (AsyncDataSetIterator,
                                                DataSetIterator,
                                                ListDataSetIterator)
from deeplearning4j_torch.eval import (Evaluation, RegressionEvaluation,
                                       ROCMultiClass)
from deeplearning4j_torch.nn.conf.base import BaseLayerConf
from deeplearning4j_torch.nn.conf.layers_recurrent import strip_rnn_carry
from deeplearning4j_torch.optimize.fit_loop import run_fit
from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.optimize.solver import Solver
from deeplearning4j_torch.optimize.updaters import updater_from_dict
from deeplearning4j_torch.runtime.dtype import canonical_dtype
from deeplearning4j_torch.runtime.rng import RngKeyManager
from deeplearning4j_torch.utils.trees import get_path, map_leaves, set_path


class BaseNetwork:
    def __init__(self, conf):
        self.conf = conf
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
        # rnn_time_step's carry, apart from state_tree (DL4J's stateMap)
        self._rnn_state_map = None

    # -- what each class supplies ---------------------------------------
    def _named_layers(self) -> Iterable[Tuple[str, BaseLayerConf]]:
        """(tree key, layer) for every layer."""
        raise NotImplementedError

    def _leaf_order(self):
        """((tree key, path...), leaf) in the reference's flattened
        order."""
        raise NotImplementedError

    def _frozen_keys(self) -> set:
        """The tree keys of ``conf.frozen_layers``."""
        raise NotImplementedError

    def _check_init(self):
        if self.params_tree is None:
            self.init()
        # a trainer holding the live (sharded or pipeline-stacked) params
        # installs this hook; it refreshes params_tree lazily, so the
        # per-step hot path never pays the sync
        hook = self.__dict__.get("_param_sync_hook")
        if hook is not None:
            hook()

    def _tensor(self, a):
        """A host array (float64 -> float32, as the reference's
        ``jnp.asarray`` gives) or a tensor, on the net's device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device)
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    # -- training --------------------------------------------------------
    def _regularization_score(self, params):
        reg = 0.0
        for key, ly in self._named_layers():
            l1, l2 = ly.l1 or 0.0, ly.l2 or 0.0
            if not (l1 or l2):
                continue
            for name in ly.regularized_param_names():
                w = get_path(params[key], name)
                if w is None:
                    continue
                if l1:
                    reg = reg + l1 * torch.sum(torch.abs(w))
                if l2:
                    # DL4J L2Regularization score: 0.5 * l2 * sum(w^2)
                    reg = reg + 0.5 * l2 * torch.sum(torch.square(w))
        return reg

    def _trainable_mask(self):
        """0/1 mask tree from ``conf.frozen_layers`` (0-d tensors), or
        None when nothing is frozen."""
        frozen = self._frozen_keys()
        if not frozen:
            return None
        return {key: map_leaves(
                    lambda p, f=key in frozen: torch.tensor(
                        0.0 if f else 1.0, device=p.device), sub)
                for key, sub in self.params_tree.items()}

    def _build_solver(self, alloc_opt_state: bool = True):
        """The solver, built once; and the model's optimizer state when
        asked and not there yet (``compiled_train_step`` builds the solver
        without it, so a later ``fit`` still gets its state)."""
        if self._solver is None:
            decay_tree = map_leaves(lambda _: 0.0, self.params_tree)
            any_decay = False
            for key, ly in self._named_layers():
                wd = ly.weight_decay or 0.0
                if wd:
                    any_decay = True
                    for name in ly.regularized_param_names():
                        if get_path(decay_tree[key], name) is not None:
                            set_path(decay_tree[key], name, wd)
            # built here, not at construction: a checkpoint whose updater
            # is not ported yet still loads and serves
            self._solver = Solver(
                score_fn=self._score_batch,
                updater=updater_from_dict(self.conf.global_conf.updater),
                grad_normalization=self.conf.grad_normalization,
                grad_norm_threshold=self.conf.grad_norm_threshold,
                minimize=self.conf.global_conf.minimize,
                decay_tree=decay_tree if any_decay else None,
                trainable_tree=self._trainable_mask(),
            )
        if alloc_opt_state and self.opt_state is None:
            self.opt_state = self._solver.init_opt_state(self.params_tree)

    def fit(self, data: Union[DataSet, MultiDataSet, DataSetIterator],
            n_epochs: int = 1, async_prefetch: bool = True,
            resume: bool = False):
        """Train (DL4J ``fit(DataSetIterator, numEpochs)`` / ``fit(DataSet)``
        / ``fit(MultiDataSet)``).  An iterator is wrapped in async
        prefetch, as DL4J wraps it in ``AsyncDataSetIterator``; a single
        batch is not (nothing to overlap).  ``resume=True`` continues
        from the newest checkpoint of the attached
        ``parallel.CheckpointListener``, ``n_epochs`` then being the
        total (``optimize.fit_loop.run_fit``).  Returns the last loss."""
        self._check_init()
        self._build_solver()
        if isinstance(data, (DataSet, MultiDataSet)):
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

    # -- recurrent state (DL4J tBPTT / rnnClearPreviousState) -----------
    def _has_rnn(self) -> bool:
        return any(getattr(ly, "IS_RNN", False)
                   for _, ly in self._named_layers())

    @staticmethod
    def _tbptt_chunks(ds: Union[DataSet, MultiDataSet], length: int):
        """A sequence batch split along time into tBPTT segments (DL4J
        ``doTruncatedBPTT``)."""
        return tbptt_segments(ds, length)

    def rnn_clear_previous_state(self):
        """Drop every stored recurrent carry (DL4J
        ``rnnClearPreviousState``)."""
        self._rnn_state_map = None
        if self.state_tree is not None:
            self.state_tree = strip_rnn_carry(self.state_tree)

    # -- evaluation --------------------------------------------------------
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

    # -- parameter access (DL4J flattened-vector views) ----------------
    def params(self) -> np.ndarray:
        """One flattened host vector in ``_leaf_order`` — the DL4J
        ``params()`` view."""
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
        """Parameters only; batch-norm statistics are state, as in the
        reference."""
        self._check_init()
        return sum(leaf.numel() for _, leaf in self._leaf_order())

    def set_listeners(self, *listeners: TrainingListener):
        self.listeners = list(listeners)

    def add_listeners(self, *listeners: TrainingListener):
        self.listeners.extend(listeners)

    def clone(self):
        """A new network on the same device with a copy of the
        configuration, parameters, state and counters (not the updater
        state, as in the reference).  The tensors are copies: ``fit``
        updates parameters in place."""
        hook = self.__dict__.get("_param_sync_hook")
        if hook is not None:
            hook()
        m = type(self)(type(self.conf).from_dict(self.conf.to_dict()))
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
