"""MultiLayerNetwork: the sequential-stack model (port of
``deeplearning4j_tpu/models/multi_layer_network.py``: ``init``,
``output``, ``feed_forward``, ``score``, ``rnn_time_step`` and
``load``; ``fit`` with truncated BPTT, ``evaluate*``, the parameter
views, ``clone`` and ``save`` come from ``models.network.BaseNetwork``).

``params_tree`` keeps the reference's shape — ``{"layer_i": {name:
tensor}}`` with the same names and ``x @ W`` layouts — as plain
dictionaries of f32 master tensors on ``self.device``, so a checkpoint or
a JAX ``params_tree`` carries over leaf by leaf; ``opt_state`` mirrors
the reference's updater state the same way.  ``fit`` drives one eager
``Solver.step`` per minibatch (forward, loss, autograd backward, updater,
in-place update) through ``optimize.fit_loop.run_fit``, and stores the
layers' new state; with a bfloat16 ``compute_dtype`` every matmul runs
in bf16 on the f32 master weights.
"""
from __future__ import annotations

import logging
from typing import List, Optional, Sequence

import torch

from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.models.network import BaseNetwork
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, apply_layer
from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_torch.nn.conf.layers_core import BaseOutputLayerConf
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.rng import fold_in, split
from deeplearning4j_torch.utils.trees import iter_leaves

log = logging.getLogger("deeplearning4j_torch")


class MultiLayerNetwork(BaseNetwork):
    def __init__(self, conf: MultiLayerConfiguration):
        super().__init__(conf)
        self.layers: Sequence[BaseLayerConf] = conf.layers

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
        self.state_tree = {f"layer_{i}": ly.init_state(dev)
                           for i, ly in enumerate(self.layers)}
        self.opt_state = None        # built at the first fit
        self.device = dev
        return self

    # ------------------------------------------------------------------
    # Forward / score
    # ------------------------------------------------------------------
    def _forward_layers(self, params, state, x, training, rng, upto=None,
                        mask=None):
        """Run layers [0, upto); returns (activation, new state tree): a
        stateful layer (``HAS_STATE``) reads its entry of ``state`` and
        its new state replaces it, as the reference threads the tree.
        ``mask`` is the features mask ([b, t] for sequences) handed to
        mask-aware layers (``USES_MASK``); ``rng`` (an integer key) is
        split into one key per layer for dropout."""
        n = len(self.layers) if upto is None else upto
        keys = split(rng, n) if rng is not None else [None] * n
        new_state = dict(state)
        for i in range(n):
            ly = self.layers[i]
            pre = self.conf.preprocessors[i]
            if pre is not None:
                x = pre(x)
            kwargs = {"mask": mask} if getattr(ly, "USES_MASK", False) \
                else {}
            x, new_state[f"layer_{i}"] = apply_layer(
                ly, params[f"layer_{i}"], state[f"layer_{i}"], x,
                compute_dtype=self._compute_dtype, training=training,
                rng=keys[i], **kwargs)
        return x, new_state

    def _forward_infer(self, params, state, x, mask=None):
        """The inference forward on the given trees (no dropout, state
        left as it is).  What ``ParallelInference`` and
        ``QuantizedInference`` call."""
        return self._forward_layers(params, state, self._tensor(x), False,
                                    None, mask=mask)[0]

    def _named_layers(self):
        return [(f"layer_{i}", ly) for i, ly in enumerate(self.layers)]

    def _frozen_keys(self):
        return {f"layer_{i}"
                for i in getattr(self.conf, "frozen_layers", ()) or ()}

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
        head_params = params[f"layer_{len(self.layers) - 1}"]
        z = out_layer.pre_output(head_params, h, self._compute_dtype)
        # the head's own key (a VAE's draws): ``rng`` already parented
        # the per-layer dropout keys
        head_rng = None if rng is None else fold_in(rng, 0x5eed)
        scores = out_layer.per_example_score(labels, z, lmask, head_input=h,
                                             rng=head_rng,
                                             params=head_params)
        if lmask is not None:
            loss = scores.sum() / torch.clamp(lmask.sum(), min=1.0)
        else:
            loss = scores.mean()
        return loss + self._regularization_score(params), new_state

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _batch_dict(self, ds: DataSet):
        """A DataSet's arrays as tensors on the net's device
        (``_tensor``)."""
        b = {"features": self._tensor(ds.features),
             "labels": self._tensor(ds.labels)}
        if ds.labels_mask is not None:
            b["labels_mask"] = self._tensor(ds.labels_mask)
        if ds.features_mask is not None:
            b["features_mask"] = self._tensor(ds.features_mask)
        return b

    # ------------------------------------------------------------------
    # Streaming (DL4J rnnTimeStep)
    # ------------------------------------------------------------------
    @torch.no_grad()
    def rnn_time_step(self, x, features_mask=None):
        """Streaming inference: run these timesteps on from the stored
        recurrent carry and store the new one (DL4J ``rnnTimeStep``).
        ``x`` is [b, t, f], or [b, f] for one step, which returns [b,
        out].  Like DL4J's ``stateMap`` the carry lives in a map of its
        own, not in ``state_tree``, so interleaved ``output`` and
        ``score`` calls still start from zeros."""
        self._check_init()
        x = self._tensor(x)
        single = x.dim() == 2
        if single:
            x = x[:, None, :]
        if features_mask is not None:
            features_mask = self._tensor(features_mask)
        state_in = dict(self.state_tree)
        for key, carry in (self._rnn_state_map or {}).items():
            state_in[key] = {**state_in[key], **carry}
        y, new_state = self._forward_layers(self.params_tree, state_in, x,
                                            False, None, mask=features_mask)
        self._rnn_state_map = {
            key: {k: v for k, v in s.items() if k.startswith("rnn_")}
            for key, s in new_state.items()}
        return y[:, -1] if single else y

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
            x, _ = apply_layer(ly, self.params_tree[f"layer_{i}"],
                               self.state_tree[f"layer_{i}"], x,
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

    # ------------------------------------------------------------------
    # Parameter access (DL4J flattened-vector views)
    # ------------------------------------------------------------------
    def _leaf_order(self):
        """((path...), leaf) pairs, layer-major then name-sorted."""
        for i in range(len(self.layers)):
            for path, leaf in iter_leaves(self.params_tree[f"layer_{i}"]):
                yield (f"layer_{i}",) + path, leaf

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
