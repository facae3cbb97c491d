"""MultiLayerNetwork: the sequential-stack model (port of
``deeplearning4j_tpu/models/multi_layer_network.py``, inference half:
``init``, ``output``, ``params_tree``, ``_check_init``).  ``fit`` and the
training machinery come with the training slice.

``params_tree`` keeps the reference's shape — ``{"layer_i": {name:
tensor}}`` with the same names and ``x @ W`` layouts — as plain
dictionaries of tensors on ``self.device``, so a checkpoint or a JAX
``params_tree`` carries over leaf by leaf.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from deeplearning4j_torch.nn.conf.base import BaseLayerConf
from deeplearning4j_torch.nn.conf.builder import MultiLayerConfiguration
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.dtype import canonical_dtype


class MultiLayerNetwork:
    def __init__(self, conf: MultiLayerConfiguration):
        self.conf = conf
        self.layers: Sequence[BaseLayerConf] = conf.layers
        self.params_tree = None
        self.state_tree = None
        self.iteration_count = 0
        self.epoch_count = 0
        self.device: Optional[torch.device] = None
        self._dtype = canonical_dtype(conf.global_conf.dtype)
        cd = getattr(conf.global_conf, "compute_dtype", None)
        self._compute_dtype = canonical_dtype(cd) if cd else torch.float32

    def init(self, seed: Optional[int] = None,
             device="cuda") -> "MultiLayerNetwork":
        """Initialize parameters on ``device`` from an explicit generator
        seeded with ``seed`` (default: the configuration's seed).  The
        values differ from the JAX package's for the same seed; carry
        weights across with ``utils.convert.load_numpy_params``."""
        dev = resolve_device(device)
        seed = self.conf.global_conf.seed if seed is None else seed
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.params_tree = {f"layer_{i}": ly.init(gen, self._dtype, dev)
                            for i, ly in enumerate(self.layers)}
        self.state_tree = {f"layer_{i}": {} for i in range(len(self.layers))}
        self.device = dev
        return self

    def _check_init(self):
        if self.params_tree is None:
            self.init()

    @torch.no_grad()
    def _forward_infer(self, params, state, x, mask=None):
        """The whole stack's forward on tensors (the reference's
        ``_forward_infer``): preprocessors, then each layer's ``apply``
        at the network's compute dtype."""
        for i, ly in enumerate(self.layers):
            pre = self.conf.preprocessors[i]
            if pre is not None:
                x = pre(x)
            kwargs = {"mask": mask} if getattr(ly, "USES_MASK", False) \
                else {}
            x = ly.apply(params[f"layer_{i}"], x,
                         compute_dtype=self._compute_dtype, **kwargs)
        return x

    def output(self, x, features_mask=None):
        """Forward pass returning final-layer activations (DL4J
        ``output(INDArray)``) as a tensor on ``self.device``."""
        self._check_init()
        x = torch.as_tensor(x, device=self.device)
        if features_mask is not None:
            features_mask = torch.as_tensor(features_mask,
                                            device=self.device)
        return self._forward_infer(self.params_tree, self.state_tree, x,
                                   features_mask)

    def num_params(self) -> int:
        self._check_init()
        return sum(t.numel() for lp in self.params_tree.values()
                   for t in lp.values())
