"""Layer-config base classes and serialization registry (port of
``deeplearning4j_tpu/nn/conf/base.py``).

A layer is ONE dataclass carrying its hyperparameters (JSON round trip
through ``to_dict``/``layer_from_dict``, field for field the reference's,
so both packages read and write the same ``configuration.json``),
``infer_shapes`` (InputType propagation), ``init(gen, dtype, device)``
(the parameter dict) and ``apply(params, x, *, compute_dtype, mask,
training, rng)`` (the forward on tensors; autograd gives the backward).

A layer that owns state (``HAS_STATE``, so far ``BatchNormalization``'s
running mean and variance) builds it with ``init_state(device)`` beside
``init``, takes it as ``apply(params, state, x, ...)`` and returns
``(y, new_state)`` — the reference's state protocol, which the networks
thread through every forward and store after every training step.  A
layer without state keeps the shorter signature.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

_LAYER_REGISTRY: Dict[str, type] = {}


def register_layer(cls):
    """Class decorator: register for polymorphic JSON round-trip."""
    _LAYER_REGISTRY[cls.__name__] = cls
    return cls


def _populate_registry():
    """Import every layers_* module in this package so @register_layer
    runs — needed when a process deserializes a checkpoint without
    having imported the layer modules."""
    import importlib
    import pkgutil

    import deeplearning4j_torch.nn.conf as conf_pkg
    for info in pkgutil.iter_modules(conf_pkg.__path__):
        if info.name.startswith("layers"):
            importlib.import_module(
                f"deeplearning4j_torch.nn.conf.{info.name}")


def layer_from_dict(d: Dict[str, Any]) -> "BaseLayerConf":
    d = dict(d)
    type_name = d.pop("type")
    cls = _LAYER_REGISTRY.get(type_name)
    if cls is None:
        _populate_registry()
        cls = _LAYER_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown layer type {type_name!r} in config "
                         "(not ported to deeplearning4j_torch yet)")
    field_names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in d.items() if k in field_names})


@dataclasses.dataclass
class BaseLayerConf:
    """Common hyperparameters every DL4J ``BaseLayer`` carries.  ``None``
    means "inherit from the global conf" — the builder resolves these."""

    # Input kinds this layer consumes, in preference order.
    WANTED_KINDS = ("any",)
    # True: apply(params, state, x, ...) -> (y, new_state)
    HAS_STATE = False

    name: Optional[str] = None
    activation: Optional[str] = None
    weight_init: Optional[str] = None
    weight_distribution: Optional[dict] = None
    bias_init: float = 0.0
    l1: Optional[float] = None
    l2: Optional[float] = None
    weight_decay: Optional[float] = None
    dropout: Optional[float] = None  # DROP probability (DL4J stores keep)
    updater: Optional[dict] = None   # per-layer updater override
    learning_rate_mult: float = 1.0

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and v != f.default:
                d[f.name] = v
        return d

    def infer_shapes(self, input_shape: Tuple[int, ...]) -> Tuple[int, ...]:
        """Propagate the (batch-free) input shape; fill in n_in if unset."""
        return input_shape

    def param_shapes(self) -> Dict[str, Tuple[int, ...]]:
        """{param name: shape} — what ``init`` builds and what a carried
        checkpoint must provide (``utils.convert.load_numpy_params``)."""
        return {}

    def has_params(self) -> bool:
        """Whether ``init`` builds any parameter (transfer learning's
        re-initialisation walks by it)."""
        return bool(self.param_shapes())

    def init(self, gen: torch.Generator, dtype=torch.float32,
             device=None) -> Dict[str, torch.Tensor]:
        return {}

    def init_state(self, device=None) -> Dict[str, torch.Tensor]:
        """The layer's initial state (the reference's second ``init``
        result); empty unless ``HAS_STATE``."""
        return {}

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        raise NotImplementedError

    def regularized_param_names(self):
        """Weight-carrying params l1/l2 and weight decay apply to (not
        biases) — the reference's ``("W",)`` for layers with params."""
        return ("W",) if self.param_shapes() else ()

    def resolve_defaults(self, global_conf: "GlobalConf"):
        """Fill None fields from global conf (builder-time)."""
        if self.activation is None:
            self.activation = global_conf.activation
        if self.weight_init is None:
            self.weight_init = global_conf.weight_init
        if self.weight_distribution is None:
            self.weight_distribution = global_conf.weight_distribution
        if self.l1 is None:
            self.l1 = global_conf.l1
        if self.l2 is None:
            self.l2 = global_conf.l2
        if self.weight_decay is None:
            self.weight_decay = global_conf.weight_decay
        if self.dropout is None:
            self.dropout = global_conf.dropout
        if self.activation is not None:
            from deeplearning4j_torch.nn.activations import get_activation
            get_activation(self.activation)


@dataclasses.dataclass
class GlobalConf:
    """Global defaults layers inherit (DL4J builder's top-level settings).
    ``updater`` is carried as the reference's plain dict
    (``optimize.updaters.updater_from_dict`` builds it)."""

    seed: int = 0
    activation: str = "identity"
    weight_init: str = "xavier"
    weight_distribution: Optional[dict] = None
    l1: float = 0.0
    l2: float = 0.0
    weight_decay: float = 0.0
    dropout: float = 0.0
    updater: Optional[dict] = None
    dtype: str = "float32"
    compute_dtype: Optional[str] = None
    minimize: bool = True


def apply_layer(layer: BaseLayerConf, params, state, x, **kwargs):
    """``(y, new_state)`` of any layer: a stateful layer gets its state
    and returns the new one; a stateless layer's state passes through."""
    if layer.HAS_STATE:
        return layer.apply(params, state, x, **kwargs)
    return layer.apply(params, x, **kwargs), state
