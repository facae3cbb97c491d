"""Feed-forward layer configs (port of
``deeplearning4j_tpu/nn/conf/layers_core.py``): ``DenseLayer`` with
dropout, ``ActivationLayer``, ``DropoutLayer``, ``EmbeddingLayer``, the
output-layer base with the loss plumbing (``per_example_score``),
``OutputLayer`` and ``LossLayer``.

``apply(params, x, *, compute_dtype, mask, training, rng)`` is the
forward on tensors; ``rng`` is an integer key from
``runtime.rng.RngKeyManager`` (dropout draws from a ``torch.Generator``
seeded with it).  Autograd supplies the backward.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, register_layer
from deeplearning4j_torch.nn.losses import FUSED_ACTIVATIONS, get_loss
from deeplearning4j_torch.nn.weights_init import init_weights
from deeplearning4j_torch.runtime import spmd
from deeplearning4j_torch.runtime.rng import generator


def apply_dropout(x, rate: float, training: bool, rng):
    """Inverted dropout; ``rate`` is the DROP probability (DL4J's
    ``dropOut(p)`` takes the retain probability; the configs store the
    drop rate, as the reference's do).  The mask is drawn from a
    ``torch.Generator`` seeded with the integer key ``rng``: reproducible
    per key, not the reference's threefry bits."""
    if not training or not rate or rng is None:
        return x
    keep = 1.0 - rate
    # a data shard of the mesh trainer draws the GLOBAL batch's mask and
    # keeps its own rows, so data parallel equals one device
    n = x.shape[0] if x.ndim else 1
    off, total = spmd.shard_rows(n)
    u = torch.rand((total,) + tuple(x.shape[1:]),
                   generator=generator(rng, x.device),
                   device=x.device)[off:off + n].reshape(x.shape)
    return torch.where(u < keep, x / keep, torch.zeros((), dtype=x.dtype,
                                                       device=x.device))


@register_layer
@dataclasses.dataclass
class DenseLayer(BaseLayerConf):
    """Fully connected layer: y = act(x @ W + b), W stored [n_in, n_out]
    (the reference's ``x @ W`` layout, not ``nn.Linear``'s [out, in])."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    WANTED_KINDS = ("ff", "rnn")

    def infer_shapes(self, input_shape):
        if self.n_in is None:
            self.n_in = int(input_shape[-1])
        return tuple(input_shape[:-1]) + (self.n_out,)

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        params = {"W": init_weights(gen, (self.n_in, self.n_out), self.n_in,
                                    self.n_out, self.weight_init, dtype,
                                    self.weight_distribution, device)}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     dtype=dtype, device=params["W"].device)
        return params

    def pre_output(self, params, x, compute_dtype=None):
        w = params["W"]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
            w = w.to(compute_dtype)
        z = x @ w
        if self.has_bias:
            z = z + params["b"].to(z.dtype)
        return z

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        z = self.pre_output(params, x, compute_dtype)
        y = get_activation(self.activation or "identity")(z)
        return apply_dropout(y, self.dropout, training, rng)


@register_layer
@dataclasses.dataclass
class ActivationLayer(BaseLayerConf):
    """Standalone activation (``org.deeplearning4j.nn.conf.layers.ActivationLayer``)."""

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        return get_activation(self.activation or "identity")(x)


@register_layer
@dataclasses.dataclass
class DropoutLayer(BaseLayerConf):
    """Standalone dropout (``DropoutLayer``); `rate` is the drop probability."""

    rate: float = 0.5

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        return apply_dropout(x, self.rate, training, rng)


@register_layer
@dataclasses.dataclass
class EmbeddingLayer(BaseLayerConf):
    """Index -> vector lookup (``EmbeddingLayer``): input [batch] or
    [batch, 1] of int ids, output [batch, n_out].  ``W`` is [n_in, n_out]
    (the reference's layout), so a carried checkpoint needs no
    transpose."""

    n_in: Optional[int] = None  # vocabulary size
    n_out: Optional[int] = None
    has_bias: bool = False

    def infer_shapes(self, input_shape):
        return (self.n_out,)

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init, dtype,
                         self.weight_distribution, device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     dtype=dtype, device=w.device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        idx = x.long()
        if idx.ndim >= 2 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        y = params["W"][idx]
        if self.has_bias:
            y = y + params["b"]
        return get_activation(self.activation or "identity")(y)


@dataclasses.dataclass
class BaseOutputLayerConf(BaseLayerConf):
    """Shared loss plumbing for output layers
    (``org.deeplearning4j.nn.layers.BaseOutputLayer``)."""

    loss: str = "mcxent"

    @staticmethod
    def promote_head(z):
        """Heads run at >= f32 (bf16 softmax is numerically unsafe); f64
        stays f64."""
        return z if z.dtype == torch.float64 else z.float()

    def per_example_score(self, labels, z, mask=None, head_input=None,
                          rng=None, params=None):
        """Per-example loss from PRE-activation ``z``, fusing softmax or
        sigmoid into the loss where the pairing allows (LossMCXENT's fused
        path).  Sequence outputs [b, t, c] are scored per timestep by
        folding time into the batch, so a label mask [b, t] (or [b, t, 1])
        weights timesteps; masks [b] / [b, 1] weight whole examples.
        ``head_input`` (the layer's input), ``rng`` (the head's key) and
        ``params`` (the layer's) are what the networks pass every head;
        a head whose loss needs them reads them (the center loss, the
        VAE), the others ignore them."""
        act = (self.activation or "identity").lower()
        loss_name = str(self.loss).lower()
        loss_fn = get_loss(loss_name)
        z = self.promote_head(z)
        seq = z.ndim == 3
        if seq:
            b, t = z.shape[0], z.shape[1]
            z2 = z.reshape(b * t, z.shape[-1])
            lab2 = (labels.reshape(b * t, labels.shape[-1])
                    if labels.ndim == 3 else labels.reshape(b * t))
        else:
            z2, lab2 = z, labels
        if FUSED_ACTIVATIONS.get(loss_name) == act:
            scores = loss_fn(lab2, None, logits=z2)
        else:
            scores = loss_fn(lab2, get_activation(act)(z2))
        if seq:
            scores = scores.reshape(b, t)
            if mask is not None:
                scores = scores * (mask[..., 0] if mask.ndim == 3 else mask)
            scores = scores.sum(dim=1)
        elif mask is not None:
            scores = scores * mask.reshape(scores.shape[0])
        return scores


@register_layer
@dataclasses.dataclass
class OutputLayer(BaseOutputLayerConf, DenseLayer):
    """Dense + loss head (``org.deeplearning4j.nn.conf.layers.OutputLayer``)."""

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        z = self.promote_head(self.pre_output(params, x, compute_dtype))
        return get_activation(self.activation or "identity")(z)


@register_layer
@dataclasses.dataclass
class LossLayer(BaseOutputLayerConf):
    """Loss without params (``org.deeplearning4j.nn.conf.layers.LossLayer``)."""

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        x = self.promote_head(x)
        return get_activation(self.activation or "identity")(x)

    def pre_output(self, params, x, compute_dtype=None):
        return x
