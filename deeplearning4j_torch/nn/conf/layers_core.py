"""Feed-forward layer configs the decoder stack uses (port of
``deeplearning4j_tpu/nn/conf/layers_core.py``): ``DenseLayer``, the
output-layer base and ``OutputLayer`` (inference half; the loss plumbing
comes with the training slice)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, register_layer
from deeplearning4j_torch.nn.weights_init import init_weights


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

    def apply(self, params, x, *, compute_dtype=None, mask=None):
        z = self.pre_output(params, x, compute_dtype)
        return get_activation(self.activation or "identity")(z)


@dataclasses.dataclass
class BaseOutputLayerConf(BaseLayerConf):
    """Shared head plumbing for output layers."""

    loss: str = "mcxent"

    @staticmethod
    def promote_head(z):
        """Heads run at >= f32 (bf16 softmax is numerically unsafe)."""
        return z if z.dtype == torch.float64 else z.float()


@register_layer
@dataclasses.dataclass
class OutputLayer(BaseOutputLayerConf, DenseLayer):
    """Dense + loss head (``org.deeplearning4j.nn.conf.layers.OutputLayer``)."""

    def apply(self, params, x, *, compute_dtype=None, mask=None):
        z = self.promote_head(self.pre_output(params, x, compute_dtype))
        return get_activation(self.activation or "identity")(z)
