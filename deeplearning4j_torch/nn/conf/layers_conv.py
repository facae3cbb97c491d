"""Convolutional-family layer configs (port of
``deeplearning4j_tpu/nn/conf/layers_conv.py``).  So far only
``GlobalPoolingLayer``, the masked pooling the BERT classifier puts
between its encoder and its head; the convolutions, subsampling and
batch norm come with the conv stack."""
from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_torch.nn.conf.base import BaseLayerConf, register_layer


@register_layer
@dataclasses.dataclass
class GlobalPoolingLayer(BaseLayerConf):
    """Pool away all spatial/time dims (``GlobalPoolingLayer``): cnn
    [b,h,w,c] -> [b,c]; rnn [b,t,f] -> [b,f] honoring the feature mask
    exactly as DL4J's masked global pooling does."""

    pooling_type: str = "max"
    pnorm: int = 2
    collapse_dimensions: bool = True

    WANTED_KINDS = ("cnn", "rnn")
    USES_MASK = True

    @property
    def OUTPUT_KIND(self):
        # collapse_dimensions=False keeps size-1 spatial/time dims and the
        # input kind, as DL4J does.
        return "ff" if self.collapse_dimensions else None

    def infer_shapes(self, input_shape):
        if self.collapse_dimensions:
            return (input_shape[-1],)
        return tuple(1 for _ in input_shape[:-1]) + (input_shape[-1],)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        axes = tuple(range(1, x.ndim - 1))
        keep = not self.collapse_dimensions
        pt = self.pooling_type.lower()
        if mask is not None and x.ndim == 3:
            m = (mask[..., 0] if mask.ndim == 3 else mask)[..., None]
            m = m.to(x.dtype)
            n_valid = m.sum(dim=1, keepdim=keep)
            if pt == "max":
                # Fully-masked rows pool to 0, not -inf (avoids NaN grads).
                lo = torch.finfo(x.dtype).min
                y = torch.where(m > 0, x, lo).amax(dim=1, keepdim=keep)
                return torch.where(n_valid > 0, y, 0.0)
            x = x * m
            if pt == "avg":
                return (x.sum(dim=1, keepdim=keep)
                        / torch.clamp(n_valid, min=1.0))
        if pt == "max":
            return x.amax(dim=axes, keepdim=keep)
        if pt == "avg":
            return x.mean(dim=axes, keepdim=keep)
        if pt == "sum":
            return x.sum(dim=axes, keepdim=keep)
        if pt == "pnorm":
            p = float(self.pnorm)
            return (x.abs() ** p).sum(dim=axes, keepdim=keep) ** (1.0 / p)
        raise ValueError(f"Unknown pooling type {self.pooling_type!r}")
