"""Transformer layers (port of
``deeplearning4j_tpu/nn/conf/layers_transformer.py``).

``EmbeddingSequenceLayer``: [b, t] ids -> word embedding + learned
positional embedding + layer norm.  ``TransformerEncoderBlock``: one
post-LN encoder layer over [b, t, d]::

    h = LN(x + Wo·Attention(Wq x, Wk x, Wv x))
    y = LN(h + W2·act(W1 h))

With ``use_flash`` attention goes through ``kernels.attention`` on the
[b, t, h, dh] views of the fused qkv projection (``layout="bthd"``, read
in place by the flash kernels K3-K6 at t >= 512, plain einsum below);
without it, through the plain ``xla_attention``.  A [b, t] features mask
becomes the additive key-position bias.  Parameter names and ``x @ W``
layouts are the reference's: ``Wqkv`` is [d, 3d], fused q|k|v.

Parity trap: the block's activation is ``self.activation or "gelu"``,
and the builder resolves ``activation`` from the global conf, whose
default is ``"identity"`` — so every zoo ``Gpt`` (and the checked-in
pangrams checkpoint) has an IDENTITY feed-forward nonlinearity.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_torch.kernels.flash_attention import (attention,
                                                         mask_to_bias,
                                                         xla_attention)
from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, register_layer
from deeplearning4j_torch.nn.conf.layers_core import apply_dropout
from deeplearning4j_torch.nn.weights_init import init_weights
from deeplearning4j_torch.runtime.rng import split


def _layer_norm(x, gamma, beta, eps=1e-12):
    """LN at >= f32 with the BIASED variance (jnp.var), output in x's
    dtype — the reference's exact sequence."""
    ct = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(ct)
    mean = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mean) * torch.rsqrt(var + eps)
    return (y * gamma.to(ct) + beta.to(ct)).to(x.dtype)


@register_layer
@dataclasses.dataclass
class EmbeddingSequenceLayer(BaseLayerConf):
    """[b, t] int ids -> [b, t, n_out] vectors: word embedding +
    (optional) learned positional embedding + (optional) layer norm."""

    n_in: Optional[int] = None       # vocabulary size
    n_out: Optional[int] = None      # embedding dim
    max_len: int = 512               # positional table length
    add_positional: bool = True
    layer_norm: bool = True
    eps: float = 1e-12

    WANTED_KINDS = ("any",)
    OUTPUT_KIND = "rnn"

    def infer_shapes(self, input_shape):
        t = input_shape[0] if input_shape else self.max_len
        return (t, self.n_out)

    def param_shapes(self):
        shapes = {"W": (self.n_in, self.n_out)}
        if self.add_positional:
            shapes["P"] = (self.max_len, self.n_out)
        if self.layer_norm:
            shapes["g"] = (self.n_out,)
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        w = init_weights(gen, (self.n_in, self.n_out), self.n_in,
                         self.n_out, self.weight_init, dtype,
                         self.weight_distribution, device)
        params = {"W": w}
        if self.add_positional:
            params["P"] = 0.02 * torch.randn(
                (self.max_len, self.n_out), generator=gen, dtype=dtype,
                device=w.device)
        if self.layer_norm:
            params["g"] = torch.ones((self.n_out,), dtype=dtype,
                                     device=w.device)
            params["b"] = torch.zeros((self.n_out,), dtype=dtype,
                                      device=w.device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        idx = x.long()
        if idx.ndim == 3 and idx.shape[-1] == 1:
            idx = idx[..., 0]
        w = params["W"]
        if compute_dtype is not None:
            w = w.to(compute_dtype)
        y = w[idx]                                   # [b, t, d]
        if self.add_positional:
            t = y.shape[1]
            y = y + params["P"][:t].to(y.dtype)[None]
        if self.layer_norm:
            y = _layer_norm(y, params["g"], params["b"], self.eps)
        return apply_dropout(y, self.dropout, training, rng)


@register_layer
@dataclasses.dataclass
class TransformerEncoderBlock(BaseLayerConf):
    """One post-LN transformer encoder layer over [b, t, d].  With
    ``compute_dtype=bfloat16`` every matmul runs in bf16; layer norms
    and the softmax stay f32."""

    n_heads: int = 8
    d_ff: Optional[int] = None       # default 4*d
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    causal: bool = False
    eps: float = 1e-12
    use_flash: bool = True

    WANTED_KINDS = ("rnn",)
    USES_MASK = True

    def infer_shapes(self, input_shape):
        t, f = input_shape
        self.n_in = int(f)
        self.n_out = int(f)
        if self.d_ff is None:
            self.d_ff = 4 * self.n_in
        if self.n_in % self.n_heads:
            raise ValueError(
                f"d_model {self.n_in} must divide by n_heads {self.n_heads}")
        return (t, self.n_out)

    def param_shapes(self):
        d, ff = self.n_in, self.d_ff
        return {"Wqkv": (d, 3 * d), "bqkv": (3 * d,), "Wo": (d, d),
                "bo": (d,), "ln1_g": (d,), "ln1_b": (d,), "W1": (d, ff),
                "b1": (ff,), "W2": (ff, d), "b2": (d,), "ln2_g": (d,),
                "ln2_b": (d,)}

    def init(self, gen, dtype=torch.float32, device=None):
        device = gen.device if device is None else device
        params = {}
        for name, shape in self.param_shapes().items():
            if name.startswith("W"):
                params[name] = init_weights(
                    gen, shape, shape[0], shape[-1], self.weight_init,
                    dtype, self.weight_distribution, device)
            elif name.endswith("_g"):
                params[name] = torch.ones(shape, dtype=dtype, device=device)
            else:
                params[name] = torch.zeros(shape, dtype=dtype, device=device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        cast = lambda w: w.to(x.dtype)
        r1 = r2 = None
        if rng is not None:
            r1, r2 = split(rng, 2)
        b, t, d = x.shape
        h, dh = self.n_heads, d // self.n_heads
        qkv = x @ cast(params["Wqkv"]) + cast(params["bqkv"])
        q, k, v = torch.split(qkv, d, dim=-1)
        bias = mask_to_bias(mask)
        if self.use_flash:
            # [b, t, h, dh] views of the projection, read in place by the
            # kernels (no [b, h, t, dh] transpose pair)
            split_heads = lambda z: z.reshape(b, t, h, dh)
            att = attention(split_heads(q), split_heads(k), split_heads(v),
                            bias=bias, causal=self.causal, layout="bthd")
        else:
            split_heads = lambda z: z.reshape(b, t, h, dh).transpose(1, 2)
            att = xla_attention(split_heads(q), split_heads(k),
                                split_heads(v), bias=bias,
                                causal=self.causal).transpose(1, 2)
        att = att.reshape(b, t, d)
        att = att @ cast(params["Wo"]) + cast(params["bo"])
        att = apply_dropout(att, self.dropout, training, r1)
        hdn = _layer_norm(x + att, params["ln1_g"], params["ln1_b"],
                          self.eps)
        act = get_activation(self.activation or "gelu")
        ffn = act(hdn @ cast(params["W1"]) + cast(params["b1"]))
        ffn = ffn @ cast(params["W2"]) + cast(params["b2"])
        ffn = apply_dropout(ffn, self.dropout, training, r2)
        return _layer_norm(hdn + ffn, params["ln2_g"], params["ln2_b"],
                           self.eps)
