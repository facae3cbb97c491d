"""The remaining DL4J layer types (port of
``deeplearning4j_tpu/nn/conf/layers_misc.py``): ``PReLULayer``,
``ElementWiseMultiplicationLayer``, ``LocallyConnected2D`` /
``LocallyConnected1D``, ``SelfAttentionLayer`` /
``LearnedSelfAttentionLayer``, ``Convolution3D`` /
``Subsampling3DLayer``, ``CenterLossOutputLayer`` and
``VariationalAutoencoder``.

Parameter names and layouts are the reference's, so a JAX checkpoint
carries over leaf by leaf: PReLU ``alpha`` (the input shape with 1 on
shared axes), the locally connected layers' per-position ``W`` ([oh, ow,
c*kh*kw, n_out] and [ot, f*k, n_out], the input channel major in the
patch dim), Conv3D ``W`` DHWIO on NDHWC activations, the VAE's
``enc{i}``/``mu``/``logvar``/``dec{i}``/``recon`` ``_W``/``_b`` stacks,
the center loss's ``centers`` [n_out, n_in] and the learned queries
``Q`` [n_queries, heads * head_size].

The locally connected layers take their patches with ``unfold`` (the
same channel-major order as XLA's ``conv_general_dilated_patches``) and
contract every position at once with one einsum.  ``Convolution3D`` and
``Subsampling3DLayer`` permute NDHWC to NCDHW at the layer boundary for
``F.conv3d`` / ``F.max_pool3d``.

``SelfAttentionLayer(use_flash=True)`` routes through
``kernels.attention`` (flash kernels K3-K6 at t >= 512 when q and k have
one length, the plain einsum below; a [b, t] mask becomes the key bias).
On the card f32 operands are cast to bf16 first, as the reference casts
them on its accelerator: the flash kernels' f32 tiles are plain FMA, far
from their bound.  On the CPU f32 goes through.  On the card a head size
above the kernels' 256 at a flash-routed length raises in the flash
wrapper (the reference's flash kernel takes any head size).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_torch.kernels.flash_attention import (attention,
                                                         mask_to_bias)
from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, register_layer
from deeplearning4j_torch.nn.conf.layers_conv import (_bias_act_dropout,
                                                      _pair, same_pads)
from deeplearning4j_torch.nn.conf.layers_core import (BaseOutputLayerConf,
                                                      DenseLayer,
                                                      apply_dropout)
from deeplearning4j_torch.nn.weights_init import init_weights
from deeplearning4j_torch.runtime.rng import generator


def _triple(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in (list(v) + [v[-1]] * 3)[:3])
    return (int(v),) * 3


# ---------------------------------------------------------------------------
@register_layer
@dataclasses.dataclass
class PReLULayer(BaseLayerConf):
    """Parametric ReLU (``PReLULayer``): one learned alpha per input
    element, optionally shared over axes (DL4J ``sharedAxes``, 1-indexed
    over non-batch dims as upstream)."""

    input_shape: Optional[Sequence[int]] = None  # inferred
    shared_axes: Optional[Sequence[int]] = None

    WANTED_KINDS = ("ff", "cnn", "rnn")

    def _alpha_shape(self, input_shape):
        shape = list(input_shape)
        for ax in (self.shared_axes or ()):
            shape[int(ax) - 1] = 1  # DL4J sharedAxes are 1-indexed
        return shape

    def infer_shapes(self, input_shape):
        for i, d in enumerate(self._alpha_shape(input_shape)):
            if d is None:
                raise ValueError(
                    "PReLULayer needs every non-shared input dim fixed; "
                    f"dim {i + 1} is dynamic — add it to shared_axes or "
                    "use a fixed InputType (e.g. recurrent(size, "
                    "timesteps))")
        self.input_shape = tuple(
            int(d) if d is not None else None for d in input_shape)
        return input_shape

    def has_params(self):
        return True

    def param_shapes(self):
        return {"alpha": tuple(int(d) for d in
                               self._alpha_shape(self.input_shape))}

    def init(self, gen, dtype=torch.float32, device=None):
        return {"alpha": torch.zeros(self.param_shapes()["alpha"],
                                     dtype=dtype, device=device or gen.device)}

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        a = params["alpha"].to(x.dtype)
        y = torch.clamp(x, min=0) + a * torch.clamp(x, max=0)
        return apply_dropout(y, self.dropout, training, rng)


# ---------------------------------------------------------------------------
@register_layer
@dataclasses.dataclass
class ElementWiseMultiplicationLayer(BaseLayerConf):
    """y = act(x * w + b) with learned per-feature w, b
    (``ElementWiseMultiplicationLayer``); n_out == n_in."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None

    WANTED_KINDS = ("ff",)

    def infer_shapes(self, input_shape):
        f = int(input_shape[-1])
        if self.n_out is not None and self.n_out != f:
            raise ValueError(
                f"ElementWiseMultiplicationLayer requires n_out == n_in "
                f"(got n_out={self.n_out}, input width {f})")
        self.n_in = self.n_out = f
        return input_shape

    def has_params(self):
        return True

    def param_shapes(self):
        return {"w": (self.n_in,), "b": (self.n_in,)}

    def init(self, gen, dtype=torch.float32, device=None):
        dev = device or gen.device
        return {"w": torch.ones((self.n_in,), dtype=dtype, device=dev),
                "b": torch.zeros((self.n_in,), dtype=dtype, device=dev)}

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        y = x * params["w"].to(x.dtype) + params["b"].to(x.dtype)
        y = get_activation(self.activation or "identity")(y)
        return apply_dropout(y, self.dropout, training, rng)


# ---------------------------------------------------------------------------
@register_layer
@dataclasses.dataclass
class LocallyConnected2D(BaseLayerConf):
    """Unshared 2-D convolution (``LocallyConnected2D``): a separate
    kernel per output position.  The patches come from one ``unfold``,
    the per-position contraction is one einsum."""

    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (1, 1)
    convolution_mode: str = "truncate"  # or 'same'
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True
    _out_hw: Optional[Tuple[int, int]] = None

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = (int(d) for d in input_shape)
        self.n_in = c
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        if self.convolution_mode == "same":
            oh, ow = -(-h // sh), -(-w // sw)
        else:
            oh, ow = (h - kh) // sh + 1, (w - kw) // sw + 1
        self._out_hw = (oh, ow)
        return (oh, ow, self.n_out)

    def has_params(self):
        return True

    def param_shapes(self):
        kh, kw = _pair(self.kernel_size)
        oh, ow = self._out_hw
        shapes = {"W": (oh, ow, kh * kw * self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (oh, ow, self.n_out)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        shapes = self.param_shapes()
        w = init_weights(gen, shapes["W"], self.n_in * kh * kw, self.n_out,
                         self.weight_init, dtype, self.weight_distribution,
                         device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full(shapes["b"], float(self.bias_init),
                                     dtype=dtype, device=w.device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w = params["W"]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        (kh, kw), (sh, sw) = _pair(self.kernel_size), _pair(self.stride)
        if self.convolution_mode == "same":
            (t, b_), (l, r) = (same_pads(x.shape[1], kh, sh),
                               same_pads(x.shape[2], kw, sw))
            x = F.pad(x, (0, 0, l, r, t, b_))
        oh, ow = self._out_hw
        # [b, c*kh*kw, oh*ow], the input channel major in the patch dim
        patches = F.unfold(x.permute(0, 3, 1, 2), (kh, kw),
                           stride=(sh, sw))
        patches = patches.transpose(1, 2).reshape(x.shape[0], oh, ow, -1)
        y = torch.einsum("bhwk,hwko->bhwo", patches, w)
        return _bias_act_dropout(self, params, y, training, rng)


@register_layer
@dataclasses.dataclass
class LocallyConnected1D(BaseLayerConf):
    """Unshared 1-D convolution over [b, t, f] (``LocallyConnected1D``)."""

    kernel_size: int = 2
    stride: int = 1
    convolution_mode: str = "truncate"
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True
    _out_t: Optional[int] = None

    WANTED_KINDS = ("rnn",)
    IS_RNN = False

    def infer_shapes(self, input_shape):
        t, f = input_shape
        self.n_in = int(f)
        k, s = int(self.kernel_size), int(self.stride)
        if self.convolution_mode == "same":
            ot = -(-int(t) // s) if t is not None else None
        else:
            ot = (int(t) - k) // s + 1 if t is not None else None
        self._out_t = ot
        return (ot, self.n_out)

    def has_params(self):
        return True

    def param_shapes(self):
        k, ot = int(self.kernel_size), self._out_t
        if ot is None:
            raise ValueError(
                "LocallyConnected1D needs a fixed sequence length "
                "(InputType.recurrent(size, timesteps))")
        shapes = {"W": (ot, k * self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (ot, self.n_out)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        shapes = self.param_shapes()
        w = init_weights(gen, shapes["W"], self.n_in * int(self.kernel_size),
                         self.n_out, self.weight_init, dtype,
                         self.weight_distribution, device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full(shapes["b"], float(self.bias_init),
                                     dtype=dtype, device=w.device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w = params["W"]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        k, s = int(self.kernel_size), int(self.stride)
        xt = x.transpose(1, 2)                              # [b, f, t]
        if self.convolution_mode == "same":
            xt = F.pad(xt, same_pads(x.shape[1], k, s))
        # [b, f, ot, k] -> [b, ot, f*k], the feature major in the patch dim
        patches = xt.unfold(2, k, s).permute(0, 2, 1, 3).reshape(
            x.shape[0], -1, k * x.shape[2])
        y = torch.einsum("btk,tko->bto", patches, w)
        return _bias_act_dropout(self, params, y, training, rng)


# ---------------------------------------------------------------------------
@register_layer
@dataclasses.dataclass
class SelfAttentionLayer(BaseLayerConf):
    """Multi-head dot-product self-attention over [b, t, f]
    (``SelfAttentionLayer``): n_heads x head_size projections, optional
    output projection (``projectInput``), feature-mask aware."""

    n_heads: int = 1
    head_size: Optional[int] = None
    project_input: bool = True
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    # route through kernels.attention (the flash kernels at t >= 512)
    use_flash: bool = False

    WANTED_KINDS = ("rnn",)
    USES_MASK = True

    def infer_shapes(self, input_shape):
        t, f = input_shape
        self.n_in = int(f)
        if self.head_size is None:
            self.head_size = self.n_in // self.n_heads
        d = self.n_heads * self.head_size
        if not self.project_input and d != self.n_in:
            raise ValueError(
                f"projectInput=false requires n_heads*head_size == n_in "
                f"({self.n_heads}x{self.head_size} != {self.n_in})")
        if self.n_out is None:
            self.n_out = d if self.project_input else self.n_in
        return (t, self.n_out)

    def has_params(self):
        return True

    def param_shapes(self):
        d = self.n_heads * self.head_size
        shapes = {"Wq": (self.n_in, d), "Wk": (self.n_in, d),
                  "Wv": (self.n_in, d)}
        if self.project_input:
            shapes["Wo"] = (d, self.n_out)
        return shapes

    def _init_mat(self, gen, shape, dtype, device):
        return init_weights(gen, shape, shape[0], shape[-1], self.weight_init,
                            dtype, self.weight_distribution, device)

    def init(self, gen, dtype=torch.float32, device=None):
        return {name: self._init_mat(gen, shape, dtype, device)
                for name, shape in self.param_shapes().items()}

    def _attend(self, q, k, v, mask):
        """[b, tq, h*s] attention of the [b, t, h*s] projections, in q's
        dtype (bf16 on the card's flash route)."""
        h, s = self.n_heads, self.head_size
        b = q.shape[0]
        split = lambda z: z.reshape(b, -1, h, s)             # [b, t, h, s]
        if self.use_flash and q.shape[1] == k.shape[1]:
            bias = mask_to_bias(mask)
            if q.is_cuda and q.dtype == torch.float32:
                # f32 operands take the kernels' plain-FMA tiles: on the
                # card use_flash implies bf16 attention math
                q, k, v = (z.to(torch.bfloat16) for z in (q, k, v))
            out = attention(split(q), split(k), split(v), bias=bias,
                            layout="bthd")
            return out.reshape(b, -1, h * s)
        q, k, v = (split(z).transpose(1, 2) for z in (q, k, v))
        logits = torch.einsum("bhqs,bhks->bhqk", q, k) / torch.sqrt(
            torch.tensor(float(s), dtype=q.dtype, device=q.device))
        if mask is not None:
            logits = torch.where(mask[:, None, None, :] > 0, logits,
                                 torch.tensor(-1e9, dtype=logits.dtype,
                                              device=logits.device))
        att = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bhks->bhqs", att, v)
        return out.transpose(1, 2).reshape(b, -1, h * s)

    def _project(self, params, x, q, training, rng, mask):
        cast = lambda w: w.to(x.dtype)
        k = x @ cast(params["Wk"])
        v = x @ cast(params["Wv"])
        # a bf16 attention output joins x's dtype (the reference's
        # promotion of bf16 @ f32)
        y = self._attend(q, k, v, mask).to(x.dtype)
        if self.project_input:
            y = y @ cast(params["Wo"])
        return apply_dropout(y, self.dropout, training, rng)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        q = x @ params["Wq"].to(x.dtype)
        return self._project(params, x, q, training, rng, mask)


@register_layer
@dataclasses.dataclass
class LearnedSelfAttentionLayer(SelfAttentionLayer):
    """Attention with LEARNED queries (``LearnedSelfAttentionLayer``):
    n_queries fixed query vectors attend over the sequence; output is
    [b, n_queries, n_out] whatever the input length (never the flash
    route: tq != tk)."""

    n_queries: int = 1

    def infer_shapes(self, input_shape):
        t, f = input_shape
        super().infer_shapes((t, f))
        return (self.n_queries, self.n_out)

    def param_shapes(self):
        shapes = super().param_shapes()
        del shapes["Wq"]
        shapes["Q"] = (self.n_queries, self.n_heads * self.head_size)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        params = {}
        for name, shape in self.param_shapes().items():
            if name == "Q":
                d = shape[1]
                params[name] = init_weights(
                    gen, shape, d, d, self.weight_init, dtype,
                    self.weight_distribution, device)
            else:
                params[name] = self._init_mat(gen, shape, dtype, device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        qp = params["Q"].to(x.dtype)
        q = qp[None].expand((x.shape[0],) + tuple(qp.shape))
        return self._project(params, x, q, training, rng, mask)


# ---------------------------------------------------------------------------
def _ncdhw(x):
    """NDHWC -> contiguous NCDHW for the op."""
    return x.permute(0, 4, 1, 2, 3).contiguous()


@register_layer
@dataclasses.dataclass
class Convolution3D(BaseLayerConf):
    """3-D convolution over [b, d, h, w, c] (``Convolution3D``, NDHWC
    activations, DHWIO kernels)."""

    kernel_size: Sequence[int] = (2, 2, 2)
    stride: Sequence[int] = (1, 1, 1)
    convolution_mode: str = "truncate"
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    WANTED_KINDS = ("cnn3d",)

    def infer_shapes(self, input_shape):
        d, h, w, c = (int(v) for v in input_shape)
        self.n_in = c
        kd, kh, kw = _triple(self.kernel_size)
        sd, sh, sw = _triple(self.stride)
        if self.convolution_mode == "same":
            od, oh, ow = -(-d // sd), -(-h // sh), -(-w // sw)
        else:
            od, oh, ow = ((d - kd) // sd + 1, (h - kh) // sh + 1,
                          (w - kw) // sw + 1)
        return (od, oh, ow, self.n_out)

    def has_params(self):
        return True

    def param_shapes(self):
        shapes = {"W": _triple(self.kernel_size) + (self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        shapes = self.param_shapes()
        w = init_weights(gen, shapes["W"],
                         self.n_in * math.prod(_triple(self.kernel_size)),
                         self.n_out, self.weight_init, dtype,
                         self.weight_distribution, device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     dtype=dtype, device=w.device)
        return params

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w = params["W"]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        k, s = _triple(self.kernel_size), _triple(self.stride)
        if self.convolution_mode == "same":
            pads = [same_pads(n, kk, ss)
                    for n, kk, ss in zip(x.shape[1:4], k, s)]
            x = F.pad(x, (0, 0) + pads[2] + pads[1] + pads[0])
        z = F.conv3d(_ncdhw(x), w.permute(4, 3, 0, 1, 2).contiguous(),
                     None, s).permute(0, 2, 3, 4, 1)
        return _bias_act_dropout(self, params, z, training, rng)


@register_layer
@dataclasses.dataclass
class Subsampling3DLayer(BaseLayerConf):
    """3-D max/avg pooling (``Subsampling3DLayer``), VALID windows."""

    kernel_size: Sequence[int] = (2, 2, 2)
    stride: Sequence[int] = (2, 2, 2)
    pooling_type: str = "max"

    WANTED_KINDS = ("cnn3d",)

    def infer_shapes(self, input_shape):
        d, h, w, c = (int(v) for v in input_shape)
        kd, kh, kw = _triple(self.kernel_size)
        sd, sh, sw = _triple(self.stride)
        return ((d - kd) // sd + 1, (h - kh) // sh + 1, (w - kw) // sw + 1,
                c)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        k, s = _triple(self.kernel_size), _triple(self.stride)
        if self.pooling_type == "max":
            y = F.max_pool3d(_ncdhw(x), k, s)
        elif self.pooling_type == "avg":
            y = F.avg_pool3d(_ncdhw(x), k, s)
        else:
            raise ValueError(f"pooling_type {self.pooling_type!r}")
        return y.permute(0, 2, 3, 4, 1)


# ---------------------------------------------------------------------------
@register_layer
@dataclasses.dataclass
class CenterLossOutputLayer(BaseOutputLayerConf, DenseLayer):
    """Softmax head + center loss (``CenterLossOutputLayer``):
    L = CE + (lambda/2)·||f − c_y||².  The centers are parameters the
    configured updater moves by the center term's gradient (the
    reference's deviation from DL4J's hand-applied ``alpha`` average)."""

    alpha: float = 0.05  # kept for config parity / serialization
    lambda_: float = 2e-4

    def has_params(self):
        return True

    def param_shapes(self):
        shapes = DenseLayer.param_shapes(self)
        shapes["centers"] = (self.n_out, self.n_in)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        params = DenseLayer.init(self, gen, dtype, device)
        params["centers"] = torch.zeros((self.n_out, self.n_in), dtype=dtype,
                                        device=params["W"].device)
        return params

    def regularized_param_names(self):
        return ("W",)

    def center_score(self, params, features, labels):
        """(lambda/2)·||f − c_y||² per example; labels one-hot [b, C]."""
        centers_y = labels.to(features.dtype) @ params["centers"].to(
            features.dtype)
        return 0.5 * self.lambda_ * torch.sum(
            torch.square(features - centers_y), dim=-1)

    def per_example_score(self, labels, z, mask=None, head_input=None,
                          rng=None, params=None):
        ce = super().per_example_score(labels, z, mask)
        if head_input is None or params is None:
            return ce
        center = self.center_score(params, self.promote_head(head_input),
                                   labels)
        if mask is not None:
            center = center * mask.reshape(center.shape[0])
        return ce + center


# ---------------------------------------------------------------------------
@register_layer
@dataclasses.dataclass
class VariationalAutoencoder(BaseOutputLayerConf):
    """``variational.VariationalAutoencoder``: encoder MLP -> (mu, logvar)
    -> reparameterized z -> decoder MLP -> reconstruction distribution,
    trained on -ELBO with ``fit(DataSet(x, x))``.  ``apply`` returns the
    posterior MEAN (DL4J's activate()).

    ``reconstruction_distribution``: 'gaussian' (loss over mean+logvar
    outputs) or 'bernoulli' (logits + binary CE).  The draws of ``eps``
    come from the head key through a ``torch.Generator`` (the port's
    counter-hash keys, not the reference's threefry bits); without a key
    or with ``num_samples=0`` the score is the mean-field path.
    """

    n_in: Optional[int] = None
    n_out: Optional[int] = None  # latent size n_z
    encoder_layer_sizes: Sequence[int] = (16,)
    decoder_layer_sizes: Sequence[int] = (16,)
    reconstruction_distribution: str = "gaussian"
    num_samples: int = 1

    WANTED_KINDS = ("ff",)

    def infer_shapes(self, input_shape):
        self.n_in = int(input_shape[-1])
        return (self.n_out,)

    def has_params(self):
        return True

    def _dense_shapes(self):
        """[(name, n_in, n_out)] in the reference's init order."""
        enc = [self.n_in, *self.encoder_layer_sizes]
        dec = [self.n_out, *self.decoder_layer_sizes]
        recon_out = (2 * self.n_in
                     if self.reconstruction_distribution == "gaussian"
                     else self.n_in)
        mats = [(f"enc{i}", enc[i], enc[i + 1]) for i in range(len(enc) - 1)]
        mats += [("mu", enc[-1], self.n_out), ("logvar", enc[-1], self.n_out)]
        mats += [(f"dec{i}", dec[i], dec[i + 1]) for i in range(len(dec) - 1)]
        mats.append(("recon", dec[-1], recon_out))
        return mats

    def param_shapes(self):
        shapes = {}
        for name, n_in, n_out in self._dense_shapes():
            shapes[f"{name}_W"] = (int(n_in), int(n_out))
            shapes[f"{name}_b"] = (int(n_out),)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        params = {}
        for name, n_in, n_out in self._dense_shapes():
            w = init_weights(gen, (int(n_in), int(n_out)), n_in, n_out,
                             self.weight_init, dtype,
                             self.weight_distribution, device)
            params[f"{name}_W"] = w
            params[f"{name}_b"] = torch.zeros((int(n_out),), dtype=dtype,
                                              device=w.device)
        return params

    def _dense(self, params, name, x, act="relu"):
        y = x @ params[f"{name}_W"].to(x.dtype) + \
            params[f"{name}_b"].to(x.dtype)
        return get_activation(act)(y)

    def _encode(self, params, x):
        h = x
        for i in range(len(self.encoder_layer_sizes)):
            h = self._dense(params, f"enc{i}", h, self.activation or "relu")
        return (self._dense(params, "mu", h, "identity"),
                self._dense(params, "logvar", h, "identity"))

    def _decode(self, params, z):
        h = z
        for i in range(len(self.decoder_layer_sizes)):
            h = self._dense(params, f"dec{i}", h, self.activation or "relu")
        return self._dense(params, "recon", h, "identity")

    def pre_output(self, params, x, compute_dtype=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        return x

    def _recon_nll(self, params, mu, logvar, e, target):
        zs = mu + e * torch.exp(0.5 * logvar)
        out = self._decode(params, zs)
        if self.reconstruction_distribution == "gaussian":
            r_mu, r_logvar = out.chunk(2, dim=-1)
            return 0.5 * torch.sum(
                r_logvar + torch.square(target - r_mu) / torch.exp(r_logvar)
                + math.log(2 * math.pi), dim=-1)
        if self.reconstruction_distribution == "bernoulli":
            # softplus as logaddexp(out, 0): stable for large |logit|
            return torch.sum(torch.logaddexp(out, torch.zeros_like(out))
                             - out * target, dim=-1)
        raise ValueError(self.reconstruction_distribution)

    def per_example_score(self, labels, z, mask=None, head_input=None,
                          rng=None, params=None):
        """-ELBO per example.  ``z`` is the raw feature batch (see
        pre_output); ``labels`` is the reconstruction target."""
        if params is None:
            raise ValueError(
                "VariationalAutoencoder scoring needs the layer params "
                "(the model passes params= automatically)")
        x = self.promote_head(z)
        target = self.promote_head(labels) if labels is not None else x
        mu, logvar = self._encode(params, x)
        if rng is not None and self.num_samples > 0:
            # DL4J numSamples: Monte-Carlo average over reparameterized
            # draws
            n_s = max(int(self.num_samples), 1)
            eps = torch.randn((n_s,) + tuple(mu.shape),
                              generator=generator(rng, mu.device),
                              dtype=mu.dtype, device=mu.device)
        else:
            eps = torch.zeros((1,) + tuple(mu.shape), dtype=mu.dtype,
                              device=mu.device)   # mean-field path
        nll = torch.stack([self._recon_nll(params, mu, logvar, e, target)
                           for e in eps]).mean(dim=0)
        kl = -0.5 * torch.sum(1 + logvar - torch.square(mu)
                              - torch.exp(logvar), dim=-1)
        score = nll + kl
        if mask is not None:
            score = score * mask.reshape(score.shape[0])
        return score

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        if compute_dtype is not None:
            x = x.to(compute_dtype)
        mu, _ = self._encode(params, x)
        return self.promote_head(mu)

    def reconstruct(self, params, x):
        """Encoder mean -> decoder output (DL4J ``reconstructionOutput``)."""
        mu, _ = self._encode(params, torch.as_tensor(x))
        out = self._decode(params, mu)
        if self.reconstruction_distribution == "gaussian":
            return out.chunk(2, dim=-1)[0]
        return torch.sigmoid(out)
