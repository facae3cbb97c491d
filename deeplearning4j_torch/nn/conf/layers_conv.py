"""Convolutional-family layer configs (port of
``deeplearning4j_tpu/nn/conf/layers_conv.py``): the 2-D convolutions
(plain, transposed, depthwise, separable), the 1-D convolution,
pooling (``SubsamplingLayer``, ``pool2d``, ``GlobalPoolingLayer``),
``BatchNormalization``, the spatial shape layers, local response
normalization and ``CnnLossLayer``.

Layouts stay the reference's: activations NHWC ``[b, h, w, c]``, kernels
HWIO ``[kh, kw, c_in, c_out]``, so checkpoints carry over leaf by leaf.
On the card an NHWC tensor viewed as NCHW (``x.permute(0, 3, 1, 2)``) is
already in ``channels_last`` memory, which cuDNN convolves without a
transpose, and the HWIO kernel becomes an OIHW view in the same memory
format by one small copy per call (on the CPU both are made contiguous
NCHW, ``_nchw``).  The reference's XLA ops map onto PyTorch's:

* ``lax.conv_general_dilated`` -> ``F.conv2d`` / ``F.conv1d``.  XLA's
  ``"SAME"`` padding puts the odd element at the END (a 7x7/2 conv on 32
  pads (2, 3)); a symmetric padding goes to the op, an asymmetric one
  is applied with ``F.pad`` first;
* ``lax.conv_transpose`` -> the input dilated by the stride, padded, and
  convolved with the kernel as it is (not flipped), as the reference
  computes it;
* ``lax.reduce_window`` -> ``F.max_pool2d`` after a ``-inf`` pad (max)
  and a window sum after a zero pad (avg, sum, pnorm); average pooling
  divides by the count of real elements in each window, in every mode;
* batch norm's statistics accumulate in f32 while x stays in its own
  dtype, and the normalisation is one multiply-add in x's dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, register_layer
from deeplearning4j_torch.nn.conf.layers_core import (BaseOutputLayerConf,
                                                      apply_dropout)
from deeplearning4j_torch.nn.weights_init import init_weights
from deeplearning4j_torch.runtime import spmd


def _pair(v) -> Tuple[int, int]:
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1] if len(v) > 1 else v[0]))
    return (int(v), int(v))


def _conv_out(size: int, k: int, s: int, p: int, d: int, mode: str) -> int:
    """Output spatial size per DL4J ConvolutionUtils.getOutputSize;
    raises for ConvolutionMode.Strict when shapes don't divide exactly."""
    eff_k = (k - 1) * d + 1
    if mode == "same":
        return -(-size // s)  # ceil
    if mode == "strict" and (size + 2 * p - eff_k) % s:
        raise ValueError(
            f"ConvolutionMode.Strict: size {size} with kernel {k} stride "
            f"{s} pad {p} dilation {d} does not divide exactly")
    return (size + 2 * p - eff_k) // s + 1


def _tblr(spec) -> Tuple[int, int, int, int]:
    """Expand a (h, w) pair or explicit (top, bottom, left, right)."""
    p = list(spec)
    if len(p) == 2:
        return p[0], p[0], p[1], p[1]
    return p[0], p[1], p[2], p[3]


def same_pads(size: int, k: int, s: int, d: int = 1) -> Tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: the output is
    ceil(size / s) and the odd element of the total pad goes at the end."""
    eff_k = (k - 1) * d + 1
    total = max((-(-size // s) - 1) * s + eff_k - size, 0)
    return total // 2, total - total // 2


def _pads_2d(mode, hw, kernel, stride, padding, dilation):
    """((top, bottom), (left, right)) for a 2-D conv or pool: XLA's SAME
    in 'same' mode, else the explicit symmetric padding."""
    if mode == "same":
        return tuple(same_pads(n, k, s, d) for n, k, s, d in
                     zip(hw, kernel, stride, dilation))
    return tuple((p, p) for p in padding)


def _pad_nhwc(x, pads, value=0.0):
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x):
    """NHWC -> NCHW for the op.  On the card a view, already in
    channels-last memory; on the CPU a contiguous copy, because the CPU
    convolutions' channels-last backward gives wrong weight gradients
    for strided 1x1 kernels (torch 2.13)."""
    x = x.permute(0, 3, 1, 2)
    return x if x.is_cuda else x.contiguous()


def _oihw(w, dtype):
    """HWIO kernel -> OIHW in the memory format ``_nchw`` gives the
    activations (one copy): channels-last on the card, contiguous on the
    CPU."""
    w = w.to(dtype)
    if w.is_cuda:
        return w.permute(3, 0, 1, 2).contiguous().permute(0, 3, 1, 2)
    return w.permute(3, 2, 0, 1).contiguous()


def conv2d_nhwc(x, w, stride, pads, dilation, groups=1):
    """NHWC x, HWIO w -> NHWC y through ``F.conv2d`` (channels-last on
    the card, ``_nchw``).  ``pads`` is ((top, bottom), (left, right)):
    an asymmetric padding is applied with ``F.pad`` (zeros), a symmetric
    one by the op."""
    (t, b), (l, r) = pads
    if t == b and l == r:
        op_pad = (t, l)
    else:
        x, op_pad = _pad_nhwc(x, pads), (0, 0)
    y = F.conv2d(_nchw(x), _oihw(w, x.dtype), None,
                 tuple(stride), op_pad, tuple(dilation), groups)
    return y.permute(0, 2, 3, 1)


def _bias_act_dropout(layer, params, z, training, rng):
    if layer.has_bias:
        z = z + params["b"].to(z.dtype)
    y = get_activation(layer.activation or "identity")(z)
    return apply_dropout(y, layer.dropout, training, rng)


@register_layer
@dataclasses.dataclass
class ConvolutionLayer(BaseLayerConf):
    """2-D convolution (``org.deeplearning4j.nn.conf.layers.ConvolutionLayer``).

    ``convolution_mode``: 'truncate' (DL4J default — floor division),
    'same', or 'strict' (shape must divide exactly).  Explicit ``padding``
    only applies to truncate/strict, as in DL4J.
    """

    kernel_size: Sequence[int] = (3, 3)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: str = "truncate"
    n_in: Optional[int] = None   # input channels
    n_out: Optional[int] = None  # output channels
    has_bias: bool = True

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        if self.n_in is None:
            self.n_in = int(c)
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        mode = self.convolution_mode
        return (_conv_out(h, kh, sh, ph, dh, mode),
                _conv_out(w, kw, sw, pw, dw, mode), self.n_out)

    def param_shapes(self):
        kh, kw = _pair(self.kernel_size)
        shapes = {"W": (kh, kw, self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        # DL4J ConvolutionParamInitializer fan conventions
        fan_in = self.n_in * kh * kw
        fan_out = self.n_out * kh * kw / float(sh * sw)
        w = init_weights(gen, (kh, kw, self.n_in, self.n_out), fan_in,
                         fan_out, self.weight_init, dtype,
                         self.weight_distribution, device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     dtype=dtype, device=w.device)
        return params

    def _conv(self, x, w):
        pads = _pads_2d(self.convolution_mode, x.shape[1:3],
                        _pair(self.kernel_size), _pair(self.stride),
                        _pair(self.padding), _pair(self.dilation))
        return conv2d_nhwc(x, w, _pair(self.stride), pads,
                           _pair(self.dilation))

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w = params["W"]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        return _bias_act_dropout(self, params, self._conv(x, w), training,
                                 rng)


@register_layer
@dataclasses.dataclass
class Deconvolution2D(ConvolutionLayer):
    """Transposed conv (``org.deeplearning4j.nn.conf.layers.Deconvolution2D``),
    as ``lax.conv_transpose`` computes it: the input dilated by the
    stride, padded, then correlated with the kernel as it is."""

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        if self.n_in is None:
            self.n_in = int(c)
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        if self.convolution_mode == "same":
            oh, ow = h * sh, w * sw
        else:
            eff_kh, eff_kw = (kh - 1) * dh + 1, (kw - 1) * dw + 1
            oh = sh * (h - 1) + eff_kh - 2 * ph
            ow = sw * (w - 1) + eff_kw - 2 * pw
        return (oh, ow, self.n_out)

    def _conv(self, x, w):
        strides = _pair(self.stride)
        dil = _pair(self.dilation)
        pads = []
        for k, s, d, p in zip(_pair(self.kernel_size), strides, dil,
                              _pair(self.padding)):
            eff_k = (k - 1) * d + 1
            if self.convolution_mode == "same":
                # lax's _conv_transpose_padding for 'SAME'
                total = eff_k + s - 2
                lo = eff_k - 1 if s > eff_k - 1 else -(-total // 2)
                pads.append((lo, total - lo))
            else:
                # forward-conv padding p maps to transpose padding
                # (eff_k - 1 - p)
                pads.append((eff_k - 1 - p, eff_k - 1 - p))
        sh, sw = strides
        if sh > 1 or sw > 1:
            b, h, wd, c = x.shape
            up = x.new_zeros((b, (h - 1) * sh + 1, (wd - 1) * sw + 1, c))
            up[:, ::sh, ::sw, :] = x
            x = up
        # F.pad takes negative pads as crops, as lax takes them
        x = _pad_nhwc(x, pads)
        return conv2d_nhwc(x, w, (1, 1), ((0, 0), (0, 0)), dil)


@register_layer
@dataclasses.dataclass
class DepthwiseConvolution2D(BaseLayerConf):
    """Per-channel conv (``DepthwiseConvolution2D``); output channels =
    n_in * depth_multiplier."""

    kernel_size: Sequence[int] = (3, 3)
    stride: Sequence[int] = (1, 1)
    padding: Sequence[int] = (0, 0)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: str = "truncate"
    depth_multiplier: int = 1
    n_in: Optional[int] = None
    has_bias: bool = True

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        if self.n_in is None:
            self.n_in = int(c)
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        return (_conv_out(h, kh, sh, ph, dh, self.convolution_mode),
                _conv_out(w, kw, sw, pw, dw, self.convolution_mode),
                self.n_in * self.depth_multiplier)

    def param_shapes(self):
        kh, kw = _pair(self.kernel_size)
        n_out = self.n_in * self.depth_multiplier
        shapes = {"W": (kh, kw, 1, n_out)}
        if self.has_bias:
            shapes["b"] = (n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        n_out = self.n_in * self.depth_multiplier
        w = init_weights(gen, (kh, kw, 1, n_out), kh * kw,
                         kh * kw * self.depth_multiplier, self.weight_init,
                         dtype, self.weight_distribution, device)
        params = {"W": w}
        if self.has_bias:
            params["b"] = torch.full((n_out,), float(self.bias_init),
                                     dtype=dtype, device=w.device)
        return params

    def _depthwise(self, x, w):
        mode = "same" if self.convolution_mode == "same" else "truncate"
        pads = _pads_2d(mode, x.shape[1:3], _pair(self.kernel_size),
                        _pair(self.stride), _pair(self.padding),
                        _pair(self.dilation))
        # groups = n_in: output channel o reads input channel
        # o // depth_multiplier, as feature_group_count does
        return conv2d_nhwc(x, w, _pair(self.stride), pads,
                           _pair(self.dilation), groups=self.n_in)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w = params["W"]
        if compute_dtype is not None:
            x, w = x.to(compute_dtype), w.to(compute_dtype)
        return _bias_act_dropout(self, params, self._depthwise(x, w),
                                 training, rng)


@register_layer
@dataclasses.dataclass
class SeparableConvolution2D(DepthwiseConvolution2D):
    """Depthwise + 1x1 pointwise (``SeparableConvolution2D``)."""

    n_out: Optional[int] = None

    def infer_shapes(self, input_shape):
        oh, ow, _ = super().infer_shapes(input_shape)
        return (oh, ow, self.n_out)

    def param_shapes(self):
        kh, kw = _pair(self.kernel_size)
        mid = self.n_in * self.depth_multiplier
        shapes = {"W": (kh, kw, 1, mid), "pW": (1, 1, mid, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        kh, kw = _pair(self.kernel_size)
        mid = self.n_in * self.depth_multiplier
        dw = init_weights(gen, (kh, kw, 1, mid), kh * kw,
                          kh * kw * self.depth_multiplier, self.weight_init,
                          dtype, self.weight_distribution, device)
        pw = init_weights(gen, (1, 1, mid, self.n_out), mid, self.n_out,
                          self.weight_init, dtype, self.weight_distribution,
                          device)
        params = {"W": dw, "pW": pw}
        if self.has_bias:
            params["b"] = torch.full((self.n_out,), float(self.bias_init),
                                     dtype=dtype, device=dw.device)
        return params

    def regularized_param_names(self):
        return ("W", "pW")

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w, pw = params["W"], params["pW"]
        if compute_dtype is not None:
            x = x.to(compute_dtype)
            w, pw = w.to(compute_dtype), pw.to(compute_dtype)
        z = self._depthwise(x, w)
        z = conv2d_nhwc(z, pw, (1, 1), ((0, 0), (0, 0)), (1, 1))
        return _bias_act_dropout(self, params, z, training, rng)


@register_layer
@dataclasses.dataclass
class Convolution1DLayer(BaseLayerConf):
    """1-D conv over [batch, time, features]
    (``org.deeplearning4j.nn.conf.layers.Convolution1DLayer``); the
    kernel is [k, n_in, n_out]."""

    kernel_size: int = 3
    stride: int = 1
    padding: int = 0
    dilation: int = 1
    convolution_mode: str = "same"  # DL4J Conv1D default keeps length
    n_in: Optional[int] = None
    n_out: Optional[int] = None
    has_bias: bool = True

    WANTED_KINDS = ("rnn",)

    def infer_shapes(self, input_shape):
        t, f = input_shape
        if self.n_in is None:
            self.n_in = int(f)
        if t is None:
            return (None, self.n_out)
        if self.convolution_mode == "causal":
            ot = -(-t // self.stride)
        else:
            ot = _conv_out(t, self.kernel_size, self.stride, self.padding,
                           self.dilation, self.convolution_mode)
        return (ot, self.n_out)

    def param_shapes(self):
        shapes = {"W": (int(self.kernel_size), self.n_in, self.n_out)}
        if self.has_bias:
            shapes["b"] = (self.n_out,)
        return shapes

    def init(self, gen, dtype=torch.float32, device=None):
        k = int(self.kernel_size)
        fan_in = self.n_in * k
        fan_out = self.n_out * k / float(self.stride)
        w = init_weights(gen, (k, self.n_in, self.n_out), fan_in, fan_out,
                         self.weight_init, dtype, self.weight_distribution,
                         device)
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
        k, d, s = int(self.kernel_size), int(self.dilation), int(self.stride)
        if self.convolution_mode == "same":
            lo, hi = same_pads(x.shape[1], k, s, d)
        elif self.convolution_mode == "causal":
            lo, hi = (k - 1) * d, 0
        else:
            lo = hi = int(self.padding)
        if lo or hi:
            x = F.pad(x, (0, 0, lo, hi))
        z = F.conv1d(x.permute(0, 2, 1), w.permute(2, 1, 0), None, s, 0, d)
        return _bias_act_dropout(self, params, z.permute(0, 2, 1), training,
                                 rng)


def _window_sum(x, kernel, stride, dilation):
    """Window sums of an already padded NHWC tensor (no further pad),
    accumulated at >= f32 as ``avg_pool2d`` does."""
    (kh, kw), (sh, sw), (dh, dw) = kernel, stride, dilation
    if dh == 1 and dw == 1:
        y = F.avg_pool2d(_nchw(x), (kh, kw), (sh, sw), 0,
                         divisor_override=1)
        return y.permute(0, 2, 3, 1)
    oh = (x.shape[1] - (kh - 1) * dh - 1) // sh + 1
    ow = (x.shape[2] - (kw - 1) * dw - 1) // sw + 1
    acc = None
    for i in range(kh):
        for j in range(kw):
            part = x[:, i * dh:i * dh + (oh - 1) * sh + 1:sh,
                     j * dw:j * dw + (ow - 1) * sw + 1:sw, :]
            acc = part if acc is None else acc + part
    return acc


def pool2d(x, pooling_type, window, strides, pad, dilation=(1, 1, 1, 1),
           pnorm=2):
    """Pooling over the spatial dims of NHWC ``x`` with the reference's
    signature: 4-D ``window``/``strides``/``dilation`` (batch and channel
    entries 1) and ``pad`` either ``"SAME"`` or four (lo, hi) pairs.
    Max pads with -inf and ties go to the first element of the window
    (as XLA's select-and-scatter does); average pooling divides by the
    count of real elements in each window."""
    kernel = (int(window[1]), int(window[2]))
    stride = (int(strides[1]), int(strides[2]))
    dil = (int(dilation[1]), int(dilation[2]))
    if isinstance(pad, str):
        if pad.upper() != "SAME":
            raise ValueError(f"Unknown padding {pad!r}")
        pads = _pads_2d("same", x.shape[1:3], kernel, stride, None, dil)
    else:
        pads = (tuple(pad[1]), tuple(pad[2]))
    pt = str(pooling_type).lower()
    if pt == "max":
        xp = _pad_nhwc(x, pads, value=float("-inf"))
        y = F.max_pool2d(_nchw(xp), kernel, stride, 0, dil)
        return y.permute(0, 2, 3, 1)
    if pt in ("avg", "sum"):
        s = _window_sum(_pad_nhwc(x, pads), kernel, stride, dil)
        if pt == "sum":
            return s
        ones = torch.ones((1,) + tuple(x.shape[1:3]) + (1,), dtype=x.dtype,
                          device=x.device)
        counts = _window_sum(_pad_nhwc(ones, pads), kernel, stride, dil)
        return s / counts
    if pt == "pnorm":
        p = float(pnorm)
        s = _window_sum(_pad_nhwc(torch.abs(x) ** p, pads), kernel, stride,
                        dil)
        return s ** (1.0 / p)
    raise ValueError(f"Unknown pooling type {pooling_type!r}")


@register_layer
@dataclasses.dataclass
class SubsamplingLayer(BaseLayerConf):
    """Pooling (``org.deeplearning4j.nn.conf.layers.SubsamplingLayer``).
    ``pooling_type``: 'max' | 'avg' | 'sum' | 'pnorm'."""

    kernel_size: Sequence[int] = (2, 2)
    stride: Sequence[int] = (2, 2)
    padding: Sequence[int] = (0, 0)
    dilation: Sequence[int] = (1, 1)
    convolution_mode: str = "truncate"
    pooling_type: str = "max"
    pnorm: int = 2

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        dh, dw = _pair(self.dilation)
        return (_conv_out(h, kh, sh, ph, dh, self.convolution_mode),
                _conv_out(w, kw, sw, pw, dw, self.convolution_mode), c)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        kh, kw = _pair(self.kernel_size)
        sh, sw = _pair(self.stride)
        dh, dw = _pair(self.dilation)
        if self.convolution_mode == "same":
            pad = "SAME"
        else:
            ph, pw = _pair(self.padding)
            pad = [(0, 0), (ph, ph), (pw, pw), (0, 0)]
        return pool2d(x, self.pooling_type, (1, kh, kw, 1), (1, sh, sw, 1),
                      pad, (1, dh, dw, 1), self.pnorm)


def _sum_of_squares(x, dims, dtype):
    """sum(x^2) over ``dims`` accumulated in ``dtype`` without an
    upcast copy of x: the squared 2-norm, whose backward reads x as it
    is (2 x g, zero where a channel's norm is 0)."""
    return torch.square(torch.linalg.vector_norm(x, 2, dim=dims,
                                                 dtype=dtype))


@register_layer
@dataclasses.dataclass
class BatchNormalization(BaseLayerConf):
    """Batch norm over the channel axis
    (``org.deeplearning4j.nn.conf.layers.BatchNormalization``).

    The running mean and variance are the layer's STATE (``HAS_STATE``):
    a training forward returns them updated with ``decay`` from the
    batch's mean and BIASED variance E[x^2] - E[x]^2 (floored at 0) —
    not ``F.batch_norm``'s unbiased one — and inference reads them."""

    n_out: Optional[int] = None  # channel count (inferred)
    decay: float = 0.9
    eps: float = 1e-5
    lock_gamma_beta: bool = False
    use_global_stats: bool = False  # DL4J useMinibatch=false analogue

    WANTED_KINDS = ("ff", "cnn", "rnn")
    HAS_STATE = True

    def infer_shapes(self, input_shape):
        self.n_out = int(input_shape[-1])
        return input_shape

    def param_shapes(self):
        if self.lock_gamma_beta:
            return {}
        return {"gamma": (self.n_out,), "beta": (self.n_out,)}

    def init(self, gen, dtype=torch.float32, device=None):
        if self.lock_gamma_beta:
            return {}
        dev = gen.device if device is None else device
        return {"gamma": torch.ones((self.n_out,), dtype=dtype, device=dev),
                "beta": torch.zeros((self.n_out,), dtype=dtype, device=dev)}

    def init_state(self, device=None):
        return {"mean": torch.zeros((self.n_out,), dtype=torch.float32,
                                    device=device),
                "var": torch.ones((self.n_out,), dtype=torch.float32,
                                  device=device)}

    def regularized_param_names(self):
        return ()

    def apply(self, params, state, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        dims = tuple(range(x.ndim - 1))
        # statistics at >= f32 even when x is bf16; f64 stays f64
        stat_dtype = torch.promote_types(x.dtype, torch.float32)
        if training and not self.use_global_stats:
            n = x.numel() // x.shape[-1]
            # Σx and Σx² summed over every data shard of the mesh trainer
            # (the identity outside one) over the global batch's count,
            # so the statistics are the GLOBAL batch's (sync-BN), as
            # GSPMD computes them
            cnt = float(n * spmd.shard_rows(x.shape[0])[1] // x.shape[0])
            s1, s2 = spmd.all_reduce_sum([
                torch.sum(x, dim=dims, dtype=stat_dtype),
                _sum_of_squares(x, dims, stat_dtype)])
            mean = s1 / cnt
            var = torch.clamp(s2 / cnt - torch.square(mean), min=0.0)
            d = self.decay
            new_state = {
                "mean": (d * state["mean"] + (1 - d) * mean.detach()).float(),
                "var": (d * state["var"] + (1 - d) * var.detach()).float()}
        else:
            mean = state["mean"].to(stat_dtype)
            var = state["var"].to(stat_dtype)
            new_state = state
        # (x - mean) * inv * gamma + beta folded into one multiply-add per
        # element: scale and offset are [C] vectors at >= f32, x is
        # touched once in its own dtype
        inv = torch.rsqrt(var + self.eps)
        if not self.lock_gamma_beta:
            scale = params["gamma"].to(stat_dtype) * inv
            offset = params["beta"].to(stat_dtype) - mean * scale
        else:
            scale = inv
            offset = -mean * inv
        y = torch.addcmul(offset.to(x.dtype), x, scale.to(x.dtype))
        return get_activation(self.activation or "identity")(y), new_state


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


@register_layer
@dataclasses.dataclass
class ZeroPaddingLayer(BaseLayerConf):
    """Spatial zero padding (``ZeroPaddingLayer``); padding is
    (top, bottom, left, right) or a (h, w) pair."""

    padding: Sequence[int] = (1, 1)

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        t, b, l, r = _tblr(self.padding)
        return (h + t + b, w + l + r, c)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        t, b, l, r = _tblr(self.padding)
        return _pad_nhwc(x, ((t, b), (l, r)))


@register_layer
@dataclasses.dataclass
class Cropping2D(BaseLayerConf):
    """Spatial crop (``Cropping2D``): (top, bottom, left, right)."""

    cropping: Sequence[int] = (0, 0, 0, 0)

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        t, b, l, r = _tblr(self.cropping)
        return (h - t - b, w - l - r, c)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        t, b, l, r = _tblr(self.cropping)
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r, :]


@register_layer
@dataclasses.dataclass
class Upsampling2D(BaseLayerConf):
    """Nearest-neighbor upsample (``Upsampling2D``)."""

    size: Sequence[int] = (2, 2)

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        sh, sw = _pair(self.size)
        return (h * sh, w * sw, c)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        sh, sw = _pair(self.size)
        return x.repeat_interleave(sh, dim=1).repeat_interleave(sw, dim=2)


@register_layer
@dataclasses.dataclass
class SpaceToDepthLayer(BaseLayerConf):
    """Rearrange spatial blocks into channels (``SpaceToDepthLayer``)."""

    block_size: int = 2

    WANTED_KINDS = ("cnn",)

    def infer_shapes(self, input_shape):
        h, w, c = input_shape
        b = self.block_size
        return (h // b, w // b, c * b * b)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        n, h, w, c = x.shape
        b = self.block_size
        y = x.reshape(n, h // b, b, w // b, b, c)
        return y.permute(0, 1, 3, 2, 4, 5).reshape(n, h // b, w // b,
                                                   c * b * b)


@register_layer
@dataclasses.dataclass
class LocalResponseNormalization(BaseLayerConf):
    """AlexNet-era LRN (``LocalResponseNormalization``); DL4J defaults
    k=2, n=5, alpha=1e-4, beta=0.75."""

    k: float = 2.0
    n: int = 5
    alpha: float = 1e-4
    beta: float = 0.75

    WANTED_KINDS = ("cnn",)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        half = self.n // 2
        # sum over a window of n adjacent channels via a padded sum
        padded = F.pad(torch.square(x), (half, half))
        c = x.shape[-1]
        window = sum(padded[..., i:i + c] for i in range(2 * half + 1))
        return x / (self.k + self.alpha * window) ** self.beta


@register_layer
@dataclasses.dataclass
class CnnLossLayer(BaseOutputLayerConf):
    """Per-pixel loss over [b,h,w,c] (``CnnLossLayer``)."""

    WANTED_KINDS = ("cnn",)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        x = self.promote_head(x)
        return get_activation(self.activation or "identity")(x)

    def pre_output(self, params, x, compute_dtype=None):
        return x

    def per_example_score(self, labels, z, mask=None, head_input=None,
                          rng=None, params=None):
        # fold [b,h,w,c] to the sequence shape [b,h*w,c] and reuse the
        # base per-timestep masked scoring
        b, c = z.shape[0], z.shape[-1]
        z2 = z.reshape(b, -1, c)
        lab2 = labels.reshape(b, -1, labels.shape[-1])
        m2 = None if mask is None else mask.reshape(b, -1)
        return super().per_example_score(lab2, z2, m2)
