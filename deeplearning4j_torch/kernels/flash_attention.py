"""Flash attention, forward and backward (port of
``deeplearning4j_tpu/kernels/flash_attention.py``).

``flash_attention`` computes softmax(Q K^T * scale + bias) V without
materialising the [t, t] scores: a streaming-softmax forward that also
saves the per-row log-sum-exp (LSE), and a backward that recomputes P
from it.  ``_Flash`` (a ``torch.autograd.Function``) takes the place of
the reference's ``_flash`` ``custom_vjp``.  Four CUDA kernels carry it on
the card, each behind a wrapper with its own launch count:

* ``flash_fwd`` — K3 (``csrc/flash_fwd.cu``, replaces ``_fwd_kernel``),
  the streaming forward: P rounded to the input dtype before the division
  by the row's denominator;
* ``flash_fwd_single`` — K4 (same source, replaces
  ``_fwd_kernel_single``), taken when one key block covers the row
  (t <= blk_k): P normalised, THEN rounded, before P.V;
* ``flash_bwd_dkdv`` — K5 (``csrc/flash_bwd.cu``, replaces
  ``_bwd_dkdv_kernel``): dK, dV and the key-bias gradient dBias;
* ``flash_bwd_dq`` — K6 (same source, replaces ``_bwd_dq_kernel``): dQ.

Beside them the plain PyTorch versions ``flash_fwd_reference`` (its
``single`` switch mirrors K4's rounding point) and ``flash_bwd_reference``
compute the same functions in full-row form, in f32 with the kernels'
rounding points.  Each wrapper routes by the tensors' device: CPU tensors
take the plain version, CUDA tensors launch the kernel or raise (float32
or bfloat16, any head dim) — there is no fallback and no switch.
The kernels are built for head dims 64, 128, 192 and 256 (bf16 on the
tensor cores at all four, with 64-row tiles at 192 and 256; every f32
build on plain FMA tiles), and past 256 for any multiple of 64, as the
reference's kernels take any head dim (bf16 up to 512 on the tensor
cores, with the output's 64-column panels split across two warpgroups;
f32, and bf16 past 512, on FMA tiles with the head dim walked in
chunks); every
wrapper zero-pads q, k, v and dO along the head dim to the
next of those (:func:`pad_head_dim`) on both routes, and slices the
padding off O, dQ, dK and dV.  That is exact: zero columns add nothing to Q K^T or to dO
V^T, the scale is the caller's (``dh ** -0.5`` of the unpadded dh), and
LSE, delta and dBias do not change.
``delta = rowsum(dO * O)`` is computed in torch between the forward and
the backward kernels, as the reference computes it in XLA.

What does not carry over from the TPU: the lane-replicated [blk, 128]
stat tiles (LSE and delta are compact [b*h, t] f32 here), the (1, 8,
blk_k) bias broadcast (the bias is [b*h, t] f32, and K5 writes dBias
without the reference's ``/ 8``, which only undid that broadcast's VJP),
``dimension_semantics`` and interpret mode.  The ``bthd`` layout is read
in place from pointer + strides, so the q/k/v column blocks of a
[b, t, 3d] projection need no transpose.

``attention()`` routes exactly as the reference does (``_FLASH_MIN_T``,
``_auto_blocks``, ``_flash_applicable``), counting
``flash_route_total{path="flash"|"xla"}`` and
``flash_fallback_above_threshold_total``; ``route_log()`` records each
call.  The short-t fallback ``xla_attention`` is plain einsum attention,
as the reference leaves it to XLA.
"""
from __future__ import annotations

import collections
import ctypes
import logging
from typing import Optional

import torch

from deeplearning4j_torch import telemetry

log = logging.getLogger("deeplearning4j_torch.kernels")

_NEG = -1e30   # finite "-inf": masked scores (as the reference)
_POS = 1e30    # LSE of a row with no unmasked key (=> p == 0 in bwd)
_KERNEL_DH = (64, 128, 192, 256)   # head dims the CUDA kernels are built for
_DH_CHUNK = 64    # past the last: any multiple of this (the chunked route)


# ---------------------------------------------------------------------------
# Plain versions (full-row form, f32 math at the kernels' rounding points)
# ---------------------------------------------------------------------------
def _acc(x):
    """``x`` in the plain versions' accumulation type: f32, or f64 for f64
    operands (which no kernel takes: the f64 gradient check runs the
    plain route at full precision)."""
    return x.to(torch.float64 if x.dtype == torch.float64
                else torch.float32)


def _scores(q, k, bias, causal: bool, scale: float):
    """[bh, t, t] f32 scores: Q K^T (f32 products of the inputs) * scale
    + bias, causally masked with -1e30."""
    s = torch.matmul(_acc(q), _acc(k).transpose(-1, -2)) * scale
    if bias is not None:
        s = s + bias.to(s.dtype)[:, None, :]
    if causal:
        t = q.shape[1]
        keep = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        s = torch.where(keep, s, _NEG)
    return s


def flash_fwd_reference(q, k, v, bias=None, *, causal: bool = False,
                        scale: float, single: bool = False):
    """Plain forward over [bh, t, dh] operands and an optional [bh, t]
    f32 key bias: returns (O [bh, t, dh] in q's dtype, LSE [bh, t] f32).

    ``single=False`` is K3's arithmetic: P rounded to the input dtype,
    P.V in f32, then divided by the denominator.  ``single=True`` is K4's:
    P divided by the denominator, THEN rounded, then P.V.  A row whose
    every key is masked gets O = 0 and LSE = 1e30."""
    s = _scores(q, k, bias, causal, scale)
    m = s.max(dim=-1, keepdim=True).values
    p = torch.where(s > 0.5 * _NEG, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    empty = l == 0.0
    l_safe = torch.where(empty, 1.0, l)
    vf = _acc(v)
    if single:
        o = torch.matmul(_acc((p / l_safe).to(v.dtype)), vf)
    else:
        o = torch.matmul(_acc(p.to(v.dtype)), vf) / l_safe
    lse = torch.where(empty, _POS, m + torch.log(l_safe))[..., 0]
    return o.to(q.dtype), lse


def flash_bwd_reference(q, k, v, bias, do, lse, delta, *,
                        causal: bool = False, scale: float):
    """Plain backward over [bh, t, dh] operands from the forward's LSE and
    ``delta = rowsum(dO * O)`` (both [bh, t] f32): returns (dQ, dK, dV in
    the inputs' dtype, dBias [bh, t] f32 — the sum over queries of dS,
    with no division by 8).  P is rounded to the input dtype for dV, and
    dS * scale for dK and dQ, as K5 and K6 do."""
    s = _scores(q, k, bias, causal, scale)
    p = torch.exp(s - lse.to(s.dtype)[..., None])
    dof = _acc(do)
    dv = torch.matmul(_acc(p.to(v.dtype)).transpose(-1, -2), dof)
    dp = torch.matmul(dof, _acc(v).transpose(-1, -2))
    ds = p * (dp - delta.to(s.dtype)[..., None])
    dbias = ds.sum(dim=1)
    dsr = _acc((ds * scale).to(q.dtype))
    dk = torch.matmul(dsr.transpose(-1, -2), _acc(q))
    dq = torch.matmul(dsr, _acc(k))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), dbias


# ---------------------------------------------------------------------------
# Layout helpers: every operand is a [b, t, h, dh] view inside the wrappers
# ---------------------------------------------------------------------------
def _to_bh(x):
    """[b, t, h, dh] -> [b*h, t, dh] (the plain versions' layout)."""
    b, t, h, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b * h, t, d)


def _from_bh(y, b, h):
    """[b*h, t, dh] -> [b, t, h, dh]."""
    return y.reshape(b, h, y.shape[1], y.shape[2]).permute(0, 2, 1, 3)


def _bth_strides(x):
    """(batch, time, head) element strides of a [b, t, h, dh] view."""
    return [x.stride(0), x.stride(1), x.stride(2)]


def kernel_head_dim(dh: int) -> int:
    """The head dim the kernels take for ``dh``: the smallest built size
    at or above it, and past the largest the next multiple of 64 (the
    chunked route)."""
    return next((size for size in _KERNEL_DH if size >= dh),
                -(-dh // _DH_CHUNK) * _DH_CHUNK)


def pad_head_dim(xs, dh: int):
    """Each [..., d] tensor of ``xs`` (None passes through) zero-padded
    along its last dim to ``dh`` (returned as it is when already that
    wide)."""
    return tuple(x if x is None or x.shape[-1] == dh
                 else torch.nn.functional.pad(x, (0, dh - x.shape[-1]))
                 for x in xs)


def _check_kernel_operands(name, tensors, stats):
    """The kernels' operand contract, checked before the head dim is
    padded: one CUDA device, one dtype (float32 or bfloat16), [b, t, h,
    dh] views of any dh; at a built dh (no padding copy)
    the head dim contiguous and rows 16-byte aligned; the [b*h, t] f32
    stats contiguous."""
    q = tensors[0]
    dev, dt = q.device, q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: float32 or bfloat16 operands, got {dt}")
    b, t, h, dh = q.shape
    vec = 16 // q.element_size()
    padded = kernel_head_dim(dh) != dh   # the kernels read fresh copies
    for x in tensors:
        if (x.device != dev or x.dtype != dt
                or tuple(x.shape) != (b, t, h, dh)):
            raise ValueError(
                f"{name}: operands must share device, dtype and shape "
                f"{(b, t, h, dh)}; got {x.device} {x.dtype} {tuple(x.shape)}")
        if not padded and (x.stride(3) != 1
                           or any(s % vec for s in _bth_strides(x))
                           or x.data_ptr() % 16):
            raise ValueError(f"{name}: each [b, t, h, dh] operand needs a "
                             "contiguous, 16-byte aligned head dim and "
                             f"strides divisible by {vec}; got strides "
                             f"{tuple(x.stride())}")
    for s in stats:
        if s is not None and (s.device != dev or s.dtype != torch.float32
                              or tuple(s.shape) != (b * h, t)
                              or not s.is_contiguous()):
            raise ValueError(f"{name}: bias/LSE/delta must be contiguous "
                             f"[{b * h}, {t}] float32 on {dev}")


_KERNEL_FNS = {}


def _kernel_fn(lib: str, symbol: str, n_ptrs: int, n_ints: int):
    """C entry ``symbol`` of built library ``lib``: ``n_ptrs`` pointers,
    the host strides array, ``n_ints`` ints (b, h, t, dh), the scale, the
    trailing int flags and the stream — every pointer as c_void_p."""
    fn = _KERNEL_FNS.get(symbol)
    if fn is None:
        from deeplearning4j_torch.kernels import _build
        fn = getattr(_build.load(lib), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.POINTER(ctypes.c_longlong)]
                       + [ctypes.c_int] * 4 + [ctypes.c_float]
                       + [ctypes.c_int] * n_ints + [ctypes.c_void_p])
        _KERNEL_FNS[symbol] = fn
    return fn


def _strides_arg(views):
    vals = [s for x in views for s in _bth_strides(x)]
    return (ctypes.c_longlong * len(vals))(*vals)


def _ptr(x):
    return None if x is None else x.data_ptr()


def _raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Kernel wrappers (each counts its own launches)
# ---------------------------------------------------------------------------
def _route(name, tensors, stats):
    """The shared head of every wrapper: (on CUDA?, the caller's dh, the
    [b, t, h, dh] operands zero-padded to the kernels' head dim).  CUDA
    operands are checked against the kernels' contract first."""
    device = tensors[0].device.type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    cuda = device == "cuda"
    if cuda:
        _check_kernel_operands(name, tensors, stats)
    dh = tensors[0].shape[-1]
    return cuda, dh, pad_head_dim(tensors, kernel_head_dim(dh))


def _unpad(x, dh: int):
    """``x`` without the head-dim padding (contiguous)."""
    return x if x.shape[-1] == dh else x[..., :dh].contiguous()


def _fwd(wrapper, q, k, v, bias, causal, scale, single):
    """Shared body of ``flash_fwd`` / ``flash_fwd_single`` on [b, t, h,
    dh] views; returns (O [b, t, h, dh], LSE [b*h, t]) and counts a
    launch on ``wrapper``."""
    name = wrapper.__name__
    cuda, dh, (q, k, v) = _route(name, (q, k, v), (bias,))
    b, t, h, dhp = q.shape
    if not cuda:
        o, lse = flash_fwd_reference(_to_bh(q), _to_bh(k), _to_bh(v), bias,
                                     causal=causal, scale=scale,
                                     single=single)
        return _unpad(_from_bh(o, b, h), dh), lse
    o = torch.empty((b, t, h, dhp), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, t), dtype=torch.float32, device=q.device)
    fn = _kernel_fn("flash_fwd", "dl4j_flash_fwd", 6, 3)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(bias),
            o.data_ptr(), lse.data_ptr(), _strides_arg((q, k, v, o)),
            b, h, t, dhp, float(scale), int(causal), int(single),
            int(q.dtype == torch.bfloat16), stream)
    _raise_on(rc, name)
    wrapper.launches += 1
    return _unpad(o, dh), lse


def flash_fwd(q, k, v, bias=None, *, causal: bool = False, scale: float):
    """K3, the streaming forward, on [b, t, h, dh] views (any strides with
    dh contiguous) and an optional [b*h, t] f32 key bias.  Returns (O
    [b, t, h, dh], LSE [b*h, t] f32).  CPU: the plain version."""
    return _fwd(flash_fwd, q, k, v, bias, causal, scale, False)


def flash_fwd_single(q, k, v, bias=None, *, causal: bool = False,
                     scale: float):
    """K4, the forward when one key block covers the row (t <= blk_k):
    as :func:`flash_fwd`, with P normalised before it is rounded."""
    return _fwd(flash_fwd_single, q, k, v, bias, causal, scale, True)


def _bwd_plain(q, k, v, bias, do, lse, delta, causal, scale):
    b, t, h, dh = q.shape
    dq, dk, dv, dbias = flash_bwd_reference(
        _to_bh(q), _to_bh(k), _to_bh(v), bias, _to_bh(do), lse, delta,
        causal=causal, scale=scale)
    return (_from_bh(dq, b, h), _from_bh(dk, b, h), _from_bh(dv, b, h),
            dbias)


def flash_bwd_dkdv(q, k, v, bias, do, lse, delta, *, causal: bool = False,
                   scale: float, need_dbias: bool = False):
    """K5 on [b, t, h, dh] views: (dK, dV [b, t, h, dh], dBias [b*h, t]
    f32 or None) from the forward's LSE and delta (both [b*h, t] f32).
    dBias is computed when ``need_dbias`` (and a bias was given).
    CPU: the plain version."""
    want_db = need_dbias and bias is not None
    cuda, dh, (q, k, v, do) = _route("flash_bwd_dkdv", (q, k, v, do),
                                     (bias, lse, delta))
    if not cuda:
        _, dk, dv, dbias = _bwd_plain(q, k, v, bias, do, lse, delta,
                                      causal, scale)
        return _unpad(dk, dh), _unpad(dv, dh), (dbias if want_db else None)
    b, t, h, dhp = q.shape
    dk = torch.empty((b, t, h, dhp), dtype=k.dtype, device=k.device)
    dv = torch.empty((b, t, h, dhp), dtype=v.dtype, device=v.device)
    dbias = (torch.empty((b * h, t), dtype=torch.float32, device=q.device)
             if want_db else None)
    fn = _kernel_fn("flash_bwd", "dl4j_flash_bwd_dkdv", 10, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _ptr(bias), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), _ptr(dbias),
            _strides_arg((q, k, v, do, q, dk, dv)), b, h, t, dhp,
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            stream)
    _raise_on(rc, "flash_bwd_dkdv")
    flash_bwd_dkdv.launches += 1
    return _unpad(dk, dh), _unpad(dv, dh), dbias


def flash_bwd_dq(q, k, v, bias, do, lse, delta, *, causal: bool = False,
                 scale: float):
    """K6 on [b, t, h, dh] views: dQ [b, t, h, dh].  CPU: the plain
    version."""
    cuda, dh, (q, k, v, do) = _route("flash_bwd_dq", (q, k, v, do),
                                     (bias, lse, delta))
    if not cuda:
        return _unpad(_bwd_plain(q, k, v, bias, do, lse, delta, causal,
                                 scale)[0], dh)
    b, t, h, dhp = q.shape
    dq = torch.empty((b, t, h, dhp), dtype=q.dtype, device=q.device)
    fn = _kernel_fn("flash_bwd", "dl4j_flash_bwd_dq", 8, 2)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            _ptr(bias), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            _strides_arg((q, k, v, do, dq, q, q)), b, h, t, dhp,
            float(scale), int(causal), int(q.dtype == torch.bfloat16),
            stream)
    _raise_on(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return _unpad(dq, dh)


#: CUDA kernel launches since the last reset (set to 0 to start a count)
flash_fwd.launches = 0
flash_fwd_single.launches = 0
flash_bwd_dkdv.launches = 0
flash_bwd_dq.launches = 0


def row_delta(do, o):
    """delta = rowsum(dO * O) in f32 (f64 for f64 operands), [b, t, h,
    dh] -> [b*h, t] (b-major, as the kernels index rows)."""
    b, t, h, _ = o.shape
    d = (_acc(do) * _acc(o)).sum(-1)                     # [b, t, h]
    return d.permute(0, 2, 1).reshape(b * h, t).contiguous()


# ---------------------------------------------------------------------------
# autograd plumbing
# ---------------------------------------------------------------------------
class _Flash(torch.autograd.Function):
    """Flash attention over [b, t, h, dh] views with a [b*h, t] f32 key
    bias (or None): forward K3 or K4, backward K5 then K6 (the
    reference's ``_flash`` custom_vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, single: bool, causal: bool,
                scale: float):
        fwd = flash_fwd_single if single else flash_fwd
        out, lse = fwd(q, k, v, bias, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, bias, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, out, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = row_delta(do, out)
        kw = dict(causal=ctx.causal, scale=ctx.scale)
        dk, dv, dbias = flash_bwd_dkdv(q, k, v, bias, do, lse, delta,
                                       need_dbias=ctx.needs_input_grad[3],
                                       **kw)
        dq = flash_bwd_dq(q, k, v, bias, do, lse, delta, **kw)
        return dq, dk, dv, dbias, None, None, None


# ---------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------
def _fold_bias(bias, b: int, h: int, t: int, device):
    """Accept [b, tk] / [b, h, tk] / [b, 1, 1, tk] (BERT's additive
    padding mask) -> [b*h, tk] f32, or None.  Gradients flow back
    through the broadcast by ordinary autograd."""
    if bias is None:
        return None
    bias = torch.as_tensor(bias, dtype=torch.float32, device=device)
    if bias.ndim == 4:
        if bias.shape[2] != 1:
            raise ValueError(
                "flash bias must be constant over query positions "
                f"(got shape {tuple(bias.shape)}); use attention() for the "
                "general fallback")
        bias = bias[:, :, 0, :]                       # [b, h|1, tk]
    elif bias.ndim == 2:
        if bias.shape[0] != b:
            raise ValueError(
                f"2-D flash bias must be [batch, t_k] (got "
                f"{tuple(bias.shape)} for batch {b}); a [t_q, t_k] mask "
                "is query-dependent — pass causal=True for the triangular "
                "case or use attention()'s fallback")
        bias = bias[:, None, :]                       # [b, 1, tk]
    return bias.expand(b, h, t).reshape(b * h, t).contiguous()


def flash_attention(q, k, v, blk_q: int = 512, blk_k: int = 512, *,
                    bias=None, causal: bool = False,
                    scale: Optional[float] = None, layout: str = "bhtd"):
    """Fused attention: softmax(Q K^T * scale + bias) V, differentiable.

    ``layout="bhtd"`` (default) takes [b, h, t, d]; ``layout="bthd"``
    takes [b, t, h, d] — the natural output of the qkv projection split —
    read in place (strided) by the kernels.  ``bias`` is an additive
    key-position mask ([b, tk], [b, h, tk] or [b, 1, 1, tk]; finite
    values, -1e9 for padding).  Block sizes clamp to the sequence length
    and t must divide by them (the reference's contract); one key block
    covering the row selects K4, else K3.  The kernels' own tiles are
    independent of the blocks."""
    if layout == "bthd":
        b, t, h, d = q.shape
        qv, kv, vv = q, k, v
    else:
        b, h, t, d = q.shape
        qv, kv, vv = (x.transpose(1, 2) for x in (q, k, v))
    blk_q = min(blk_q, t)
    blk_k = min(blk_k, t)
    if t % blk_k or t % blk_q:
        raise ValueError(
            f"sequence length {t} must be divisible by block sizes "
            f"({blk_q}, {blk_k})")
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    bias_f = _fold_bias(bias, b, h, t, q.device)
    single = t // blk_k == 1
    out = _Flash.apply(qv, kv, vv, bias_f, single, bool(causal),
                       float(scale))
    return out if layout == "bthd" else out.transpose(1, 2)


# Below this sequence length attention() takes the plain einsum path (the
# reference's threshold, so both packages route the same shapes).
_FLASH_MIN_T = 512


def _auto_blocks(t: int, causal: bool = False):
    """The reference's blocks: (1024, 512) where t divides, else 512 or t;
    one key block (K4) when it covers the row."""
    bq = 1024 if t % 1024 == 0 else (512 if t % 512 == 0 else t)
    bk = 512 if t % 512 == 0 else t
    return min(bq, t), min(bk, t)


def _flash_applicable(q, k, bias, blk_q, blk_k) -> bool:
    """The reference's routing rule, on [b, h, t, d] shapes."""
    if q.shape != k.shape:           # cross-attention / tq != tk
        return False
    t = q.shape[2]
    if t < _FLASH_MIN_T:
        return False
    bq, bk = min(blk_q, t), min(blk_k, t)
    if t % bq or t % bk or t % 8 or bk % 128:
        return False
    if max(bq, bk) > 1024:
        return False
    if bias is not None:
        shape = tuple(bias.shape)
        b = q.shape[0]
        if len(shape) == 4 and shape[2] != 1:
            return False             # query-dependent bias
        if len(shape) in (2, 3) and shape[0] != b:
            return False             # dim 0 must be batch
    return True


def mask_to_bias(mask):
    """[b, t] sequence mask (nonzero = valid) -> additive key-position
    bias (-1e9 at padded positions), or None passthrough."""
    if mask is None:
        return None
    return (1.0 - (mask > 0).float()) * -1e9


def xla_attention(q, k, v, bias=None, causal: bool = False,
                  scale: Optional[float] = None):
    """Plain einsum attention over [b, h, tq, d] (the reference's
    ``xla_attention``): scores in the input dtype then promoted to >= f32,
    the bias added, the causal mask as -1e30, softmax cast to V's dtype,
    then P.V.  attention()'s short-t path and the ``use_flash=False``
    path of the transformer block."""
    tq, d = q.shape[2], q.shape[3]
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q, k).to(ct) * scale
    if bias is not None:
        bias = torch.as_tensor(bias, dtype=ct, device=q.device)
        if bias.ndim == 2:                # [b, tk] key-position mask
            bias = bias[:, None, None, :]
        elif bias.ndim == 3:              # [b, h, tk]
            bias = bias[:, :, None, :]
        s = s + bias
    if causal:
        tk = k.shape[2]
        keep = (torch.arange(tk, device=q.device)[None, :]
                <= torch.arange(tq, device=q.device)[:, None])
        s = torch.where(keep[None, None], s, _NEG)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# Route-taken probe: one ('flash'|'xla', t, d) entry per attention() call
# (bounded at the last 256); the production signal is the counter below.
_ROUTE_LOG: collections.deque = collections.deque(maxlen=256)
_ROUTE_TOTAL = telemetry.counter(
    "flash_route_total",
    "attention() route decisions, by kernel path", labelnames=("path",))
_ROUTE_FLASH = _ROUTE_TOTAL.labels(path="flash")
_ROUTE_XLA = _ROUTE_TOTAL.labels(path="xla")
_ROUTE_XLA_LONG_T = telemetry.counter(
    "flash_fallback_above_threshold_total",
    "fallbacks at t >= the flash threshold — should be 0; nonzero means "
    "a shape/bias/block constraint silently demoted a hot path")


def reset_route_log() -> None:
    _ROUTE_LOG.clear()


def route_log() -> tuple:
    """Tuple of ('flash'|'xla', t, d) per attention() call since the last
    reset (bounded at the last 256 entries)."""
    return tuple(_ROUTE_LOG)


def attention(q, k, v, bias=None, causal: bool = False,
              scale: Optional[float] = None, blk_q: Optional[int] = None,
              blk_k: Optional[int] = None, layout: str = "bhtd"):
    """General attention entry: :func:`flash_attention` when the shape and
    mask permit, else :func:`xla_attention`.  ``layout="bthd"`` accepts
    [b, t, h, d] operands (read in place on the flash path; the fallback
    transposes)."""
    if layout == "bthd":
        tq, d = q.shape[1], q.shape[3]
        qn, kn = q.transpose(1, 2), k.transpose(1, 2)
    else:
        tq, d = q.shape[2], q.shape[3]
        qn, kn = q, k
    if scale is None:
        scale = 1.0 / (d ** 0.5)
    if blk_q is None or blk_k is None:
        abq, abk = _auto_blocks(tq, causal=causal)
        blk_q = blk_q or abq
        blk_k = blk_k or abk
    if _flash_applicable(qn, kn, bias, blk_q, blk_k):
        _ROUTE_LOG.append(("flash", tq, d))
        _ROUTE_FLASH.inc()
        return flash_attention(q, k, v, blk_q, blk_k, bias=bias,
                               causal=causal, scale=scale, layout=layout)
    _ROUTE_LOG.append(("xla", tq, d))
    _ROUTE_XLA.inc()
    if tq >= _FLASH_MIN_T:
        _ROUTE_XLA_LONG_T.inc()
        log.warning(
            "attention: plain fallback at t=%d (>= flash threshold %d) — "
            "shape/bias/block constraint failed (q=%s k=%s bias=%s "
            "blk=(%d,%d))", tq, _FLASH_MIN_T, tuple(q.shape),
            tuple(k.shape), None if bias is None else tuple(bias.shape),
            blk_q, blk_k)
    if layout == "bthd":
        out = xla_attention(qn, kn, v.transpose(1, 2), bias=bias,
                            causal=causal, scale=scale)
        return out.transpose(1, 2)
    return xla_attention(q, k, v, bias=bias, causal=causal, scale=scale)
