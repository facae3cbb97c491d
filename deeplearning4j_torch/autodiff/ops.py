"""Op registry for the graph IR (port of
``deeplearning4j_tpu/autodiff/ops.py``).

The analogue of libnd4j's ``DeclarableOp``/``OpRegistrator`` and the JVM
op classes: every op is a thin PyTorch lowering registered under the
reference's name, with the reference's attributes, so a graph recorded or
imported by either package runs in the other.

Static/constant folding: ops whose inputs are all host values (numpy
arrays, ints) execute with numpy, as the reference does at trace time.
This is how TF graphs' shape-metaprogramming subgraphs (Shape ->
StridedSlice -> Pack -> Reshape) stay on the host: ``shape`` always
returns a host np.int64 vector, and everything derived from it stays
host-side, so Reshape/Tile/etc. see concrete targets.  ``SameDiff``
caches those folded values per feed shape, so a step does not re-fold
them.

Host values that meet a tensor become tensors on the device of the run
(:func:`device_scope`), with the reference's x64-off dtypes (float64 ->
float32, int64 -> int32), except that a float64 host value joins a
float64 tensor at float64 (the CPU reference runs in f64).  Index
operands are cast to int64 inside the ops that need it; feeds keep their
dtypes.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import threading
from typing import Callable, Dict

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_torch.runtime.dtype import canonical_dtype


@dataclasses.dataclass
class OpDef:
    name: str
    fn: Callable  # fn(*inputs, **attrs) -> output or tuple of outputs
    n_out: int = 1  # 0 = variable output count; caller must pass n_out


OP_REGISTRY: Dict[str, OpDef] = {}


def register_op(name: str, n_out: int = 1):
    def deco(fn):
        OP_REGISTRY[name] = OpDef(name=name, fn=fn, n_out=n_out)
        return fn
    return deco


def get_op(name: str) -> OpDef:
    op = OP_REGISTRY.get(name)
    if op is None:
        raise KeyError(
            f"Unknown op {name!r}; registered: {sorted(OP_REGISTRY)}")
    return op


def is_static_value(v) -> bool:
    """True when `v` is a host value (safe to constant-fold with numpy)."""
    return isinstance(v, (int, float, bool, np.ndarray, np.generic, list,
                          tuple))


def _xp(*args):
    """numpy when all inputs are host values (constant folding), else
    torch."""
    return np if all(is_static_value(a) for a in args) else torch


# ---------------------------------------------------------------------------
# Host -> device conversion
# ---------------------------------------------------------------------------
_SCOPE = threading.local()


@contextlib.contextmanager
def device_scope(device):
    """Host values converted inside this block land on ``device``."""
    prev = getattr(_SCOPE, "device", None)
    _SCOPE.device = torch.device(device)
    try:
        yield
    finally:
        _SCOPE.device = prev


def current_device() -> torch.device:
    return getattr(_SCOPE, "device", None) or torch.device("cpu")


_X64_OFF = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
            np.dtype(np.uint64): np.uint32,
            np.dtype(np.complex128): np.complex64}


def _t(x, like=None) -> torch.Tensor:
    """``x`` as a tensor: tensors pass through; host values go to the
    run's device (or ``like``'s) with the reference's x64-off dtypes."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    dev = like.device if isinstance(like, torch.Tensor) else current_device()
    if a.dtype == np.float64 and isinstance(like, torch.Tensor) \
            and like.dtype == torch.float64:
        pass
    elif a.dtype in _X64_OFF:
        a = a.astype(_X64_OFF[a.dtype])
    return torch.as_tensor(np.ascontiguousarray(a), device=dev)


def _ts(*xs):
    """All of ``xs`` as tensors on the device of the first tensor among
    them (host values follow its float64-ness)."""
    like = next((x for x in xs if isinstance(x, torch.Tensor)), None)
    return tuple(_t(x, like) for x in xs)


def _idx(x) -> torch.Tensor:
    """An index operand as int64 (torch's index type)."""
    return _t(x).long()


def _ints(v):
    return [int(s) for s in np.asarray(v).reshape(-1)]


def _host(v):
    """A host (numpy) copy of a static value or a tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


# ---------------------------------------------------------------------------
# Elementwise binary (broadcasting)
# ---------------------------------------------------------------------------
for _name, _npf, _tf in [
    ("add", np.add, torch.add), ("sub", np.subtract, torch.sub),
    ("mul", np.multiply, torch.mul), ("div", np.divide, torch.true_divide),
    ("floordiv", np.floor_divide, torch.floor_divide),
    ("mod", np.mod, torch.remainder), ("pow", np.power, torch.pow),
    ("maximum", np.maximum, torch.maximum),
    ("minimum", np.minimum, torch.minimum),
    ("squared_difference", lambda a, b: np.square(a - b),
     lambda a, b: torch.square(a - b)),
    ("equal", np.equal, torch.eq), ("not_equal", np.not_equal, torch.ne),
    ("greater", np.greater, torch.gt), ("less", np.less, torch.lt),
    ("greater_equal", np.greater_equal, torch.ge),
    ("less_equal", np.less_equal, torch.le),
    ("logical_and", np.logical_and, torch.logical_and),
    ("logical_or", np.logical_or, torch.logical_or),
]:
    def _make(npf, tf):
        def impl(a, b):
            if _xp(a, b) is np:
                return npf(a, b)
            return tf(*_ts(a, b))
        return impl
    register_op(_name)(_make(_npf, _tf))


# ---------------------------------------------------------------------------
# Elementwise unary (always on the device, as the reference's jnp calls)
# ---------------------------------------------------------------------------
def _rsqrt(x):
    return torch.rsqrt(x if x.is_floating_point() else x.float())


for _name, _tf in [
    ("neg", torch.neg), ("abs", torch.abs), ("sign", torch.sign),
    ("exp", torch.exp), ("log", torch.log), ("log1p", torch.log1p),
    ("sqrt", torch.sqrt), ("rsqrt", _rsqrt),
    ("square", torch.square), ("reciprocal", torch.reciprocal),
    ("floor", torch.floor), ("ceil", torch.ceil), ("round", torch.round),
    ("sin", torch.sin), ("cos", torch.cos), ("tan", torch.tan),
    ("tanh", torch.tanh), ("sigmoid", torch.sigmoid), ("erf", torch.erf),
    ("relu", torch.relu), ("relu6", F.relu6), ("elu", F.elu),
    ("selu", F.selu), ("softplus", F.softplus),
    ("softsign", F.softsign), ("logical_not", torch.logical_not),
    ("isnan", torch.isnan), ("isinf", torch.isinf),
]:
    register_op(_name)(lambda x, _f=_tf: _f(_t(x)))

register_op("identity")(lambda x: x)
register_op("stop_gradient")(lambda x: x if is_static_value(x)
                             else x.detach())
register_op("erfc")(lambda x: torch.erfc(_t(x)))
register_op("leaky_relu")(lambda x, alpha=0.2: F.leaky_relu(_t(x), alpha))
register_op("gelu")(lambda x, approximate=True: F.gelu(
    _t(x), approximate="tanh" if approximate else "none"))
register_op("clip_by_value")(lambda x, lo, hi: torch.clamp(*_ts(x, lo, hi)))


@register_op("cast")
def _cast(x, dtype):
    if is_static_value(x) and str(dtype) != "bfloat16":
        return np.asarray(x).astype(dtype)
    return _t(x).to(canonical_dtype(dtype))


# ---------------------------------------------------------------------------
# Matmul family
# ---------------------------------------------------------------------------
@register_op("matmul")
def _matmul(a, b, transpose_a=False, transpose_b=False, expect_k=None):
    """2-D+ matmul (``Mmul``/TF MatMul/BatchMatMulV2 in one: batched).

    ``expect_k`` is set by ``rewrites.fold_flatten_reshapes``, which
    removed a flattening reshape on ``a``: when the contraction axis is
    already innermost the operand rides through rank-3 untouched and the
    matmul batches; in any other case re-applying the flatten here
    reproduces the dropped reshape exactly."""
    a, b = _ts(a, b)
    if expect_k is not None and a.shape[-1] != expect_k:
        a = torch.reshape(a, (-1, expect_k))
    if transpose_a:
        a = a.transpose(-1, -2)
    if transpose_b:
        b = b.transpose(-1, -2)
    return torch.matmul(a, b)


@register_op("tensordot")
def _tensordot(a, b, axes=2):
    return torch.tensordot(*_ts(a, b), dims=axes)


@register_op("bias_add")
def _bias_add(x, b):
    x, b = _ts(x, b)
    return x + b


# ---------------------------------------------------------------------------
# Reductions
# ---------------------------------------------------------------------------
def _norm_axis(axis):
    if axis is None:
        return None
    if isinstance(axis, (np.ndarray, list, tuple)):
        seq = np.asarray(axis).reshape(-1).tolist()
        return tuple(int(a) for a in seq)
    if isinstance(axis, torch.Tensor):
        seq = axis.reshape(-1).tolist()
        return tuple(int(a) for a in seq) if axis.ndim else int(seq[0])
    return int(axis)


def _dims(x, axis):
    """``axis`` (None, int or tuple) as a sorted tuple of dims of x."""
    if axis is None:
        return tuple(range(x.ndim))
    axes = axis if isinstance(axis, tuple) else (axis,)
    return tuple(sorted(a % max(x.ndim, 1) for a in axes))


def _reduce_each(fn, x, axis, keep):
    """Reduce one dim at a time (ops without tuple-dim support)."""
    for d in sorted(_dims(x, axis), reverse=True):
        x = fn(x, d, keep)
    return x


def _t_sum(x, axis, keep):
    y = torch.sum(x, dim=_dims(x, axis), keepdim=keep)
    return y.to(torch.int32) if x.dtype == torch.bool else y.to(x.dtype)


def _t_mean(x, axis, keep):
    xf = x if x.is_floating_point() else x.float()
    return torch.mean(xf, dim=_dims(x, axis), keepdim=keep)


def _t_prod(x, axis, keep):
    y = _reduce_each(lambda v, d, k: torch.prod(v, d, keepdim=k), x, axis,
                     keep)
    return y.to(torch.int32) if x.dtype == torch.bool else y.to(x.dtype)


_T_REDUCE = {
    "sum": _t_sum, "mean": _t_mean, "prod": _t_prod,
    "max": lambda x, a, k: torch.amax(x, dim=_dims(x, a), keepdim=k),
    "min": lambda x, a, k: torch.amin(x, dim=_dims(x, a), keepdim=k),
    "any": lambda x, a, k: _reduce_each(
        lambda v, d, kk: torch.any(v, d, keepdim=kk), x.bool(), a, k),
    "all": lambda x, a, k: _reduce_each(
        lambda v, d, kk: torch.all(v, d, keepdim=kk), x.bool(), a, k),
}

for _name, _f in [("reduce_sum", "sum"), ("reduce_mean", "mean"),
                  ("reduce_max", "max"), ("reduce_min", "min"),
                  ("reduce_prod", "prod"), ("reduce_any", "any"),
                  ("reduce_all", "all")]:
    def _make_red(fname):
        def impl(x, axis=None, keep_dims=False):
            ax = _norm_axis(axis)
            if _xp(x) is np:
                return getattr(np, fname)(x, axis=ax,
                                          keepdims=bool(keep_dims))
            if ax == ():                  # no axes: nothing to reduce
                return x
            return _T_REDUCE[fname](x, ax, bool(keep_dims))
        return impl
    register_op(_name)(_make_red(_f))

register_op("argmax")(lambda x, axis=-1: torch.argmax(
    _t(x), dim=_norm_axis(axis)).to(torch.int32))
register_op("argmin")(lambda x, axis=-1: torch.argmin(
    _t(x), dim=_norm_axis(axis)).to(torch.int32))


def _scan(fn, one, x, axis, exclusive, reverse):
    x = _t(x)
    axis = int(axis)
    if reverse:
        x = torch.flip(x, (axis,))
    out = fn(x, dim=axis)
    if x.dtype != torch.bool and not x.is_floating_point():
        out = out.to(x.dtype)
    if exclusive:
        n = out.shape[axis]
        first = one(out.narrow(axis, 0, 1))
        out = torch.cat([first, out.narrow(axis, 0, n - 1)], dim=axis)
    if reverse:
        out = torch.flip(out, (axis,))
    return out


@register_op("cumsum")
def _cumsum(x, axis=0, exclusive=False, reverse=False):
    return _scan(torch.cumsum, torch.zeros_like, x, axis, exclusive, reverse)


# ---------------------------------------------------------------------------
# Shape metaprogramming (static: constant-folds on the host)
# ---------------------------------------------------------------------------
@register_op("shape")
def _shape(x):
    """A HOST vector, so downstream Pack/StridedSlice/Reshape stay
    constant (the TF-import equivalent of SameDiff's shape functions)."""
    return np.asarray(np.shape(x) if is_static_value(x) else tuple(x.shape),
                      dtype=np.int64)


@register_op("size")
def _size(x):
    return np.int64(np.prod(np.shape(x) if is_static_value(x)
                            else tuple(x.shape)))


@register_op("rank")
def _rank(x):
    return np.int64(len(np.shape(x) if is_static_value(x) else x.shape))


@register_op("reshape")
def _reshape(x, shape):
    shape = tuple(_ints(_host(shape)))
    if _xp(x) is np:
        return np.reshape(x, shape)
    return torch.reshape(x, shape)


@register_op("transpose")
def _transpose(x, perm=None):
    if perm is not None:
        perm = tuple(_ints(_host(perm)))
    if _xp(x) is np:
        return np.transpose(x, perm)
    if perm is None:
        perm = tuple(reversed(range(x.ndim)))
    return x.permute(perm)


@register_op("expand_dims")
def _expand_dims(x, axis=0):
    axis = int(np.asarray(_host(axis)).reshape(()))
    if _xp(x) is np:
        return np.expand_dims(x, axis)
    return torch.unsqueeze(x, axis)


@register_op("squeeze")
def _squeeze(x, axis=None):
    ax = _norm_axis(axis)
    if _xp(x) is np:
        return np.squeeze(x, axis=ax)
    if ax is None:
        return torch.squeeze(x)
    return torch.squeeze(x, _dims(x, ax)) if x.ndim else x


@register_op("concat")
def _concat(*xs, axis=0):
    if _xp(*xs) is np:
        return np.concatenate(xs, axis=int(axis))
    return torch.cat(_ts(*xs), dim=int(axis))


@register_op("pack")
def _pack(*xs, axis=0):
    if _xp(*xs) is np:
        return np.stack(xs, axis=int(axis))
    return torch.stack(_ts(*xs), dim=int(axis))


@register_op("unstack", n_out=0)  # variable out count, resolved at build
def _unstack(x, axis=0, num=None):
    x = _t(x)
    axis = int(axis)
    n = num or x.shape[axis]
    if x.shape[axis] != int(n):
        raise ValueError(f"unstack: axis {axis} has {x.shape[axis]} "
                         f"entries, not {n}")
    return tuple(torch.unbind(x, dim=axis))


def _split_sizes(n_total, num_split):
    if isinstance(num_split, (list, tuple, np.ndarray)):
        return _ints(num_split)
    n = int(num_split)
    if n_total % n:
        raise ValueError(f"split: {n_total} does not divide into {n}")
    return [n_total // n] * n


@register_op("split", n_out=0)
def _split(x, num_split, axis=0):
    """Equal split (int) or explicit section sizes (list — ONNX
    Split's ``split`` attr / opset-13 sizes input)."""
    x = _t(x)
    axis = int(axis)
    return tuple(torch.split(x, _split_sizes(x.shape[axis], num_split),
                             dim=axis))


@register_op("tile")
def _tile(x, multiples):
    multiples = tuple(_ints(_host(multiples)))
    if _xp(x) is np:
        return np.tile(x, multiples)
    return torch.tile(x, multiples)


def _index(x, idx):
    """``x[idx]`` for numpy or torch, where torch's slices may not step
    backwards: a negative-step slice becomes an index_select."""
    if isinstance(x, np.ndarray) or not any(
            isinstance(s, slice) and s.step is not None and s.step < 0
            for s in idx):
        return x[tuple(idx)]
    n_cons = sum(1 for s in idx if s is not None and s is not Ellipsis)
    plain, fix, out_d, in_d = [], [], 0, 0
    for s in idx:
        if s is Ellipsis:
            k = x.ndim - n_cons
            plain.append(s)
            out_d, in_d = out_d + k, in_d + k
        elif s is None:
            plain.append(None)
            out_d += 1
        elif isinstance(s, slice):
            if s.step is not None and s.step < 0:
                fix.append((out_d, torch.arange(*s.indices(x.shape[in_d]),
                                                device=x.device)))
                plain.append(slice(None))
            else:
                plain.append(s)
            out_d, in_d = out_d + 1, in_d + 1
        else:
            plain.append(s)
            in_d += 1
    out = x[tuple(plain)]
    for d, sel in fix:
        out = out.index_select(d, sel)
    return out


@register_op("slice")
def _slice(x, begin, size):
    begin = _ints(_host(begin))
    size = _ints(_host(size))
    idx = tuple(slice(b, None if s == -1 else b + s)
                for b, s in zip(begin, size))
    return x[idx] if isinstance(x, np.ndarray) else _t(x)[idx]


@register_op("strided_slice")
def _strided_slice(x, begin, end, strides=None, begin_mask=0, end_mask=0,
                   ellipsis_mask=0, new_axis_mask=0, shrink_axis_mask=0):
    """Full TF StridedSlice semantics: begin/end/shrink masks plus
    new-axis (None) and ellipsis positions."""
    begin = _ints(_host(begin))
    end = _ints(_host(end))
    strides = (_ints(_host(strides)) if strides is not None
               else [1] * len(begin))
    idx = []
    for i in range(len(begin)):
        if (new_axis_mask >> i) & 1:
            idx.append(None)
            continue
        if (ellipsis_mask >> i) & 1:
            idx.append(Ellipsis)
            continue
        b = None if (begin_mask >> i) & 1 else begin[i]
        e = None if (end_mask >> i) & 1 else end[i]
        if (shrink_axis_mask >> i) & 1:
            idx.append(begin[i])
        else:
            idx.append(slice(b, e, strides[i]))
    if not is_static_value(x):
        x = _t(x)
    elif not isinstance(x, np.ndarray):
        x = np.asarray(x)
    return _index(x, idx)


def _take(p, i, axis):
    """``jnp.take(p, i, axis)`` (negative indices wrap once)."""
    n = p.shape[axis]
    i = _idx(i).to(p.device)
    i = torch.where(i < 0, i + n, i)
    flat = torch.index_select(p, axis, i.reshape(-1))
    return flat.reshape(tuple(p.shape[:axis]) + tuple(i.shape)
                        + tuple(p.shape[axis + 1:]))


@register_op("gather")
def _gather(params, indices, axis=0, batch_dims=0):
    axis, batch_dims = int(axis), int(batch_dims)
    if batch_dims == 0:
        if _xp(params, indices) is np:
            return np.take(params, np.asarray(indices), axis=axis)
        p = _t(params, indices if isinstance(indices, torch.Tensor)
               else None)
        return _take(p, indices, axis % max(p.ndim, 1))
    # TF GatherV2 batch_dims semantics: the first `batch_dims` axes of
    # params and indices are matched pairwise; `axis` counts in the FULL
    # params rank.  vmap over each batch axis, gathering on the residual.
    p, i = _ts(params, indices)
    sub_axis = (axis % p.ndim) - batch_dims
    fn = lambda pp, ii: _take(pp, ii, sub_axis)
    for _ in range(batch_dims):
        fn = torch.func.vmap(fn)
    return fn(p, i.long())


@register_op("gather_nd")
def _gather_nd(params, indices):
    p = _t(params)
    i = _idx(indices)
    return p[tuple(torch.movedim(i, -1, 0))]


@register_op("scatter_nd")
def _scatter_nd(indices, updates, shape):
    shape = tuple(_ints(_host(shape)))
    u = _t(updates)
    z = torch.zeros(shape, dtype=u.dtype, device=u.device)
    idx = tuple(torch.movedim(_idx(indices), -1, 0))
    return z.index_put(idx, u, accumulate=True)


@register_op("one_hot")
def _one_hot(indices, depth, on_value=1.0, off_value=0.0, axis=-1,
             dtype="float32"):
    i = _t(indices)
    dt = canonical_dtype(dtype)
    oh = (i.long().unsqueeze(-1)
          == torch.arange(int(depth), device=i.device)).to(dt)
    if int(axis) != -1:
        oh = torch.movedim(oh, -1, int(axis))
    if on_value != 1.0 or off_value != 0.0:
        oh = oh * (on_value - off_value) + off_value
    return oh


@register_op("fill")
def _fill(shape, value):
    shape = tuple(_ints(_host(shape)))
    if is_static_value(value):
        return np.full(shape, value)
    return value.reshape(()).expand(shape).clone()


@register_op("zeros_like")
def _zeros_like(x):
    return np.zeros_like(x) if _xp(x) is np else torch.zeros_like(x)


@register_op("ones_like")
def _ones_like(x):
    return np.ones_like(x) if _xp(x) is np else torch.ones_like(x)


def _scalar_int(v) -> int:
    return int(np.asarray(_host(v)).reshape(()))


@register_op("range")
def _range(start, limit, delta=1):
    return np.arange(_scalar_int(start), _scalar_int(limit),
                     _scalar_int(delta))


def _pad_list(pairs):
    """[(lo, hi)] per dim, first dim first -> F.pad's flat last-first
    list."""
    flat = []
    for lo, hi in reversed(pairs):
        flat += [int(lo), int(hi)]
    return flat


@register_op("pad")
def _pad(x, paddings, constant_value=0.0):
    pads = [tuple(int(v) for v in row)
            for row in np.asarray(_host(paddings)).reshape(-1, 2)]
    return F.pad(_t(x), _pad_list(pads), value=constant_value)


@register_op("broadcast_to")
def _broadcast_to(x, shape):
    shape = tuple(_ints(_host(shape)))
    if _xp(x) is np:
        return np.broadcast_to(x, shape)
    return torch.broadcast_to(x, shape)


def _where(cond, a, b):
    if _xp(cond, a, b) is np:
        return np.where(cond, a, b)
    c, a, b = _ts(cond, a, b)
    return torch.where(c.bool(), a, b)


register_op("where")(_where)
register_op("select")(_where)


# ---------------------------------------------------------------------------
# NN ops
# ---------------------------------------------------------------------------
@register_op("softmax")
def _softmax(x, axis=-1):
    return torch.softmax(_t(x), dim=int(axis))


@register_op("log_softmax")
def _log_softmax(x, axis=-1):
    return torch.log_softmax(_t(x), dim=int(axis))


@register_op("softmax_cross_entropy_with_logits")
def _sce(labels, logits):
    labels, logits = _ts(labels, logits)
    return -torch.sum(labels * torch.log_softmax(logits, -1), dim=-1)


@register_op("sparse_softmax_cross_entropy_with_logits")
def _ssce(labels, logits):
    lp = torch.log_softmax(_t(logits), -1)
    lab = _idx(labels).to(lp.device)
    return -torch.gather(lp, -1, lab.unsqueeze(-1))[..., 0]


@register_op("sigmoid_cross_entropy_with_logits")
def _bce(labels, logits):
    labels, logits = _ts(labels, logits)
    return torch.clamp(logits, min=0) - logits * labels + torch.log1p(
        torch.exp(-torch.abs(logits)))


@register_op("layer_norm")
def _layer_norm(x, gamma, beta, axis=-1, eps=1e-12):
    x, gamma, beta = _ts(x, gamma, beta)
    mean = torch.mean(x, dim=axis, keepdim=True)
    var = torch.var(x, dim=axis, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


@register_op("dropout")
def _dropout(x, rate=0.0):
    # Inference graphs import dropout as identity (the TF graph freezes
    # keep_prob=1); training uses the framework's own dropout plumbing.
    return x


@register_op("l2_normalize")
def _l2_normalize(x, axis=-1, eps=1e-12):
    x = _t(x)
    return x * torch.rsqrt(torch.clamp(
        torch.sum(torch.square(x), dim=axis, keepdim=True), min=eps))


@register_op("embedding_lookup")
def _embedding_lookup(table, ids):
    return _take(_t(table), ids, 0)


def _same_pads(sizes, window, strides, dilations=None):
    """XLA 'SAME' padding per spatial dim: the odd element at the END."""
    dil = dilations or (1,) * len(sizes)
    out = []
    for size, k, s, d in zip(sizes, window, strides, dil):
        k_eff = (int(k) - 1) * int(d) + 1
        o = -(-int(size) // int(s))
        total = max((o - 1) * int(s) + k_eff - int(size), 0)
        out.append((total // 2, total - total // 2))
    return out


def _resolve_pads(padding, sizes, window, strides, dilations=None):
    if isinstance(padding, bytes):
        padding = padding.decode()
    if isinstance(padding, str):
        if padding == "SAME":
            return _same_pads(sizes, window, strides, dilations)
        if padding == "VALID":
            return [(0, 0)] * len(sizes)
        raise ValueError(f"unknown padding {padding!r}")
    return [tuple(int(v) for v in p) for p in padding]


def _channels_first(x, n_sp):
    return x.permute(0, n_sp + 1, *range(1, n_sp + 1))


def _channels_last(y, n_sp):
    return y.permute(0, *range(2, n_sp + 2), 1)


_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _conv_nchw(x, w_oi, strides, pads, dilations, groups=1):
    """N-d convolution of channels-first ``x`` with an OI... weight and
    explicit (lo, hi) pads (negative pads crop)."""
    if any(lo or hi for lo, hi in pads):
        x = F.pad(x, _pad_list([(0, 0), (0, 0)] + list(pads)))
    n_sp = x.ndim - 2
    return _CONV[n_sp](x, w_oi, stride=tuple(int(s) for s in strides),
                       dilation=tuple(int(d) for d in dilations),
                       groups=int(groups))


def _conv_channels_last(x, w, strides, padding, dilations, groups=1):
    """TF-layout convolution: x [n, *sp, c], w [*k, c_in/g, c_out]."""
    x, w = _ts(x, w)
    n_sp = x.ndim - 2
    pads = _resolve_pads(padding, x.shape[1:1 + n_sp], w.shape[:n_sp],
                         strides, dilations)
    w_oi = w.permute(n_sp + 1, n_sp, *range(n_sp))
    y = _conv_nchw(_channels_first(x, n_sp), w_oi, strides, pads,
                   dilations, groups)
    return _channels_last(y, n_sp)


@register_op("conv2d")
def _conv2d(x, w, strides=(1, 1), padding="SAME", dilations=(1, 1)):
    return _conv_channels_last(x, w, strides, padding, dilations)


def _pool_channels_last(x, ksize, strides, padding, kind):
    """TF-layout max/avg pooling ([n, *sp, c]); padded elements never
    win a max and are not counted by an average."""
    x = _t(x)
    n_sp = x.ndim - 2
    k = tuple(int(v) for v in ksize)
    s = tuple(int(v) for v in strides)
    pads = _resolve_pads(padding, x.shape[1:1 + n_sp], k, s)
    y = _pool_nchw(_channels_first(x, n_sp), k, s, pads, kind, False)
    return _channels_last(y, n_sp)


_MAXPOOL = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_AVGPOOL = {2: F.avg_pool2d, 3: F.avg_pool3d}


def _pool_nchw(x, k, s, pads, kind, count_include_pad):
    n_sp = x.ndim - 2
    flat = _pad_list([(0, 0), (0, 0)] + list(pads))
    if kind == "max":
        xp = F.pad(x, flat, value=float("-inf")) if any(flat) else x
        return _MAXPOOL[n_sp](xp, k, s)
    xp = F.pad(x, flat) if any(flat) else x
    summed = _AVGPOOL[n_sp](xp, k, s, divisor_override=1)
    if count_include_pad:
        return summed / float(np.prod(k))
    ones = torch.ones((1, 1) + tuple(x.shape[2:]), dtype=x.dtype,
                      device=x.device)
    op = F.pad(ones, flat) if any(flat) else ones
    counts = _AVGPOOL[n_sp](op, k, s, divisor_override=1)
    return summed / counts


@register_op("max_pool")
def _max_pool(x, ksize=(2, 2), strides=(2, 2), padding="VALID"):
    return _pool_channels_last(x, ksize, strides, padding, "max")


# ---------------------------------------------------------------------------
# Control flow — registered for build-time lookup; EXECUTION is handled
# by SameDiff._run_graph (_exec_while/_exec_cond), because these ops
# carry whole subgraphs in their attrs.
# ---------------------------------------------------------------------------
@register_op("while_loop", n_out=0)
def _while_loop_stub(*args, **attrs):
    raise RuntimeError(
        "while_loop executes via SameDiff._exec_while, not the registry")


@register_op("cond", n_out=0)
def _cond_stub(*args, **attrs):
    raise RuntimeError(
        "cond executes via SameDiff._exec_cond, not the registry")


def _flash_module():
    # the package re-exports the function under the module's name
    return importlib.import_module(
        "deeplearning4j_torch.kernels.flash_attention")


@register_op("fused_attention")
def _fused_attention(q, k, v, bias=None, causal=False, scale=None,
                     compute_dtype=None, bias_layout=None):
    """softmax(QK^T*scale + bias)V in one node — the lowering target of
    the importer's attention-subgraph rewrite (``autodiff/rewrites.py``).
    Routes as the reference does (``kernels.flash_attention.attention``:
    the flash kernels at t >= 512 where shape and mask permit, the plain
    einsum below).  On the card a t >= 512 call the kernels cannot take
    raises instead of falling back.  ``compute_dtype='bfloat16'`` runs
    the attention math in bf16; output returns in the input dtype."""
    fa = _flash_module()
    q, k, v = _ts(q, k, v)
    out_dtype = q.dtype
    if compute_dtype is not None:
        cd = canonical_dtype(compute_dtype)
        q, k, v = q.to(cd), k.to(cd), v.to(cd)
    squeeze_head = q.ndim == 3
    if squeeze_head:   # [b, t, d] -> single-head [b, 1, t, d]
        q, k, v = q[:, None], k[:, None], v[:, None]
    if bias is not None:
        bias = _t(bias, q)
        if bias_layout == "qk" and bias.ndim == 2:
            # declared square [tq, tk] attention bias (the kept causal
            # mask): lift to [1, 1, tq, tk] — the kernel's bare-2-D
            # convention is a [b, tk] padding mask, ambiguous with this
            bias = bias[None, None]
    sc = None if scale is None else float(scale)
    if q.device.type == "meta":       # the rewrite check's shape probe
        out = fa.xla_attention(q, k, v, bias=bias, causal=bool(causal),
                               scale=sc)
    else:
        t = q.shape[2]
        if q.device.type == "cuda" and t >= fa._FLASH_MIN_T and \
                not fa._flash_applicable(q, k, bias,
                                         *fa._auto_blocks(t, bool(causal))):
            raise ValueError(
                f"fused_attention: t={t} >= {fa._FLASH_MIN_T} but the flash "
                f"kernels cannot take q={tuple(q.shape)} "
                f"bias={None if bias is None else tuple(bias.shape)}; "
                "there is no plain route on the card")
        out = fa.attention(q, k, v, bias=bias, causal=bool(causal),
                           scale=sc)
    if squeeze_head:
        out = out[:, 0]
    return out.to(out_dtype)


@register_op("avg_pool")
def _avg_pool(x, ksize=(2, 2), strides=(2, 2), padding="VALID"):
    return _pool_channels_last(x, ksize, strides, padding, "avg")


# ---------------------------------------------------------------------------
# Elementwise extensions
# ---------------------------------------------------------------------------
for _name, _tf in [
    ("asin", torch.asin), ("acos", torch.acos), ("atan", torch.atan),
    ("sinh", torch.sinh), ("cosh", torch.cosh), ("asinh", torch.asinh),
    ("acosh", torch.acosh), ("atanh", torch.atanh),
    ("expm1", torch.expm1), ("rint", torch.round),
    ("isfinite", torch.isfinite),
    ("lgamma", torch.lgamma),
    ("digamma", torch.digamma),
]:
    register_op(_name)(lambda x, _f=_tf: _f(_t(x)))

register_op("atan2")(lambda y, x: torch.atan2(*_ts(y, x)))


def _xlogy(x, y):
    x, y = _ts(x, y)
    return torch.where(x == 0.0, torch.zeros_like(x), x * torch.log(y))


def _xdivy(x, y):
    x, y = _ts(x, y)
    return torch.where(x == 0.0, torch.zeros_like(x), x / y)


register_op("xlogy")(_xlogy)
register_op("xdivy")(_xdivy)
register_op("logical_xor")(lambda a, b: torch.logical_xor(*_ts(a, b)))
register_op("l2_loss")(lambda x: torch.sum(torch.square(_t(x))) / 2.0)


@register_op("add_n")
def _add_n(*xs):
    xs = _ts(*xs)
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return out


# ---------------------------------------------------------------------------
# Array manipulation
# ---------------------------------------------------------------------------
@register_op("reverse")
def _reverse(x, axis):
    return torch.flip(_t(x), tuple(_ints(_host(axis))))


@register_op("roll")
def _roll(x, shift, axis):
    return torch.roll(_t(x), tuple(_ints(_host(shift))),
                      tuple(_ints(_host(axis))))


@register_op("top_k", n_out=2)
def _top_k(x, k=1, sorted=True):
    v, i = torch.topk(_t(x), int(k), dim=-1)
    return v, i.to(torch.int32)


@register_op("invert_permutation")
def _invert_permutation(p):
    p = _t(p)
    out = torch.zeros_like(p)
    out[p.long()] = torch.arange(p.shape[0], dtype=p.dtype, device=p.device)
    return out


@register_op("matrix_band_part")
def _matrix_band_part(x, lower, upper):
    x = _t(x)
    lower, upper = _scalar_int(lower), _scalar_int(upper)
    m, n = x.shape[-2], x.shape[-1]
    rows = torch.arange(m, device=x.device)[:, None]
    cols = torch.arange(n, device=x.device)[None, :]
    keep = torch.ones((m, n), dtype=torch.bool, device=x.device)
    if lower >= 0:
        keep &= (rows - cols) <= lower
    if upper >= 0:
        keep &= (cols - rows) <= upper
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def _reflect_index(n, lo, hi, symmetric, device):
    """Source index of each padded position along one axis (numpy
    'reflect' / 'symmetric' modes)."""
    i = np.arange(-lo, n + hi)
    if symmetric:
        period = 2 * n
        i = np.mod(i, period)
        i = np.where(i >= n, period - 1 - i, i)
    else:
        period = max(2 * n - 2, 1)
        i = np.mod(i, period)
        i = np.where(i >= n, period - i, i)
    return torch.as_tensor(i, device=device)


def _mirror(x, pairs, symmetric):
    for d, (lo, hi) in enumerate(pairs):
        if lo or hi:
            x = x.index_select(d, _reflect_index(x.shape[d], lo, hi,
                                                 symmetric, x.device))
    return x


@register_op("mirror_pad")
def _mirror_pad(x, paddings, mode="REFLECT"):
    pads = [tuple(int(v) for v in row)
            for row in np.asarray(_host(paddings)).reshape(-1, 2)]
    return _mirror(_t(x), pads, str(mode).upper() != "REFLECT")


@register_op("cumprod")
def _cumprod(x, axis=0, exclusive=False, reverse=False):
    return _scan(torch.cumprod, torch.ones_like, x, axis, exclusive, reverse)


@register_op("tensor_scatter_update")
def _tensor_scatter_update(x, indices, updates):
    x, u = _ts(x, updates)
    idx = tuple(torch.movedim(_idx(indices), -1, 0))
    return x.index_put(idx, u.to(x.dtype))


@register_op("tensor_scatter_add")
def _tensor_scatter_add(x, indices, updates):
    x, u = _ts(x, updates)
    idx = tuple(torch.movedim(_idx(indices), -1, 0))
    return x.index_put(idx, u.to(x.dtype), accumulate=True)


@register_op("depth_to_space")
def _depth_to_space(x, block_size=2):
    x = _t(x)
    b = int(block_size)
    n, h, w, c = x.shape
    x = x.reshape(n, h, w, b, b, c // (b * b))
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * b, w * b, c // (b * b))


@register_op("space_to_depth")
def _space_to_depth(x, block_size=2):
    x = _t(x)
    b = int(block_size)
    n, h, w, c = x.shape
    x = x.reshape(n, h // b, b, w // b, b, c)
    x = x.permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h // b, w // b, c * b * b)


@register_op("space_to_batch_nd")
def _space_to_batch_nd(x, block_shape, paddings):
    x = _t(x)
    bs = _ints(_host(block_shape))
    pads = [(0, 0)] + [tuple(int(v) for v in row) for row in
                       np.asarray(_host(paddings)).reshape(-1, 2)]
    pads += [(0, 0)] * (x.ndim - len(pads))
    x = F.pad(x, _pad_list(pads))
    n = x.shape[0]
    spatial = list(x.shape[1:1 + len(bs)])
    rest = list(x.shape[1 + len(bs):])
    shape = [n]
    for s, b in zip(spatial, bs):
        shape += [s // b, b]
    x = x.reshape(shape + rest)
    # [n, s1/b1, b1, s2/b2, b2, ...] -> [b1, b2, ..., n, s1/b1, ...]
    perm = ([2 * i + 2 for i in range(len(bs))] + [0]
            + [2 * i + 1 for i in range(len(bs))]
            + list(range(1 + 2 * len(bs), x.ndim)))
    x = x.permute(perm)
    out_n = n * int(np.prod(bs))
    return x.reshape([out_n] + [s // b for s, b in zip(spatial, bs)]
                     + rest)


@register_op("batch_to_space_nd")
def _batch_to_space_nd(x, block_shape, crops):
    x = _t(x)
    bs = _ints(_host(block_shape))
    cr = [tuple(int(v) for v in row) for row in
          np.asarray(_host(crops)).reshape(-1, 2)]
    n = x.shape[0]
    spatial = list(x.shape[1:1 + len(bs)])
    rest = list(x.shape[1 + len(bs):])
    base_n = n // int(np.prod(bs))
    x = x.reshape(bs + [base_n] + spatial + rest)
    # [b1, b2, n, s1, s2, ...] -> [n, s1, b1, s2, b2, ...]
    perm = [len(bs)]
    for i in range(len(bs)):
        perm += [len(bs) + 1 + i, i]
    perm += list(range(1 + 2 * len(bs), x.ndim))
    x = x.permute(perm)
    x = x.reshape([base_n] + [s * b for s, b in zip(spatial, bs)] + rest)
    idx = [slice(None)]
    for (lo, hi), s, b in zip(cr, spatial, bs):
        idx.append(slice(lo, s * b - hi))
    return x[tuple(idx)]


def _legacy_axis_coords(out_n: int, in_n: int, device):
    """TF half_pixel_centers=False sampling: src = i * (in/out)."""
    return torch.arange(out_n, dtype=torch.float32,
                        device=device) * (in_n / out_n)


def _nhwc_resize(x, h, w, mode):
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode=mode,
                      **({"align_corners": False, "antialias": True}
                         if mode == "bilinear" else {}))
    return y.permute(0, 2, 3, 1)


@register_op("resize_bilinear")
def _resize_bilinear(x, size, half_pixel_centers=True):
    x = _t(x)
    h, w = _ints(_host(size))
    if half_pixel_centers:
        return _nhwc_resize(x, h, w, "bilinear")

    # legacy TF sampling (attr default!): corner-anchored coordinates
    def interp(arr, coords, axis):
        i0 = torch.floor(coords).long()
        i1 = torch.clamp(i0 + 1, max=arr.shape[axis] - 1)
        shape = [1] * arr.ndim
        shape[axis] = coords.shape[0]
        frac = (coords - i0).reshape(shape).to(arr.dtype)
        a0 = arr.index_select(axis, i0)
        a1 = arr.index_select(axis, i1)
        return a0 + (a1 - a0) * frac

    y = interp(x, _legacy_axis_coords(h, x.shape[1], x.device), 1)
    return interp(y, _legacy_axis_coords(w, x.shape[2], x.device), 2)


@register_op("resize_nearest")
def _resize_nearest(x, size, half_pixel_centers=True):
    x = _t(x)
    h, w = _ints(_host(size))
    if half_pixel_centers:
        return _nhwc_resize(x, h, w, "nearest-exact")
    iy = torch.floor(_legacy_axis_coords(h, x.shape[1], x.device)).long()
    ix = torch.floor(_legacy_axis_coords(w, x.shape[2], x.device)).long()
    return x.index_select(1, iy).index_select(2, ix)


# ---------------------------------------------------------------------------
# Segment reductions (embedding-gradient graphs)
# ---------------------------------------------------------------------------
def _segments(data, segment_ids, num_segments):
    """(data rows [m, ...], ids [m] with out-of-range ids dropped, n)."""
    d = _t(data)
    ids = _idx(segment_ids).to(d.device)
    n = _scalar_int(num_segments)
    rows = d.reshape((-1,) + tuple(d.shape[ids.ndim:]))
    ids = ids.reshape(-1)
    keep = (ids >= 0) & (ids < n)
    return rows[keep], ids[keep], n


@register_op("unsorted_segment_sum")
def _unsorted_segment_sum(data, segment_ids, num_segments):
    rows, ids, n = _segments(data, segment_ids, num_segments)
    out = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                      device=rows.device)
    return out.index_add(0, ids, rows)


@register_op("unsorted_segment_mean")
def _unsorted_segment_mean(data, segment_ids, num_segments):
    rows, ids, n = _segments(data, segment_ids, num_segments)
    s = torch.zeros((n,) + tuple(rows.shape[1:]), dtype=rows.dtype,
                    device=rows.device).index_add(0, ids, rows)
    cnt = torch.zeros(n, dtype=s.dtype, device=s.device).index_add(
        0, ids, torch.ones(ids.shape, dtype=s.dtype, device=s.device))
    return s / torch.clamp(cnt.reshape(cnt.shape + (1,) * (s.ndim - 1)),
                           min=1.0)


@register_op("unsorted_segment_max")
def _unsorted_segment_max(data, segment_ids, num_segments):
    rows, ids, n = _segments(data, segment_ids, num_segments)
    low = (float("-inf") if rows.is_floating_point()
           else torch.iinfo(rows.dtype).min)
    out = torch.full((n,) + tuple(rows.shape[1:]), low, dtype=rows.dtype,
                     device=rows.device)
    index = ids.reshape((-1,) + (1,) * (rows.ndim - 1)).expand(rows.shape)
    return out.scatter_reduce(0, index, rows, reduce="amax",
                              include_self=True)


# ---------------------------------------------------------------------------
# NN extensions
# ---------------------------------------------------------------------------
def _dilate(x, strides):
    """Insert (s - 1) zeros between the spatial elements of channels-first
    ``x`` (XLA's lhs dilation)."""
    if all(int(s) == 1 for s in strides):
        return x
    sp = [(int(n) - 1) * int(s) + 1 for n, s in zip(x.shape[2:], strides)]
    out = x.new_zeros(tuple(x.shape[:2]) + tuple(sp))
    idx = (slice(None), slice(None)) + tuple(
        slice(None, None, int(s)) for s in strides)
    out[idx] = x
    return out


def _conv_transpose_padding(k, s, padding):
    """lax.conv_transpose's padding for a string ``padding``."""
    if padding == "SAME":
        pad_len = k + s - 2
        pad_a = k - 1 if s > k - 1 else int(np.ceil(pad_len / 2))
    else:
        pad_len = k + s - 2 + max(k - s, 0)
        pad_a = k - 1
    return pad_a, pad_len - pad_a


@register_op("conv2d_transpose")
def _conv2d_transpose(dy, w, strides=(1, 1), padding="SAME",
                      output_shape=None):
    """TF Conv2DBackpropInput semantics (the op behind
    tf.nn.conv2d_transpose): the gradient of conv2d wrt its input.

    ``output_shape`` (the op's input_sizes operand) disambiguates odd
    input sizes under SAME/stride>1.  With it, the exact adjoint is
    computed: dy dilated by the stride, padded with (k-1-pad) on each
    side, correlated with the spatially-flipped, io-swapped kernel."""
    dy, w = _ts(dy, w)
    s = tuple(int(v) for v in strides)
    kh, kw = w.shape[0], w.shape[1]
    if output_shape is None:
        pad = [_conv_transpose_padding(kh, s[0], str(padding)),
               _conv_transpose_padding(kw, s[1], str(padding))] \
            if isinstance(padding, str) else \
            [tuple(int(v) for v in p) for p in padding]
    else:
        tgt = _ints(output_shape)
        in_h, in_w = tgt[1], tgt[2]
        pad = []
        for size, k, st, dn in ((in_h, kh, s[0], dy.shape[1]),
                                (in_w, kw, s[1], dy.shape[2])):
            if str(padding) == "SAME":
                o = -(-size // st)
                total = max((o - 1) * st + k - size, 0)
                plo = total // 2
            else:                       # VALID forward: no padding
                plo = 0
            dilated = (dn - 1) * st + 1
            lo = k - 1 - plo
            hi = size + k - 1 - dilated - lo
            pad.append((lo, hi))
    w_t = torch.flip(w, (0, 1)).transpose(2, 3)   # flip HW, swap I<->O
    x = _dilate(_channels_first(dy, 2), s)
    y = _conv_nchw(x, w_t.permute(3, 2, 0, 1), (1, 1), pad, (1, 1))
    return _channels_last(y, 2)


@register_op("depthwise_conv2d")
def _depthwise_conv2d(x, w, strides=(1, 1), padding="SAME",
                      dilations=(1, 1)):
    x, w = _ts(x, w)
    h, ww, c, m = w.shape           # TF filter [H, W, C_in, mult]
    return _conv_channels_last(x, w.reshape(h, ww, 1, c * m), strides,
                               padding, dilations, groups=c)


@register_op("conv3d")
def _conv3d(x, w, strides=(1, 1, 1), padding="SAME",
            dilations=(1, 1, 1)):
    return _conv_channels_last(x, w, strides, padding, dilations)


@register_op("max_pool3d")
def _max_pool3d(x, ksize=(2, 2, 2), strides=(2, 2, 2), padding="VALID"):
    return _pool_channels_last(x, ksize, strides, padding, "max")


@register_op("avg_pool3d")
def _avg_pool3d(x, ksize=(2, 2, 2), strides=(2, 2, 2), padding="VALID"):
    return _pool_channels_last(x, ksize, strides, padding, "avg")


@register_op("lrn")
def _lrn(x, depth_radius=5, bias=1.0, alpha=1.0, beta=0.5):
    x = _t(x)
    r = int(depth_radius)
    sq = F.pad(torch.square(x), (r, r))
    acc = sq.unfold(-1, 2 * r + 1, 1).sum(-1)
    return x / torch.pow(bias + alpha * acc, beta)


@register_op("softmax_cross_entropy_with_logits_v2", n_out=2)
def _sce_v2(logits, labels):
    """TF's raw op: outputs (per-example loss, backprop = p - labels)."""
    logits, labels = _ts(logits, labels)
    lp = torch.log_softmax(logits, -1)
    loss = -torch.sum(labels * lp, -1)
    return loss, torch.exp(lp) - labels


@register_op("sparse_softmax_cross_entropy_with_logits_v2", n_out=2)
def _ssce_v2(logits, labels):
    lp = torch.log_softmax(_t(logits), -1)
    oh = _one_hot(_t(labels, lp), lp.shape[-1], dtype=lp.dtype)
    loss = -torch.sum(oh * lp, -1)
    return loss, torch.exp(lp) - oh


# ---------------------------------------------------------------------------
# Linear algebra
# ---------------------------------------------------------------------------
@register_op("matrix_inverse")
def _matrix_inverse(x, adjoint=False):
    x = _t(x)
    if adjoint:
        x = x.transpose(-1, -2)
    return torch.linalg.inv(x)


@register_op("cholesky")
def _cholesky(x):
    return torch.linalg.cholesky(_t(x))


@register_op("matrix_determinant")
def _matrix_determinant(x):
    return torch.linalg.det(_t(x))


@register_op("matrix_triangular_solve")
def _matrix_triangular_solve(matrix, rhs, lower=True, adjoint=False):
    a, b = _ts(matrix, rhs)
    if adjoint:
        a, lower = a.transpose(-1, -2), not lower
    return torch.linalg.solve_triangular(a, b, upper=not bool(lower))


@register_op("matrix_diag")
def _matrix_diag(d):
    d = _t(d)
    return torch.diag_embed(d)


@register_op("matrix_diag_part")
def _matrix_diag_part(x):
    return torch.diagonal(_t(x), dim1=-2, dim2=-1)


@register_op("matrix_set_diag")
def _matrix_set_diag(x, d):
    x, d = _ts(x, d)
    eye = torch.eye(x.shape[-2], x.shape[-1], dtype=x.dtype, device=x.device)
    return x * (1 - eye) + eye * d[..., None]


# ---------------------------------------------------------------------------
# ONNX-semantics ops (the NCHW-native lowering targets of
# autodiff/onnx_import.py)
# ---------------------------------------------------------------------------
@register_op("reshape_with_zero")
def _reshape_with_zero(x, shape):
    """ONNX Reshape: 0 copies the input dim, -1 infers."""
    x = _t(x)
    tgt = _ints(shape)
    tgt = [x.shape[i] if s == 0 else s for i, s in enumerate(tgt)]
    return torch.reshape(x, tgt)


@register_op("flatten_onnx")
def _flatten_onnx(x, axis=1):
    x = _t(x)
    axis = int(axis)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    return torch.reshape(x, (lead, -1))


@register_op("unsqueeze_onnx")
def _unsqueeze_onnx(x, axis):
    # ONNX Unsqueeze axes are relative to the OUTPUT rank; normalize
    # negatives against ndim+len(axes) before inserting in ascending
    # order (axes=[-1,-3] on (2,3) -> (2,1,3,1), not (1,2,3,1)).
    # Host-preserving: shape-metaprogramming chains (Shape -> Gather ->
    # Unsqueeze -> Concat, e.g. torch LSTM h0 Expands) must stay
    # constant-foldable.
    host = _xp(x) is np
    if host:
        x = np.asarray(x)
    axes = _ints(axis)
    out_rank = np.ndim(x) + len(axes)
    norm = sorted(a + out_rank if a < 0 else a for a in axes)
    for a in norm:
        x = np.expand_dims(x, a) if host else torch.unsqueeze(x, a)
    return x


@register_op("softmax_onnx_pre13")
def _softmax_onnx_pre13(x, axis=1):
    # Opset<13 ONNX Softmax: coerce to 2-D at `axis`, softmax over the
    # flattened trailing block, restore shape.
    x = _t(x)
    axis = int(axis) % max(1, x.ndim)
    lead = int(np.prod(x.shape[:axis])) if axis else 1
    flat = torch.reshape(x, (lead, -1))
    return torch.reshape(torch.softmax(flat, dim=-1), x.shape)


@register_op("clip_scalar")
def _clip_scalar(x, lo=-np.inf, hi=np.inf):
    return torch.clamp(_t(x), float(lo), float(hi))


def _onnx_spatial_pads(pads, n_spatial):
    if pads is None:
        return [(0, 0)] * n_spatial
    p = _ints(pads)
    return [(p[i], p[i + n_spatial]) for i in range(n_spatial)]


def _onnx_padding(auto_pad, pads, x, window, strides, dilations=None):
    """Resolve ONNX auto_pad/pads to explicit per-spatial-dim pairs.
    SAME_LOWER puts the odd pad at the BEGINNING; SAME_UPPER at the end."""
    n_sp = x.ndim - 2
    ap = str(auto_pad)
    if ap in ("SAME_UPPER", "SAME_LOWER"):
        dil = dilations or (1,) * n_sp
        out = []
        for i in range(n_sp):
            size = x.shape[2 + i]
            k_eff = (int(window[i]) - 1) * int(dil[i]) + 1
            o = -(-size // int(strides[i]))        # ceil
            total = max((o - 1) * int(strides[i]) + k_eff - size, 0)
            lo = (total + 1) // 2 if ap == "SAME_LOWER" else total // 2
            out.append((lo, total - lo))
        return out
    if ap == "VALID":
        return [(0, 0)] * n_sp
    return _onnx_spatial_pads(pads, n_sp)


@register_op("onnx_conv")
def _onnx_conv(x, w, b=None, strides=(1, 1), pads=None,
               auto_pad="NOTSET", dilations=(1, 1), group=1):
    x, w = _ts(x, w)
    n_sp = x.ndim - 2
    padding = _onnx_padding(auto_pad, pads, x, w.shape[2:], strides,
                            dilations)
    y = _conv_nchw(x, w, strides, padding, dilations, group)
    if b is not None:
        y = y + _t(b, y).reshape((1, -1) + (1,) * n_sp)
    return y


@register_op("onnx_max_pool")
def _onnx_max_pool(x, kernel_shape=(2, 2), strides=(2, 2), pads=None,
                   auto_pad="NOTSET"):
    x = _t(x)
    k = tuple(int(v) for v in kernel_shape)
    s = tuple(int(v) for v in strides)
    padding = _onnx_padding(auto_pad, pads, x, k, s)
    return _pool_nchw(x, k, s, padding, "max", False)


@register_op("onnx_avg_pool")
def _onnx_avg_pool(x, kernel_shape=(2, 2), strides=(2, 2), pads=None,
                   auto_pad="NOTSET", count_include_pad=0):
    x = _t(x)
    k = tuple(int(v) for v in kernel_shape)
    s = tuple(int(v) for v in strides)
    padding = _onnx_padding(auto_pad, pads, x, k, s)
    return _pool_nchw(x, k, s, padding, "avg", bool(count_include_pad))


@register_op("onnx_global_avg_pool")
def _onnx_global_avg_pool(x):
    x = _t(x)
    return torch.mean(x, dim=tuple(range(2, x.ndim)), keepdim=True)


@register_op("onnx_batch_norm")
def _onnx_batch_norm(x, scale, b, mean, var, eps=1e-5):
    x, scale, b, mean, var = _ts(x, scale, b, mean, var)
    shape = (1, -1) + (1,) * (x.ndim - 2)
    inv = torch.rsqrt(var + eps) * scale
    return x * inv.reshape(shape) + (b - mean * inv).reshape(shape)


@register_op("onnx_layer_norm")
def _onnx_layer_norm(x, scale, b=None, axis=-1, eps=1e-5):
    x, scale = _ts(x, scale)
    axis = int(axis)
    axes = tuple(range(axis % x.ndim, x.ndim))
    mean = torch.mean(x, dim=axes, keepdim=True)
    var = torch.var(x, dim=axes, keepdim=True, unbiased=False)
    y = (x - mean) * torch.rsqrt(var + eps) * scale
    if b is not None:
        y = y + _t(b, y)
    return y


@register_op("onnx_pad")
def _onnx_pad(x, pads, mode="constant", value=0.0):
    x = _t(x)
    p = _ints(pads)
    n = x.ndim
    pairs = [(p[i], p[i + n]) for i in range(n)]
    mode = str(mode)
    if mode == "constant":
        return F.pad(x, _pad_list(pairs), value=value)
    if mode == "reflect":
        return _mirror(x, pairs, False)
    for d, (lo, hi) in enumerate(pairs):          # edge
        if lo or hi:
            i = torch.clamp(torch.arange(-lo, x.shape[d] + hi,
                                         device=x.device),
                            0, x.shape[d] - 1)
            x = x.index_select(d, i)
    return x


@register_op("onnx_slice")
def _onnx_slice(x, starts, ends, axes, steps):
    x = _t(x)
    idx = [slice(None)] * x.ndim
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        dim = x.shape[ax]
        en = min(int(en), dim) if en >= 0 else en
        idx[int(ax)] = slice(int(st), int(en), int(sp))
    return _index(x, idx)


# ---------------------------------------------------------------------------
# TF RNN-cell block ops (LSTMBlockCell / dynamic_rnn-era frozen graphs).
# Gate layout: LSTMBlockCell/BlockLSTM are ICFO; BlockLSTMV2 is IFCO.
# ---------------------------------------------------------------------------
def _lstm_gate_split(z, gate_order):
    a, b_, c, d = torch.chunk(z, 4, dim=-1)
    if gate_order == "icfo":
        return a, b_, c, d          # i, ci, f, o
    return a, c, b_, d              # ifco -> (i, ci, f, o)


def _lstm_cell_math(x, cs_prev, h_prev, w, wci, wcf, wco, b,
                    forget_bias, cell_clip, use_peephole, gate_order):
    xh = torch.cat([x, h_prev], dim=1)
    i, ci, f, o = _lstm_gate_split(xh @ w + b, gate_order)
    if use_peephole:
        i = i + wci * cs_prev
        f = f + wcf * cs_prev
    i = torch.sigmoid(i)
    f = torch.sigmoid(f + forget_bias)
    ci = torch.tanh(ci)
    cs = ci * i + cs_prev * f
    if cell_clip is not None and float(cell_clip) > 0:
        cs = torch.clamp(cs, -float(cell_clip), float(cell_clip))
    if use_peephole:
        o = o + wco * cs
    o = torch.sigmoid(o)
    co = torch.tanh(cs)
    h = co * o
    return i, cs, f, o, ci, co, h


@register_op("lstm_block_cell", n_out=7)
def _lstm_block_cell(x, cs_prev, h_prev, w, wci, wcf, wco, b,
                     forget_bias=1.0, cell_clip=3.0,
                     use_peephole=False, gate_order="icfo"):
    return _lstm_cell_math(*_ts(x, cs_prev, h_prev, w, wci, wcf, wco, b),
                           forget_bias, cell_clip, use_peephole, gate_order)


@register_op("block_lstm", n_out=7)
def _block_lstm(seq_len_max, x, cs_prev, h_prev, w, wci, wcf, wco, b,
                forget_bias=1.0, cell_clip=3.0, use_peephole=False,
                gate_order="icfo"):
    """Whole-sequence LSTM over x [t, b, in], one step at a time.  Steps
    at or past seq_len_max freeze the carry and emit zeros."""
    x, cs_p, h_p, w, wci, wcf, wco, b = _ts(x, cs_prev, h_prev, w, wci,
                                            wcf, wco, b)
    slm = _scalar_int(seq_len_max)
    ys = []
    for t in range(x.shape[0]):
        outs = _lstm_cell_math(x[t], cs_p, h_p, w, wci, wcf, wco, b,
                               forget_bias, cell_clip, use_peephole,
                               gate_order)
        if t < slm:
            cs_p, h_p = outs[1], outs[6]
            ys.append(outs)
        else:
            ys.append(tuple(torch.zeros_like(v) for v in outs))
    return tuple(torch.stack([y[j] for y in ys]) for j in range(7))


@register_op("gru_block_cell", n_out=4)
def _gru_block_cell(x, h_prev, w_ru, w_c, b_ru, b_c):
    x, h_prev, w_ru, w_c, b_ru, b_c = _ts(x, h_prev, w_ru, w_c, b_ru, b_c)
    xh = torch.cat([x, h_prev], dim=1)
    r, u = torch.chunk(torch.sigmoid(xh @ w_ru + b_ru), 2, dim=-1)
    xrh = torch.cat([x, r * h_prev], dim=1)
    c = torch.tanh(xrh @ w_c + b_c)
    h = u * h_prev + (1.0 - u) * c
    return r, u, c, h


# ---------------------------------------------------------------------------
# ONNX recurrent ops (torch.onnx.export emits these for nn.LSTM/GRU).
# ONNX gate orders: LSTM [i o f c], GRU [z r h].  Optional inputs are
# slot-encoded via the ``present`` attr.
# ---------------------------------------------------------------------------
def _slotted(args, present):
    slots = {}
    for p, a in zip(present, args):
        slots[int(p)] = a
    return slots


_DIRS = {"forward": [(0, False)], "reverse": [(0, True)],
         "bidirectional": [(0, False), (1, True)]}


@register_op("onnx_lstm", n_out=3)
def _onnx_lstm(*args, present=(0, 1, 2), hidden_size=None,
               direction="forward"):
    s = {k: _t(v) for k, v in _slotted(args, present).items()}
    x, w, r = s[0], s[1], s[2]
    if 4 in s and s[4] is not None:
        raise NotImplementedError("ONNX LSTM sequence_lens")
    if 7 in s:
        raise NotImplementedError("ONNX LSTM peepholes")
    t, bsz, _ = x.shape
    nd = w.shape[0]
    h = int(hidden_size or w.shape[1] // 4)
    b_all = s.get(3)
    if b_all is None:
        b_all = x.new_zeros((nd, 8 * h))
    h0 = s.get(5)
    c0 = s.get(6)
    if h0 is None:
        h0 = x.new_zeros((nd, bsz, h))
    if c0 is None:
        c0 = x.new_zeros((nd, bsz, h))

    def run_dir(d, reverse):
        wi, ri = w[d], r[d]
        bias = b_all[d, :4 * h] + b_all[d, 4 * h:]
        hp, cp = h0[d], c0[d]
        ys = [None] * t
        for step in (reversed(range(t)) if reverse else range(t)):
            g = x[step] @ wi.T + hp @ ri.T + bias
            i_, o_, f_, c_ = torch.chunk(g, 4, -1)      # ONNX iofc
            c = torch.sigmoid(f_) * cp + torch.sigmoid(i_) * torch.tanh(c_)
            hp, cp = torch.sigmoid(o_) * torch.tanh(c), c
            ys[step] = hp
        return torch.stack(ys), hp, cp

    outs = [run_dir(d, rev) for d, rev in _DIRS[str(direction)]]
    y = torch.stack([o[0] for o in outs], dim=1)       # [t, nd, b, h]
    y_h = torch.stack([o[1] for o in outs], dim=0)
    y_c = torch.stack([o[2] for o in outs], dim=0)
    return y, y_h, y_c


@register_op("onnx_gru", n_out=2)
def _onnx_gru(*args, present=(0, 1, 2), hidden_size=None,
              direction="forward", linear_before_reset=0):
    s = {k: _t(v) for k, v in _slotted(args, present).items()}
    x, w, r = s[0], s[1], s[2]
    if 4 in s and s[4] is not None:
        raise NotImplementedError("ONNX GRU sequence_lens")
    t, bsz, _ = x.shape
    nd = w.shape[0]
    h = int(hidden_size or w.shape[1] // 3)
    b_all = s.get(3)
    if b_all is None:
        b_all = x.new_zeros((nd, 6 * h))
    h0 = s.get(5)
    if h0 is None:
        h0 = x.new_zeros((nd, bsz, h))
    lbr = bool(int(linear_before_reset))

    def run_dir(d, reverse):
        wi, ri = w[d], r[d]
        wb, rb = b_all[d, :3 * h], b_all[d, 3 * h:]
        hp = h0[d]
        ys = [None] * t
        for step in (reversed(range(t)) if reverse else range(t)):
            zx, rx, hx = torch.chunk(x[step] @ wi.T + wb, 3, -1)  # zrh
            if lbr:
                zh, rh, hh_ = torch.chunk(hp @ ri.T + rb, 3, -1)
            else:   # the h-gate recurrence applies AFTER reset
                zh, rh = torch.chunk(hp @ ri[:2 * h].T + rb[:2 * h], 2, -1)
            z = torch.sigmoid(zx + zh)
            rr = torch.sigmoid(rx + rh)
            if lbr:
                ht = torch.tanh(hx + rr * hh_)
            else:
                ht = torch.tanh(hx + (rr * hp) @ ri[2 * h:].T + rb[2 * h:])
            hp = (1.0 - z) * ht + z * hp
            ys[step] = hp
        return torch.stack(ys), hp

    outs = [run_dir(d, rev) for d, rev in _DIRS[str(direction)]]
    y = torch.stack([o[0] for o in outs], dim=1)
    y_h = torch.stack([o[1] for o in outs], dim=0)
    return y, y_h


@register_op("broadcast_to_dynamic")
def _broadcast_to_dynamic(x, shape):
    """ONNX Expand whose target rides the graph (Shape->...->Concat):
    the shape chain constant-folds to a HOST vector (see module
    docstring); anything else is a data-dependent shape — fail loudly."""
    if not is_static_value(shape):
        raise ValueError(
            "Expand target shape did not constant-fold on the host "
            "(data-dependent shapes are not supported)")
    tgt = _ints(shape)
    # ONNX Expand: BIDIRECTIONAL numpy broadcast — right-align and pad
    # BOTH sides to the max rank
    xs = list(np.shape(x) if is_static_value(x) else x.shape)
    rank = max(len(xs), len(tgt))
    xs = [1] * (rank - len(xs)) + xs
    tgt = [1] * (rank - len(tgt)) + tgt
    out = tuple(max(a, b) for a, b in zip(xs, tgt))
    if _xp(x) is np:
        return np.broadcast_to(x, out)
    return torch.broadcast_to(x, out)


@register_op("reshape_dynamic")
def _reshape_dynamic(x, shape):
    """ONNX Reshape with a graph-computed target (host-folded); supports
    0 = copy input dim and a single -1."""
    if not is_static_value(shape):
        raise ValueError("Reshape target did not constant-fold on the host")
    dims = np.shape(x) if is_static_value(x) else tuple(x.shape)
    tgt = [dims[i] if s == 0 else s for i, s in enumerate(_ints(shape))]
    if _xp(x) is np:
        return np.reshape(x, tuple(tgt))
    return torch.reshape(x, tuple(tgt))
