"""Paged decode attention — K/V read through a block table (port of
``deeplearning4j_tpu/kernels/paged_attention.py``, the decode half).

K/V live in a global pool of fixed-size blocks ``[n_blocks, h,
block_size, dh]`` and every decode slot carries a ``[max_blocks]`` int32
block table mapping its logical positions onto pool blocks.  Block 0 is
the pool's scratch sink for masked-inactive writes: never referenced by
a live table entry, so its contents are garbage by design and must never
be read unmasked.

Two implementations behind one wrapper, ``paged_decode_attention``:

* ``paged_decode_attention_reference`` — plain PyTorch, the reference's
  math step for step: gather the table's blocks into the slot's
  contiguous view, score einsum in the input dtype then ``.float()``,
  ``* scale``, ``-1e9`` where ``j > pos``, f32 softmax cast to V's dtype,
  then the P.V einsum.  Those bf16 rounding points are what parity with
  the JAX package and with the port's stripe decode rests on.
* the CUDA kernel ``csrc/paged_decode.cu`` (replaces the Pallas
  ``_decode_kernel``): one thread block per (head, slot) walking the
  slot's table entries, online softmax in f32, no gathered copy.

The wrapper routes by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise — there is no fallback.
``paged_route_total{path="kernel"|"reference"}`` counts the routes, and
``paged_decode_attention.launches`` counts kernel launches (chip runs
read it to prove the serving path went through the kernel).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_torch import telemetry

_ROUTE_TOTAL = telemetry.counter(
    "paged_route_total",
    "paged_decode_attention route decisions, by path (kernel = the CUDA "
    "kernel, reference = the plain PyTorch version on CPU tensors)",
    labelnames=("path",))
_ROUTE_KERNEL = _ROUTE_TOTAL.labels(path="kernel")
_ROUTE_REFERENCE = _ROUTE_TOTAL.labels(path="reference")

_MAX_DH = 128


def paged_gather(pool, block_table):
    """[n_blocks, h, bs, dh] pool + [B, max_blocks] table -> the per-slot
    contiguous [B, h, max_blocks*bs, dh] view (the stripe the table
    logically describes).  Unallocated table entries point at the scratch
    block 0 — callers must mask those positions."""
    B, mb = block_table.shape
    _, h, bs, dh = pool.shape
    lin = pool[block_table.long()]                   # [B, mb, h, bs, dh]
    return lin.permute(0, 2, 1, 3, 4).reshape(B, h, mb * bs, dh)


def paged_decode_attention_reference(q, k_pool, v_pool, block_table, pos,
                                     scale: float):
    """One-query-per-slot attention through the block table, stripe math
    (mirrors the reference's ``paged_decode_attention_reference``)."""
    kl = paged_gather(k_pool, block_table)
    vl = paged_gather(v_pool, block_table)
    L = kl.shape[2]
    qq = q[:, :, None, :]                            # [B, h, 1, dh]
    s = torch.einsum("bhqd,bhkd->bhqk", qq, kl).float()
    s = s * scale
    valid = (torch.arange(L, device=q.device)[None, :]
             <= pos.long()[:, None])[:, None, None, :]
    s = torch.where(valid, s, -1e9)
    p = torch.softmax(s, dim=-1).to(vl.dtype)
    att = torch.einsum("bhqk,bhkd->bhqd", p, vl)
    return att[:, :, 0, :]


def _check(q, k_pool, v_pool, block_table, pos):
    tensors = (q, k_pool, v_pool, block_table, pos)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError("paged_decode_attention: all operands must be on "
                         f"one device, got {[str(t.device) for t in tensors]}")
    if q.dim() != 3 or k_pool.dim() != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(
            "paged_decode_attention: q [B, h, dh], pools [n_blocks, h, bs, "
            f"dh], got q {tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}")
    B, h, dh = q.shape
    if k_pool.shape[1] != h or k_pool.shape[3] != dh:
        raise ValueError(f"paged_decode_attention: pool heads/dh "
                         f"{tuple(k_pool.shape)} do not match q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(pos.shape) != (B,):
        raise ValueError(
            "paged_decode_attention: block_table [B, max_blocks] and pos "
            f"[B] for B={B}, got {tuple(block_table.shape)} and "
            f"{tuple(pos.shape)}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError("paged_decode_attention: block_table and pos must "
                         "be int32")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError("paged_decode_attention: q and pools must share "
                         "one dtype, float32 or bfloat16; got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_decode_attention: operands must be "
                         "contiguous")


_KERNEL_FN = None


def _kernel_fn():
    """The C entry of the built library, argument types declared (every
    pointer and the stream as c_void_p, or ctypes would cut them to 32
    bits)."""
    global _KERNEL_FN
    if _KERNEL_FN is None:
        from deeplearning4j_torch.kernels import _build
        fn = _build.load("paged_decode").dl4j_paged_decode_attention
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _KERNEL_FN = fn
    return _KERNEL_FN


def _launch(q, k_pool, v_pool, block_table, pos, scale: float):
    """Launch the CUDA kernel on the current stream; raise on a refused
    launch."""
    B, h, dh = q.shape
    if dh > _MAX_DH or dh % 8:
        raise ValueError(f"paged decode kernel: dh={dh} must be a multiple "
                         f"of 8 and <= {_MAX_DH}")
    fn = _kernel_fn()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            B, h, k_pool.shape[2], dh, block_table.shape[1], float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           scale: Optional[float] = None):
    """softmax(q . K_table^T) V_table for ONE query token per slot.

    ``q`` [B, h, dh] — the just-written token's query per slot;
    ``k_pool``/``v_pool`` [n_blocks, h, block_size, dh] (block 0 is the
    scratch sink); ``block_table`` [B, max_blocks] int32; ``pos`` [B]
    int32 — attend over positions <= pos (the row written this tick
    included).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (float32 or bfloat16, dh a multiple of 8 up to 128)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    _check(q, k_pool, v_pool, block_table, pos)
    if q.device.type == "cpu":
        _ROUTE_REFERENCE.inc()
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                block_table, pos,
                                                float(scale))
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    out = _launch(q, k_pool, v_pool, block_table, pos, float(scale))
    paged_decode_attention.launches += 1
    _ROUTE_KERNEL.inc()
    return out


#: CUDA kernel launches since the last reset (set it to 0 to start a count)
paged_decode_attention.launches = 0
