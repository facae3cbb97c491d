"""Paged attention — K/V read through a block table (port of
``deeplearning4j_tpu/kernels/paged_attention.py``: the decode and the
speculative-verify halves).

K/V live in a global pool of fixed-size blocks ``[n_blocks, h,
block_size, dh]`` and every decode slot carries a ``[max_blocks]`` int32
block table mapping its logical positions onto pool blocks.  Block 0 is
the pool's scratch sink for masked-inactive writes: never referenced by
a live table entry, so its contents are garbage by design and must never
be read unmasked.

Two implementations behind each of two wrappers.  The decode read,
``paged_decode_attention`` (one query per slot):

* ``paged_decode_attention_reference`` — plain PyTorch, the reference's
  math step for step: gather the table's blocks into the slot's
  contiguous view, score einsum in the input dtype then ``.float()``,
  ``* scale``, ``-1e9`` where ``j > pos``, f32 softmax cast to V's dtype,
  then the P.V einsum.  Those bf16 rounding points are what parity with
  the JAX package and with the port's stripe decode rests on.
* the CUDA kernel ``csrc/paged_decode.cu`` (replaces the Pallas
  ``_decode_kernel``): split-K over the context in one launch — grid
  (head, slot, split), each split an online f32 softmax over its chunk
  of the slot's table entries, the last split of a (slot, head) merging
  the partials — with no gathered copy and no host read of ``pos``.
  :func:`decode_split_rows` picks the chunk from the table's capacity.
  Head dims above 128 or not a multiple of 8 (up to 256) take
  ``csrc/paged_any_dh.cuh``'s kernel instead: rows read element by
  element, q and the accumulator in a register width padded to 128 or
  256, zero past dh.

The speculative verification read, ``paged_verify_attention`` (W query
rows per slot, row j at position ``pos0 + j``):

* ``paged_verify_attention_reference`` — plain PyTorch, UNROLLED per
  query row: each row runs the decode reference's exact shapes ([B, h,
  1, L]) against the once-gathered table view, as the JAX reference
  does;
* the CUDA kernel ``csrc/paged_verify.cu`` (replaces the Pallas
  ``_verify_kernel``): K1's split-K carried over — grid (head x row
  group, slot, split), each block the W <= 16 rows of one group as one
  tensor-core fragment over its chunk of the table, the last split of a
  (slot, head, group) merging the partials in the same launch.  Any W:
  rows go in groups of 16 (:func:`verify_split_rows` picks the chunk).
  The other head dims up to 256 take ``paged_any_dh.cuh``'s kernel, each
  query row on its own.

Each wrapper routes by the tensors' device: CPU tensors take the plain
version, CUDA tensors launch the kernel or raise — there is no fallback.
``paged_route_total{path="kernel"|"reference"}`` counts the routes of
both, and ``<wrapper>.launches`` counts each wrapper's kernel launches
(chip runs read them to prove the serving path went through the
kernels).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from deeplearning4j_torch import telemetry

_ROUTE_TOTAL = telemetry.counter(
    "paged_route_total",
    "paged_decode_attention / paged_verify_attention route decisions, by "
    "path (kernel = the CUDA kernel, reference = the plain PyTorch "
    "version on CPU tensors)",
    labelnames=("path",))
_ROUTE_KERNEL = _ROUTE_TOTAL.labels(path="kernel")
_ROUTE_REFERENCE = _ROUTE_TOTAL.labels(path="reference")

_MAX_DH = 256        # head dims the kernels take
_FAST_DH = 128       # the fast kernels: dh <= this and a multiple of 8
_VERIFY_GROUP = 16   # verify query rows a kernel block takes (one fragment)
_VERIFY_TILE = 64    # the verify kernel's key tile; its chunk is a multiple
_VERIFY_MAX_SPLIT = 512   # splits the verify kernel's merge takes


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


def _check(name, q_dims, q, k_pool, v_pool, block_table, pos):
    """Operand checks shared by both wrappers: ``q`` laid out as
    ``q_dims`` ("[B, h, dh]" for decode, "[B, W, h, dh]" for verify),
    pools [n_blocks, h, bs, dh], table [B, max_blocks] and positions [B]
    int32, one device, one float dtype, contiguous."""
    tensors = (q, k_pool, v_pool, block_table, pos)
    dev = q.device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{name}: all operands must be on one device, "
                         f"got {[str(t.device) for t in tensors]}")
    if q.dim() != len(q_dims.split(",")) or k_pool.dim() != 4 \
            or v_pool.shape != k_pool.shape:
        raise ValueError(
            f"{name}: q {q_dims}, pools [n_blocks, h, bs, dh], got q "
            f"{tuple(q.shape)}, k {tuple(k_pool.shape)}, "
            f"v {tuple(v_pool.shape)}")
    B, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    if k_pool.shape[1] != h or k_pool.shape[3] != dh:
        raise ValueError(f"{name}: pool heads/dh {tuple(k_pool.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if block_table.dim() != 2 or block_table.shape[0] != B \
            or tuple(pos.shape) != (B,):
        raise ValueError(
            f"{name}: block_table [B, max_blocks] and positions [B] for "
            f"B={B}, got {tuple(block_table.shape)} and "
            f"{tuple(pos.shape)}")
    if block_table.dtype != torch.int32 or pos.dtype != torch.int32:
        raise ValueError(f"{name}: block_table and positions must be "
                         "int32")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise ValueError(f"{name}: q and pools must share one dtype, "
                         "float32 or bfloat16; got "
                         f"{q.dtype}, {k_pool.dtype}, {v_pool.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: operands must be contiguous")


_KERNEL_FNS = {}


def _kernel_fn(lib: str, symbol: str, n_ptrs: int, n_ints: int):
    """The C entry ``symbol`` of built library ``lib``, argument types
    declared: ``n_ptrs`` pointers, ``n_ints`` ints, the scale, the bf16
    flag and the stream (every pointer and the stream as c_void_p, or
    ctypes would cut them to 32 bits)."""
    fn = _KERNEL_FNS.get(symbol)
    if fn is None:
        from deeplearning4j_torch.kernels import _build
        fn = getattr(_build.load(lib), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptrs
                       + [ctypes.c_int] * n_ints
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        _KERNEL_FNS[symbol] = fn
    return fn


def _check_dh(what: str, dh: int):
    if dh > _MAX_DH:
        raise ValueError(f"{what}: dh={dh}; the kernels take head dims up "
                         f"to {_MAX_DH}")


def _fast_dh(dh: int) -> bool:
    """Whether the fast kernels take ``dh`` (rows as whole 16-byte
    vectors); every other head dim up to 256 takes the any-dh kernel."""
    return dh <= _FAST_DH and dh % 8 == 0


_SPLIT_QUANTUM = 32     # the decode kernel's chunk is a multiple of this
H100_SMS = 132


def decode_split_rows(B: int, h: int, capacity: int,
                      n_sm: int = H100_SMS) -> int:
    """Context rows per split of the decode kernel (a multiple of 32):
    the largest chunk for which the live (slot, head, split) blocks at a
    mid context of ``7/16`` of the table's ``capacity`` rows (~450 at
    1024, the serving path's mid contexts) number at least two per SM.
    A function of the shapes alone, never of the positions, so a call
    reads nothing back from the card."""
    q = _SPLIT_QUANTUM
    mid = max(1, capacity * 7 // 16)
    need = -(-2 * n_sm // (B * h))             # live splits per (slot, head)
    chunk = max(q, mid // need // q * q)
    return min(chunk, -(-capacity // q) * q)


def decode_chunk(q, k_pool, block_table, split_rows=None,
                 n_sm: int = H100_SMS, W: int = 1) -> int:
    """The decode kernel's context rows per split for this call (``W``
    query rows per slot on the any-dh kernel).  ``split_rows`` (slots,
    heads): the shape to choose the chunk for, where this call is one
    shard of a sharded tick — the replica's unsharded (B, h), so each
    (slot, head) sums its splits in the order an unsharded call sums
    them; None takes ``q``'s own."""
    B, h = split_rows or (q.shape[0], q.shape[-2])
    bs, mb = k_pool.shape[2], block_table.shape[1]
    return decode_split_rows(B * W, h, mb * bs, n_sm)


def verify_chunk(q, k_pool, block_table, split_rows=None,
                 n_sm: int = H100_SMS) -> int:
    """The verify kernel's context rows per split for this call;
    ``split_rows`` as in :func:`decode_chunk`."""
    B, h = split_rows or (q.shape[0], q.shape[-2])
    bs, mb = k_pool.shape[2], block_table.shape[1]
    return verify_split_rows(B, q.shape[1], h, mb * bs, n_sm)


_COUNTERS = {}


def _split_counters(device, stream: int, n: int):
    """[>= n] int32 ticket counters for the split kernels' merge, zeroed
    once and cached per device and stream (the kernel leaves them zero;
    launches on one stream run in order, so they never share a counter
    at once), so a call launches no memset and stays safe to capture in
    a CUDA graph."""
    key = (device, stream)
    buf = _COUNTERS.get(key)
    if buf is None or buf.numel() < n:
        buf = _COUNTERS[key] = torch.zeros(max(n, 1024), dtype=torch.int32,
                                           device=device)
    return buf


_SMS = {}


def _sm_count(device) -> int:
    n = _SMS.get(device)
    if n is None:
        n = _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def _launch_any_dh(lib: str, symbol: str, q, k_pool, v_pool, block_table,
                   pos, W: int, scale: float, split_rows=None):
    """Launch ``paged_any_dh.cuh``'s kernel (entry ``symbol`` of ``lib``)
    over ``q`` [B, h, dh] (decode) or [B, W, h, dh] (verify), each query
    row on its own; raise on a refused launch."""
    B, h, dh = q.shape[0], q.shape[-2], q.shape[-1]
    bs, mb = k_pool.shape[2], block_table.shape[1]
    chunk = decode_chunk(q, k_pool, block_table, split_rows,
                         _sm_count(q.device), W)
    n_split = -(-(mb * bs) // chunk)
    ints = ((B, h, bs, dh, mb, chunk) if q.dim() == 3
            else (B, W, h, bs, dh, mb, chunk))
    fn = _kernel_fn(lib, symbol, 8, len(ints))
    out = torch.empty_like(q)
    part = torch.empty(B * W * h * n_split * (dh + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _split_counters(q.device, stream, B * W * h)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), *ints, float(scale),
            int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"paged any-dh kernel launch failed ({symbol}): "
                           f"CUDA error {rc}")
    return out


def _launch(q, k_pool, v_pool, block_table, pos, scale: float,
            split_rows=None):
    """Launch the decode kernel on the current stream; raise on a refused
    launch.  Its f32 partials go to scratch allocated here."""
    B, h, dh = q.shape
    _check_dh("paged decode kernel", dh)
    if not _fast_dh(dh):
        return _launch_any_dh("paged_decode",
                              "dl4j_paged_decode_attention_any", q, k_pool,
                              v_pool, block_table, pos, 1, scale,
                              split_rows)
    bs, mb = k_pool.shape[2], block_table.shape[1]
    chunk = decode_chunk(q, k_pool, block_table, split_rows,
                         _sm_count(q.device))
    n_split = -(-(mb * bs) // chunk)
    fn = _kernel_fn("paged_decode", "dl4j_paged_decode_attention", 8, 6)
    out = torch.empty_like(q)
    part = torch.empty(B * h * n_split * (dh + 2), dtype=torch.float32,
                       device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _split_counters(q.device, stream, B * h)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), pos.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), B, h, bs, dh, mb, chunk,
            float(scale), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"paged decode kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def paged_decode_attention(q, k_pool, v_pool, block_table, pos,
                           scale: Optional[float] = None,
                           split_rows=None):
    """softmax(q . K_table^T) V_table for ONE query token per slot.

    ``q`` [B, h, dh] — the just-written token's query per slot;
    ``k_pool``/``v_pool`` [n_blocks, h, block_size, dh] (block 0 is the
    scratch sink); ``block_table`` [B, max_blocks] int32; ``pos`` [B]
    int32 — attend over positions <= pos (the row written this tick
    included).  CPU tensors take the plain version; CUDA tensors launch
    the kernel (float32 or bfloat16, any dh up to 256).  ``split_rows``
    (slots, heads): this call is one shard of a sharded tick, and the
    split-K chunk follows that unsharded shape (:func:`decode_chunk`)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    _check("paged_decode_attention", "[B, h, dh]", q, k_pool, v_pool,
           block_table, pos)
    if q.device.type == "cpu":
        _ROUTE_REFERENCE.inc()
        return paged_decode_attention_reference(q, k_pool, v_pool,
                                                block_table, pos,
                                                float(scale))
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    out = _launch(q, k_pool, v_pool, block_table, pos, float(scale),
                  split_rows)
    paged_decode_attention.launches += 1
    _ROUTE_KERNEL.inc()
    return out


#: CUDA kernel launches since the last reset (set it to 0 to start a count)
paged_decode_attention.launches = 0


def paged_verify_attention_reference(q, k_pool, v_pool, block_table,
                                     pos0, scale: float):
    """W-query verification attention through the block table, stripe
    math, UNROLLED per query row (mirrors the reference's
    ``paged_verify_attention_reference``): query row j of slot b sits at
    position ``pos0[b] + j`` and attends over positions <= its own.  Each
    row runs the decode reference's exact shapes ([B, h, 1, L]) against
    the once-gathered table view."""
    kl = paged_gather(k_pool, block_table)
    vl = paged_gather(v_pool, block_table)
    L = kl.shape[2]
    W = q.shape[1]
    cols = torch.arange(L, device=q.device)[None, :]
    rows = []
    for j in range(W):
        qq = q[:, j].contiguous()[:, :, None, :]      # [B, h, 1, dh]
        s = torch.einsum("bhqd,bhkd->bhqk", qq, kl).float()
        s = s * scale
        valid = (cols <= (pos0.long() + j)[:, None])[:, None, None, :]
        s = torch.where(valid, s, -1e9)
        p = torch.softmax(s, dim=-1).to(vl.dtype)
        rows.append(torch.einsum("bhqk,bhkd->bhqd", p, vl)[:, :, 0, :])
    return torch.stack(rows, dim=1)                    # [B, W, h, dh]


def verify_split_rows(B: int, W: int, h: int, capacity: int,
                      n_sm: int = H100_SMS) -> int:
    """Context rows per split of the verify kernel: the decode kernel's
    chunk (:func:`decode_split_rows`) for the (slot, row group, head)
    blocks, rounded up to the kernel's 64-key tile, and large enough that
    the table takes at most 512 splits (what the kernel's merge holds).
    A function of the shapes alone, never of the positions."""
    n_grp = -(-W // _VERIFY_GROUP)
    chunk = max(decode_split_rows(B * n_grp, h, capacity, n_sm),
                -(-capacity // _VERIFY_MAX_SPLIT))
    return -(-chunk // _VERIFY_TILE) * _VERIFY_TILE


def _launch_verify(q, k_pool, v_pool, block_table, pos0, scale: float,
                   split_rows=None):
    """Launch the verify kernel on the current stream; raise on a refused
    launch.  ``q`` is read, and the output written, in the [B, W, h, dh]
    layout as it stands; the f32 partials go to scratch allocated here."""
    B, W, h, dh = q.shape
    _check_dh("paged verify kernel", dh)
    if not _fast_dh(dh):
        return _launch_any_dh("paged_verify",
                              "dl4j_paged_verify_attention_any", q, k_pool,
                              v_pool, block_table, pos0, W, scale,
                              split_rows)
    bs, mb = k_pool.shape[2], block_table.shape[1]
    chunk = verify_chunk(q, k_pool, block_table, split_rows,
                         _sm_count(q.device))
    n_split = -(-(mb * bs) // chunk)
    n_grp = -(-W // _VERIFY_GROUP)
    fn = _kernel_fn("paged_verify", "dl4j_paged_verify_attention", 8, 7)
    out = torch.empty_like(q)
    part = torch.empty(B * h * n_grp * n_split * _VERIFY_GROUP * (dh + 4),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    counters = _split_counters(q.device, stream, B * h * n_grp)
    rc = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
            block_table.data_ptr(), pos0.data_ptr(), out.data_ptr(),
            part.data_ptr(), counters.data_ptr(), B, W, h, bs, dh, mb,
            chunk, float(scale), int(q.dtype == torch.bfloat16), stream)
    if rc != 0:
        raise RuntimeError(f"paged verify kernel launch failed: CUDA "
                           f"error {rc}")
    return out


def paged_verify_attention(q, k_pool, v_pool, block_table, pos0,
                           scale: Optional[float] = None,
                           split_rows=None):
    """softmax(q . K_table^T) V_table for a CHUNK of W query tokens per
    slot — the speculative verification read.  Query row j of slot b is
    the chunk's j-th token, at position ``pos0[b] + j``, attending over
    every position <= its own (the caller has written the whole chunk's
    K/V into the pool first).

    ``q`` [B, W, h, dh]; pools / table as :func:`paged_decode_attention`;
    ``pos0`` [B] int32.  Returns [B, W, h, dh].  CPU tensors take the
    plain version; CUDA tensors launch the kernel (float32 or bfloat16,
    any dh up to 256, any W).  ``split_rows`` as in
    :func:`paged_decode_attention`."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    _check("paged_verify_attention", "[B, W, h, dh]", q, k_pool, v_pool,
           block_table, pos0)
    if q.device.type == "cpu":
        _ROUTE_REFERENCE.inc()
        return paged_verify_attention_reference(q, k_pool, v_pool,
                                                block_table, pos0,
                                                float(scale))
    if q.device.type != "cuda":
        raise ValueError(f"paged_verify_attention: unsupported device "
                         f"{q.device}")
    out = _launch_verify(q, k_pool, v_pool, block_table, pos0, float(scale),
                         split_rows)
    paged_verify_attention.launches += 1
    _ROUTE_KERNEL.inc()
    return out


#: CUDA kernel launches since the last reset (set it to 0 to start a count)
paged_verify_attention.launches = 0
