"""Ring attention: sequence (context) parallelism over a mesh (port of
``deeplearning4j_tpu/parallel/ring_attention.py``).

Exact attention over a sequence split across devices: each device holds
one block of Q and one block of K/V; the K/V blocks rotate around the
ring while a flash-style running softmax (running max, denominator,
weighted accumulator) folds each incoming block in — memory per device is
O(t_local²) per step instead of O(t²).  The reference rotates with
``lax.ppermute`` inside ``shard_map``; the port keeps one block per
shard on its device and rotates by device copies, every op plain torch
(the reference computes this in ``jnp``, not in a Pallas kernel), so
autograd carries the gradients through the rotation and the same
function serves training.

``ring_attention(q_blocks, k_blocks, v_blocks, masks)`` is the per-ring
function over lists of per-shard blocks; ``ring_self_attention(mesh, q,
k, v, mask)`` splits [b, h, t, d] tensors over the mesh's 'sequence'
axis (and the batch over 'data' when the mesh has one), runs the ring
and returns the full output on q's device.

When the 'sequence' axis crosses processes (a mesh over
``distributed.global_devices()``), each process keeps its Q block and
passes its K/V block to the next process of the ring through
:class:`_Rotate`, whose backward passes the gradients the other way —
``lax.ppermute`` under ``shard_map`` in the reference.  Every process
gives the full q/k/v and gets the full output; the inputs' gradients are
summed over the ring (Megatron's ``f``), so each process holds them
whole.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from deeplearning4j_torch.parallel.mesh import Mesh, gather_blocks, to_group


def _block_attend(q, k, v, mask_k, m, l, o):
    """Fold one K/V block into the running softmax state.

    q [b, h, tq, d]; k/v [b, h, tk, d]; mask_k [b, tk] or None;
    m, l [b, h, tq]; o [b, h, tq, d]."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / (q.shape[-1] ** 0.5)
    if mask_k is not None:
        s = torch.where(mask_k[:, None, None, :] > 0, s,
                        torch.full((), -1e30, dtype=s.dtype,
                                   device=s.device))
    m_new = torch.maximum(m, s.amax(-1))
    scale = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * scale + p.sum(-1)
    o_new = o * scale[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def ring_attention(q_blocks: Sequence[torch.Tensor],
                   k_blocks: Sequence[torch.Tensor],
                   v_blocks: Sequence[torch.Tensor],
                   masks: Optional[Sequence[torch.Tensor]] = None
                   ) -> List[torch.Tensor]:
    """Exact attention of every query block over every key block of the
    ring.  Block i ([b, h, t_i, d], ``masks[i]`` [b, t_i] keyed to its
    keys) lives on its own device; n steps, each folding the K/V block
    the shard holds, then passing it to the next shard.  Returns the
    output blocks, one per shard on its device."""
    n = len(q_blocks)
    devs = [q.device for q in q_blocks]
    state = []
    for q in q_blocks:
        m0 = torch.full(q.shape[:-1], float("-inf"), dtype=q.dtype,
                        device=q.device)
        state.append((m0, torch.zeros_like(m0), torch.zeros_like(q)))
    ks, vs = list(k_blocks), list(v_blocks)
    ms = list(masks) if masks is not None else [None] * n
    for _ in range(n):
        state = [_block_attend(q_blocks[i], ks[i], vs[i], ms[i], *state[i])
                 for i in range(n)]
        # rotate: shard i's block moves to shard i + 1
        ks = [ks[(i - 1) % n].to(devs[i]) for i in range(n)]
        vs = [vs[(i - 1) % n].to(devs[i]) for i in range(n)]
        if masks is not None:
            ms = [ms[(i - 1) % n].to(devs[i]) for i in range(n)]
    return [o / torch.clamp(l, min=1e-30)[..., None] for _, l, o in state]


class _Rotate(torch.autograd.Function):
    """One ring step: this process's block goes to the next process and
    the previous one's arrives; the backward sends the gradient back."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return group.rotate(t, 1)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.rotate(g.contiguous(), -1), None


def ring_attention_blocks(group, q, k, v, mask=None) -> torch.Tensor:
    """The ring over processes: ``q``/``k``/``v`` [b, h, t_i, d] and
    ``mask`` [b, t_i] are this process's blocks (coordinate
    ``group.index`` of the sequence); ``group.size`` steps fold the K/V
    block held, passing it on between steps.  Returns this process's
    output block."""
    n = group.size
    m0 = torch.full(q.shape[:-1], float("-inf"), dtype=q.dtype,
                    device=q.device)
    state = (m0, torch.zeros_like(m0), torch.zeros_like(q))
    for step in range(n):
        state = _block_attend(q, k, v, mask, *state)
        if step < n - 1:
            k, v = _Rotate.apply(k, group), _Rotate.apply(v, group)
            if mask is not None:
                mask = group.rotate(mask, 1)
    _, l, o = state
    return o / torch.clamp(l, min=1e-30)[..., None]


def _ring_across_processes(mesh, group, q, k, v, mask):
    from deeplearning4j_torch.parallel import distributed
    if distributed.mesh_groups(mesh).get("data") is not None:
        raise ValueError("ring_self_attention over processes keeps the "
                         "data axis inside each process")
    n_data = mesh.shape.get("data", 1)
    q, k, v = (to_group(x, group) for x in (q, k, v))
    c = group.index
    outs = []
    for r in range(n_data):
        rows = slice(r * q.shape[0] // n_data,
                     (r + 1) * q.shape[0] // n_data)
        dev = mesh.device(data=r, sequence=c)

        def block(x):
            return torch.chunk(x[rows], group.size, dim=2)[c].to(dev)
        mblk = None if mask is None else torch.chunk(
            mask[rows].to(q.dtype), group.size, dim=1)[c].to(dev)
        o = ring_attention_blocks(group, block(q), block(k), block(v),
                                  mblk)
        outs.append(gather_blocks(o, group, 2).to(q.device))
    return torch.cat(outs, dim=0)


def ring_self_attention(mesh: Mesh, q, k, v,
                        mask: Optional[torch.Tensor] = None):
    """q/k/v [b, h, t, d] split over the mesh's 'sequence' axis on t (and
    'data' on b when the mesh has one); returns [b, h, t, d] on q's
    device.  With a sequence axis across processes (collective: every
    process of the ring calls it with the same full q/k/v), each process
    runs its block of the ring."""
    if "sequence" not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no 'sequence' axis")
    n_seq = mesh.shape["sequence"]
    n_data = mesh.shape.get("data", 1)
    if q.shape[2] % n_seq or q.shape[0] % n_data:
        raise ValueError(f"[b={q.shape[0]}, t={q.shape[2]}] does not "
                         f"divide over data={n_data} x sequence={n_seq}")
    if mesh.spans_processes:
        from deeplearning4j_torch.parallel import distributed
        group = distributed.mesh_groups(mesh).get("sequence")
        if group is not None:
            return _ring_across_processes(mesh, group, q, k, v, mask)
    outs = []
    for r in range(n_data):
        rows = slice(r * q.shape[0] // n_data,
                     (r + 1) * q.shape[0] // n_data)
        devs = [mesh.device(data=r, sequence=s) for s in range(n_seq)]

        def blocks(x):
            return [c.to(d) for c, d in
                    zip(torch.chunk(x[rows], n_seq, dim=2), devs)]
        masks = None
        if mask is not None:
            masks = [c.to(d) for c, d in
                     zip(torch.chunk(mask[rows].to(q.dtype), n_seq, dim=1),
                         devs)]
        out = ring_attention(blocks(q), blocks(k), blocks(v), masks)
        outs.append(torch.cat([o.to(q.device) for o in out], dim=2))
    return torch.cat(outs, dim=0)


def full_attention_reference(q, k, v, mask=None):
    """Single-device reference (for tests and the chip check)."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / (q.shape[-1] ** 0.5)
    if mask is not None:
        s = torch.where(mask[:, None, None, :] > 0, s,
                        torch.full((), -1e30, dtype=s.dtype,
                                   device=s.device))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)
