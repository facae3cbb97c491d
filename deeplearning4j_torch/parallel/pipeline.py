"""Pipeline parallelism — GPipe microbatching over a pipe mesh axis (port
of ``deeplearning4j_tpu/parallel/pipeline.py``).

The reference expresses the stages as SPMD under ``shard_map``: one
program on every device, the stage's parameter slice from a pipe-sharded
leading axis, activations rotated with ``lax.ppermute`` inside a
``lax.scan``, the backward by autodiff through the schedule.  The port
runs the same GPipe schedule eagerly: the batch splits into
``n_micro`` microbatches, tick ``t`` runs stage ``s`` on microbatch
``t - s``, each stage's blocks sit on that stage's device, and the
stage-to-stage hand-off is a device copy.  The backward is autograd
through the schedule (the copies are differentiable), so the GPipe
backward falls out as in the reference.  Values equal sequential block
application; the bubble fraction is (S-1)/(S-1+n_micro).

When the pipe axis crosses processes (a mesh over
``distributed.global_devices()``), each process runs its own stage
(:func:`gpipe_stage`): stage 0 splits the batch, every stage hands each
microbatch's activations to the next stage's process as soon as they
are ready (``send``/``recv``, staged through the host under gloo), and
the backward runs from the last stage down, each stage sending its
inputs' gradients back (``parallel.trainer``).  The reference's
``lax.ppermute`` carries the same hand-offs.

Scope as in the reference: homogeneous stacks (N identical blocks);
N must divide by the stage count.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from deeplearning4j_torch import telemetry
from deeplearning4j_torch.parallel.mesh import Mesh
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves

# one series answers "how much of the schedule is bubble" whichever
# trainer built the schedule — ShardedTrainer's pipelined path imports
# this family
_PIPE_BUBBLE = telemetry.gauge(
    "pipeline_bubble_fraction",
    "(S-1)/(S-1+n_micro) idle fraction of the GPipe schedule")
_PIPE_STEPS = telemetry.counter(
    "pipeline_steps_total", "PipelinedTransformerLM optimizer steps",
    labelnames=("worker",))


class ShardMapPartialAutoError(NotImplementedError):
    """The reference raises this when a mesh needs partial-auto
    ``shard_map`` on a jax release without top-level ``jax.shard_map``.
    The port has no compiler partitioning, so tensor parallelism inside
    pipeline stages always composes and this is never raised; the type
    stays for callers that catch it.  Carries ``auto_axes``."""

    def __init__(self, auto_axes):
        self.auto_axes = tuple(sorted(auto_axes))
        super().__init__(
            f"axes {list(self.auto_axes)} cannot stay auto-partitioned "
            "inside the manual pipeline region")


def _worker_index() -> int:
    dist = torch.distributed
    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def stack_block_params(block_conf, n_blocks: int, key: int,
                       dtype=torch.float32, device="cuda"):
    """Init ``n_blocks`` independent parameter sets (one generator seeded
    with ``key``, drawn block after block) and stack each leaf on a
    leading axis — the layout the pipe axis splits."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(int(key))
    trees = [block_conf.init(gen, dtype, dev) for _ in range(n_blocks)]
    return map_leaves(lambda *ls: torch.stack(ls), *trees)


def pipe_axis_name(mesh: Mesh) -> str:
    """Canonical pipe-axis lookup: 'pipe' or MeshConfig's 'pipeline'."""
    for name in ("pipe", "pipeline"):
        if name in mesh.shape:
            return name
    raise ValueError(f"mesh {mesh.shape} has no pipe/pipeline axis")


def gpipe_schedule(stage_fns: Sequence[Callable], stage_devices,
                   x: torch.Tensor, n_micro: int) -> torch.Tensor:
    """The GPipe schedule over one data shard: ``x`` [B, ...] in
    ``n_micro`` microbatches, tick ``t`` running stage ``s`` on
    microbatch ``t - s``; returns [B, ...] on the last stage's device."""
    B = x.shape[0]
    micro = list(torch.split(x, B // n_micro))
    S = len(stage_fns)
    for t in range(S + n_micro - 1):
        for s in range(S):
            m = t - s
            if 0 <= m < n_micro:
                micro[m] = stage_fns[s](micro[m].to(stage_devices[s]))
    return torch.cat(micro, 0)


def gpipe_stage(stage_fn: Callable, group, x: Optional[torch.Tensor],
                n_micro: int, device):
    """This process's stage of the GPipe schedule across processes:
    ``group`` is the pipeline ``AxisGroup`` (its ``index`` the stage).
    Stage 0 splits ``x`` [B, ...] into ``n_micro`` microbatches; every
    later stage receives them from the previous stage's process (leaves
    that require grad).  Each microbatch's output goes on to the next
    stage as soon as it is computed.  Returns ``(inputs, outputs)``: the
    received activations ([] on stage 0) and this stage's outputs, one
    per microbatch."""
    s, S = group.index, group.size
    micro = list(torch.split(x, x.shape[0] // n_micro)) if s == 0 else None
    ins, outs = [], []
    for m in range(n_micro):
        if s == 0:
            h = micro[m]
        else:
            h = group.recv(s - 1, device).requires_grad_(True)
            ins.append(h)
        y = stage_fn(h)
        if s < S - 1:
            group.send(y.detach(), s + 1)
        outs.append(y)
    return ins, outs


def check_pipeline(n_blocks: int, S: int, B: int, n_micro: int,
                   d_sz: int = 1) -> None:
    """The reference's divisibility errors, by message."""
    if n_blocks % S:
        raise ValueError(f"{n_blocks} blocks do not divide over "
                         f"{S} pipeline stages")
    if B % (n_micro * d_sz):
        raise ValueError(f"batch {B} must divide into {n_micro} "
                         f"microbatches x {d_sz} data shards")


def gpipe_apply(mesh: Mesh, stacked_params, x, block_apply: Callable,
                n_micro: int, axis: Optional[str] = None,
                data_axis: Optional[str] = None):
    """Run x [B, ...] through the stacked blocks with a GPipe schedule.

    ``block_apply(params_one_block, activations) -> activations`` is the
    per-block forward; stage ``s`` owns blocks ``[s*N/S, (s+1)*N/S)`` on
    the pipe axis's device ``s``.  ``n_micro`` must divide the per-data-
    shard batch.  With ``data_axis`` every data shard runs its own
    pipeline on its rows.  Returns [B, ...] on x's device, equal to
    applying the blocks in sequence."""
    axis = axis or pipe_axis_name(mesh)
    S = mesh.shape[axis]
    B = x.shape[0]
    d_sz = mesh.shape[data_axis] if data_axis else 1
    n_blocks = next(iter_leaves(stacked_params))[1].shape[0]
    check_pipeline(n_blocks, S, B, n_micro, d_sz)
    per = n_blocks // S
    outs = []
    for r, xr in enumerate(torch.split(x, B // d_sz)):
        coords = {data_axis: r} if data_axis else {}
        devs = [mesh.device(**{axis: s}, **coords) for s in range(S)]

        def stage(s, h, devs=devs):
            for j in range(s * per, (s + 1) * per):
                p = map_leaves(lambda leaf, j=j: leaf[j].to(devs[s]),
                               stacked_params)
                h = block_apply(p, h)
            return h

        fns = [lambda h, s=s: stage(s, h) for s in range(S)]
        outs.append(gpipe_schedule(fns, devs, xr, n_micro).to(x.device))
    return torch.cat(outs, 0)


class PipelinedTransformerLM:
    """Embedding + N pipelined ``TransformerEncoderBlock``s + a mean-pool
    head, trained through ``fit_batch``.  Composes DP x PP when the mesh
    carries a 'data' axis (each data shard runs its own pipeline, the
    gradients of the shards add up through autograd)."""

    @classmethod
    def from_mesh_config(cls, mesh_conf, devices=None, **kw):
        """Build from a ``MeshConfig(data=..., pipeline=...)``."""
        return cls(mesh=mesh_conf.build(devices), **kw)

    def __init__(self, vocab_size: int, d_model: int, n_blocks: int,
                 n_heads: int, d_ff: int, seq_len: int, n_classes: int,
                 mesh: Mesh, n_micro: int = 4, lr: float = 1e-3,
                 seed: int = 0):
        from deeplearning4j_torch.nn.conf.layers_transformer import (
            EmbeddingSequenceLayer, TransformerEncoderBlock)
        from deeplearning4j_torch.optimize.updaters import Adam

        self.mesh, self.n_micro = mesh, n_micro
        self._pipe_axis = pipe_axis_name(mesh)
        self._data_axis = ("data" if mesh.shape.get("data", 1) > 1
                           else None)
        self.device = mesh.device()
        self.block_conf = TransformerEncoderBlock(
            n_heads=n_heads, d_ff=d_ff, use_flash=False)
        self.block_conf.infer_shapes((seq_len, d_model))
        emb = EmbeddingSequenceLayer(n_in=vocab_size, n_out=d_model,
                                     max_len=seq_len)
        emb.infer_shapes((seq_len,))
        self.emb_conf = emb
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        emb_params = emb.init(gen, torch.float32, dev)
        blocks = stack_block_params(self.block_conf, n_blocks,
                                    int(seed) + 1, device=dev)
        head_w = 0.02 * torch.randn((d_model, n_classes), generator=gen,
                                    device=dev)
        self.params = {"emb": emb_params, "blocks": blocks,
                       "head": {"W": head_w,
                                "b": torch.zeros((n_classes,),
                                                 device=dev)}}
        self._updater = Adam(learning_rate=lr)
        self.opt_state = self._updater.init_state(self.params)
        self._it = 0
        S = mesh.shape[self._pipe_axis]
        _PIPE_BUBBLE.set((S - 1) / (S - 1 + n_micro))
        self._step_counter = _PIPE_STEPS.labels(worker=_worker_index())

    def _forward(self, params, ids):
        h = self.emb_conf.apply(params["emb"], ids, training=False)
        blk = self.block_conf
        h = gpipe_apply(self.mesh, params["blocks"], h,
                        lambda p, a: blk.apply(p, a, training=False),
                        self.n_micro, axis=self._pipe_axis,
                        data_axis=self._data_axis)
        pooled = torch.mean(h, dim=1)
        return pooled @ params["head"]["W"] + params["head"]["b"]

    def _tensor(self, a):
        t = torch.as_tensor(np.asarray(a), device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    def fit_batch(self, ids, labels) -> float:
        ids, labels = self._tensor(ids), self._tensor(labels)
        with telemetry.span("train/pipeline_step", iteration=self._it):
            paths = [p for p, _ in iter_leaves(self.params)]
            leaves = [l.detach().requires_grad_(True)
                      for _, l in iter_leaves(self.params)]
            live: dict = {}
            for path, leaf in zip(paths, leaves):
                node = live
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = leaf
            with torch.enable_grad():
                logits = self._forward(live, ids)
                lp = torch.log_softmax(logits, -1)
                loss = -torch.mean(torch.sum(labels * lp, -1))
                grads = torch.autograd.grad(loss, leaves)
            gtree: dict = {}
            for path, g in zip(paths, grads):
                node = gtree
                for k in path[:-1]:
                    node = node.setdefault(k, {})
                node[path[-1]] = g
            with torch.no_grad():
                updates, self.opt_state = self._updater.update(
                    gtree, self.opt_state, self.params, self._it)
                for (_, p), (_, u) in zip(iter_leaves(self.params),
                                          iter_leaves(updates)):
                    p.sub_(u)
                self.opt_state = self._updater.finalize(self.opt_state,
                                                        self.params)
            loss = float(loss.detach())
        self._it += 1
        self._step_counter.inc()
        return loss

    @torch.no_grad()
    def predict(self, ids) -> np.ndarray:
        return self._forward(self.params,
                             self._tensor(ids)).float().cpu().numpy()

