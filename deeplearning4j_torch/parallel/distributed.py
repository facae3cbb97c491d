"""Multi-process runtime (port of
``deeplearning4j_tpu/parallel/distributed.py``).

The reference joins a ``jax.distributed`` job and builds ONE global mesh
over every host's devices; GSPMD places the gradient all-reduce.  The
port joins a ``torch.distributed`` process group (gloo for CPU tensors,
NCCL on the card) and keeps a mesh per process over its own devices:
only the ``data`` axis and the control reductions cross a process
boundary.

* :func:`initialize` — ``init_process_group`` with an explicit address,
  world size and rank (idempotent; loud on any other failure);
* :func:`global_mesh` / :func:`host_local_batch_to_global` — this
  process's ``("data", "model")`` mesh and its shards of the global
  batch (every process feeds the identical global batch and keeps its
  rows);
* :func:`or_reduce_flag` / :func:`min_reduce` / :func:`sum_reduce` — the
  fleet's control reductions: every device of the caller's mesh
  contributes the process's value, so ``sum_reduce(1)`` is the device
  total of the job;
* :func:`all_reduce_sum_tensors` — the gradient all-reduce after the
  trainer's local shard sum (one bucket per device and dtype).

A mesh axis other than ``data`` cannot span processes here: a
configuration that needs it raises :class:`CrossProcessAxisError`.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_torch.parallel.mesh import (Mesh, P, _device_array,
                                                default_devices)

log = logging.getLogger("deeplearning4j_torch")


class CrossProcessAxisError(NotImplementedError):
    """A mesh whose ``model``, ``pipeline`` or ``sequence`` axis would span
    processes: only the ``data`` axis crosses a process boundary in the
    port (ROADMAP Queue 1 carries the rest)."""


def group_live() -> bool:
    """True once this process has joined a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids: Optional[Sequence[int]] = None,
               backend: Optional[str] = None):
    """Join the multi-process job (idempotent).  ``coordinator_address``
    is ``host:port`` or an init URL (``tcp://localhost:29500``); with it,
    ``num_processes`` and ``process_id`` are required.  ``backend``
    defaults to NCCL when this process uses a CUDA device, else gloo.
    Without an address, a job started by a launcher (``WORLD_SIZE`` /
    ``RANK`` / ``MASTER_ADDR`` in the environment) joins through it, and
    a lone process stays single-process."""
    if group_live():
        return
    if local_device_ids:
        torch.cuda.set_device(int(local_device_ids[0]))
    if backend is None:
        backend = ("nccl" if torch.cuda.is_available()
                   and torch.cuda.device_count() > 0 else "gloo")
    if coordinator_address is None:
        if "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            dist.init_process_group(backend, init_method="env://")
            return
        log.info("single-process run: torch.distributed not initialized")
        return
    if num_processes is None or process_id is None:
        raise ValueError("initialize with an address needs num_processes "
                         "and process_id")
    url = (coordinator_address if "://" in coordinator_address
           else f"tcp://{coordinator_address}")
    # a multi-process job that silently degrades to one process trains
    # on 1/N of the data: every failure here propagates
    dist.init_process_group(backend, init_method=url,
                            world_size=int(num_processes),
                            rank=int(process_id))


def shutdown():
    """Leave the process group (a no-op when none)."""
    if group_live():
        dist.destroy_process_group()


def process_count() -> int:
    return dist.get_world_size() if group_live() else 1


def process_index() -> int:
    return dist.get_rank() if group_live() else 0


def global_mesh(data: Optional[int] = None, model: int = 1,
                devices=None) -> Mesh:
    """This process's ``("data", "model")`` mesh of a job whose GLOBAL data
    axis is ``data`` (default: every device of every process over
    ``model``).  The data axis splits over the processes; the model axis
    stays inside one."""
    devs = list(devices) if devices is not None else default_devices()
    n, procs = len(devs), process_count()
    if model > n:
        raise CrossProcessAxisError(
            f"model={model} needs more than this process's {n} devices: "
            "only the data axis crosses processes (ROADMAP Queue 1)")
    if data is None:
        data = (n // model) * procs
    if data % procs or (data // procs) * model != n:
        raise ValueError(f"mesh {data}x{model} over {procs} process(es) "
                         f"!= {n} devices per process")
    return Mesh(_device_array(devs, (data // procs, model)),
                ("data", "model"))


def host_local_batch_to_global(mesh: Mesh, local_batch,
                               spec: P = P("data")) -> List[torch.Tensor]:
    """THIS process's data shards of the global batch: ``local_batch`` is
    the process's 1/num_processes of the rows, split over the mesh's
    data axis, one tensor per data shard on its device."""
    t = torch.as_tensor(np.asarray(local_batch))
    axis = list(spec).index("data") if "data" in tuple(spec) else None
    d = mesh.axis_size("data")
    if axis is None:
        return [t.to(mesh.device(data=r)).clone() for r in range(d)]
    if t.shape[axis] % d:
        raise ValueError(f"{t.shape[axis]} rows do not divide over "
                         f"data={d}")
    return [p.to(mesh.device(data=r)).clone()
            for r, p in enumerate(torch.chunk(t, d, dim=axis))]


# -- in-band control reductions ---------------------------------------------
# Collective: every process must call with the same mesh at the same
# point.  One lock keeps two threads of a process (a trainer and a
# watchdog) from interleaving their collectives.
_CONTROL_LOCK = threading.Lock()


def _collective_device() -> torch.device:
    if group_live() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _reduce_scalar(op: str, value: int, mesh: Optional[Mesh]) -> int:
    mine = mesh.size if mesh is not None else 1
    local = int(value) * mine if op == "sum" else int(value)
    if not group_live():
        return local
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    with _CONTROL_LOCK:
        t = torch.tensor([local], dtype=torch.int64,
                         device=_collective_device())
        dist.all_reduce(t, op=red)
        return int(t.item())


def or_reduce_flag(flag: bool, mesh: Optional[Mesh] = None) -> bool:
    """Fleet-wide OR of a per-process flag — the in-band preemption
    broadcast: any process's SIGTERM is visible to every process at the
    same step boundary."""
    return bool(_reduce_scalar("max", 1 if flag else 0, mesh))


def min_reduce(value: int, mesh: Optional[Mesh] = None) -> int:
    """Fleet-wide minimum — the newest-common-checkpoint agreement."""
    return int(_reduce_scalar("min", value, mesh))


def sum_reduce(value: int, mesh: Optional[Mesh] = None) -> int:
    """Fleet-wide sum, one contribution per mesh device — the rendezvous
    barrier: it completes only when every process dispatched it."""
    return int(_reduce_scalar("sum", value, mesh))


def all_reduce_sum_tensors(tensors: List[torch.Tensor]
                           ) -> List[torch.Tensor]:
    """Sum ``tensors`` over the processes (the data-parallel gradient
    all-reduce), one flat bucket per (device, dtype); identity in a
    single-process run."""
    if not group_live():
        return list(tensors)
    coll = _collective_device()
    groups = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.device, t.dtype), []).append(i)
    out = list(tensors)
    with _CONTROL_LOCK:
        for (device, _), idx in groups.items():
            flat = torch.cat([tensors[i].reshape(-1) for i in idx])
            flat = flat.to(coll)
            dist.all_reduce(flat, op=dist.ReduceOp.SUM)
            flat = flat.to(device)
            off = 0
            for i in idx:
                n = tensors[i].numel()
                out[i] = flat[off:off + n].view_as(tensors[i])
                off += n
    return out
