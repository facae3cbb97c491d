"""Multi-process runtime (port of
``deeplearning4j_tpu/parallel/distributed.py``).

The reference joins a ``jax.distributed`` job and builds ONE global mesh
over every host's devices; GSPMD places the collectives.  The port joins
a ``torch.distributed`` process group (gloo for CPU tensors, NCCL on the
card) and builds the same global mesh: every coordinate knows the
process that owns it, each process holds its own coordinates' devices,
and any axis may cross a process boundary.  The collectives along an
axis run in an :class:`AxisGroup`, one process group per row or column
of the axis (made identically on every rank by :func:`mesh_groups`).

* :func:`initialize` — ``init_process_group`` with an explicit address,
  world size and rank (idempotent; loud on any other failure);
* :func:`global_devices` / :func:`global_mesh` /
  :func:`host_local_batch_to_global` — every process's devices as one
  list, the ``("data", "model")`` mesh over them, and this process's
  shards of the global batch;
* :class:`AxisGroup` — gather, ordered sum, broadcast and ring rotation
  along one axis (all-gather + a sum in coordinate order: the
  single-process shard order, so every rank and the one-process mesh
  add alike) and the pipeline's point-to-point hand-off;
* :func:`or_reduce_flag` / :func:`min_reduce` / :func:`sum_reduce` — the
  fleet's control reductions: every device of the caller's mesh that
  this process holds contributes the process's value, so
  ``sum_reduce(1)`` is the device total of the job;
* :func:`all_reduce_sum_tensors` — the gradient all-reduce after the
  trainer's local shard sum on a mesh of one process's devices (one
  bucket per device and dtype).

Gloo moves CPU tensors: a gloo collective on CUDA tensors stages them
through host memory (:func:`_collective_device`).  That is how several
processes share one card, where NCCL refuses two ranks on one device.
"""
from __future__ import annotations

import logging
import os
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from deeplearning4j_torch.parallel.mesh import (Mesh, P, ProcessDevice,
                                                _device_array,
                                                _owner_array,
                                                default_devices)

log = logging.getLogger("deeplearning4j_torch")


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


def global_devices(local=None) -> List[ProcessDevice]:
    """Every device of every process, process-major: ``local`` (default
    this process's CUDA devices) is this process's, and every process
    must list as many.  In one process, its own devices."""
    local = list(local) if local is not None else default_devices()
    procs, me = process_count(), process_index()
    if procs > 1 and (min_reduce(len(local)) != len(local) or
                      -min_reduce(-len(local)) != len(local)):
        raise ValueError("every process must list as many local devices")
    return [ProcessDevice(p, torch.device(local[i]) if p == me else None)
            for p in range(procs) for i in range(len(local))]


def global_mesh(data: Optional[int] = None, model: int = 1,
                devices=None) -> Mesh:
    """A ``("data", "model")`` mesh over ALL processes' devices (the
    reference's global mesh).  ``devices``: a global list
    (:func:`global_devices`), or this process's devices (each process
    passes its own; default its CUDA devices).  Row-major over the
    process-major list, so the model axis stays inside a process when
    it fits there and crosses processes when it does not."""
    devs = list(devices) if devices is not None else default_devices()
    if not any(isinstance(d, ProcessDevice) for d in devs):
        devs = global_devices(devs)
    n = len(devs)
    if data is None:
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    shape = (data, model)
    return Mesh(_device_array(devs, shape), ("data", "model"),
                _owner_array(devs, shape))


def _local_device(mesh: Mesh, **coords) -> torch.device:
    """A device this process holds at the given coordinates (the first
    along every axis not given)."""
    idx = tuple(coords[n] if n in coords else mesh.local_coords(n)[0]
                for n in mesh.axis_names)
    return mesh.devices[idx]


def host_local_batch_to_global(mesh: Mesh, local_batch,
                               spec: P = P("data")) -> List[torch.Tensor]:
    """THIS process's data shards of the global batch: ``local_batch`` is
    the rows of the data coordinates this process holds (every process
    along another axis feeds the same rows), split over them, one tensor
    per data coordinate on its device."""
    t = torch.as_tensor(np.asarray(local_batch))
    axis = list(spec).index("data") if "data" in tuple(spec) else None
    rows = mesh.local_coords("data")
    d = len(rows)
    if axis is None:
        return [t.to(_local_device(mesh, data=r)).clone() for r in rows]
    if t.shape[axis] % d:
        raise ValueError(f"{t.shape[axis]} rows do not divide over "
                         f"data={d}")
    return [p.to(_local_device(mesh, data=r)).clone()
            for r, p in zip(rows, torch.chunk(t, d, dim=axis))]


# -- collectives along one mesh axis -----------------------------------------
_DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.float64,
           torch.int32, torch.int64, torch.int16, torch.int8, torch.uint8,
           torch.bool]


_HALF = (torch.bfloat16, torch.float16)


def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` as gloo/NCCL move it: contiguous, on the collective device,
    a 2-byte float as its raw bytes (pure data movement; gloo lacks some
    16-bit types)."""
    t = t.detach().contiguous()
    if t.dtype in _HALF:
        t = t.reshape(-1).view(torch.uint8)
    return t.to(_collective_device())


def _unwire(t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    if dtype in _HALF:
        t = t.view(dtype).reshape(shape)
    return t.to(device)


class AxisGroup:
    """The processes along one mesh axis through this process's
    coordinate: ``ranks[c]`` owns coordinate ``c``, this process is
    ``index``.  Collective: every process of the group calls each method
    at the same point."""

    def __init__(self, axis: str, ranks: Sequence[int], pg):
        self.axis = axis
        self.ranks = [int(r) for r in ranks]
        self.pg = pg
        self.size = len(self.ranks)
        self.index = self.ranks.index(process_index())
        # all_gather returns the group's ranks in ascending order
        order = sorted(self.ranks)
        self._slot = [order.index(r) for r in self.ranks]

    def __repr__(self):
        return f"AxisGroup({self.axis!r}, ranks={self.ranks})"

    def gather(self, t: torch.Tensor) -> List[torch.Tensor]:
        """Every coordinate's ``t`` (one shape), in coordinate order, on
        ``t``'s device."""
        x = _wire(t)
        bufs = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(bufs, x, group=self.pg)
        return [_unwire(bufs[s], t.dtype, t.shape, t.device)
                for s in self._slot]

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over the coordinates in coordinate order — the same
        additions, in the same order, on every process."""
        parts = self.gather(t)
        acc = parts[0]
        for p in parts[1:]:
            acc = acc + p
        return acc

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Coordinate ``src``'s ``t`` on every process (``t`` gives the
        shape and dtype elsewhere)."""
        x = _wire(t)
        dist.broadcast(x, src=self.ranks[src], group=self.pg)
        return _unwire(x, t.dtype, t.shape, t.device)

    def rotate(self, t: torch.Tensor, shift: int = 1) -> torch.Tensor:
        """Send ``t`` to coordinate ``index + shift`` and return what
        coordinate ``index - shift`` sent (a ring step; one shape)."""
        if self.size == 1:
            return t
        x = _wire(t)
        buf = torch.empty_like(x)
        dst = self.ranks[(self.index + shift) % self.size]
        src = self.ranks[(self.index - shift) % self.size]
        req = dist.isend(x, dst=dst)
        dist.recv(buf, src=src)
        req.wait()
        return _unwire(buf, t.dtype, t.shape, t.device)

    def send(self, t: torch.Tensor, to: int) -> None:
        """``t`` (any shape) to coordinate ``to``: a header (dtype,
        rank, shape), then the data."""
        if t.ndim > 8:
            raise ValueError("send carries at most 8 dimensions")
        dst = self.ranks[to]
        head = torch.zeros(10, dtype=torch.int64)
        head[0], head[1] = _DTYPES.index(t.dtype), t.ndim
        head[2:2 + t.ndim] = torch.tensor(t.shape, dtype=torch.int64)
        dist.send(head.to(_collective_device()), dst=dst)
        dist.send(_wire(t), dst=dst)

    def recv(self, frm: int, device) -> torch.Tensor:
        """The tensor coordinate ``frm`` sends, on ``device``."""
        src = self.ranks[frm]
        coll = _collective_device()
        head = torch.zeros(10, dtype=torch.int64, device=coll)
        dist.recv(head, src=src)
        head = head.cpu()
        dtype = _DTYPES[int(head[0])]
        shape = [int(v) for v in head[2:2 + int(head[1])]]
        n = 1
        for d in shape:
            n *= d
        buf = (torch.empty(2 * n, dtype=torch.uint8, device=coll)
               if dtype in _HALF else
               torch.empty(shape, dtype=dtype, device=coll))
        dist.recv(buf, src=src)
        return _unwire(buf, dtype, shape, device)


_GROUPS: Dict[tuple, Dict[str, Optional[AxisGroup]]] = {}


def _runs(line) -> Optional[tuple]:
    """The processes along one row or column of an axis, in coordinate
    order (a process holding several neighbouring coordinates counts
    once); None when the coordinates of a process are not neighbours."""
    ranks = []
    for r in (int(v) for v in line):
        if not ranks or ranks[-1] != r:
            if r in ranks:
                return None
            ranks.append(r)
    return tuple(ranks)


def mesh_groups(mesh: Mesh) -> Dict[str, Optional[AxisGroup]]:
    """One :class:`AxisGroup` per axis of ``mesh`` that crosses processes
    through this process's coordinates (None for an axis it holds whole),
    and under ``"*"`` the group of every process of the mesh.  Every
    process group of every row and column of such an axis is made here,
    in one order on every rank (``dist.new_group`` is collective over
    the job): call it on every rank with the same mesh.  Cached per mesh
    layout."""
    if not mesh.spans_processes:
        return {n: None for n in mesh.axis_names}
    key = (mesh.axis_names, mesh.owners.shape, mesh.owners.tobytes())
    if key in _GROUPS:
        return _GROUPS[key]
    me = process_index()
    out: Dict[str, Optional[AxisGroup]] = {}
    made: Dict[tuple, object] = {}

    def group(name, ranks):
        if ranks not in made:
            made[ranks] = dist.new_group(sorted(ranks))
        return AxisGroup(name, ranks, made[ranks]) if me in ranks else None

    for ax, name in enumerate(mesh.axis_names):
        lines = np.moveaxis(mesh.owners, ax, -1).reshape(
            -1, mesh.owners.shape[ax])
        out[name] = None
        for line in lines:
            ranks = _runs(line)
            if ranks is None:
                raise ValueError(
                    f"axis {name!r} visits a process twice "
                    f"({line.tolist()}): a process holds neighbouring "
                    "coordinates of an axis")
            if len(ranks) > 1:
                g = group(name, ranks)
                out[name] = g if g is not None else out[name]
    everyone = tuple(sorted(set(mesh.owners.reshape(-1).tolist())))
    out["*"] = group("*", everyone)
    _GROUPS[key] = out
    return out


# -- in-band control reductions ---------------------------------------------
# Collective: every process must call with the same mesh at the same
# point.  One lock keeps two threads of a process (a trainer and a
# watchdog) from interleaving their collectives.
_CONTROL_LOCK = threading.Lock()


def _collective_device() -> torch.device:
    if group_live() and dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _held(mesh: Optional[Mesh]) -> int:
    """The coordinates of ``mesh`` this process holds."""
    if mesh is None:
        return 1
    if mesh.owners is None:
        return mesh.size
    return sum(d is not None for d in mesh.devices.flat)


def _reduce_scalar(op: str, value: int, mesh: Optional[Mesh]) -> int:
    mine = _held(mesh)
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
