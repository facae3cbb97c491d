"""Device meshes (port of ``deeplearning4j_tpu/parallel/mesh.py``).

The reference builds a ``jax.sharding.Mesh`` and lets GSPMD place every
collective inside one jitted program.  The port keeps the vocabulary —
``MeshConfig(data=, model=, pipeline=, sequence=)``, ``serving_mesh``,
``TpShardCtx`` — over an explicit array of ``torch.device``s, and the
code that runs on it (``ShardedTrainer``, the sharded decode tick, ring
attention) places each shard's tensors on its device and does the
collectives itself: sums over ``data`` shards, concatenation of column
shards, sums of row-shard partial products, K/V rotation.

A device list may repeat a device (``[torch.device("cuda:0")] * 2``):
each shard still gets tensors of its own (``put``/``replicate`` clone,
never alias), so one card runs the sharded math with real gathers and
sums.  The reference's meshes are built over distinct devices; the
repeated device is the port's deliberate addition.

A mesh may span processes, as the reference's global mesh does: built
over ``distributed.global_devices()`` (one :class:`ProcessDevice` per
device of every process), each coordinate knows its owning process
(``owners``) and each process holds the ``torch.device`` of its own
coordinates only (None elsewhere).  A :class:`TpLeaf` whose model axis
crosses processes holds this process's shard alone and does its
collectives through an ``AxisGroup`` (Megatron's pairs below).

Serving (:func:`serving_mesh` + :class:`TpShardCtx`) carries ONE
replica's slice as a ``("data", "tp")`` mesh: the KV pool shards its
head axis along ``tp``, block weights their OUTPUT columns, and
:meth:`TpShardCtx.rep` gathers a column-sharded activation back to full
width before every reduction over the feature axis — no contraction is
ever split.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch


class PartitionSpec(tuple):
    """Where a tensor's axes lie on the mesh: one mesh-axis name (or None,
    replicated) per tensor axis — the reference's ``PartitionSpec``, kept
    as the placement record of the port's sharded trees."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


P = PartitionSpec


def default_devices() -> List[torch.device]:
    """Every CUDA device of this process; raises without one — a mesh on
    the CPU is asked for by passing ``devices=[torch.device("cpu")] * n``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError(
            "no CUDA device for the mesh; pass devices=[torch.device("
            "'cpu')] * n to run the plain PyTorch path")
    return [torch.device("cuda", i) for i in range(n)]


@dataclasses.dataclass(frozen=True)
class ProcessDevice:
    """One device of a multi-process job: the ``process`` that owns it
    and, in that process alone, its ``torch.device`` (None in every
    other process)."""
    process: int
    device: Optional[torch.device] = None


def _device_array(devices, shape) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        if isinstance(d, ProcessDevice):
            d = d.device
        arr[i] = None if d is None else torch.device(d)
    return arr.reshape(shape)


def _owner_array(devices, shape) -> Optional[np.ndarray]:
    """The owning process per coordinate of a global device list, or None
    for a list of this process's devices."""
    if not any(isinstance(d, ProcessDevice) for d in devices):
        return None
    if not all(isinstance(d, ProcessDevice) for d in devices):
        raise ValueError("a device list mixes ProcessDevice entries with "
                         "plain devices")
    return np.asarray([d.process for d in devices],
                      dtype=np.int64).reshape(shape)


class Mesh:
    """An array of ``torch.device``s with named axes (the reference's
    ``jax.sharding.Mesh``).  ``owners`` (same shape, int) gives the
    process of each coordinate when the mesh spans processes; a foreign
    coordinate's device is None."""

    def __init__(self, devices, axis_names: Sequence[str],
                 owners: Optional[np.ndarray] = None):
        devices = np.asarray(devices, dtype=object) \
            if isinstance(devices, np.ndarray) else devices
        if not isinstance(devices, np.ndarray):
            devices = _device_array(list(devices), (len(devices),))
        self.axis_names = tuple(axis_names)
        if devices.ndim != len(self.axis_names):
            raise ValueError(f"{devices.ndim}-d device array for axes "
                             f"{self.axis_names}")
        self.devices = devices
        self.owners = None if owners is None else \
            np.asarray(owners, dtype=np.int64).reshape(devices.shape)

    @property
    def spans_processes(self) -> bool:
        """True when more than one process owns a coordinate."""
        return self.owners is not None and \
            len(np.unique(self.owners)) > 1

    def local_coords(self, name: str) -> List[int]:
        """The coordinates along ``name`` that this process holds ([0]
        for an axis the mesh lacks)."""
        if name not in self.axis_names:
            return [0]
        ax = self.axis_names.index(name)
        held = np.vectorize(lambda d: d is not None, otypes=[bool])(
            self.devices)
        return [int(i) for i in np.nonzero(held.any(
            axis=tuple(a for a in range(held.ndim) if a != ax)))[0]]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def axis_size(self, name: str) -> int:
        """The extent of ``name``, 1 when the mesh has no such axis."""
        return self.shape.get(name, 1)

    def device(self, **coords) -> torch.device:
        """The device at the given axis coordinates (absent axes: 0)."""
        idx = tuple(int(coords.get(n, 0)) for n in self.axis_names)
        return self.devices[idx]

    def __repr__(self):
        owners = "" if self.owners is None else \
            f", owners={self.owners.reshape(-1).tolist()}"
        return (f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]}"
                f"{owners})")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh shape.  The product must not exceed the device count
    (remaining devices are left unused).  Axis names are canonical:
    'data' (DP), 'model' (TP), 'pipeline' (PP), 'sequence' (SP)."""

    data: int = 1
    model: int = 1
    pipeline: int = 1
    sequence: int = 1

    def axis_sizes(self) -> Tuple[Tuple[str, int], ...]:
        return (("data", self.data), ("model", self.model),
                ("pipeline", self.pipeline), ("sequence", self.sequence))

    def total(self) -> int:
        return self.data * self.model * self.pipeline * self.sequence

    def build(self, devices=None) -> Mesh:
        """The mesh over ``devices`` (default: this process's CUDA
        devices); a global list (``distributed.global_devices()``) builds
        a mesh whose axes may cross processes."""
        devices = list(devices) if devices is not None else \
            default_devices()
        n = self.total()
        if n > len(devices):
            raise ValueError(
                f"Mesh needs {n} devices, only {len(devices)} available")
        # only axes of size > 1, plus 'data' (so at least one axis)
        names = [name for name, size in self.axis_sizes() if size > 1]
        sizes = [size for _, size in self.axis_sizes() if size > 1]
        if not names:
            names, sizes = ["data"], [1]
        return Mesh(_device_array(devices[:n], tuple(sizes)), names,
                    _owner_array(devices[:n], tuple(sizes)))

    @staticmethod
    def data_parallel(n_devices: Optional[int] = None) -> "MeshConfig":
        """All devices on the data axis — the ParallelWrapper /
        SharedTrainingMaster equivalent."""
        return MeshConfig(data=n_devices or len(default_devices()))


def serving_mesh(devices, tp: Optional[int] = None) -> Mesh:
    """A ``("data", "tp")`` mesh over ONE serving replica's device slice.
    ``tp`` defaults to the slice size; ``len(devices) // tp`` becomes the
    ``data`` extent."""
    devices = list(devices)
    if not devices:
        raise ValueError("serving_mesh needs at least one device")
    tp = len(devices) if tp is None else int(tp)
    if tp < 1 or len(devices) % tp:
        raise ValueError(
            f"tp={tp} must divide the device slice ({len(devices)} "
            "device(s))")
    data = len(devices) // tp
    return Mesh(_device_array(devices, (data, tp)), ("data", "tp"))


def _own_copy(t: torch.Tensor, device) -> torch.Tensor:
    """``t`` on ``device`` in storage of its own: ``.to`` of a tensor
    already there returns the same tensor, and a repeated device would
    then alias two shards (an in-place update of one would move both)."""
    out = t.to(device)
    return out.clone() if out.data_ptr() == t.data_ptr() else out


class _ToGroup(torch.autograd.Function):
    """Megatron's ``f``: identity forward; the backward sums the
    gradient over the group, so a replicated input of a sharded product
    gets every shard's share."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.sum(g.contiguous()), None


class _GatherShards(torch.autograd.Function):
    """Megatron's ``g``: every process's block concatenated along ``dim``
    in coordinate order; the backward keeps this process's slice."""

    @staticmethod
    def forward(ctx, t, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, t.shape[dim]
        return torch.cat(group.gather(t.contiguous()), dim)

    @staticmethod
    def backward(ctx, g):
        return (g.narrow(ctx.dim, ctx.group.index * ctx.n, ctx.n)
                .contiguous(), None, None)


class _SumShards(torch.autograd.Function):
    """The sum of every process's partial product in coordinate order (the
    single-process shard order, so both meshes add alike); the backward
    is the identity."""

    @staticmethod
    def forward(ctx, t, group):
        return group.sum(t.contiguous())

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_blocks(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Differentiable all-gather of ``t`` over ``group`` along ``dim``."""
    return _GatherShards.apply(t, group, dim % t.ndim)


def to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums over ``group`` (Megatron's ``f``)."""
    return _ToGroup.apply(x, group)


class TpLeaf:
    """A weight split over the tensor-parallel devices: ``shards`` split
    by columns (``col``) or rows (``row``).  ``x @ W`` runs each shard's
    product on its device and concatenates the column shards (or adds
    the row shards' partial products in shard order); ``W[ids]`` of a
    row-split table adds each shard's rows where the id falls in its
    range; ``W.to(dtype)`` casts shard by shard.  Every other use (torch
    functions, attributes) sees the gathered tensor, so a layer's code
    runs on it unchanged.  The mesh trainer hands these to the forward;
    the sharded decode tick holds its embedding, head and MLP weights
    as these.

    With a ``group`` (a model axis across processes) ``shards`` is this
    process's one shard and every collective crosses the processes:
    the input passes Megatron's ``f`` (its gradient summed over the
    group), a column product is all-gathered (the backward keeps this
    process's columns), a row product and a row lookup are summed over
    the group (identity backward)."""

    def __init__(self, shards: List[torch.Tensor], kind: str, group=None):
        self.shards = shards
        self.kind = kind
        self.axis = -1 if kind == "col" else 0
        self.group = group

    @property
    def shape(self):
        s = list(self.shards[0].shape)
        if self.group is not None:
            s[self.axis] *= self.group.size
        else:
            s[self.axis] = sum(t.shape[self.axis] for t in self.shards)
        return torch.Size(s)

    @property
    def dtype(self):
        return self.shards[0].dtype

    @property
    def device(self):
        return self.shards[0].device

    @property
    def ndim(self):
        return self.shards[0].ndim

    def dim(self):
        return self.ndim

    def full(self, device=None) -> torch.Tensor:
        """The gathered tensor (a differentiable concatenation)."""
        dev = self.device if device is None else device
        if self.group is not None:
            return gather_blocks(self.shards[0], self.group,
                                 self.axis).to(dev)
        return torch.cat([s.to(dev) for s in self.shards], self.axis)

    def to(self, *args, **kwargs):
        dtypes = [a for a in args if isinstance(a, torch.dtype)]
        if len(dtypes) == len(args) and set(kwargs) <= {"dtype"}:
            return TpLeaf([s.to(*args, **kwargs) for s in self.shards],
                          self.kind, self.group)
        return self.full().to(*args, **kwargs)

    def matmul_from_left(self, x: torch.Tensor) -> torch.Tensor:
        """``x @ W``: column shards' products concatenated, or row shards'
        partial products added in shard order."""
        if self.group is not None:
            s, g = self.shards[0], self.group
            x = to_group(x, g)
            if self.kind == "col":
                return gather_blocks(x @ s, g, -1)
            n = s.shape[0]
            return _SumShards.apply(x.narrow(-1, g.index * n, n) @ s, g)
        if self.kind == "col":
            return torch.cat([(x.to(s.device) @ s).to(x.device)
                              for s in self.shards], -1)
        sizes = [s.shape[0] for s in self.shards]
        acc = None
        for xc, s in zip(torch.split(x, sizes, dim=-1), self.shards):
            part = (xc.to(s.device) @ s).to(x.device)
            acc = part if acc is None else acc + part
        return acc

    @staticmethod
    def _rows_in(s, idx, lo):
        n = s.shape[0]
        i = idx.to(s.device)
        inside = (i >= lo) & (i < lo + n)
        part = s[torch.where(inside, i - lo, torch.zeros_like(i))]
        return part * inside[..., None].to(part.dtype)

    def take_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """``W[idx]`` of a row-split table: each vocab shard's rows where
        the id falls in its range, zeros elsewhere, added up."""
        if self.group is not None:
            s = self.shards[0]
            return _SumShards.apply(
                self._rows_in(s, idx, self.group.index * s.shape[0]),
                self.group)
        acc, lo = None, 0
        for s in self.shards:
            part = self._rows_in(s, idx, lo).to(idx.device)
            acc = part if acc is None else acc + part
            lo += s.shape[0]
        return acc

    def __getitem__(self, idx):
        if self.kind == "row" and isinstance(idx, torch.Tensor) and \
                not idx.is_floating_point() and idx.dtype != torch.bool:
            return self.take_rows(idx)
        return self.full()[idx]

    def __rmatmul__(self, x):
        return self.matmul_from_left(x)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.full(), name)

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.Tensor.__matmul__, torch.matmul) and \
                len(args) == 2 and isinstance(args[1], TpLeaf) and \
                isinstance(args[0], torch.Tensor):
            return args[1].matmul_from_left(args[0])
        if func is torch.Tensor.__getitem__ and isinstance(args[0],
                                                           TpLeaf):
            return args[0][args[1]]
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   None)

        def gather(a):
            if isinstance(a, TpLeaf):
                return a.full(dev)
            if isinstance(a, (list, tuple)):
                return type(a)(gather(b) for b in a)
            return a
        return func(*gather(args), **{k: gather(v)
                                      for k, v in kwargs.items()})


class TpShardCtx:
    """Sharding context of the mesh-sharded decode tick: the placement of
    each param / pool / state leaf on the replica's ``("data", "tp")``
    mesh, and :meth:`rep`, the gather that precedes every reduction over
    a feature axis (layer norms, ``@ Wo``, ``@ W2``, the head's argmax),
    so no device sums a partial feature axis.

    Weights shard along OUTPUT axes only (q/k/v columns per head, mlp
    columns), so every shard computes a full-depth reduction for its own
    output columns.  Sharded leaves are lists of per-device tensors in
    mesh order (``devices``); a tp=1 server builds no ctx."""

    def __init__(self, mesh: Mesh):
        names = tuple(mesh.axis_names)
        if names != ("data", "tp"):
            raise ValueError(
                f"TpShardCtx needs a ('data', 'tp') mesh, got {names}")
        self.mesh = mesh
        self.data = int(mesh.shape["data"])
        self.tp = int(mesh.shape["tp"])
        #: the data extent of the whole replica: a :meth:`row`'s ctx
        #: runs 1 / ``replica_data`` of the replica's slots
        self.replica_data = self.data

    def row(self, r: int) -> "TpShardCtx":
        """The ctx of data row ``r`` alone (its tp devices; data 1),
        which remembers the replica's data extent."""
        ctx = TpShardCtx(Mesh(self.mesh.devices[r:r + 1],
                              self.mesh.axis_names))
        ctx.replica_data = self.data
        return ctx

    @property
    def devices(self) -> List[torch.device]:
        """The replica's device slice, mesh-ordered (data-major)."""
        return list(self.mesh.devices.flat)

    def spec(self, *axes) -> PartitionSpec:
        return PartitionSpec(*axes)

    def rep(self, parts: Sequence[torch.Tensor], dim: int = -1,
            device=None) -> torch.Tensor:
        """Gather the tp column blocks of one activation (``parts[c]`` on
        tp device c) into the full tensor — pure data movement, the
        concatenation in shard order — on ``device`` (default the
        slice's first device, where the tick's replicated math runs)."""
        dev = self.devices[0] if device is None else device
        return torch.cat([p.to(dev) for p in parts], dim=dim)

    @property
    def tp_devices(self) -> List[torch.device]:
        """The tp devices of the slice's first data row."""
        return self.devices[:self.tp]

    def put(self, arr, *axes) -> List[torch.Tensor]:
        """The per-device blocks of ``arr`` (one per mesh device, in
        mesh order), each in storage of its own.  A named axis whose
        extent the mesh axis does not divide is replicated instead;
        missing trailing axes are replicated."""
        t = torch.as_tensor(arr)
        sizes = {"data": self.data, "tp": self.tp, None: 1}
        fixed = [a if (a is not None and t.shape[i] % sizes[a] == 0)
                 else None for i, a in enumerate(axes[:t.ndim])]
        out = []
        for r in range(self.data):
            for c in range(self.tp):
                blk = t
                for i, a in enumerate(fixed):
                    if a is None:
                        continue
                    k = r if a == "data" else c
                    n = t.shape[i] // sizes[a]
                    blk = blk.narrow(i, k * n, n)
                out.append(_own_copy(blk.contiguous(),
                                     self.mesh.devices[r, c]))
        return out

    def put_batch(self, arr) -> List[torch.Tensor]:
        """A per-slot leaf: leading batch axis on ``data``."""
        return self.put(arr, "data")

    def replicate(self, tree):
        """Every leaf of a nested dict as per-device copies."""
        if isinstance(tree, dict):
            return {k: self.replicate(v) for k, v in tree.items()}
        return self.put(tree)
