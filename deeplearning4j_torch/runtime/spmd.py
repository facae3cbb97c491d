"""The data-parallel shard context of the mesh trainer (the port's
stand-in for what GSPMD does inside the reference's jitted step).

The reference shards one jitted step over the ``data`` axis and lets the
compiler place the collectives: a loss mean over the GLOBAL batch,
batch-norm statistics over the GLOBAL batch, dropout masks drawn for the
GLOBAL shape.  The port runs one eager forward per data shard, so the
three places where a shard must see the whole batch ask this module:

* :func:`batch_mean` / :func:`masked_mean` — the loss normaliser, the
  global row count (or the global mask sum) instead of the shard's;
* :func:`all_reduce_sum` — a differentiable sum over the shards (batch
  norm's Σx and Σx², so its statistics are sync-BN's);
* :func:`shard_rows` — the rows of the global batch this shard holds
  (``apply_dropout`` draws the global mask and keeps its rows).

Outside a shard (``current()`` is None) each of them is the
single-device math: the sum is the identity and the rows are all of
them, so the layers and losses keep one code path.  :class:`Lockstep` runs the shards' forwards in threads that take
turns, ONE running at a time, and switch only at a collective: shard 0
runs to its first collective, hands over to shard 1, ..., the last shard
sums every shard's operands, then shard 0 continues.  No two threads run
torch at once, so launch counters and the autograd graph see a serial
program; the collective's sum is ordinary autograd ops across the
shards' tensors, so ONE backward over the summed losses carries the
sync-BN backward exactly.
"""
from __future__ import annotations

import dataclasses
import threading
from contextlib import contextmanager
from typing import Callable, List, Optional, Sequence

import torch

_LOCAL = threading.local()


class LockstepAborted(RuntimeError):
    """A peer shard failed; this shard unwinds without running on."""


class Lockstep:
    """Turn-taking threads for ``n`` shard bodies (see the module doc).
    Every body must reach the same collectives in the same order."""

    def __init__(self, n: int):
        self.n = int(n)
        self._cv = threading.Condition()
        self._turn = 0
        self._slots: List[Optional[Sequence[torch.Tensor]]] = [None] * n
        self._results: List[Optional[list]] = [None] * n
        self._error: Optional[BaseException] = None

    def _wait_turn(self, rank: int) -> None:
        with self._cv:
            while self._turn != rank and self._error is None:
                self._cv.wait()
            if self._error is not None:
                raise LockstepAborted("a peer shard failed")

    def _pass_turn(self, to: int) -> None:
        with self._cv:
            self._turn = to
            self._cv.notify_all()

    def all_reduce(self, rank: int, tensors: Sequence[torch.Tensor]):
        """Sum ``tensors`` elementwise over the shards, in rank order;
        each shard gets the sums on the device of its own operands."""
        self._slots[rank] = list(tensors)
        if rank < self.n - 1:
            self._pass_turn(rank + 1)
            self._wait_turn(rank)
            return self._results[rank]
        totals = []
        for i in range(len(tensors)):
            dev0 = self._slots[0][i].device
            acc = self._slots[0][i]
            for r in range(1, self.n):
                acc = acc + self._slots[r][i].to(dev0)
            totals.append(acc)
        for r in range(self.n):
            self._results[r] = [t.to(self._slots[r][i].device)
                                for i, t in enumerate(totals)]
        self._pass_turn(0)
        self._wait_turn(rank)
        return self._results[rank]

    def run(self, bodies: Sequence[Callable[[], object]]) -> list:
        """Run ``bodies[r]`` as shard r; returns their results in rank
        order, or raises the first failure."""
        assert len(bodies) == self.n
        out: list = [None] * self.n

        def worker(rank):
            try:
                self._wait_turn(rank)
                out[rank] = bodies[rank]()
            except BaseException as e:      # re-raised by run()
                with self._cv:
                    if self._error is None and \
                            not isinstance(e, LockstepAborted):
                        self._error = e
                    self._cv.notify_all()
                return
            self._pass_turn(rank + 1)

        if self.n == 1:
            return [bodies[0]()]
        threads = [threading.Thread(target=worker, args=(r,),
                                    name=f"spmd-shard-{r}", daemon=True)
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._error is not None:
            raise self._error
        return out


@dataclasses.dataclass(frozen=True)
class ShardRows:
    """This shard's place in the global batch: data shard ``rank`` of
    this process holds rows ``[offset, offset + rows)`` of ``total``;
    ``group`` the collective (None: the process holds one shard and
    ``process_sum`` alone reduces); ``lead`` True on the one shard of the
    job that carries the regularization term."""
    rank: int
    offset: int
    rows: int
    total: int
    lead: bool = True
    group: Optional[Lockstep] = None
    process_sum: Optional[Callable] = None


def current() -> Optional[ShardRows]:
    return getattr(_LOCAL, "rows", None)


@contextmanager
def shard_scope(info: Optional[ShardRows]):
    prev = current()
    _LOCAL.rows = info
    try:
        yield info
    finally:
        _LOCAL.rows = prev


def batch_mean(scores: torch.Tensor) -> torch.Tensor:
    """``scores.mean()``, over the GLOBAL batch inside a shard."""
    n = scores.numel()
    if scores.ndim:
        n = n // max(1, scores.shape[0]) * shard_rows(scores.shape[0])[1]
    return scores.sum() / float(n)


def masked_mean(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``scores.sum() / max(mask.sum(), 1)`` with the GLOBAL mask sum
    inside a shard (a collective)."""
    total = all_reduce_sum([mask.sum()])[0]
    return scores.sum() / torch.clamp(total, min=1.0)


def regularization_share(reg):
    """The l1/l2 term once per job: the lead shard carries it (the
    gradient sum over the shards then adds it once), the others add 0."""
    info = current()
    return reg if info is None or info.lead else 0.0


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Differentiable sum of ``tensors`` over every data shard (this
    process's shards, then the processes'); identity outside a shard."""
    info = current()
    if info is None:
        return list(tensors)
    out = list(tensors)
    if info.group is not None:
        out = info.group.all_reduce(info.rank, out)
    if info.process_sum is not None:
        out = info.process_sum(out)
    return out


def shard_rows(n_rows: int):
    """(offset, total) of a tensor whose leading axis holds ``n_rows``
    batch rows: where they sit in the global batch inside a data shard,
    else (0, n_rows)."""
    info = current()
    if info is None or n_rows != info.rows:
        return 0, n_rows
    return info.offset, info.total
