"""DataSetIterator protocol + async prefetch (port of
``deeplearning4j_tpu/data/iterator.py``).

Parity with ``org.nd4j.linalg.dataset.api.iterator.DataSetIterator`` and
``org.deeplearning4j.datasets.iterator.AsyncDataSetIterator`` (the
background prefetch thread DL4J wraps every fit() iterator in).  The prefetch
thread overlaps host ETL with the card's work on the previous
step.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_torch.data.dataset import DataSet


class DataSetIterator:
    """Base contract: iterable over DataSet minibatches, resettable."""

    def __iter__(self) -> Iterator[DataSet]:
        raise NotImplementedError

    def reset(self) -> None:
        pass

    def batch_size(self) -> Optional[int]:
        return None

    def total_outcomes(self) -> Optional[int]:
        return None

    # DL4J's pre-processor hook (DataNormalization attaches here)
    pre_processor = None

    def _maybe_preprocess(self, ds: DataSet) -> DataSet:
        if self.pre_processor is not None:
            ds = self.pre_processor.transform(ds)
        return ds


class ListDataSetIterator(DataSetIterator):
    """Iterate over a pre-batched list (``ListDataSetIterator``)."""

    def __init__(self, data: Sequence[DataSet], batch_size: Optional[int] = None):
        if batch_size is not None:
            merged = DataSet.merge(list(data))
            data = merged.batch_by(batch_size)
        self._batches: List[DataSet] = list(data)
        self._bs = batch_size or (self._batches[0].num_examples()
                                  if self._batches else None)

    def __iter__(self):
        for b in self._batches:
            yield self._maybe_preprocess(b)

    def batch_size(self):
        return self._bs

    def total_outcomes(self):
        if self._batches:
            return int(self._batches[0].labels.shape[-1])
        return None


class ArrayDataSetIterator(DataSetIterator):
    """Batch a (features, labels) array pair with optional shuffling —
    the workhorse equivalent of DL4J's in-memory iterators."""

    def __init__(self, features: np.ndarray, labels: np.ndarray,
                 batch_size: int, shuffle: bool = False, seed: int = 0,
                 drop_last: bool = False):
        self.features = features
        self.labels = labels
        self._bs = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self.drop_last = drop_last

    def __iter__(self):
        n = self.features.shape[0]
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(idx)
        self._epoch += 1
        end = n - (n % self._bs) if self.drop_last else n
        for i in range(0, end, self._bs):
            sl = idx[i:i + self._bs]
            yield self._maybe_preprocess(
                DataSet(self.features[sl], self.labels[sl]))

    def reset(self):
        pass  # epoch counter advances shuffling; order resets naturally

    def set_epoch(self, epoch: int):
        """Make the next ``iter()`` yield epoch ``epoch``'s order (the
        resume hook of ``run_fit``)."""
        self._epoch = int(epoch)

    def batch_size(self):
        return self._bs

    def total_outcomes(self):
        return int(self.labels.shape[-1])


class ExistingDataSetIterator(DataSetIterator):
    """Wrap any python iterable of DataSets (``ExistingDataSetIterator``)."""

    def __init__(self, iterable_factory):
        """``iterable_factory``: a zero-arg callable returning a fresh
        iterable (so ``reset()`` works), or a list."""
        if isinstance(iterable_factory, (list, tuple)):
            data = list(iterable_factory)
            self._factory = lambda: iter(data)
        else:
            self._factory = iterable_factory

    def __iter__(self):
        for b in self._factory():
            yield self._maybe_preprocess(b)


class AsyncDataSetIterator(DataSetIterator):
    """Background-thread prefetch (``AsyncDataSetIterator``): a worker
    thread pulls from the wrapped iterator into a bounded queue, so host
    ETL/normalization overlaps device execution of the previous step."""

    _SENTINEL = object()

    def __init__(self, wrapped: DataSetIterator, queue_size: int = 4):
        self.wrapped = wrapped
        self.queue_size = max(1, int(queue_size))

    def __iter__(self):
        q: "queue.Queue" = queue.Queue(maxsize=self.queue_size)
        err: List[BaseException] = []
        cancelled = threading.Event()

        def worker():
            try:
                for item in self.wrapped:
                    # Bounded put with cancellation poll so an abandoned
                    # consumer (exception mid-epoch) never strands this
                    # thread blocked on a full queue.
                    while not cancelled.is_set():
                        try:
                            q.put(item, timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if cancelled.is_set():
                        return
            except BaseException as e:  # propagate into consumer
                err.append(e)
            # no sentinel: the consumer watches thread liveness instead,
            # so a full queue at shutdown can never deadlock either side.

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = q.get(timeout=0.1)
                except queue.Empty:
                    if not t.is_alive() and q.empty():
                        break
                    continue
                yield item
        finally:
            # Runs on normal exhaustion AND on generator close/abandon.
            cancelled.set()
            t.join(timeout=5.0)
        if err:
            raise err[0]

    def reset(self):
        self.wrapped.reset()

    def batch_size(self):
        return self.wrapped.batch_size()

    def total_outcomes(self):
        return self.wrapped.total_outcomes()
