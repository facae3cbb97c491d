"""RecordReader → DataSet bridge (port of
``deeplearning4j_tpu/datavec/iterator.py``:
``org.deeplearning4j.datasets.datavec.RecordReaderDataSetIterator`` and
``SequenceRecordReaderDataSetIterator``).

Records batch into ONE contiguous numpy array per slot (features, one-hot
or regression labels) so the network copies each slot to the card once
per batch; wrap in ``AsyncDataSetIterator`` for the prefetch thread.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from deeplearning4j_torch.data.dataset import DataSet
from deeplearning4j_torch.data.iterator import DataSetIterator
from deeplearning4j_torch.datavec.records import RecordReader


def _one_hot(idx, n):
    out = np.zeros((len(idx), n), np.float32)
    out[np.arange(len(idx)), np.asarray(idx, np.int64)] = 1.0
    return out


class RecordReaderDataSetIterator(DataSetIterator):
    """(reader, batch_size, label_index, n_classes) — DL4J's main ETL
    bridge.  ``label_index=-1`` means the LAST column; ``n_classes=None``
    means regression (label kept as float, no one-hot).  Records whose
    first value is an ndarray (ImageRecordReader) stack it as features."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, n_classes: Optional[int] = None,
                 transform_process=None):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.n_classes = n_classes
        self.tp = transform_process

    def batch_size(self):
        return self._batch

    def total_outcomes(self):
        return self.n_classes

    def _records(self):
        recs = iter(self.reader)
        if self.tp is not None:
            recs = iter(self.tp.execute(recs))
        return recs

    def _to_dataset(self, rows: List[List]) -> DataSet:
        first = rows[0]
        if isinstance(first[0], np.ndarray) and first[0].ndim >= 2:
            # image records: [array, label]
            feats = np.stack([r[0] for r in rows]).astype(np.float32)
            labs = [r[1] for r in rows]
        else:
            li = self.label_index if self.label_index >= 0 \
                else len(first) + self.label_index
            feats = np.asarray(
                [[v for i, v in enumerate(r) if i != li] for r in rows],
                np.float32)
            labs = [r[li] for r in rows]
        if self.n_classes is not None:
            labels = _one_hot([int(l) for l in labs], self.n_classes)
        else:
            labels = np.asarray(labs, np.float32)
            if labels.ndim == 1:
                labels = labels[:, None]
        return DataSet(feats, labels)

    def __iter__(self):
        rows: List[List] = []
        for rec in self._records():
            rows.append(rec)
            if len(rows) == self._batch:
                yield self._maybe_preprocess(self._to_dataset(rows))
                rows = []
        if rows:
            yield self._maybe_preprocess(self._to_dataset(rows))

    def reset(self):
        self.reader.reset()


class SequenceRecordReaderDataSetIterator(DataSetIterator):
    """Sequence reader → [b, t, f] DataSet with per-timestep one-hot
    labels and padding masks for ragged lengths (DL4J's ALIGN_END
    simplification: we align START and mask the tail)."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: int = -1, n_classes: Optional[int] = None):
        self.reader = reader
        self._batch = batch_size
        self.label_index = label_index
        self.n_classes = n_classes

    def _to_dataset(self, seqs: List[List[List]]) -> DataSet:
        li_of = lambda row: (self.label_index if self.label_index >= 0
                             else len(row) + self.label_index)
        t_max = max(len(s) for s in seqs)
        n_feat = len(seqs[0][0]) - 1
        b = len(seqs)
        feats = np.zeros((b, t_max, n_feat), np.float32)
        mask = np.zeros((b, t_max), np.float32)
        if self.n_classes is not None:
            labels = np.zeros((b, t_max, self.n_classes), np.float32)
        else:
            labels = np.zeros((b, t_max, 1), np.float32)
        for bi, seq in enumerate(seqs):
            for ti, row in enumerate(seq):
                li = li_of(row)
                feats[bi, ti] = [v for i, v in enumerate(row) if i != li]
                mask[bi, ti] = 1.0
                if self.n_classes is not None:
                    labels[bi, ti, int(row[li])] = 1.0
                else:
                    labels[bi, ti, 0] = float(row[li])
        return DataSet(feats, labels, features_mask=mask, labels_mask=mask)

    def __iter__(self):
        seqs: List[List[List]] = []
        for seq in self.reader:
            seqs.append(seq)
            if len(seqs) == self._batch:
                yield self._maybe_preprocess(self._to_dataset(seqs))
                seqs = []
        if seqs:
            yield self._maybe_preprocess(self._to_dataset(seqs))

    def reset(self):
        self.reader.reset()
