"""DataSet container (port of ``deeplearning4j_tpu/data/dataset.py``,
``DataSet``): features, labels and their masks as host numpy arrays,
with the split/shuffle/batch utilities; conversion to device tensors
happens at the step boundary (``MultiLayerNetwork._batch_dict``); and
``MultiDataSet``, the multi-input container ``BertIterator`` yields;
and ``tbptt_segments``, the truncated-BPTT splitter."""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataSet:
    features: np.ndarray
    labels: np.ndarray
    features_mask: Optional[np.ndarray] = None
    labels_mask: Optional[np.ndarray] = None

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def batch_by(self, batch_size: int) -> List["DataSet"]:
        out = []
        n = self.num_examples()
        for i in range(0, n, batch_size):
            sl = slice(i, min(i + batch_size, n))
            out.append(DataSet(
                self.features[sl], self.labels[sl],
                None if self.features_mask is None else self.features_mask[sl],
                None if self.labels_mask is None else self.labels_mask[sl],
            ))
        return out

    def shuffle(self, seed: Optional[int] = None) -> "DataSet":
        rng = np.random.default_rng(seed)
        idx = rng.permutation(self.num_examples())
        return DataSet(
            self.features[idx], self.labels[idx],
            None if self.features_mask is None else self.features_mask[idx],
            None if self.labels_mask is None else self.labels_mask[idx],
        )

    def split_test_and_train(self, n_train: int):
        """DL4J ``splitTestAndTrain``: (train, test) SplitTestAndTrain."""
        train = DataSet(
            self.features[:n_train], self.labels[:n_train],
            None if self.features_mask is None else self.features_mask[:n_train],
            None if self.labels_mask is None else self.labels_mask[:n_train])
        test = DataSet(
            self.features[n_train:], self.labels[n_train:],
            None if self.features_mask is None else self.features_mask[n_train:],
            None if self.labels_mask is None else self.labels_mask[n_train:])
        return train, test

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        def cat(parts):
            if any(p is None for p in parts):
                return None
            return np.concatenate(parts, axis=0)
        return DataSet(
            cat([d.features for d in datasets]),
            cat([d.labels for d in datasets]),
            cat([d.features_mask for d in datasets]),
            cat([d.labels_mask for d in datasets]),
        )


@dataclasses.dataclass
class MultiDataSet:
    """Multi-input/multi-output sample batch (``org.nd4j.linalg.dataset.MultiDataSet``)."""

    features: List[np.ndarray]
    labels: List[np.ndarray]
    features_masks: Optional[List[Optional[np.ndarray]]] = None
    labels_masks: Optional[List[Optional[np.ndarray]]] = None

    def num_examples(self) -> int:
        return int(self.features[0].shape[0])


def tbptt_segments(ds, length: int):
    """Split a sequence batch along time into truncated-BPTT segments
    (DL4J ``MultiLayerNetwork.doTruncatedBPTT`` /
    ``ComputationGraph.doTruncatedBPTT``): [b, t, f] arrays are sliced on
    the time axis and so are 2-D masks; per-example arrays pass through.
    A batch with no time dimension comes back unchanged."""
    def t_len(arrays):
        for a in arrays:
            if a is not None and np.ndim(a) == 3:
                return a.shape[1]
        return None

    def tslice(a, sl, is_mask=False):
        if a is None:
            return None
        if np.ndim(a) == 3 or (is_mask and np.ndim(a) == 2):
            return a[:, sl]
        return a

    def slices(t):
        return [slice(s, min(s + length, t)) for s in range(0, t, length)]

    if isinstance(ds, MultiDataSet):
        t = t_len(list(ds.features) + list(ds.labels))
        if t is None:
            return [ds]
        return [MultiDataSet(
            [tslice(a, sl) for a in ds.features],
            [tslice(a, sl) for a in ds.labels],
            None if ds.features_masks is None else
            [tslice(a, sl, True) for a in ds.features_masks],
            None if ds.labels_masks is None else
            [tslice(a, sl, True) for a in ds.labels_masks])
            for sl in slices(t)]
    t = t_len([ds.features, ds.labels])
    if t is None:
        return [ds]
    return [DataSet(tslice(ds.features, sl), tslice(ds.labels, sl),
                    tslice(ds.features_mask, sl, True),
                    tslice(ds.labels_mask, sl, True))
            for sl in slices(t)]
