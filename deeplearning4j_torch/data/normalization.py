"""Data normalizers with fit/transform semantics (port of
``deeplearning4j_tpu/data/normalization.py``; ``org.nd4j.linalg.dataset.
api.preprocessor.{NormalizerStandardize,NormalizerMinMaxScaler,
ImagePreProcessingScaler}``) — fit statistics on a training iterator,
then attach as the iterator's ``pre_processor`` so every batch is
normalized on the host prefetch thread.  Host numpy, as in the
reference.
"""
from __future__ import annotations

import numpy as np

from deeplearning4j_torch.data.dataset import DataSet


class DataNormalization:
    def fit(self, iterator) -> "DataNormalization":
        raise NotImplementedError

    def transform(self, ds: DataSet) -> DataSet:
        raise NotImplementedError

    # serialization for checkpoints (NormalizerSerializer analogue)
    def state_dict(self) -> dict:
        return {}

    def load_state_dict(self, d: dict) -> None:
        pass


class NormalizerStandardize(DataNormalization):
    """Zero-mean unit-variance per feature column."""

    def __init__(self):
        self.mean = None
        self.std = None

    def fit(self, iterator):
        # one streaming pass: running sums of x and x^2 in float64
        n, s, s2 = 0, None, None
        for ds in iterator:
            f = ds.features.reshape(ds.features.shape[0], -1).astype(np.float64)
            if s is None:
                s = f.sum(0)
                s2 = (f * f).sum(0)
            else:
                s += f.sum(0)
                s2 += (f * f).sum(0)
            n += f.shape[0]
        iterator.reset()
        self.mean = (s / n).astype(np.float32)
        var = np.maximum(s2 / n - (s / n) ** 2, 1e-12)
        self.std = np.sqrt(var).astype(np.float32)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        shape = ds.features.shape
        f = ds.features.reshape(shape[0], -1)
        f = (f - self.mean) / self.std
        return DataSet(f.reshape(shape).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def state_dict(self):
        return {"mean": self.mean, "std": self.std}

    def load_state_dict(self, d):
        self.mean, self.std = d["mean"], d["std"]


class NormalizerMinMaxScaler(DataNormalization):
    """Scale features into [min, max] (default [0, 1])."""

    def __init__(self, min_val: float = 0.0, max_val: float = 1.0):
        self.target_min = min_val
        self.target_max = max_val
        self.data_min = None
        self.data_max = None

    def fit(self, iterator):
        lo, hi = None, None
        for ds in iterator:
            f = ds.features.reshape(ds.features.shape[0], -1)
            bmin, bmax = f.min(0), f.max(0)
            lo = bmin if lo is None else np.minimum(lo, bmin)
            hi = bmax if hi is None else np.maximum(hi, bmax)
        iterator.reset()
        self.data_min, self.data_max = lo.astype(np.float32), hi.astype(np.float32)
        return self

    def transform(self, ds: DataSet) -> DataSet:
        shape = ds.features.shape
        f = ds.features.reshape(shape[0], -1)
        rng = np.maximum(self.data_max - self.data_min, 1e-12)
        f = (f - self.data_min) / rng
        f = f * (self.target_max - self.target_min) + self.target_min
        return DataSet(f.reshape(shape).astype(np.float32), ds.labels,
                       ds.features_mask, ds.labels_mask)

    def state_dict(self):
        return {"data_min": self.data_min, "data_max": self.data_max,
                "target_min": self.target_min, "target_max": self.target_max}

    def load_state_dict(self, d):
        self.data_min, self.data_max = d["data_min"], d["data_max"]
        self.target_min, self.target_max = d["target_min"], d["target_max"]


class ImagePreProcessingScaler(DataNormalization):
    """Pixel scaling [0,255] -> [a,b] (``ImagePreProcessingScaler``);
    needs no fit."""

    def __init__(self, min_val: float = 0.0, max_val: float = 1.0):
        self.min_val = min_val
        self.max_val = max_val

    def fit(self, iterator):
        return self

    def transform(self, ds: DataSet) -> DataSet:
        f = ds.features.astype(np.float32) / 255.0
        f = f * (self.max_val - self.min_val) + self.min_val
        return DataSet(f, ds.labels, ds.features_mask, ds.labels_mask)

    def state_dict(self):
        return {"min_val": self.min_val, "max_val": self.max_val}

    def load_state_dict(self, d):
        self.min_val, self.max_val = d["min_val"], d["max_val"]
