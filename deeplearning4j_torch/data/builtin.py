"""Built-in small datasets (port of ``deeplearning4j_tpu/data/builtin.py``;
``IrisDataSetIterator``, ``Cifar10DataSetIterator``).

Iris is the real 150-example Fisher set, kept in the port's own
``resources/iris.csv``.  CIFAR-10 binary batches load from
``$DL4J_TPU_CIFAR_DIR`` when the standard ``data_batch_*.bin`` /
``test_batch.bin`` files are there; otherwise a DETERMINISTIC synthetic
set stands in (class-conditional textured colour fields with noise,
``is_synthetic=True``), drawn with the same numpy calls in the same
order as the reference, so both packages see the same images element
for element.  The checked-in SimpleCNN was trained and gated on it.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from deeplearning4j_torch.data.iterator import ArrayDataSetIterator

_RES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "resources")


def load_iris_arrays():
    """(features [150, 4] f32, one-hot labels [150, 3] f32)."""
    rows = np.loadtxt(os.path.join(_RES, "iris.csv"), delimiter=",")
    feats = rows[:, :4].astype(np.float32)
    labels = rows[:, 4].astype(np.int32)
    return feats, np.eye(3, dtype=np.float32)[labels]


class IrisDataSetIterator(ArrayDataSetIterator):
    """The classic 150-example Fisher iris set
    (``IrisDataSetIterator(batch, numExamples)``)."""

    def __init__(self, batch_size: int = 150,
                 n_examples: Optional[int] = None, shuffle: bool = True,
                 seed: int = 123):
        feats, onehot = load_iris_arrays()
        if shuffle:
            # deterministic pre-shuffle so truncation keeps all classes
            # (the file is class-ordered)
            order = np.random.default_rng(seed).permutation(len(feats))
            feats, onehot = feats[order], onehot[order]
        if n_examples is not None:
            feats, onehot = feats[:n_examples], onehot[:n_examples]
        super().__init__(feats, onehot, batch_size, shuffle=shuffle,
                         seed=seed)


def synthetic_cifar(n: int, train: bool, seed: int):
    """Class-conditional 32x32 RGB fields: a palette colour times a
    sinusoidal texture per class, noise-jittered — separable but not
    trivial.  (images uint8 [n,32,32,3], labels int32 [n])."""
    rng = np.random.default_rng(seed + (0 if train else 1))
    labels = rng.integers(0, 10, n).astype(np.int32)
    yy, xx = np.mgrid[0:32, 0:32].astype(np.float32) / 31.0
    imgs = np.empty((n, 32, 32, 3), np.float32)
    base = np.random.default_rng(7)          # fixed class palettes
    palette = base.random((10, 3)).astype(np.float32)
    freq = base.integers(1, 5, size=(10, 2))
    for i in range(n):
        c = labels[i]
        tex = 0.5 + 0.5 * np.sin(
            freq[c, 0] * np.pi * yy + freq[c, 1] * np.pi * xx
            + rng.random() * 2 * np.pi)
        img = palette[c][None, None, :] * tex[..., None]
        imgs[i] = np.clip(img + rng.normal(0, 0.08, (32, 32, 3)), 0, 1)
    return (imgs * 255).astype(np.uint8), labels


def _load_real_cifar(train: bool):
    d = os.environ.get("DL4J_TPU_CIFAR_DIR")
    if not d or not os.path.isdir(d):
        return None
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)] if train
             else ["test_batch.bin"])
    imgs, labels = [], []
    for name in names:
        p = os.path.join(d, name)
        if not os.path.exists(p):
            return None
        raw = np.fromfile(p, np.uint8).reshape(-1, 3073)
        labels.append(raw[:, 0].astype(np.int32))
        imgs.append(raw[:, 1:].reshape(-1, 3, 32, 32)
                    .transpose(0, 2, 3, 1))  # CHW binary -> NHWC
    return np.concatenate(imgs), np.concatenate(labels)


class Cifar10DataSetIterator(ArrayDataSetIterator):
    """CIFAR-10 iterator (``Cifar10DataSetIterator``): NHWC [b,32,32,3]
    float in [0,1], one-hot labels [b,10]; ``is_synthetic`` says which
    set it holds."""

    def __init__(self, batch_size: int, train: bool = True,
                 n_examples: Optional[int] = None, seed: int = 123,
                 shuffle: bool = True):
        real = _load_real_cifar(train)
        if real is not None:
            images, labels = real
        else:
            n = n_examples or (50000 if train else 10000)
            images, labels = synthetic_cifar(n, train, seed)
        if n_examples is not None:
            images, labels = images[:n_examples], labels[:n_examples]
        feats = images.astype(np.float32) / 255.0
        onehot = np.eye(10, dtype=np.float32)[labels]
        super().__init__(feats, onehot, batch_size,
                         shuffle=shuffle and train, seed=seed)
        self.is_synthetic = real is None
