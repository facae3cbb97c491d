"""MNIST dataset iterator (port of ``deeplearning4j_tpu/data/mnist.py``;
``org.deeplearning4j.datasets.iterator.impl.MnistDataSetIterator``).

Real IDX files are read from ``$DL4J_TPU_MNIST_DIR`` (default
``~/.deeplearning4j_tpu/mnist``), the same place the reference reads.
Without them — nothing is downloaded — a DETERMINISTIC SYNTHETIC digit
set stands in: class-conditional stroke templates rendered at 28x28 with
per-example shifts, scales and noise, drawn with the same numpy calls in
the same order as the reference, so both packages see the same images
element for element.  The checked-in LeNet was trained and gated on it.
"""
from __future__ import annotations

import gzip
import os
import struct
from typing import Optional, Tuple

import numpy as np

from deeplearning4j_torch.data.iterator import ArrayDataSetIterator

_CACHE_ENV = "DL4J_TPU_MNIST_DIR"
_DEFAULT_CACHE = os.path.join("~", ".deeplearning4j_tpu", "mnist")

_IDX_FILES = {
    True: ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    False: ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def read_idx(path: str) -> np.ndarray:
    """One IDX file (optionally gzipped) as a uint8 array."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        _, _, ndim = struct.unpack(">HBB", f.read(4))
        dims = struct.unpack(">" + "I" * ndim, f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(dims)


def _load_real(train: bool) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    cache = os.path.expanduser(os.environ.get(_CACHE_ENV, _DEFAULT_CACHE))
    img_name, lbl_name = _IDX_FILES[train]
    for suffix in ("", ".gz"):
        ip = os.path.join(cache, img_name + suffix)
        lp = os.path.join(cache, lbl_name + suffix)
        if os.path.exists(ip) and os.path.exists(lp):
            return read_idx(ip), read_idx(lp)
    return None


def _digit_templates(rng: np.random.Generator) -> np.ndarray:
    """10 fixed 28x28 'digit' stroke templates from a seeded generator:
    random quadratic strokes per class, separable but overlapping."""
    templates = np.zeros((10, 28, 28), np.float32)
    yy, xx = np.mgrid[0:28, 0:28]
    for c in range(10):
        n_strokes = 3 + c % 3
        img = np.zeros((28, 28), np.float32)
        for _ in range(n_strokes):
            # quadratic Bezier stroke in pixel space
            p0 = rng.uniform(4, 24, 2)
            p1 = rng.uniform(4, 24, 2)
            p2 = rng.uniform(4, 24, 2)
            t = np.linspace(0, 1, 64)[:, None]
            pts = ((1 - t) ** 2) * p0 + 2 * t * (1 - t) * p1 + (t**2) * p2
            for py, px in pts:
                d2 = (yy - py) ** 2 + (xx - px) ** 2
                img += np.exp(-d2 / 3.0)
        templates[c] = np.clip(img / img.max(), 0, 1)
    return templates


def synthetic_mnist(n: int, train: bool, seed: int = 123
                    ) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic digit arrays: (images uint8 [n,28,28],
    labels int32 [n]).  Train and test draw from the same distribution
    with disjoint generator streams."""
    templates = _digit_templates(np.random.default_rng(seed))
    rng = np.random.default_rng(seed + (1 if train else 2))
    labels = rng.integers(0, 10, size=n)
    images = np.zeros((n, 28, 28), np.float32)
    shifts = rng.integers(-1, 2, size=(n, 2))
    noise = rng.normal(0, 0.15, size=(n, 28, 28)).astype(np.float32)
    scales = rng.uniform(0.8, 1.0, size=n).astype(np.float32)
    for i in range(n):
        img = np.roll(templates[labels[i]], tuple(shifts[i]), axis=(0, 1))
        images[i] = img * scales[i]
    images = np.clip(images + noise, 0, 1)
    return (images * 255).astype(np.uint8), labels.astype(np.int32)


class MnistDataSetIterator(ArrayDataSetIterator):
    """DL4J-style MNIST iterator: features flat [batch, 784] float scaled
    to [0,1] (DL4J's MnistDataFetcher does the /255 itself), one-hot
    labels [batch, 10].  ``is_synthetic`` says which set it holds."""

    def __init__(self, batch_size: int, train: bool = True,
                 seed: int = 123, binarize: bool = False,
                 shuffle: bool = True, n_examples: Optional[int] = None):
        real = _load_real(train)
        if real is not None:
            images, labels = real
        else:
            n = n_examples or (60000 if train else 10000)
            images, labels = synthetic_mnist(n, train, seed)
        if n_examples is not None:
            images, labels = images[:n_examples], labels[:n_examples]
        feats = images.reshape(images.shape[0], 784).astype(np.float32) / 255.0
        if binarize:
            feats = (feats > 0.5).astype(np.float32)
        onehot = np.zeros((labels.shape[0], 10), np.float32)
        onehot[np.arange(labels.shape[0]), labels] = 1.0
        super().__init__(feats, onehot, batch_size, shuffle=shuffle and train,
                         seed=seed)
        self.is_synthetic = real is None
