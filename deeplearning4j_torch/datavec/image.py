"""Image pipeline (port of ``deeplearning4j_tpu/datavec/image.py``:
``org.datavec.image.recordreader.ImageRecordReader`` +
``NativeImageLoader``'s JavaCV decode).

Host-side decode→resize→scale with OpenCV (already native C++ SIMD — the
JavaCV indirection the reference needed does not exist here), directory
name = label (DL4J ``ParentPathLabelGenerator``), NHWC float32 output.
Batches assemble into ONE contiguous array so the device sees a single
transfer; async prefetch overlaps the whole thing with device compute
(wrap the iterator — ``AsyncDataSetIterator`` — exactly as DL4J does).
"""
from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from deeplearning4j_torch.datavec.records import RecordReader

_EXTS = (".jpg", ".jpeg", ".png", ".bmp", ".ppm")


def _decode(path: str, h: int, w: int, channels: int) -> np.ndarray:
    import cv2
    flag = cv2.IMREAD_COLOR if channels == 3 else cv2.IMREAD_GRAYSCALE
    img = cv2.imread(path, flag)
    if img is None:
        raise IOError(f"Cannot decode image {path!r}")
    if (img.shape[0], img.shape[1]) != (h, w):
        img = cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
    if channels == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    else:
        img = img[..., None]
    return img


def _decode_f32(args):
    """Module-level (picklable) worker for the process pool."""
    path, h, w, c = args
    return _decode(path, h, w, c).astype(np.float32)


class ImageRecordReader(RecordReader):
    """Yields ``[image_hwc_float32, label_index]`` records from a
    directory tree ``root/<label>/<file>`` (ParentPathLabelGenerator) or
    an explicit (paths, labels) list."""

    def __init__(self, height: int, width: int, channels: int = 3,
                 root: Optional[str] = None,
                 paths: Optional[Sequence[str]] = None,
                 labels: Optional[Sequence[int]] = None,
                 label_names: Optional[List[str]] = None,
                 shuffle_seed: Optional[int] = None,
                 n_workers: int = 0):
        """``n_workers > 0`` decodes via a PROCESS pool — thread-based
        prefetch cannot scale Python-side decode past the GIL (measured:
        in-fit decode throughput drops ~4x under dispatch contention);
        per-image decode is embarrassingly parallel across cores."""
        self.h, self.w, self.c = height, width, channels
        self.n_workers = int(n_workers)
        if root is not None:
            self.label_names = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
            self.paths, self.labels = [], []
            for li, lab in enumerate(self.label_names):
                d = os.path.join(root, lab)
                for f in sorted(os.listdir(d)):
                    if f.lower().endswith(_EXTS):
                        self.paths.append(os.path.join(d, f))
                        self.labels.append(li)
        elif paths is not None:
            self.paths = list(paths)
            self.labels = list(labels) if labels is not None else [0] * len(self.paths)
            self.label_names = label_names or sorted(
                {str(l) for l in self.labels})
        else:
            raise ValueError("Give root= or paths=")
        if shuffle_seed is not None:
            rng = np.random.default_rng(shuffle_seed)
            order = rng.permutation(len(self.paths))
            self.paths = [self.paths[i] for i in order]
            self.labels = [self.labels[i] for i in order]

    def n_labels(self) -> int:
        return len(self.label_names)

    def __len__(self):
        return len(self.paths)

    def __iter__(self):
        if self.n_workers > 0:
            import multiprocessing as mp
            # spawn, NOT fork: __iter__ runs inside the async prefetch
            # thread while the main thread's CUDA runtime holds internal
            # locks — a fork()ed child can inherit a locked mutex and
            # hang pool startup.  Worker + args are picklable by design.
            ctx = mp.get_context("spawn")
            with ctx.Pool(self.n_workers) as pool:
                args = [(p, self.h, self.w, self.c) for p in self.paths]
                for img, lab in zip(
                        pool.imap(_decode_f32, args, chunksize=16),
                        self.labels):
                    yield [img, lab]
            return
        for p, lab in zip(self.paths, self.labels):
            img = _decode(p, self.h, self.w, self.c).astype(np.float32)
            yield [img, lab]
