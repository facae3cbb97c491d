"""Classification evaluation.

Parity with ``org.nd4j.evaluation.classification.Evaluation`` (confusion
matrix, accuracy, precision/recall/F1 micro+macro, top-N) and
``EvaluationBinary`` (per-output binary metrics under a shared threshold).

Port of ``deeplearning4j_tpu/eval/classification.py``: the same code, numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class Evaluation:
    """Streaming multi-class evaluation over one-hot or index labels."""

    def __init__(self, n_classes: Optional[int] = None, top_n: int = 1):
        self.n_classes = n_classes
        self.top_n = top_n
        self.confusion: Optional[np.ndarray] = None
        self._top_n_correct = 0
        self._count = 0

    def _ensure(self, n):
        if self.confusion is None:
            self.n_classes = self.n_classes or n
            self.confusion = np.zeros((self.n_classes, self.n_classes), np.int64)

    def eval(self, labels, predictions, mask=None):
        """labels: one-hot [n, c] or int [n]; predictions: prob/logit [n, c].
        Sequence inputs [n, t, c] are flattened over time (mask-aware)."""
        labels = np.asarray(labels)
        predictions = np.asarray(predictions)
        if predictions.ndim == 3:
            if mask is not None:
                m = np.asarray(mask).reshape(-1).astype(bool)
            else:
                m = np.ones(labels.shape[0] * labels.shape[1], bool)
            labels = labels.reshape(-1, labels.shape[-1])[m]
            predictions = predictions.reshape(-1, predictions.shape[-1])[m]
        elif mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, predictions = labels[m], predictions[m]
        self._ensure(predictions.shape[-1])
        true_idx = labels.argmax(-1) if labels.ndim == 2 else labels.astype(int)
        pred_idx = predictions.argmax(-1)
        np.add.at(self.confusion, (true_idx, pred_idx), 1)
        self._count += len(true_idx)
        if self.top_n > 1:
            top = np.argsort(-predictions, axis=-1)[:, : self.top_n]
            self._top_n_correct += int((top == true_idx[:, None]).any(-1).sum())

    # ---- metrics (names mirror DL4J's accessors) ----
    def accuracy(self) -> float:
        c = self.confusion
        return float(np.trace(c) / max(c.sum(), 1))

    def top_n_accuracy(self) -> float:
        return self._top_n_correct / max(self._count, 1)

    def _per_class(self):
        c = self.confusion.astype(np.float64)
        tp = np.diag(c)
        fp = c.sum(0) - tp
        fn = c.sum(1) - tp
        prec = tp / np.maximum(tp + fp, 1e-12)
        rec = tp / np.maximum(tp + fn, 1e-12)
        f1 = 2 * prec * rec / np.maximum(prec + rec, 1e-12)
        support = c.sum(1)
        return prec, rec, f1, support

    def precision(self, cls: Optional[int] = None) -> float:
        p, _, _, s = self._per_class()
        return float(p[cls]) if cls is not None else float(p[s > 0].mean())

    def recall(self, cls: Optional[int] = None) -> float:
        _, r, _, s = self._per_class()
        return float(r[cls]) if cls is not None else float(r[s > 0].mean())

    def f1(self, cls: Optional[int] = None) -> float:
        _, _, f, s = self._per_class()
        return float(f[cls]) if cls is not None else float(f[s > 0].mean())

    def stats(self) -> str:
        """Human-readable report (DL4J ``Evaluation.stats()``)."""
        p, r, f, s = self._per_class()
        lines = [
            f"# of classes: {self.n_classes}",
            f"Accuracy:  {self.accuracy():.4f}",
            f"Precision: {self.precision():.4f}",
            f"Recall:    {self.recall():.4f}",
            f"F1 Score:  {self.f1():.4f}",
        ]
        if self.top_n > 1:
            lines.append(f"Top-{self.top_n} Accuracy: {self.top_n_accuracy():.4f}")
        lines.append("Confusion matrix (rows=actual, cols=predicted):")
        lines.append(np.array2string(self.confusion))
        return "\n".join(lines)

    def merge(self, other: "Evaluation") -> "Evaluation":
        if other.confusion is not None:
            self._ensure(other.n_classes)
            self.confusion += other.confusion
            self._count += other._count
            self._top_n_correct += other._top_n_correct
        return self


class EvaluationBinary:
    """Per-output binary metrics (``EvaluationBinary``)."""

    def __init__(self, threshold: float = 0.5):
        self.threshold = threshold
        self.tp = self.fp = self.tn = self.fn = None

    def eval(self, labels, predictions, mask=None):
        labels = np.asarray(labels).reshape(-1, np.asarray(labels).shape[-1])
        preds_f = np.asarray(predictions).reshape(labels.shape)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            labels, preds_f = labels[m], preds_f[m]
        preds = (preds_f >= self.threshold).astype(int)
        lab = (labels >= 0.5).astype(int)
        if self.tp is None:
            n = labels.shape[-1]
            self.tp = np.zeros(n, np.int64)
            self.fp = np.zeros(n, np.int64)
            self.tn = np.zeros(n, np.int64)
            self.fn = np.zeros(n, np.int64)
        self.tp += ((preds == 1) & (lab == 1)).sum(0)
        self.fp += ((preds == 1) & (lab == 0)).sum(0)
        self.tn += ((preds == 0) & (lab == 0)).sum(0)
        self.fn += ((preds == 0) & (lab == 1)).sum(0)

    def accuracy(self, out: int = 0) -> float:
        tot = self.tp[out] + self.fp[out] + self.tn[out] + self.fn[out]
        return float((self.tp[out] + self.tn[out]) / max(tot, 1))

    def precision(self, out: int = 0) -> float:
        return float(self.tp[out] / max(self.tp[out] + self.fp[out], 1))

    def recall(self, out: int = 0) -> float:
        return float(self.tp[out] / max(self.tp[out] + self.fn[out], 1))

    def f1(self, out: int = 0) -> float:
        p, r = self.precision(out), self.recall(out)
        return 2 * p * r / max(p + r, 1e-12)

    def stats(self) -> str:
        n = len(self.tp)
        rows = [f"out {i}: acc={self.accuracy(i):.4f} prec={self.precision(i):.4f} "
                f"rec={self.recall(i):.4f} f1={self.f1(i):.4f}" for i in range(n)]
        return "\n".join(rows)
