"""ROC / AUC evaluation.

Parity with ``org.nd4j.evaluation.classification.{ROC,ROCMultiClass}``.
DL4J supports exact mode (store all probabilities) and thresholded
histogram mode; both are provided — histogram mode keeps memory constant
for large eval sets.

Port of ``deeplearning4j_tpu/eval/roc.py``: the same code, numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

from typing import Optional

import numpy as np


class ROC:
    """Binary ROC.  exact=False uses `n_bins` probability histogram bins
    (DL4J's thresholded mode, default 30 steps)."""

    def __init__(self, exact: bool = True, n_bins: int = 200):
        self.exact = exact
        self.n_bins = n_bins
        self._scores = []
        self._labels = []
        self._pos_hist = np.zeros(n_bins, np.int64)
        self._neg_hist = np.zeros(n_bins, np.int64)

    def eval(self, labels, predictions, mask=None):
        l = np.asarray(labels).reshape(-1)
        p = np.asarray(predictions).reshape(-1)
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            l, p = l[m], p[m]
        if self.exact:
            self._labels.append(l >= 0.5)
            self._scores.append(p)
        else:
            bins = np.clip((p * self.n_bins).astype(int), 0, self.n_bins - 1)
            pos = l >= 0.5
            np.add.at(self._pos_hist, bins[pos], 1)
            np.add.at(self._neg_hist, bins[~pos], 1)

    def _curve(self):
        if self.exact:
            y = np.concatenate(self._labels)
            s = np.concatenate(self._scores)
            order = np.argsort(-s, kind="stable")
            y = y[order]
            tps = np.cumsum(y)
            fps = np.cumsum(~y)
            P, N = max(tps[-1], 1), max(fps[-1], 1)
            tpr = np.concatenate([[0], tps / P])
            fpr = np.concatenate([[0], fps / N])
            return fpr, tpr
        # histogram mode: sweep thresholds from high to low bins
        pos = self._pos_hist[::-1].cumsum()
        neg = self._neg_hist[::-1].cumsum()
        P, N = max(pos[-1], 1), max(neg[-1], 1)
        tpr = np.concatenate([[0], pos / P])
        fpr = np.concatenate([[0], neg / N])
        return fpr, tpr

    def calculate_auc(self) -> float:
        fpr, tpr = self._curve()
        return float(np.trapezoid(tpr, fpr))

    def calculate_auprc(self) -> float:
        if not self.exact:
            pos = self._pos_hist[::-1].cumsum()
            neg = self._neg_hist[::-1].cumsum()
            P = max(pos[-1], 1)
            recall = pos / P
            precision = pos / np.maximum(pos + neg, 1)
            return float(np.trapezoid(precision, recall))
        y = np.concatenate(self._labels)
        s = np.concatenate(self._scores)
        order = np.argsort(-s, kind="stable")
        y = y[order]
        tps = np.cumsum(y)
        P = max(tps[-1], 1)
        precision = tps / (np.arange(len(y)) + 1)
        recall = tps / P
        return float(np.trapezoid(precision, recall))


class ROCMultiClass:
    """One-vs-all ROC per class (``ROCMultiClass``)."""

    def __init__(self, exact: bool = True, n_bins: int = 200):
        self.exact = exact
        self.n_bins = n_bins
        self._rocs: Optional[list] = None

    def eval(self, labels, predictions, mask=None):
        l = np.asarray(labels)
        p = np.asarray(predictions)
        l = l.reshape(-1, l.shape[-1])
        p = p.reshape(-1, p.shape[-1])
        if self._rocs is None:
            self._rocs = [ROC(self.exact, self.n_bins) for _ in range(l.shape[-1])]
        for c, roc in enumerate(self._rocs):
            roc.eval(l[:, c], p[:, c], mask)

    def calculate_auc(self, cls: int) -> float:
        return self._rocs[cls].calculate_auc()

    def calculate_average_auc(self) -> float:
        return float(np.mean([r.calculate_auc() for r in self._rocs]))
