"""EvaluationCalibration (``org.nd4j.evaluation.classification
.EvaluationCalibration``): reliability diagram bins, expected calibration
error, probability/residual histograms.

Accumulation is STREAMING like the rest of the eval package: per-batch
updates into fixed-size counters (per-bin sums + histogram counts) — a
million-example eval never materializes in memory.

Port of ``deeplearning4j_tpu/eval/calibration.py``: the same code, numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class EvaluationCalibration:
    """Accumulates (predicted probability, label) batches.

    ``reliability_bins`` returns, per confidence bin, the mean predicted
    probability and observed accuracy of the PREDICTED class — the
    reliability-diagram data; ``expected_calibration_error`` is the
    bin-weighted |accuracy − confidence|.
    """

    def __init__(self, n_bins: int = 10, histogram_bins: int = 20):
        self.n_bins = int(n_bins)
        self.histogram_bins = int(histogram_bins)
        self._n = 0
        self._bin_count = np.zeros(self.n_bins, np.int64)
        self._bin_conf_sum = np.zeros(self.n_bins, np.float64)
        self._bin_correct_sum = np.zeros(self.n_bins, np.float64)
        self._prob_hist = None  # [C, histogram_bins] per-class counts
        self._resid_hist = np.zeros(self.histogram_bins, np.int64)

    def eval(self, labels, predictions):
        """labels one-hot [b, C] or int [b]; predictions probs [b, C]."""
        p = np.asarray(predictions, np.float64)
        lab = np.asarray(labels)
        n_classes = p.shape[-1]
        if lab.ndim == p.ndim and lab.shape[-1] == n_classes:
            y = lab.argmax(-1)
        elif lab.ndim == p.ndim - 1 or (lab.ndim == p.ndim
                                        and lab.shape[-1] == 1):
            y = lab.reshape(len(p)).astype(np.int64)
        else:
            raise ValueError(
                f"labels shape {lab.shape} matches neither one-hot "
                f"[b, {n_classes}] nor class-index [b]")
        pred = p.argmax(-1)
        conf = p.max(-1)
        correct = (pred == y).astype(np.float64)

        idx = np.minimum((conf * self.n_bins).astype(np.int64),
                         self.n_bins - 1)
        np.add.at(self._bin_count, idx, 1)
        np.add.at(self._bin_conf_sum, idx, conf)
        np.add.at(self._bin_correct_sum, idx, correct)
        self._n += len(p)

        if self._prob_hist is None:
            self._prob_hist = np.zeros((n_classes, self.histogram_bins),
                                       np.int64)
        h_idx = np.minimum((p * self.histogram_bins).astype(np.int64),
                           self.histogram_bins - 1)
        for c in range(n_classes):
            np.add.at(self._prob_hist[c], h_idx[:, c], 1)
        onehot = np.eye(n_classes)[y]
        res = np.abs(onehot - p).reshape(-1)
        r_idx = np.minimum((res * self.histogram_bins).astype(np.int64),
                           self.histogram_bins - 1)
        np.add.at(self._resid_hist, r_idx, 1)

    # ------------------------------------------------------------------
    def _check(self):
        if self._n == 0:
            raise ValueError("eval(...) some batches first")

    def reliability_bins(self):
        self._check()
        edges = np.linspace(0.0, 1.0, self.n_bins + 1)
        rows = []
        for i in range(self.n_bins):
            n = int(self._bin_count[i])
            rows.append({
                "bin": (float(edges[i]), float(edges[i + 1])),
                "count": n,
                "mean_confidence": (self._bin_conf_sum[i] / n) if n else None,
                "accuracy": (self._bin_correct_sum[i] / n) if n else None,
            })
        return rows

    def expected_calibration_error(self) -> float:
        self._check()
        ece = 0.0
        for row in self.reliability_bins():
            if row["count"]:
                ece += (row["count"] / self._n) * abs(
                    row["accuracy"] - row["mean_confidence"])
        return float(ece)

    def probability_histogram(self, class_idx: Optional[int] = None):
        """Histogram counts of predicted probabilities (all classes
        pooled, or one class); returns (counts, edges)."""
        self._check()
        counts = (self._prob_hist.sum(0) if class_idx is None
                  else self._prob_hist[class_idx])
        edges = np.linspace(0.0, 1.0, self.histogram_bins + 1)
        return counts.tolist(), edges.tolist()

    def residual_histogram(self):
        """Histogram of |label − prob| residuals (DL4J residual plot)."""
        self._check()
        edges = np.linspace(0.0, 1.0, self.histogram_bins + 1)
        return self._resid_hist.tolist(), edges.tolist()

    def stats(self) -> str:
        return (f"EvaluationCalibration: n={self._n} "
                f"bins={self.n_bins} "
                f"ECE={self.expected_calibration_error():.4f}")
