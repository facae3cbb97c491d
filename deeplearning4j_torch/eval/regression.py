"""Regression evaluation.

Parity with ``org.nd4j.evaluation.regression.RegressionEvaluation``:
per-column MSE, MAE, RMSE, R^2, Pearson correlation — streaming.

Port of ``deeplearning4j_tpu/eval/regression.py``: the same code, numpy and
the standard library only (the port keeps its own copy).
"""
from __future__ import annotations

import numpy as np


class RegressionEvaluation:
    def __init__(self):
        self._n = 0
        self._sum_err2 = None
        self._sum_abs = None
        self._sum_l = None
        self._sum_l2 = None
        self._sum_p = None
        self._sum_p2 = None
        self._sum_lp = None

    def eval(self, labels, predictions, mask=None):
        l = np.asarray(labels, np.float64)
        p = np.asarray(predictions, np.float64)
        l = l.reshape(-1, l.shape[-1])
        p = p.reshape(-1, p.shape[-1])
        if mask is not None:
            m = np.asarray(mask).reshape(-1).astype(bool)
            l, p = l[m], p[m]
        if self._sum_err2 is None:
            n = l.shape[-1]
            z = lambda: np.zeros(n, np.float64)
            self._sum_err2, self._sum_abs = z(), z()
            self._sum_l, self._sum_l2 = z(), z()
            self._sum_p, self._sum_p2, self._sum_lp = z(), z(), z()
        e = p - l
        self._sum_err2 += (e * e).sum(0)
        self._sum_abs += np.abs(e).sum(0)
        self._sum_l += l.sum(0)
        self._sum_l2 += (l * l).sum(0)
        self._sum_p += p.sum(0)
        self._sum_p2 += (p * p).sum(0)
        self._sum_lp += (l * p).sum(0)
        self._n += l.shape[0]

    def mean_squared_error(self, col: int = 0) -> float:
        return float(self._sum_err2[col] / max(self._n, 1))

    def mean_absolute_error(self, col: int = 0) -> float:
        return float(self._sum_abs[col] / max(self._n, 1))

    def root_mean_squared_error(self, col: int = 0) -> float:
        return self.mean_squared_error(col) ** 0.5

    def r_squared(self, col: int = 0) -> float:
        n = max(self._n, 1)
        ss_tot = self._sum_l2[col] - self._sum_l[col] ** 2 / n
        ss_res = self._sum_err2[col]
        return float(1.0 - ss_res / max(ss_tot, 1e-12))

    def pearson_correlation(self, col: int = 0) -> float:
        n = max(self._n, 1)
        cov = self._sum_lp[col] - self._sum_l[col] * self._sum_p[col] / n
        vl = self._sum_l2[col] - self._sum_l[col] ** 2 / n
        vp = self._sum_p2[col] - self._sum_p[col] ** 2 / n
        return float(cov / max(np.sqrt(vl * vp), 1e-12))

    def stats(self) -> str:
        cols = len(self._sum_err2) if self._sum_err2 is not None else 0
        rows = [
            f"col {c}: MSE={self.mean_squared_error(c):.6f} "
            f"MAE={self.mean_absolute_error(c):.6f} "
            f"RMSE={self.root_mean_squared_error(c):.6f} "
            f"R^2={self.r_squared(c):.4f} "
            f"corr={self.pearson_correlation(c):.4f}"
            for c in range(cols)
        ]
        return "\n".join(rows)
