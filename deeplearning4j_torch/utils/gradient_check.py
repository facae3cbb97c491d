"""Numerical gradient checking (port of
``deeplearning4j_tpu/utils/gradient_check.py``).

Parity with ``org.deeplearning4j.gradientcheck.GradientCheckUtil``:
centred finite differences against the analytic gradient, in float64,
on a parameter SUBSET by default (``max_per_param=None`` sweeps every
entry).  The analytic side is ``torch.autograd`` through the model's
score function, so what this vets is each layer's forward and every
hand-written backward on the way (``_Flash``'s plain K5/K6 math among
them), kinks, detached paths and dtype truncation.  It runs on the CPU:
the parameters and the batch are copied there in float64, and the
model's compute dtype is float64 for the duration.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from deeplearning4j_torch.utils.trees import (deep_copy_dicts, iter_leaves,
                                              map_leaves, set_path)


@dataclasses.dataclass
class GradCheckFailure:
    path: str
    index: int
    analytic: float
    numeric: float
    rel_error: float


@dataclasses.dataclass
class GradCheckResult:
    passed: bool
    max_rel_error: float
    n_checked: int
    failures: List[GradCheckFailure]

    def __bool__(self):
        return self.passed


def _to64(x):
    """A float64 CPU copy of a floating tensor (others: on the CPU)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu")
        return x.to(torch.float64) if x.is_floating_point() else x
    if isinstance(x, dict):
        return {k: _to64(v) for k, v in x.items()}
    return x


def check_model_gradients(
    model,
    ds,
    epsilon: float = 1e-6,
    max_rel_error: float = 1e-5,
    min_abs_error: float = 1e-8,
    max_per_param: Optional[int] = 32,
    seed: int = 0,
) -> GradCheckResult:
    """Centred finite differences vs ``torch.autograd`` on the model's
    score (regularization included), double precision.

    DL4J semantics: relative error |a - n| / max(|a|, |n|); a check
    passes if relError < maxRelError OR |a - n| < minAbsoluteError.  The
    batch goes through the model's ``_batch_dict`` (so its floats are
    the model's float32 values) and is then widened to float64.
    """
    model._check_init()
    compute_was = model._compute_dtype
    model._compute_dtype = torch.float64
    try:
        batch = _to64(model._batch_dict(ds))
        state64 = map_leaves(_to64, model.state_tree)
        base = map_leaves(_to64, model.params_tree)

        def loss_fn(params):
            loss, _ = model._score_batch(params, state64, batch, None, False)
            return loss

        paths = [p for p, _ in iter_leaves(base)]
        leaves = [leaf.clone().requires_grad_(True)
                  for _, leaf in iter_leaves(base)]
        live = deep_copy_dicts(base)
        for path, leaf in zip(paths, leaves):
            set_path(live, path, leaf)
        with torch.enable_grad():
            grads = torch.autograd.grad(loss_fn(live), leaves,
                                        allow_unused=True)

        rng = np.random.default_rng(seed)
        failures: List[GradCheckFailure] = []
        max_err = 0.0
        n_checked = 0
        with torch.no_grad():
            for path, leaf, g in zip(paths, leaves, grads):
                flat = leaf.detach().reshape(-1)
                n = flat.numel()
                if n == 0:
                    continue
                g = (torch.zeros(n, dtype=torch.float64) if g is None
                     else g.reshape(-1))
                idxs = (np.arange(n)
                        if max_per_param is None or n <= max_per_param
                        else rng.choice(n, size=max_per_param,
                                        replace=False))
                probe = deep_copy_dicts(base)
                for i in idxs:
                    scores = []
                    for sign in (+1, -1):
                        pert = flat.clone()
                        pert[i] += sign * epsilon
                        set_path(probe, path, pert.reshape(leaf.shape))
                        scores.append(float(loss_fn(probe)))
                    numeric = (scores[0] - scores[1]) / (2 * epsilon)
                    analytic = float(g[i])
                    denom = max(abs(analytic), abs(numeric))
                    rel = (0.0 if denom == 0
                           else abs(analytic - numeric) / denom)
                    n_checked += 1
                    max_err = max(max_err, rel)
                    if rel > max_rel_error and \
                            abs(analytic - numeric) > min_abs_error:
                        failures.append(GradCheckFailure(
                            "/".join(path), int(i), analytic, numeric, rel))
        return GradCheckResult(not failures, max_err, n_checked, failures)
    finally:
        model._compute_dtype = compute_was
