"""Candidate generation + the optimization loop
(``org.deeplearning4j.arbiter.optimize.runner.LocalOptimizationRunner``,
``generator.{RandomSearchGenerator,GridSearchCandidateGenerator}``,
``api.termination.MaxCandidatesCondition``).  Port of
``deeplearning4j_tpu/arbiter/runner.py``: the same code, host only; the
models the user's builder makes train wherever it puts them."""
from __future__ import annotations

import dataclasses
import itertools
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_torch.arbiter.space import ParameterSpace


class RandomSearchGenerator:
    def __init__(self, space: Dict[str, ParameterSpace], seed: int = 0):
        self.space = space
        self._rng = np.random.default_rng(seed)

    def __iter__(self):
        while True:
            yield {k: s.sample(self._rng) for k, s in self.space.items()}


class GridSearchGenerator:
    """Cartesian product over per-dimension grids
    (``GridSearchCandidateGenerator`` with discretization count)."""

    def __init__(self, space: Dict[str, ParameterSpace],
                 discretization: int = 3):
        self.space = space
        self.discretization = discretization

    def __iter__(self):
        keys = list(self.space)
        grids = [self.space[k].grid(self.discretization) for k in keys]
        for combo in itertools.product(*grids):
            yield dict(zip(keys, combo))


@dataclasses.dataclass
class OptimizationResult:
    best_candidate: Dict[str, Any]
    best_score: float
    best_model: Any
    all_results: List[Dict[str, Any]]


class OptimizationRunner:
    """Evaluate candidates sequentially (one card = one worker; a mesh
    maps candidates across hosts the same way Spark mapped Arbiter
    workers — plug a distributed executor in here later).

    ``model_builder(params) -> model`` and
    ``scorer(model, params) -> float`` are user functions;
    ``maximize=True`` for accuracy-style scores.
    """

    def __init__(self, generator, model_builder: Callable,
                 scorer: Callable, max_candidates: int = 10,
                 maximize: bool = True,
                 timeout_seconds: Optional[float] = None):
        self.generator = generator
        self.model_builder = model_builder
        self.scorer = scorer
        self.max_candidates = int(max_candidates)
        self.maximize = maximize
        self.timeout_seconds = timeout_seconds

    def execute(self) -> OptimizationResult:
        best_score = -np.inf if self.maximize else np.inf
        best_params, best_model = None, None
        results = []
        t0 = time.perf_counter()
        for i, params in enumerate(self.generator):
            if i >= self.max_candidates:
                break
            if (self.timeout_seconds is not None
                    and time.perf_counter() - t0 > self.timeout_seconds):
                break
            model = self.model_builder(params)
            score = float(self.scorer(model, params))
            results.append({"candidate": params, "score": score})
            better = (score > best_score if self.maximize
                      else score < best_score)
            if better:
                best_score, best_params, best_model = score, params, model
        if best_params is None:
            if results:
                raise ValueError(
                    f"All {len(results)} candidate scores were NaN — "
                    "the scorer diverged on every configuration")
            raise ValueError("No candidates were evaluated")
        return OptimizationResult(best_params, best_score, best_model,
                                  results)
