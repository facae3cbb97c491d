"""Parameter spaces (``org.deeplearning4j.arbiter.optimize.parameter.*``:
ContinuousParameterSpace, IntegerParameterSpace, DiscreteParameterSpace)
with optional log-uniform sampling for scale-free hyperparameters.  Port
of ``deeplearning4j_tpu/arbiter/space.py``: the same code, host only
(candidates come from numpy's generator)."""
from __future__ import annotations

import dataclasses
import math
from typing import Any, List, Sequence

import numpy as np


class ParameterSpace:
    def sample(self, rng: np.random.Generator):
        raise NotImplementedError

    def grid(self, n: int) -> List[Any]:
        """n representative values for grid search."""
        raise NotImplementedError


@dataclasses.dataclass
class ContinuousParameterSpace(ParameterSpace):
    low: float
    high: float
    log_scale: bool = False

    def sample(self, rng):
        if self.log_scale:
            return float(math.exp(rng.uniform(math.log(self.low),
                                              math.log(self.high))))
        return float(rng.uniform(self.low, self.high))

    def grid(self, n):
        if self.log_scale:
            return np.exp(np.linspace(math.log(self.low),
                                      math.log(self.high), n)).tolist()
        return np.linspace(self.low, self.high, n).tolist()


@dataclasses.dataclass
class IntegerParameterSpace(ParameterSpace):
    low: int
    high: int  # inclusive

    def sample(self, rng):
        return int(rng.integers(self.low, self.high + 1))

    def grid(self, n):
        return sorted({int(round(v)) for v in
                       np.linspace(self.low, self.high, n)})


@dataclasses.dataclass
class DiscreteParameterSpace(ParameterSpace):
    values: Sequence[Any]

    def sample(self, rng):
        return self.values[int(rng.integers(0, len(self.values)))]

    def grid(self, n):
        return list(self.values)
