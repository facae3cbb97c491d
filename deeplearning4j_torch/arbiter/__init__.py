"""Hyperparameter optimization (port of ``deeplearning4j_tpu.arbiter``;
Arbiter: ``arbiter-core``/
``arbiter-deeplearning4j`` — ``ParameterSpace``, random/grid
``CandidateGenerator``, ``OptimizationRunner``).

A search space is a dict of named ParameterSpace objects; the model
builder is a plain function of the sampled values (the
``MultiLayerSpace`` indirection dissolves — configs here are already
Python).
"""
from deeplearning4j_torch.arbiter.space import (ContinuousParameterSpace,
                                              DiscreteParameterSpace,
                                              IntegerParameterSpace,
                                              ParameterSpace)
from deeplearning4j_torch.arbiter.runner import (GridSearchGenerator,
                                               OptimizationResult,
                                               OptimizationRunner,
                                               RandomSearchGenerator)

__all__ = ["ParameterSpace", "ContinuousParameterSpace",
           "IntegerParameterSpace", "DiscreteParameterSpace",
           "RandomSearchGenerator", "GridSearchGenerator",
           "OptimizationRunner", "OptimizationResult"]
