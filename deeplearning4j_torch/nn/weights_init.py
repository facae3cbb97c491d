"""Weight initialization schemes (port of
``deeplearning4j_tpu/nn/weights_init.py``).

Same DL4J ``WeightInit`` semantics (xavier = N(0, 2/(fanIn+fanOut)),
...), sampled from an explicit ``torch.Generator``.  The bits differ from
``jax.random``'s for the same seed; tests that compare the two packages
carry the weights across (``utils.convert.load_numpy_params``) instead.
"""
from __future__ import annotations

import math

import torch


def init_weights(gen: torch.Generator, shape, fan_in: float, fan_out: float,
                 scheme: str = "xavier", dtype=torch.float32,
                 distribution=None, device=None) -> torch.Tensor:
    """Sample a weight tensor per DL4J ``WeightInitUtil.initWeights`` on
    ``device`` (default: the generator's device)."""
    device = gen.device if device is None else device
    s = str(scheme).lower() if scheme is not None else "xavier"
    if s == "zero":
        return torch.zeros(shape, dtype=dtype, device=device)
    if s == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if s == "identity":
        if len(shape) != 2 or shape[0] != shape[1]:
            raise ValueError("IDENTITY init requires a square 2-D shape")
        return torch.eye(shape[0], dtype=dtype, device=device)
    if s == "distribution":
        if distribution is None:
            raise ValueError("DISTRIBUTION init requires a `distribution` spec")
        return _sample_distribution(gen, shape, distribution, dtype, device)

    def normal():
        return torch.randn(shape, generator=gen, dtype=dtype, device=device)

    def uniform():
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return 2.0 * u - 1.0

    if s in ("xavier", "var_scaling_normal_fan_avg"):
        return normal() * math.sqrt(2.0 / (fan_in + fan_out))
    if s == "xavier_uniform":
        return uniform() * math.sqrt(6.0 / (fan_in + fan_out))
    if s in ("xavier_fan_in", "lecun_normal", "normal"):
        return normal() / math.sqrt(fan_in)
    if s == "relu":
        return normal() * math.sqrt(2.0 / fan_in)
    if s == "relu_uniform":
        return uniform() * math.sqrt(6.0 / fan_in)
    if s == "lecun_uniform":
        return uniform() * math.sqrt(3.0 / fan_in)
    if s == "sigmoid_uniform":
        return uniform() * 4.0 * math.sqrt(6.0 / (fan_in + fan_out))
    if s == "uniform":
        return uniform() / math.sqrt(fan_in)
    raise ValueError(f"Unknown weight init scheme {scheme!r}")


def _sample_distribution(gen, shape, dist, dtype, device):
    """``dist`` is a dict like {"type": "normal", "mean": 0, "std": 1e-2}."""
    t = dist.get("type", "normal").lower()
    if t in ("normal", "gaussian"):
        return dist.get("mean", 0.0) + torch.randn(
            shape, generator=gen, dtype=dtype, device=device) * dist.get(
                "std", 1.0)
    if t == "uniform":
        lo, hi = dist.get("lower", -1.0), dist.get("upper", 1.0)
        u = torch.rand(shape, generator=gen, dtype=dtype, device=device)
        return lo + (hi - lo) * u
    raise ValueError(f"Unknown distribution type {t!r}")
