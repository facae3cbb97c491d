"""Activation functions by DL4J enum name (port of
``deeplearning4j_tpu/nn/activations.py``).

Parity traps with the JAX package:

* ``"gelu"`` there is ``jax.nn.gelu``, whose default is the TANH
  approximation — so here it is ``F.gelu(approximate="tanh")``, not
  torch's default erf form;
* ``"hardsigmoid"`` is ``jax.nn.hard_sigmoid`` = relu6(x + 3) / 6, which
  is what ``F.hardsigmoid`` computes.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _rational_tanh(x):
    # tanh approximation from DL4J's RATIONALTANH (Anguita et al.)
    a = 1.7159
    y = a * _rational_core((2.0 / 3.0) * x)
    return torch.clamp(y, -a, a)


def _rational_core(x):
    ax = torch.abs(x)
    return torch.sign(x) * (1.0 - 1.0 / (1.0 + ax + x * x + 1.41645 * x**4))


ACTIVATIONS = {
    "identity": lambda x: x,
    "relu": F.relu,
    "relu6": lambda x: torch.clamp(x, 0.0, 6.0),
    "leakyrelu": lambda x: F.leaky_relu(x, 0.01),
    "elu": F.elu,
    "selu": F.selu,
    "celu": F.celu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "sigmoid": torch.sigmoid,
    "hardsigmoid": F.hardsigmoid,
    "hardtanh": lambda x: torch.clamp(x, -1.0, 1.0),
    "tanh": torch.tanh,
    "rationaltanh": _rational_tanh,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "logsoftmax": lambda x: torch.log_softmax(x, dim=-1),
    "softplus": F.softplus,
    "softsign": F.softsign,
    "swish": F.silu,
    "mish": lambda x: x * torch.tanh(F.softplus(x)),
    "cube": lambda x: x**3,
    "thresholdedrelu": lambda x: torch.where(x > 1.0, x,
                                             torch.zeros_like(x)),
}


def get_activation(name: str):
    """Look up an activation by DL4J enum name (case-insensitive)."""
    fn = ACTIVATIONS.get(str(name).lower())
    if fn is None:
        raise ValueError(
            f"Unknown activation {name!r}; available: {sorted(ACTIVATIONS)}"
        )
    return fn
