"""Updaters (optimizers) over dicts of tensors (port of
``deeplearning4j_tpu/optimize/updaters.py``: ``NoOp``, ``Sgd``,
``Nesterovs``, ``Adam``, ``AdamW``, ``AdaDelta``).

The reference's math, not ``torch.optim``'s:

* Adam is DL4J's form: ``alpha_t = lr * sqrt(1 - b2^t) / (1 - b1^t)``
  applied to the raw moments, ``u = alpha_t * m / (sqrt(v) + eps)`` —
  eps sits outside the bias-corrected sqrt, where ``torch.optim.Adam``
  puts it inside (``m_hat / (sqrt(v_hat) + eps)``); the two differ
  whenever eps matters.  ``alpha_t`` is computed in float32, as the
  reference's traced step computes it;
* Nesterovs applies ``params += mu * v' - lr * g`` with
  ``v' = mu * v - lr * g`` (DL4J's look-ahead step);
* AdaDelta (the zoo CNNs' default) ignores the learning rate and keeps
  two running averages, ``g2`` of g^2 and ``dx2`` of the updates^2, with
  eps inside both square roots.

``update(grads, state, params, step) -> (updates, new_state)`` is
functional (new tensors; ``new_params = params - updates``), so the
solver can select the old state on a non-finite step.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from deeplearning4j_torch.optimize.schedules import schedule_from_spec
from deeplearning4j_torch.utils.trees import map_leaves

_UPDATER_REGISTRY: Dict[str, type] = {}


def register_updater(cls):
    _UPDATER_REGISTRY[cls.__name__] = cls
    return cls


def updater_from_dict(d) -> "BaseUpdater":
    if d is None:
        return Sgd()
    if isinstance(d, BaseUpdater):
        return d
    d = dict(d)
    type_name = d.pop("type")
    cls = _UPDATER_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown updater type {type_name!r} (not ported "
                         f"to deeplearning4j_torch yet); available: "
                         f"{sorted(_UPDATER_REGISTRY)}")
    return cls(**d)


def _zeros_like(params):
    return map_leaves(torch.zeros_like, params)


@dataclasses.dataclass
class BaseUpdater:
    learning_rate: Any = 0.1  # float or schedule spec dict

    def to_dict(self):
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            d[f.name] = getattr(self, f.name)
        return d

    def lr_at(self, step) -> float:
        return float(schedule_from_spec(self.learning_rate)(step))

    def init_state(self, params):
        return {}

    def update(self, grads, state, params, step):
        raise NotImplementedError

    def finalize(self, state, new_params):
        """Hook called after the final parameters are computed (after
        decoupled weight decay) — the reference's Ema hook point."""
        return state


@register_updater
@dataclasses.dataclass
class NoOp(BaseUpdater):
    def update(self, grads, state, params, step):
        return map_leaves(torch.zeros_like, grads), state


@register_updater
@dataclasses.dataclass
class Sgd(BaseUpdater):
    def update(self, grads, state, params, step):
        lr = self.lr_at(step)
        return map_leaves(lambda g: lr * g, grads), state


@register_updater
@dataclasses.dataclass
class Nesterovs(BaseUpdater):
    learning_rate: Any = 0.1
    momentum: float = 0.9

    def init_state(self, params):
        return {"v": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr, mu = self.lr_at(step), self.momentum
        v_new = map_leaves(lambda v, g: mu * v - lr * g, state["v"], grads)
        # DL4J NesterovsUpdater: params += mu * v_new - lr * g
        updates = map_leaves(lambda vn, g: -(mu * vn - lr * g), v_new, grads)
        return updates, {"v": v_new}


@register_updater
@dataclasses.dataclass
class Adam(BaseUpdater):
    learning_rate: Any = 1e-3
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params)}

    def alpha(self, step) -> float:
        """DL4J's bias-corrected step size, in float32 as the reference
        computes it: lr * sqrt(1 - b2^t) / (1 - b1^t), t = step + 1."""
        f = np.float32
        t = f(step + 1)
        return float(f(self.lr_at(step)) * np.sqrt(f(1) - f(self.beta2) ** t)
                     / (f(1) - f(self.beta1) ** t))

    def update(self, grads, state, params, step):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = map_leaves(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = map_leaves(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                       grads)
        alpha = self.alpha(step)
        updates = map_leaves(lambda m, v: alpha * m / (torch.sqrt(v) + eps),
                             m, v)
        return updates, {"m": m, "v": v}


@register_updater
@dataclasses.dataclass
class AdamW(Adam):
    weight_decay: float = 1e-2

    def update(self, grads, state, params, step):
        updates, st = super().update(grads, state, params, step)
        lr, wd = self.lr_at(step), self.weight_decay
        updates = map_leaves(lambda u, p: u + lr * wd * p, updates, params)
        return updates, st


@register_updater
@dataclasses.dataclass
class AdaDelta(BaseUpdater):
    learning_rate: Any = 1.0  # unused by the algorithm; kept for interface
    rho: float = 0.95
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"g2": _zeros_like(params), "dx2": _zeros_like(params)}

    def update(self, grads, state, params, step):
        rho, eps = self.rho, self.epsilon
        g2 = map_leaves(lambda a, g: rho * a + (1 - rho) * g * g,
                        state["g2"], grads)
        dx = map_leaves(lambda g, a, d: g * torch.sqrt(d + eps)
                        / torch.sqrt(a + eps), grads, g2, state["dx2"])
        dx2 = map_leaves(lambda d, x: rho * d + (1 - rho) * x * x,
                         state["dx2"], dx)
        return dx, {"g2": g2, "dx2": dx2}
