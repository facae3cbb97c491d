"""Updaters (optimizers) over dicts of tensors (port of
``deeplearning4j_tpu/optimize/updaters.py``: ``NoOp``, ``Sgd``,
``Nesterovs``, ``Adam``, ``AdamW``, ``AMSGrad``, ``Nadam``, ``AdaMax``,
``RmsProp``, ``AdaGrad``, ``AdaDelta`` and the ``Ema`` wrapper), under
the reference's type names, so ``updater_from_dict`` reads every
configuration JSON the JAX package writes.

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
  eps inside both square roots;
* AdaGrad puts eps inside the square root, RmsProp outside it;
* the bias corrections of AMSGrad, Nadam and AdaMax are computed in
  float32 on the host, as the reference's traced step computes them.

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
        raise ValueError(f"Unknown updater type {type_name!r}; "
                         f"available: {sorted(_UPDATER_REGISTRY)}")
    return cls(**d)


def _zeros_like(params):
    return map_leaves(torch.zeros_like, params)


def _f32_pow(base: float, step) -> np.float32:
    """``base ** t`` in float32, t = step + 1 (the reference's traced
    ``b ** t`` with t a float32 array)."""
    return np.float32(base) ** np.float32(step + 1)


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

    def _moments(self, grads, state):
        b1, b2 = self.beta1, self.beta2
        m = map_leaves(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        v = map_leaves(lambda v, g: b2 * v + (1 - b2) * g * g, state["v"],
                       grads)
        return m, v

    def update(self, grads, state, params, step):
        eps = self.epsilon
        m, v = self._moments(grads, state)
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
class AMSGrad(Adam):
    """Adam over the running maximum of the second moment."""

    def init_state(self, params):
        return {"m": _zeros_like(params), "v": _zeros_like(params),
                "vhat": _zeros_like(params)}

    def update(self, grads, state, params, step):
        eps = self.epsilon
        m, v = self._moments(grads, state)
        vhat = map_leaves(torch.maximum, state["vhat"], v)
        alpha = self.alpha(step)
        updates = map_leaves(lambda m, vh: alpha * m / (torch.sqrt(vh) + eps),
                             m, vhat)
        return updates, {"m": m, "v": v, "vhat": vhat}


@register_updater
@dataclasses.dataclass
class Nadam(Adam):
    """Adam with Nesterov momentum on the bias-corrected first moment."""

    def update(self, grads, state, params, step):
        lr, b1, eps = self.lr_at(step), self.beta1, self.epsilon
        m, v = self._moments(grads, state)
        f = np.float32
        mc = float(f(1.0) / (f(1) - _f32_pow(b1, step)))
        vc = float(f(1.0) / (f(1) - _f32_pow(self.beta2, step)))
        updates = map_leaves(
            lambda m, v, g: lr * (b1 * m * mc + (1 - b1) * g * mc)
            / (torch.sqrt(v * vc) + eps), m, v, grads)
        return updates, {"m": m, "v": v}


@register_updater
@dataclasses.dataclass
class AdaMax(Adam):
    """Adam with the infinity norm in place of the second moment."""

    def init_state(self, params):
        return {"m": _zeros_like(params), "u": _zeros_like(params)}

    def update(self, grads, state, params, step):
        b1, b2, eps = self.beta1, self.beta2, self.epsilon
        m = map_leaves(lambda m, g: b1 * m + (1 - b1) * g, state["m"], grads)
        u = map_leaves(lambda u, g: torch.maximum(b2 * u, torch.abs(g)),
                       state["u"], grads)
        alpha = float(np.float32(self.lr_at(step))
                      / (np.float32(1) - _f32_pow(b1, step)))
        updates = map_leaves(lambda m, u: alpha * m / (u + eps), m, u)
        return updates, {"m": m, "u": u}


@register_updater
@dataclasses.dataclass
class RmsProp(BaseUpdater):
    learning_rate: Any = 1e-1
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, params):
        return {"g2": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr, d, eps = self.lr_at(step), self.rms_decay, self.epsilon
        g2 = map_leaves(lambda a, g: d * a + (1 - d) * g * g, state["g2"],
                        grads)
        updates = map_leaves(lambda g, a: lr * g / (torch.sqrt(a) + eps),
                             grads, g2)
        return updates, {"g2": g2}


@register_updater
@dataclasses.dataclass
class AdaGrad(BaseUpdater):
    learning_rate: Any = 1e-1
    epsilon: float = 1e-6

    def init_state(self, params):
        return {"g2": _zeros_like(params)}

    def update(self, grads, state, params, step):
        lr, eps = self.lr_at(step), self.epsilon
        g2 = map_leaves(lambda a, g: a + g * g, state["g2"], grads)
        updates = map_leaves(lambda g, a: lr * g / torch.sqrt(a + eps),
                             grads, g2)
        return updates, {"g2": g2}


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


@register_updater
@dataclasses.dataclass
class Ema(BaseUpdater):
    """Wrapper keeping an exponential moving average of the PARAMETERS in
    the optimizer state (``{"base": <base state>, "ema": params-like}``).
    Wraps any base updater; ``decay=0`` tracks the raw parameters.  Fetch
    the averaged weights with ``Ema.params_from_state(opt_state)``."""

    base: Any = None        # BaseUpdater | serialized dict | None=Sgd
    decay: float = 0.999

    def _resolved(self) -> BaseUpdater:
        return updater_from_dict(self.base)

    def to_dict(self):
        d = super().to_dict()
        if isinstance(d.get("base"), BaseUpdater):
            d["base"] = d["base"].to_dict()
        return d

    def lr_at(self, step) -> float:
        return self._resolved().lr_at(step)

    def init_state(self, params):
        # a copy, not the live tensors: the solver updates params in place
        return {"base": self._resolved().init_state(params),
                "ema": map_leaves(lambda p: p.detach().clone(), params)}

    def update(self, grads, state, params, step):
        updates, base_state = self._resolved().update(
            grads, state["base"], params, step)
        # the average advances in finalize(), after the solver has folded
        # decoupled weight decay into the update
        return updates, {"base": base_state, "ema": state["ema"]}

    def finalize(self, state, new_params):
        d = self.decay
        ema = map_leaves(lambda e, p: d * e + (1 - d) * p, state["ema"],
                         new_params)
        return {"base": state["base"], "ema": ema}

    @staticmethod
    def params_from_state(opt_state):
        """The averaged parameter tree held in the optimizer state."""
        return opt_state["ema"]
