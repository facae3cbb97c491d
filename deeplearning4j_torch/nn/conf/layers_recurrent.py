"""Recurrent layer configs (port of
``deeplearning4j_tpu/nn/conf/layers_recurrent.py``): ``LSTM``,
``GravesLSTM``, ``GRU``, ``SimpleRnn``, the ``Bidirectional`` and
``LastTimeStep`` wrappers, ``RnnOutputLayer``, and the helpers
``strip_rnn_carry``, ``reverse_sequence`` and ``last_time_step``.

The recurrence mirrors the reference's math op for op:

* the input projection of every timestep is hoisted out of the
  recurrence — one [b·t, n_in] x [n_in, 4h] ``torch.matmul``;
* a Python loop over the time steps does the [b, h] x [h, 4h] product
  and the gate arithmetic (the reference's ``lax.scan`` body); it makes
  no host sync;
* masked timesteps HOLD the carried state and emit zeros (DL4J masking
  semantics), as multiplies by the [b] mask column;
* dtype points as the reference's: x, W and R cast to the compute
  dtype, ``x @ W`` cast back to the parameter dtype, ``h_prev`` cast to
  W's dtype before ``@ R``.

No library RNN stands in for it: ``torch.nn.LSTM`` and cuDNN keep a
second bias and have no peepholes for ``GravesLSTM``.

Sequences are [batch, time, features].  The carry (keys ``rnn_h`` /
``rnn_c``) is the layer's STATE (``HAS_STATE``): ``apply`` starts from
the carry in ``state`` when its batch size matches, else from zeros, and
returns the final carry in the new state — how tBPTT chunks and
``rnn_time_step`` continue a sequence.  The carry is batch-sized, so the
networks strip it between independent batches (``strip_rnn_carry``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_torch.nn.activations import get_activation
from deeplearning4j_torch.nn.conf.base import (BaseLayerConf, apply_layer,
                                               layer_from_dict,
                                               register_layer)
from deeplearning4j_torch.nn.conf.layers_core import (OutputLayer,
                                                      apply_dropout)
from deeplearning4j_torch.nn.weights_init import init_weights


def strip_rnn_carry(state_tree):
    """Drop batch-sized recurrent carries (keys ``rnn_*``) from a state
    tree — between independent batches, so no state leaks across them."""
    if isinstance(state_tree, dict):
        return {k: strip_rnn_carry(v) for k, v in state_tree.items()
                if not k.startswith("rnn_")}
    return state_tree


class BaseRecurrentConf(BaseLayerConf):
    """Shared recurrent plumbing; subclasses define the cell math."""

    IS_RNN = True
    USES_MASK = True
    HAS_STATE = True
    WANTED_KINDS = ("rnn",)
    OUTPUT_KIND = "rnn"
    # the state keys of the carry
    CARRY_KEYS = ("rnn_h",)
    # gates in the fused projection (4 for an LSTM's i, f, g, o)
    N_GATES = 1

    def infer_shapes(self, input_shape):
        t, f = input_shape
        if self.n_in is None:
            self.n_in = int(f)
        return (t, self.n_out)

    def param_shapes(self):
        g = self.N_GATES * self.n_out
        return {"W": (self.n_in, g), "R": (self.n_out, g), "b": (g,)}

    def init(self, gen, dtype=torch.float32, device=None):
        g = self.N_GATES * self.n_out
        w = init_weights(gen, (self.n_in, g), self.n_in, g, self.weight_init,
                         dtype, self.weight_distribution, device)
        r = init_weights(gen, (self.n_out, g), self.n_out, g,
                         self.weight_init, dtype, self.weight_distribution,
                         device)
        return {"W": w, "R": r,
                "b": torch.zeros((g,), dtype=dtype, device=w.device)}

    def carry_init(self, batch: int, dtype, device):
        """The zero carry of a fresh sequence."""
        return {k: torch.zeros((batch, self.n_out), dtype=dtype,
                               device=device) for k in self.CARRY_KEYS}

    def regularized_param_names(self):
        return ("W", "R")

    def apply(self, params, state, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        """x: [b, t, f] -> ([b, t, h], new state): the carry in ``state``
        continues when its batch size matches, else zeros; the final
        carry goes into the new state."""
        b = x.shape[0]
        w = params["W"]
        carry = {k: state[k] for k in self.CARRY_KEYS if k in state}
        if not carry or next(iter(carry.values())).shape[0] != b:
            carry = self.carry_init(b, w.dtype, w.device)
        y, new_carry = self.apply_seq(params, x, carry, mask, compute_dtype)
        new_state = dict(state)
        new_state.update(new_carry)
        return apply_dropout(y, self.dropout, training, rng), new_state

    def _projection(self, params, x, compute_dtype):
        """(x @ W + b as [t, b, g] in the parameter dtype, R), the
        operands in the compute dtype."""
        dtype = params["W"].dtype
        w, r = params["W"], params["R"]
        if compute_dtype is not None:
            x, w, r = (a.to(compute_dtype) for a in (x, w, r))
        xz = (x @ w).to(dtype) + params["b"]
        return xz.transpose(0, 1), r

    def apply_seq(self, params, x, carry, mask, compute_dtype):
        """([b, t, h] outputs, final carry) from ``carry``."""
        dtype = params["W"].dtype
        xz, r = self._projection(params, x, compute_dtype)
        mask_t = None if mask is None else mask.transpose(0, 1)
        state = [carry[k] for k in self.CARRY_KEYS]
        ys = []
        for s in range(xz.shape[0]):
            new = self._cell(xz[s], state, params, r, dtype)
            if mask_t is None:
                ys.append(new[0])
            else:
                mm = mask_t[s][:, None].to(new[0].dtype)
                new = [n * mm + o * (1 - mm) for n, o in zip(new, state)]
                ys.append(new[0] * mm)
            state = new
        return (torch.stack(ys, dim=1),
                dict(zip(self.CARRY_KEYS, state)))

    def _cell(self, z_x, state, params, r, dtype):
        """The new carry list (hidden first) of one step from its input
        projection ``z_x`` [b, g] and the carry list ``state``."""
        raise NotImplementedError


def _recurrent(h_prev, r, dtype):
    """h_prev @ R: h_prev cast to R's (compute) dtype, the product cast
    back to the parameter dtype."""
    return (h_prev.to(r.dtype) @ r).to(dtype)


@register_layer
@dataclasses.dataclass
class LSTM(BaseRecurrentConf):
    """LSTM without peepholes (``org.deeplearning4j.nn.conf.layers.LSTM``).
    Gate layout in the fused [.., 4h] projection: input, forget, cell
    (g), output; ``forget_gate_bias_init`` (default 1.0, as upstream)
    fills the forget slice [h:2h] of the bias."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    # DL4J's LSTM default activation is tanh (not the global default)
    activation: Optional[str] = "tanh"
    forget_gate_bias_init: float = 1.0
    gate_activation: str = "sigmoid"

    CARRY_KEYS = ("rnn_h", "rnn_c")
    N_GATES = 4

    def init(self, gen, dtype=torch.float32, device=None):
        params = super().init(gen, dtype, device)
        h = self.n_out
        params["b"][h:2 * h] = self.forget_gate_bias_init
        return params

    def _gates(self, z, c_prev, params, sigma, act):
        h = self.n_out
        return (sigma(z[:, :h]), sigma(z[:, h:2 * h]),
                act(z[:, 2 * h:3 * h]), z[:, 3 * h:])

    def _peep_o(self, o_pre, c_new, params):
        return o_pre

    def _cell(self, z_x, state, params, r, dtype):
        sigma = get_activation(self.gate_activation)
        act = get_activation(self.activation or "tanh")
        z = z_x + _recurrent(state[0], r, dtype)
        c_prev = state[1]
        i, f, g, o_pre = self._gates(z, c_prev, params, sigma, act)
        c_new = f * c_prev + i * g
        o = sigma(self._peep_o(o_pre, c_new, params))
        return [o * act(c_new), c_new]


@register_layer
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """Peephole LSTM per Graves (2013) — upstream ``GravesLSTM``, the
    char-RNN baseline layer.  ``P`` [3, h] holds the peepholes: i and f
    see c_{t-1}, o sees c_t."""

    def param_shapes(self):
        return {**super().param_shapes(), "P": (3, self.n_out)}

    def init(self, gen, dtype=torch.float32, device=None):
        params = super().init(gen, dtype, device)
        params["P"] = torch.zeros((3, self.n_out), dtype=dtype,
                                  device=params["W"].device)
        return params

    def _gates(self, z, c_prev, params, sigma, act):
        h = self.n_out
        p = params["P"].to(z.dtype)
        return (sigma(z[:, :h] + p[0] * c_prev),
                sigma(z[:, h:2 * h] + p[1] * c_prev),
                act(z[:, 2 * h:3 * h]), z[:, 3 * h:])

    def _peep_o(self, o_pre, c_new, params):
        return o_pre + params["P"].to(o_pre.dtype)[2] * c_new


@register_layer
@dataclasses.dataclass
class GRU(BaseRecurrentConf):
    """GRU (libnd4j ``gruCell``).  Gate layout [.., 3h]: reset, update,
    candidate; the reset gate scales the candidate third of ``h @ R``,
    and h = u·h_prev + (1 − u)·c."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: Optional[str] = "tanh"
    gate_activation: str = "sigmoid"

    N_GATES = 3

    def _cell(self, z_x, state, params, r, dtype):
        sigma = get_activation(self.gate_activation)
        act = get_activation(self.activation or "tanh")
        h = self.n_out
        h_prev = state[0]
        hz = _recurrent(h_prev, r, dtype)
        rg = sigma(z_x[:, :h] + hz[:, :h])
        ug = sigma(z_x[:, h:2 * h] + hz[:, h:2 * h])
        cand = act(z_x[:, 2 * h:] + rg * hz[:, 2 * h:])
        return [ug * h_prev + (1 - ug) * cand]


@register_layer
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentConf):
    """Elman RNN (``...conf.layers.recurrent.SimpleRnn``):
    h_t = act(x_t W + h_{t-1} R + b)."""

    n_in: Optional[int] = None
    n_out: Optional[int] = None
    activation: Optional[str] = "tanh"

    def _cell(self, z_x, state, params, r, dtype):
        return [get_activation(self.activation or "tanh")(
            z_x + _recurrent(state[0], r, dtype))]


def reverse_sequence(x, mask):
    """Mask-aware time reversal: each example's VALID prefix is reversed
    in place and the padding stays at the end (DL4J
    ``ReverseTimeSeriesVertex`` with a mask; a plain flip without)."""
    if mask is None:
        return torch.flip(x, dims=(1,))
    t = x.shape[1]
    lengths = mask.to(torch.int64).sum(dim=1, keepdim=True)       # [b, 1]
    ar = torch.arange(t, device=x.device)[None, :]                # [1, t]
    idx = torch.where(ar < lengths, lengths - 1 - ar, ar)
    if x.dim() == 3:
        idx = idx[..., None].expand(-1, -1, x.shape[2])
    return torch.gather(x, 1, idx)


def last_time_step(x, mask):
    """[b, t, h] -> [b, h] at each example's last valid timestep."""
    if mask is None:
        return x[:, -1]
    idx = torch.clamp(mask.to(torch.int64).sum(dim=1) - 1, min=0)
    return x[torch.arange(x.shape[0], device=x.device), idx]


def _nested(layer):
    """A wrapped layer given as its ``to_dict`` (a configuration read
    from JSON) becomes the layer."""
    return layer_from_dict(layer) if isinstance(layer, dict) else layer


@register_layer
@dataclasses.dataclass
class Bidirectional(BaseLayerConf):
    """Bidirectional wrapper (``...conf.layers.recurrent.Bidirectional``):
    the wrapped recurrent layer runs forward and (mask-aware) reversed,
    each direction from a zero carry with its own params ``{"fwd",
    "bwd"}``, combined by mode concat | add | mul | average.  It cannot
    stream (it needs the whole sequence), so it keeps no carry."""

    layer: Optional[BaseRecurrentConf] = None
    mode: str = "concat"

    IS_RNN = True
    USES_MASK = True
    WANTED_KINDS = ("rnn",)
    OUTPUT_KIND = "rnn"

    def __post_init__(self):
        self.layer = _nested(self.layer)

    def to_dict(self):
        d = super().to_dict()
        d["layer"] = self.layer.to_dict()
        return d

    def resolve_defaults(self, global_conf):
        super().resolve_defaults(global_conf)
        self.layer.resolve_defaults(global_conf)

    def infer_shapes(self, input_shape):
        t, h = self.layer.infer_shapes(input_shape)
        return (t, 2 * h if self.mode == "concat" else h)

    def param_shapes(self):
        inner = self.layer.param_shapes()
        return {"fwd": inner, "bwd": dict(inner)}

    def init(self, gen, dtype=torch.float32, device=None):
        return {"fwd": self.layer.init(gen, dtype, device),
                "bwd": self.layer.init(gen, dtype, device)}

    def regularized_param_names(self):
        # path-addressed names into the nested {fwd, bwd} param dicts
        inner = self.layer.regularized_param_names()
        return tuple(f"{d}/{n}" for d in ("fwd", "bwd") for n in inner)

    def apply(self, params, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        w = params["fwd"]["W"]
        zero = self.layer.carry_init(x.shape[0], w.dtype, w.device)
        yf, _ = self.layer.apply_seq(params["fwd"], x, zero, mask,
                                     compute_dtype)
        yb, _ = self.layer.apply_seq(params["bwd"],
                                     reverse_sequence(x, mask), zero, mask,
                                     compute_dtype)
        yb = reverse_sequence(yb, mask)
        mode = self.mode.lower()
        if mode == "concat":
            y = torch.cat([yf, yb], dim=-1)
        elif mode == "add":
            y = yf + yb
        elif mode == "mul":
            y = yf * yb
        elif mode == "average":
            y = (yf + yb) * 0.5
        else:
            raise ValueError(f"Unknown Bidirectional mode {self.mode!r}")
        return apply_dropout(y, self.dropout, training, rng)


@register_layer
@dataclasses.dataclass
class LastTimeStep(BaseLayerConf):
    """Wrapper reducing [b, t, h] to the LAST VALID timestep's [b, h]
    (``...conf.layers.recurrent.LastTimeStep``).  A wrapped recurrent
    layer's carry lands in this layer's state, so it counts as recurrent
    for the carry stripping between batches."""

    layer: Optional[BaseLayerConf] = None

    HAS_STATE = True
    USES_MASK = True
    WANTED_KINDS = ("rnn",)
    OUTPUT_KIND = "ff"

    @property
    def IS_RNN(self):
        return self.layer is not None and getattr(self.layer, "IS_RNN",
                                                  False)

    def __post_init__(self):
        self.layer = _nested(self.layer)

    def to_dict(self):
        d = super().to_dict()
        if self.layer is not None:
            d["layer"] = self.layer.to_dict()
        return d

    def resolve_defaults(self, global_conf):
        super().resolve_defaults(global_conf)
        if self.layer is not None:
            self.layer.resolve_defaults(global_conf)

    def infer_shapes(self, input_shape):
        if self.layer is not None:
            return (self.layer.infer_shapes(input_shape)[-1],)
        return (input_shape[-1],)

    def param_shapes(self):
        return self.layer.param_shapes() if self.layer is not None else {}

    def init(self, gen, dtype=torch.float32, device=None):
        return (self.layer.init(gen, dtype, device)
                if self.layer is not None else {})

    def regularized_param_names(self):
        return (self.layer.regularized_param_names()
                if self.layer is not None else ())

    def apply(self, params, state, x, *, compute_dtype=None, mask=None,
              training=False, rng=None):
        if self.layer is not None:
            kwargs = {"mask": mask} if getattr(self.layer, "USES_MASK",
                                               False) else {}
            x, state = apply_layer(self.layer, params, state, x,
                                   compute_dtype=compute_dtype,
                                   training=training, rng=rng, **kwargs)
        return last_time_step(x, mask), state


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(OutputLayer):
    """Per-timestep output layer over [b, t, f]: the dense projection
    broadcasts over time ([b, t, in] @ [in, out]); the base scorer folds
    [b, t, V] pre-activations into per-timestep scores, with sparse [b, t]
    labels for ``sparse_mcxent`` and [b, t] label masks."""

    WANTED_KINDS = ("rnn",)
    OUTPUT_KIND = "rnn"
