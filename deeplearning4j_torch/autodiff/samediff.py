"""SameDiff-equivalent: serializable define-by-run graph IR (port of
``deeplearning4j_tpu/autodiff/samediff.py``).

Parity target: ``org.nd4j.autodiff.samediff.SameDiff``, ``SDVariable``,
``TrainingConfig``, and the ``SameDiff.save/load`` format.

* Execution: the reference traces the recorded DAG into one jitted
  program; here ``output``/``fit`` interpret it eagerly in PyTorch, in
  the same topological order, on the graph's device.  What that trace
  fixes once is cached per (outputs, feed names, feed shapes and dtypes,
  compute dtype): the ops to run and the values folded on the host
  (shape metaprogramming, constants and what derives from them only), so
  a training step walks only the ops that touch parameters or feeds.
* Reverse-mode: ``torch.autograd`` over the interpreted loss — there is
  no gradient graph to build or serialize.
* Serialization is the reference's zip of ``graph.json`` (structure) +
  ``values.npz`` (VARIABLE/CONSTANT arrays): a zip written by either
  package loads in the other.
"""
from __future__ import annotations

import dataclasses
import io
import json
import time
import zipfile
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from deeplearning4j_torch.autodiff import ops as _ops
from deeplearning4j_torch.autodiff.ops import get_op, is_static_value
from deeplearning4j_torch.optimize.updaters import (
    BaseUpdater, updater_from_dict)
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.dtype import canonical_dtype

VAR_TYPES = ("VARIABLE", "CONSTANT", "PLACEHOLDER", "ARRAY")
# ops whose output depends only on their input's SHAPE (foldable whenever
# that shape is fixed by the feed shapes)
_SHAPE_OPS = ("shape", "size", "rank")
_CONTROL = ("while_loop", "cond")


def _clean_attr(v):
    """JSON-safe attrs (TF import hands us np arrays/bytes/dtypes;
    control-flow ops carry whole subgraphs)."""
    if isinstance(v, SameDiff):
        return {"__subgraph__": v.to_portable_dict()}
    if isinstance(v, bytes):
        return v.decode()
    if isinstance(v, (np.ndarray, np.generic)):
        return np.asarray(v).tolist()
    if isinstance(v, (list, tuple)):
        return [_clean_attr(x) for x in v]
    if isinstance(v, np.dtype):
        return v.name
    return v


def _revive_attr(v, device=None):
    """Inverse of _clean_attr for the subgraph case."""
    if isinstance(v, dict) and "__subgraph__" in v:
        return SameDiff.from_portable_dict(v["__subgraph__"], device=device)
    return v


@dataclasses.dataclass
class SDVariable:
    """A named symbol in the graph (``org.nd4j.autodiff.samediff
    .SDVariable``): VARIABLE (trainable), CONSTANT, PLACEHOLDER (fed), or
    ARRAY (op output)."""

    sd: "SameDiff"
    name: str
    var_type: str
    shape: Optional[Sequence[int]] = None
    dtype: str = "float32"

    # -- ergonomic operator sugar (SDVariable.add/mul/... in DL4J) --
    def _bin(self, op, other, reverse=False):
        other = self.sd._as_var(other)
        a, b = (other, self) if reverse else (self, other)
        return self.sd.op(op, a, b)

    def __add__(self, o):
        return self._bin("add", o)

    def __radd__(self, o):
        return self._bin("add", o, True)

    def __sub__(self, o):
        return self._bin("sub", o)

    def __rsub__(self, o):
        return self._bin("sub", o, True)

    def __mul__(self, o):
        return self._bin("mul", o)

    def __rmul__(self, o):
        return self._bin("mul", o, True)

    def __truediv__(self, o):
        return self._bin("div", o)

    def __matmul__(self, o):
        return self._bin("matmul", o)

    def __neg__(self):
        return self.sd.op("neg", self)

    def eval(self, feeds: Optional[Dict[str, Any]] = None):
        return self.sd.output(feeds or {}, [self.name])[self.name]


@dataclasses.dataclass
class OpNode:
    op_name: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]

    def to_dict(self):
        return {"op": self.op_name, "inputs": self.inputs,
                "outputs": self.outputs,
                "attrs": {k: _clean_attr(v) for k, v in self.attrs.items()}}


@dataclasses.dataclass
class TrainingConfig:
    """``org.nd4j.autodiff.samediff.TrainingConfig`` analogue: updater,
    l2, and the mapping from DataSet slots to placeholder names.

    ``compute_dtype`` is the mixed-precision policy of the TRAINING path
    only ("bfloat16": f32 master weights, float leaves cast to bf16 at
    graph entry, loss accumulated f32; grads come back f32 through the
    cast).  output() is unaffected."""

    updater: Union[BaseUpdater, dict]
    l2: float = 0.0
    data_set_feature_mapping: Sequence[str] = ()
    data_set_label_mapping: Sequence[str] = ()
    compute_dtype: Optional[str] = None

    def resolved_updater(self) -> BaseUpdater:
        u = self.updater
        return updater_from_dict(u) if isinstance(u, dict) else u


class SameDiff:
    """The graph container + builder + executor, on one device
    (``device=``, default ``"cuda"``; a CUDA device on a machine without
    CUDA raises)."""

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.vars: Dict[str, SDVariable] = {}
        self.values: Dict[str, np.ndarray] = {}  # VARIABLE + CONSTANT
        self.ops: List[OpNode] = []  # creation order == topological order
        self.loss_variables: List[str] = []
        self.training_config: Optional[TrainingConfig] = None
        # designated outputs (subgraphs need an explicit, ordered list)
        self.outputs: Optional[List[str]] = None
        self._updater_state = None
        self._step = 0
        # execution plans (see _run) and the needed-sets they came from
        self._fn_cache: Dict[Any, Any] = {}
        # device copies of host values: name -> (the host value, tensor)
        self._dev: Dict[str, Any] = {}
        # host seconds spent walking the graph (forward interpretation)
        # and the wall seconds of each fit step (synchronised by its loss)
        self.run_stats = {"interpret_s": 0.0, "runs": 0, "step_s": []}

    @staticmethod
    def create(device=None) -> "SameDiff":
        return SameDiff(device)

    # ------------------------------------------------------------------
    # Variable creation
    # ------------------------------------------------------------------
    def _unique(self, base: str) -> str:
        if base not in self.vars:
            return base
        i = 1
        while f"{base}_{i}" in self.vars:
            i += 1
        return f"{base}_{i}"

    def _register(self, name, var_type, shape=None, dtype="float32"):
        v = SDVariable(self, name, var_type,
                       tuple(shape) if shape is not None else None,
                       str(dtype))
        self.vars[name] = v
        return v

    def placeholder(self, name: str, shape=None, dtype="float32") -> SDVariable:
        return self._register(self._unique(name), "PLACEHOLDER", shape, dtype)

    def var(self, name: str, value=None, shape=None, dtype="float32",
            initializer: str = "zeros", key=None) -> SDVariable:
        """Trainable variable; give an array, or shape+initializer
        (``key``: the numpy seed of the "normal" initializer)."""
        name = self._unique(name)
        if value is None:
            if initializer == "zeros":
                value = np.zeros(shape, dtype)
            elif initializer == "ones":
                value = np.ones(shape, dtype)
            elif initializer == "normal":
                value = np.random.default_rng(
                    0 if key is None else key).normal(size=shape) \
                    .astype(dtype)
            else:
                raise ValueError(f"Unknown initializer {initializer!r}")
        value = np.asarray(value)
        self.values[name] = value
        return self._register(name, "VARIABLE", value.shape, value.dtype.name)

    def constant(self, name: str, value) -> SDVariable:
        name = self._unique(name)
        value = np.asarray(value)
        self.values[name] = value
        return self._register(name, "CONSTANT", value.shape, value.dtype.name)

    def _as_var(self, x) -> SDVariable:
        if isinstance(x, SDVariable):
            return x
        return self.constant("const", np.asarray(x))

    # ------------------------------------------------------------------
    # Op recording
    # ------------------------------------------------------------------
    def op(self, op_name: str, *inputs, name: Optional[str] = None,
           n_out: Optional[int] = None, **attrs):
        """Record one op; returns its SDVariable (or tuple for multi-out).
        The registry is consulted eagerly so unknown ops fail at build
        time (the DeclarableOp lookup)."""
        opdef = get_op(op_name)
        in_vars = [self._as_var(x) for x in inputs]
        if n_out is None and opdef.n_out == 0:
            raise ValueError(
                f"Op {op_name!r} has a variable output count — pass "
                "n_out= explicitly (e.g. sd.op('split', x, n_out=3, ...))")
        n = n_out if n_out is not None else opdef.n_out
        base = name or op_name
        outs = [self._unique(base if n == 1 else f"{base}:{i}")
                for i in range(n)]
        self.ops.append(OpNode(op_name, [v.name for v in in_vars], outs,
                               attrs))
        out_vars = [self._register(o, "ARRAY") for o in outs]
        self._fn_cache.clear()
        return out_vars[0] if n == 1 else tuple(out_vars)

    def __getattr__(self, item):
        # sd.matmul(a, b) sugar for any registered op.
        from deeplearning4j_torch.autodiff.ops import OP_REGISTRY
        if item in OP_REGISTRY:
            return lambda *a, **kw: self.op(item, *a, **kw)
        raise AttributeError(item)

    def set_loss_variables(self, *names):
        self.loss_variables = [n.name if isinstance(n, SDVariable) else n
                               for n in names]

    # ------------------------------------------------------------------
    # Device values
    # ------------------------------------------------------------------
    def _device_value(self, name: str) -> torch.Tensor:
        """The device copy of ``self.values[name]``, re-made when the
        host value object was replaced."""
        host = self.values[name]
        hit = self._dev.get(name)
        if hit is not None and hit[0] is host:
            return hit[1]
        t = torch.as_tensor(np.ascontiguousarray(host), device=self.device)
        self._dev[name] = (host, t)
        return t

    def _device_params(self) -> Dict[str, torch.Tensor]:
        return {k: self._device_value(k) for k, v in self.vars.items()
                if v.var_type == "VARIABLE" and k in self.values}

    def _feed(self, v) -> torch.Tensor:
        """A fed value as a tensor on the graph's device, dtype kept."""
        if isinstance(v, torch.Tensor):
            return v.to(self.device)
        return torch.as_tensor(np.ascontiguousarray(np.asarray(v)),
                               device=self.device)

    def _to_output(self, v):
        if isinstance(v, torch.Tensor):
            return v
        with _ops.device_scope(self.device):
            return _ops._t(v)

    # ------------------------------------------------------------------
    # Execution (eager interpretation with a cached plan)
    # ------------------------------------------------------------------
    def _run_graph(self, param_vals: Dict[str, Any],
                   feed_vals: Dict[str, Any], needed: set,
                   compute_dtype: Optional[str] = None,
                   plan: Optional[dict] = None) -> Dict[str, Any]:
        """Interpret the needed ops in order.  With ``plan`` (a dict),
        a ready plan replays its folded values and runs only its ops; an
        empty one is filled by this run."""
        t0 = time.perf_counter()
        if compute_dtype is None:
            cast = lambda v: v
        else:
            cd = canonical_dtype(compute_dtype)

            def cast(v):
                # only float leaves move; ids/masks/bools stay put
                if isinstance(v, torch.Tensor):
                    return v.to(cd) if v.is_floating_point() else v
                if np.issubdtype(np.asarray(v).dtype, np.floating):
                    return _ops._t(v).to(cd)
                return v
        with _ops.device_scope(self.device):
            if plan is not None and plan.get("ready"):
                env = dict(plan["static"])
                env.update({k: cast(v) for k, v in param_vals.items()})
                env.update({k: cast(v) for k, v in feed_vals.items()})
                for node in plan["nodes"]:
                    self._exec_node(node, env)
            else:
                env = self._run_and_plan(param_vals, feed_vals, needed, cast,
                                         plan)
        self.run_stats["interpret_s"] += time.perf_counter() - t0
        self.run_stats["runs"] += 1
        return env

    def _run_and_plan(self, param_vals, feed_vals, needed, cast, plan):
        env: Dict[str, Any] = {}
        static, dynamic = set(), set()
        for k, v in self.values.items():
            if self.vars[k].var_type == "CONSTANT" and k in needed:
                env[k] = cast(v)
                static.add(k)
        env.update({k: cast(v) for k, v in param_vals.items()})
        env.update({k: cast(v) for k, v in feed_vals.items()})
        nodes = []
        for node in self.ops:
            if not any(o in needed for o in node.outputs):
                continue
            self._exec_node(node, env)
            # shapes after control flow may depend on the data
            if node.op_name in _CONTROL or any(i in dynamic
                                               for i in node.inputs):
                dynamic.update(node.outputs)
            foldable = node.op_name not in _CONTROL and (
                all(i in static for i in node.inputs)
                or (node.op_name in _SHAPE_OPS
                    and not any(i in dynamic for i in node.inputs)))
            if foldable:
                static.update(node.outputs)
            else:
                nodes.append(node)
        if plan is not None:
            plan["static"] = {k: env[k] for k in static if k in env}
            plan["nodes"] = nodes
            plan["ready"] = True
        return env

    def _exec_node(self, node: OpNode, env: Dict[str, Any]):
        args = [env[i] for i in node.inputs]
        if node.op_name == "while_loop":
            out = self._exec_while(node, args)
        elif node.op_name == "cond":
            out = self._exec_cond(node, args)
        else:
            out = get_op(node.op_name).fn(*args, **node.attrs)
        if len(node.outputs) == 1:
            env[node.outputs[0]] = out
        else:
            for o, v in zip(node.outputs, out):
                env[o] = v

    def _plan(self, outputs, feeds: Dict[str, Any], compute_dtype=None):
        """(needed set, plan dict) cached per outputs, feed names and
        the feeds' shapes and dtypes."""
        key = (tuple(outputs), compute_dtype, tuple(sorted(
            (k, tuple(np.shape(v)) if is_static_value(v)
             else tuple(v.shape), str(getattr(v, "dtype", type(v))))
            for k, v in feeds.items())))
        hit = self._fn_cache.get(key)
        if hit is None:
            hit = (self._needed_for(outputs), {})
            self._fn_cache[key] = hit
        return hit

    def _run(self, outputs, params, feeds, compute_dtype=None):
        needed, plan = self._plan(outputs, feeds, compute_dtype)
        env = self._run_graph(params, feeds, needed, compute_dtype, plan)
        missing = [o for o in outputs if o not in env]
        if missing:
            raise KeyError(f"Outputs not computed: {missing}")
        return env

    # ------------------------------------------------------------------
    # Control flow (the TF Switch/Merge/Enter/Exit frame machinery of
    # AbstractSession becomes structured loops and branches over
    # sub-SameDiffs)
    # ------------------------------------------------------------------
    def run_subgraph(self, inputs: Sequence[Any]) -> List[Any]:
        """Execute this graph as a PURE function: `inputs` bind to the
        placeholders in registration order; returns the designated
        ``self.outputs`` (explicit, ordered — required for subgraphs)."""
        ph = [v.name for v in self.vars.values()
              if v.var_type == "PLACEHOLDER"]
        if len(ph) != len(inputs):
            raise ValueError(
                f"subgraph expects {len(ph)} inputs ({ph}), got "
                f"{len(inputs)}")
        outs = self.outputs
        if not outs:
            raise ValueError("subgraph has no designated outputs")
        env = self._run(outs, self._device_params(),
                        dict(zip(ph, inputs)))
        return [env[o] for o in outs]

    @staticmethod
    def _resolve_ident(sub: "SameDiff", name: str, depth: int = 4) -> str:
        """Follow identity ops backward inside a subgraph."""
        prod = {o: n for n in sub.ops for o in n.outputs}
        for _ in range(depth):
            n = prod.get(name)
            if n is None or n.op_name != "identity":
                return name
            name = n.inputs[0]
        return name

    def _while_static_pattern(self, node):
        """Match the bounded-counter loop shape: cond is
        ``less(state_k, N)`` with N a cond-graph constant or a
        pass-through loop var, and the body increments state_k by
        exactly 1.  Returns (k, ("const", N) | ("state", j)) or None.
        For this shape the trip count is static (cond holds for
        i = init..N-1 and fails at N): the reference's scan-convertible,
        reverse-differentiable case, which training requires."""
        cond_sd, body_sd = node.attrs["cond"], node.attrs["body"]
        ph = [v.name for v in cond_sd.vars.values()
              if v.var_type == "PLACEHOLDER"]
        outs = cond_sd.outputs or []
        if len(outs) != 1:
            return None
        prod = {o: n for n in cond_sd.ops for o in n.outputs}
        less = prod.get(self._resolve_ident(cond_sd, outs[0]))
        if less is None or less.op_name != "less":
            return None
        a = self._resolve_ident(cond_sd, less.inputs[0])
        b = self._resolve_ident(cond_sd, less.inputs[1])
        if a not in ph:
            return None
        k = ph.index(a)
        bv = cond_sd.vars.get(b)
        if bv is not None and bv.var_type == "CONSTANT":
            nval = np.asarray(cond_sd.values[b])
            if not np.issubdtype(nval.dtype, np.integer):
                return None      # float bound: int() would truncate
            bound = ("const", int(nval.reshape(())))
        elif b in ph:
            bound = ("state", ph.index(b))
        else:
            return None
        bph = [v.name for v in body_sd.vars.values()
               if v.var_type == "PLACEHOLDER"]
        bouts = body_sd.outputs or []
        if len(bouts) != len(bph) or k >= len(bouts):
            return None
        bprod = {o: n for n in body_sd.ops for o in n.outputs}
        inc = bprod.get(self._resolve_ident(body_sd, bouts[k]))
        if inc is None or inc.op_name != "add":
            return None
        i0 = self._resolve_ident(body_sd, inc.inputs[0])
        i1 = self._resolve_ident(body_sd, inc.inputs[1])
        if i0 == bph[k]:
            step = i1
        elif i1 == bph[k]:
            step = i0
        else:
            return None
        sv = body_sd.vars.get(step)
        if sv is None or sv.var_type != "CONSTANT":
            return None
        sval = np.asarray(body_sd.values[step])
        if not np.issubdtype(sval.dtype, np.integer) or \
                int(sval.reshape(())) != 1:
            return None
        if bound[0] == "state":
            j = bound[1]
            if self._resolve_ident(body_sd, bouts[j]) != bph[j]:
                return None          # bound must ride unchanged
        return k, bound

    def _while_trip_static(self, node, args):
        """Static trip count when the counter pattern matches AND the
        init/bound values are host values, else None."""
        pat = self._while_static_pattern(node)
        if pat is None:
            return None
        k, bound = pat

        def host_int(v):
            if isinstance(v, torch.Tensor):
                return None       # a value the run computed
            a = np.asarray(v)
            if not np.issubdtype(a.dtype, np.integer):
                return None       # float counter: int() would truncate
            return int(a.reshape(()))
        init = host_int(args[k])
        if init is None:
            return None
        n = bound[1] if bound[0] == "const" else host_int(args[bound[1]])
        if n is None:
            return None
        return max(0, n - init)

    def _exec_while(self, node, args):
        """``while cond(*state): state = body(*state)``, run as a loop
        (differentiable either way; the bounded-counter form skips the
        cond evaluations).  State is ALL inputs (TF v2 While semantics:
        captured tensors ride as pass-through loop vars)."""
        cond_sd, body_sd = node.attrs["cond"], node.attrs["body"]
        init = tuple(_ops._t(a) for a in args)
        trip = self._while_trip_static(node, args)
        state = init

        def body(st):
            r = body_sd.run_subgraph(list(st))
            return tuple(_ops._t(x, i).to(i.dtype) for x, i in zip(r, init))

        if trip is not None:
            for _ in range(int(trip)):
                state = body(state)
        else:
            while bool(torch.as_tensor(
                    _ops._host(cond_sd.run_subgraph(list(state))[0]))
                    .reshape(())):
                state = body(state)
        return state if len(node.outputs) > 1 else state[0]

    def _exec_cond(self, node, args):
        """``then(*operands) if pred else orelse(*operands)``
        (differentiable: only the taken branch runs)."""
        then_sd, else_sd = node.attrs["then"], node.attrs["orelse"]
        pred = bool(np.asarray(_ops._host(args[0])).reshape(()))
        operands = [_ops._t(a) for a in args[1:]]
        r = (then_sd if pred else else_sd).run_subgraph(operands)
        out = tuple(_ops._t(x) for x in r)
        return out if len(node.outputs) > 1 else out[0]

    def _needed_for(self, outputs: Sequence[str]) -> set:
        """Backward slice: op outputs required to compute `outputs`."""
        produced_by = {o: node for node in self.ops for o in node.outputs}
        needed, stack = set(), list(outputs)
        while stack:
            n = stack.pop()
            if n in needed:
                continue
            needed.add(n)
            node = produced_by.get(n)
            if node is not None:
                needed.update(node.outputs)
                stack.extend(node.inputs)
        return needed

    def _param_values(self) -> Dict[str, np.ndarray]:
        return {k: v for k, v in self.values.items()
                if self.vars[k].var_type == "VARIABLE"}

    def output(self, feeds: Dict[str, Any],
               outputs: Optional[Sequence[str]] = None) -> Dict[str, Any]:
        """Execute and fetch (DL4J ``SameDiff.output(Map, String...)``);
        values come back as tensors on the graph's device."""
        feeds = {(k.name if isinstance(k, SDVariable) else k): self._feed(v)
                 for k, v in feeds.items()}
        if outputs is None:
            all_outs = {o for n in self.ops for o in n.outputs}
            consumed = {i for n in self.ops for i in n.inputs}
            outputs = sorted(all_outs - consumed) or sorted(all_outs)
        outputs = [o.name if isinstance(o, SDVariable) else o for o in outputs]
        with torch.no_grad():
            env = self._run(outputs, self._device_params(), feeds)
            return {o: self._to_output(env[o]) for o in outputs}

    # ------------------------------------------------------------------
    # Gradients (autograd over the interpreted loss — no gradient graph)
    # ------------------------------------------------------------------
    def _loss(self, params, feeds, l2=0.0, compute_dtype=None):
        losses = self.loss_variables
        if not losses:
            raise ValueError("set_loss_variables(...) first")
        env = self._run(losses, params, feeds, compute_dtype)
        total = 0.0
        for name in losses:
            total = total + torch.mean(self._to_output(env[name]).float())
        if l2:
            for v in params.values():
                total = total + 0.5 * l2 * torch.sum(torch.square(v))
        return total

    def _loss_and_grads(self, params, feeds, l2=0.0, compute_dtype=None):
        leaves = {k: v.detach().requires_grad_(True)
                  for k, v in params.items()}
        loss = self._loss(leaves, feeds, l2, compute_dtype)
        grads = torch.autograd.grad(loss, list(leaves.values()),
                                    allow_unused=True)
        return loss.detach(), {
            k: (g if g is not None else torch.zeros_like(leaves[k]))
            for k, g in zip(leaves, grads)}

    def calculate_gradients(self, feeds: Dict[str, Any],
                            wrt: Optional[Sequence[str]] = None
                            ) -> Dict[str, torch.Tensor]:
        feeds = {(k.name if isinstance(k, SDVariable) else k): self._feed(v)
                 for k, v in feeds.items()}
        _, grads = self._loss_and_grads(self._device_params(), feeds)
        if wrt is not None:
            wrt = [w.name if isinstance(w, SDVariable) else w for w in wrt]
            grads = {k: grads[k] for k in wrt}
        return grads

    # ------------------------------------------------------------------
    # Training (TrainingSession analogue)
    # ------------------------------------------------------------------
    def set_training_config(self, cfg: TrainingConfig):
        self.training_config = cfg

    def _check_trainable_loops(self):
        """Fail FAST (fit-time) when a while_loop in the loss path is not
        the bounded-counter form the reference can differentiate —
        the reference's rules, kept so a graph that trains in one
        package trains in the other.  Recurses into cond/while
        subgraphs."""
        needed = self._needed_for(self.loss_variables)

        def check_sub(sub_sd):
            for n in sub_sd.ops:
                for key in ("cond", "body", "then", "orelse"):
                    child = n.attrs.get(key)
                    if isinstance(child, SameDiff):
                        check_sub(child)
                if n.op_name != "while_loop":
                    continue
                pat = sub_sd._while_static_pattern(n)

                # a nested loop's counter init and bound must be
                # constants of the nested graph (a ("state", j) bound
                # is fine when the while's j-th input is one)
                def _is_const(name):
                    v = sub_sd.vars.get(
                        sub_sd._resolve_ident(sub_sd, name))
                    return v is not None and v.var_type == "CONSTANT"

                ok = pat is not None and (
                    pat[1][0] == "const"
                    or (pat[1][0] == "state"
                        and pat[1][1] < len(n.inputs)
                        and _is_const(n.inputs[pat[1][1]])))
                if ok:
                    ok = _is_const(n.inputs[pat[0]])
                if not ok:
                    raise ValueError(
                        f"nested while_loop producing {n.outputs[0]!r} "
                        "inside a control-flow subgraph on the loss "
                        "path is not scan-convertible (its counter "
                        "init and bound must be constants of the "
                        "nested graph); see the while_loop training "
                        "requirements.")

        for node in self.ops:
            if not any(o in needed for o in node.outputs):
                continue
            for key in ("cond", "body", "then", "orelse"):
                child = node.attrs.get(key)
                if isinstance(child, SameDiff):
                    check_sub(child)
            if node.op_name != "while_loop":
                continue
            pat = self._while_static_pattern(node)
            ok = pat is not None
            if ok:
                k, bound = pat

                def _is_const(name):
                    v = self.vars.get(name)
                    return v is not None and v.var_type == "CONSTANT"
                ok = _is_const(node.inputs[k]) and (
                    bound[0] == "const" or _is_const(
                        node.inputs[bound[1]]))
            if not ok:
                raise ValueError(
                    f"while_loop producing {node.outputs[0]!r} is in "
                    "the loss path but is not scan-convertible: "
                    "training needs `cond = (i < N)` with a constant "
                    "bound, a body that increments i by 1, and a "
                    "constant initial counter.  Inference via output() "
                    "still works; restructure the loop or freeze this "
                    "subgraph to fine-tune the rest.")

    def _train_step_fn(self, feed_names):
        """(step, updater): ``step(params, opt_state, step_idx, feeds)
        -> (params, opt_state, loss)``, functional over dicts of
        device tensors."""
        cfg = self.training_config
        updater = cfg.resolved_updater()
        self._check_trainable_loops()

        def step(params, opt_state, step_idx, feeds):
            loss, grads = self._loss_and_grads(params, feeds, cfg.l2,
                                               cfg.compute_dtype)
            with torch.no_grad():
                updates, opt_state = updater.update(grads, opt_state,
                                                    params, int(step_idx))
                params = {k: params[k] - updates[k] for k in params}
                opt_state = updater.finalize(opt_state, params)
            return params, opt_state, loss

        return step, updater

    def fit(self, data, n_epochs: int = 1):
        """Train from a DataSet/MultiDataSet iterator using the configured
        feature/label placeholder mappings (DL4J ``SameDiff.fit``).
        Returns the per-step losses; the trained values are written back
        to ``values``."""
        cfg = self.training_config
        if cfg is None:
            raise ValueError("set_training_config(...) first")
        feat_names = list(cfg.data_set_feature_mapping)
        lab_names = list(cfg.data_set_label_mapping)
        step_fn, updater = self._train_step_fn(feat_names + lab_names)
        params = self._device_params()
        if self._updater_state is None:
            self._updater_state = updater.init_state(params)
        losses = []
        iterator = data if hasattr(data, "__iter__") else [data]
        for _ in range(n_epochs):
            for ds in iterator:
                t0 = time.perf_counter()
                feats = ds.features if isinstance(ds.features, (list, tuple)) \
                    else [ds.features]
                labs = ds.labels if isinstance(ds.labels, (list, tuple)) \
                    else [ds.labels]
                feeds = {n: self._feed(a)
                         for n, a in zip(feat_names + lab_names,
                                         list(feats) + list(labs))}
                params, self._updater_state, loss = step_fn(
                    params, self._updater_state, self._step, feeds)
                self._step += 1
                losses.append(float(loss))
                self.run_stats["step_s"].append(time.perf_counter() - t0)
            if hasattr(data, "reset"):
                data.reset()
        for k, v in params.items():
            host = v.detach().to("cpu").numpy().copy()
            self.values[k] = host
            self._dev[k] = (host, v.detach())
        return losses

    # ------------------------------------------------------------------
    # Serialization (zip: graph.json + values.npz — the .fb analogue)
    # ------------------------------------------------------------------
    def to_dict(self) -> dict:
        return {
            "format": "deeplearning4j_tpu/samediff-v1",
            "variables": [
                {"name": v.name, "type": v.var_type,
                 "shape": list(v.shape) if v.shape is not None else None,
                 "dtype": v.dtype}
                for v in self.vars.values()],
            "ops": [n.to_dict() for n in self.ops],
            "loss_variables": self.loss_variables,
            "outputs": self.outputs,
        }

    def to_portable_dict(self) -> dict:
        """Self-contained dict INCLUDING values (JSON-safe) — how
        control-flow subgraphs embed in their parent's attrs.  Values
        ride as base64 npz bytes, as the reference writes them."""
        import base64
        d = self.to_dict()
        if self.values:
            buf = io.BytesIO()
            np.savez_compressed(buf, **self.values)
            d["values_npz_b64"] = base64.b64encode(
                buf.getvalue()).decode("ascii")
        return d

    def _load_structure(self, d: dict):
        for v in d["variables"]:
            self._register(v["name"], v["type"], v["shape"], v["dtype"])
        for n in d["ops"]:
            self.ops.append(OpNode(
                n["op"], n["inputs"], n["outputs"],
                {k: _revive_attr(v, self.device)
                 for k, v in n["attrs"].items()}))
        self.loss_variables = d.get("loss_variables", [])
        self.outputs = d.get("outputs")

    @staticmethod
    def from_portable_dict(d: dict, device=None) -> "SameDiff":
        import base64
        sd = SameDiff(device)
        sd._load_structure(d)
        if "values_npz_b64" in d:
            vals = np.load(io.BytesIO(
                base64.b64decode(d["values_npz_b64"])), allow_pickle=False)
            for k in vals.files:
                sd.values[k] = vals[k]
        for k, meta in d.get("values_inline", {}).items():  # legacy form
            sd.values[k] = np.asarray(
                meta["data"], dtype=meta["dtype"]).reshape(meta["shape"])
        return sd

    def save(self, path: str):
        buf = io.BytesIO()
        np.savez(buf, **self.values)
        with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
            z.writestr("graph.json", json.dumps(self.to_dict(), indent=1))
            z.writestr("values.npz", buf.getvalue())

    @staticmethod
    def load(path: str, device=None) -> "SameDiff":
        sd = SameDiff(device)
        with zipfile.ZipFile(path) as z:
            d = json.loads(z.read("graph.json"))
            vals = np.load(io.BytesIO(z.read("values.npz")))
            sd._load_structure(d)
            for k in vals.files:
                sd.values[k] = vals[k]
        return sd

    def summary(self) -> str:
        lines = [f"SameDiff: {len(self.vars)} vars, {len(self.ops)} ops"]
        for v in self.vars.values():
            if v.var_type != "ARRAY":
                lines.append(f"  {v.var_type:<11} {v.name} {v.shape}")
        counts: Dict[str, int] = {}
        for n in self.ops:
            counts[n.op_name] = counts.get(n.op_name, 0) + 1
        lines.append("  ops: " + ", ".join(
            f"{k}x{c}" for k, c in sorted(counts.items())))
        return "\n".join(lines)
