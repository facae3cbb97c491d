"""ONNX → graph IR importer (port of
``deeplearning4j_tpu/autodiff/onnx_import.py``).

Parity target: ``nd4j/samediff-import/samediff-import-onnx``.  Consumes
ONNX protobuf files through the in-repo wire codec (``onnx_serde`` — no
``onnx`` package needed), maps nodes onto the op registry, and returns
the same ``SameDiff`` IR the reference produces, so execution, training,
serialization and the rewrites apply unchanged.  An ONNX attention block
(``Transpose`` + ``MatMul``) does not match the attention rewrite, in
either package.

ONNX is NCHW-native: Conv/Pool/BatchNorm lower through NCHW-aware
registry ops (PyTorch's own layout — no transpose insertion needed).
Scope: the feed-forward/CNN/transformer inference op set (Gemm, Conv,
pooling, normalization, attention building blocks) and torch-exported
LSTM/GRU.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_torch.autodiff import onnx_serde as O
from deeplearning4j_torch.autodiff.samediff import OpNode, SameDiff, SDVariable
from deeplearning4j_torch.autodiff.tf_import import _default_trainable_filter

_SIMPLE = {
    "Add": "add", "Sub": "sub", "Mul": "mul", "Div": "div", "Pow": "pow",
    "Sqrt": "sqrt", "Exp": "exp", "Log": "log", "Neg": "neg",
    "Abs": "abs", "Erf": "erf", "Tanh": "tanh", "Sigmoid": "sigmoid",
    "Relu": "relu", "Floor": "floor", "Ceil": "ceil", "Sign": "sign",
    "Reciprocal": "reciprocal", "MatMul": "matmul", "Not": "logical_not",
    "Equal": "equal", "Greater": "greater", "Less": "less",
    "GreaterOrEqual": "greater_equal", "LessOrEqual": "less_equal",
    "And": "logical_and", "Or": "logical_or", "Xor": "logical_xor",
    "Where": "where", "Max": "maximum", "Min": "minimum",
    "Identity": "identity", "Sin": "sin", "Cos": "cos", "Tan": "tan",
    "Asin": "asin", "Acos": "acos", "Atan": "atan", "Sinh": "sinh",
    "Cosh": "cosh", "Asinh": "asinh", "Acosh": "acosh",
    "Atanh": "atanh", "IsNaN": "isnan", "IsInf": "isinf",
}


def _attrs(node: dict) -> Dict[str, object]:
    out = {}
    for a in node.get("attribute", []):
        t = a.get("type")
        if t == O.ATTR_FLOAT:
            out[a["name"]] = a.get("f", 0.0)
        elif t == O.ATTR_INT:
            out[a["name"]] = a.get("i", 0)
        elif t == O.ATTR_STRING:
            out[a["name"]] = a.get("s", b"").decode("utf-8")
        elif t == O.ATTR_TENSOR:
            out[a["name"]] = O.tensor_to_numpy(a["t"])
        elif t == O.ATTR_INTS:
            out[a["name"]] = list(a.get("ints", []))
        elif t == O.ATTR_FLOATS:
            out[a["name"]] = list(a.get("floats", []))
        elif t == O.ATTR_STRINGS:
            out[a["name"]] = [
                (v.decode("utf-8") if isinstance(v, bytes) else str(v))
                for v in a.get("strings", [])]
    return out


class _OnnxImporter:
    def __init__(self, model: dict, trainable_consts: bool = True,
                 trainable_filter: Optional[Callable] = None, device=None):
        self.model = model
        self.g = model["graph"]
        self.sd = SameDiff.create(device)
        self.trainable_filter = (trainable_filter
                                 or _default_trainable_filter)
        self.trainable_consts = trainable_consts
        self.tensors: Dict[str, SDVariable] = {}
        self.const_values: Dict[str, np.ndarray] = {}
        self.opset = max(
            (int(o.get("version", 0))
             for o in model.get("opset_import", [])
             if o.get("domain", "") in ("", "ai.onnx")),
            default=13)

    def _resolve(self, ref: str) -> SDVariable:
        v = self.tensors.get(ref)
        if v is None:
            raise KeyError(f"Input tensor {ref!r} not yet produced")
        return v

    def _const_of(self, var) -> np.ndarray:
        val = self.const_values.get(var.name)
        if val is None:
            raise ValueError(
                f"{var.name!r} must be a constant at import time")
        return val

    def _emit(self, node, op_name, inputs, n_out=1, **attrs):
        inputs = [v for v in inputs if v is not None]  # trailing optionals
        outs = [o for o in node["output"][:n_out]]
        self.sd.ops.append(OpNode(op_name, [v.name for v in inputs],
                                  outs, attrs))
        for o in outs:
            self.tensors[o] = self.sd._register(o, "ARRAY")
        return [self.tensors[o] for o in outs]

    def _emit_named(self, op_name: str, input_names: List[str],
                    out: str, **attrs) -> SDVariable:
        self.sd.ops.append(OpNode(op_name, input_names, [out], attrs))
        v = self.sd._register(out, "ARRAY")
        self.tensors[out] = v
        return v

    # ------------------------------------------------------------------
    def run(self) -> SameDiff:
        for t in self.g.get("initializer", []):
            arr = O.tensor_to_numpy(t)
            name = t["name"]
            if self.trainable_consts and self.trainable_filter(name, arr):
                v = self.sd.var(name, arr)
            else:
                v = self.sd.constant(name, arr)
                self.const_values[name] = arr
            self.tensors[name] = v
        init_names = set(self.tensors)
        for vi in self.g.get("input", []):
            if vi["name"] in init_names:
                continue
            tt = vi.get("type", {}).get("tensor_type", {})
            dims = [d.get("dim_value") for d in
                    tt.get("shape", {}).get("dim", [])]
            dt = O.DT_TO_NP.get(tt.get("elem_type", O.DT_FLOAT),
                                "float32")
            self.tensors[vi["name"]] = self.sd.placeholder(
                vi["name"], dims or None, dt)
        for node in self.g.get("node", []):
            self._handle(node)
        self.sd.outputs = [o["name"] for o in self.g.get("output", [])]
        return self.sd

    # ------------------------------------------------------------------
    def _handle(self, node):
        op = node["op_type"]
        # POSITION-PRESERVING: ONNX omits optional inputs with "" —
        # filtering would shift later positional inputs (Clip with only
        # max, Slice with steps but no axes, ...)
        ins = [self._resolve(i) if i else None
               for i in node.get("input", [])]
        a = _attrs(node)
        if op in _SIMPLE:
            return self._emit(node, _SIMPLE[op],
                              [i for i in ins if i is not None])
        if op == "Constant":
            val = a.get("value")
            if val is None:
                raise NotImplementedError("Constant without tensor value")
            name = node["output"][0]
            v = self.sd.constant(name, np.asarray(val))
            self.const_values[v.name] = np.asarray(val)
            self.tensors[name] = v
            return
        if op == "Gemm":
            alpha, beta = a.get("alpha", 1.0), a.get("beta", 1.0)
            out = node["output"][0]
            # an omitted optional C arrives as the empty-string
            # input, which resolves to None (advisor r3)
            has_c = len(ins) > 2 and ins[2] is not None
            mm_out = out if (alpha == 1.0 and not has_c) else out + "/mm"
            self._emit_named("matmul", [ins[0].name, ins[1].name],
                             mm_out,
                             transpose_a=bool(a.get("transA", 0)),
                             transpose_b=bool(a.get("transB", 0)))
            cur = mm_out
            if alpha != 1.0:
                ac = self.sd.constant(out + "/alpha", np.float32(alpha))
                nxt = out + "/scaled" if has_c else out
                self._emit_named("mul", [cur, ac.name], nxt)
                cur = nxt
            if has_c:
                cname = ins[2].name
                if beta != 1.0:
                    bc = self.sd.constant(out + "/beta",
                                          np.float32(beta))
                    self._emit_named("mul", [cname, bc.name],
                                     out + "/bscaled")
                    cname = out + "/bscaled"
                self._emit_named("add", [cur, cname], out)
            return
        if op == "Reshape":
            try:
                shape = self._const_of(ins[1])
            except ValueError:
                # graph-computed target: folds to host at trace time
                return self._emit(node, "reshape_dynamic", ins[:2])
            return self._emit(node, "reshape_with_zero", ins[:1],
                              shape=[int(s) for s in shape])
        if op == "Transpose":
            return self._emit(node, "transpose", ins,
                              perm=a.get("perm") or None)
        if op == "Concat":
            return self._emit(node, "concat", ins, axis=a.get("axis", 0))
        if op == "Flatten":
            return self._emit(node, "flatten_onnx", ins,
                              axis=a.get("axis", 1))
        if op in ("Squeeze", "Unsqueeze"):
            axes = a.get("axes")
            if axes is None and len(ins) > 1:
                axes = [int(v) for v in self._const_of(ins[1])]
            name = "squeeze" if op == "Squeeze" else "unsqueeze_onnx"
            return self._emit(node, name, ins[:1], axis=axes)
        if op == "Gather":
            return self._emit(node, "gather", ins, axis=a.get("axis", 0))
        if op == "Cast":
            return self._emit(node, "cast", ins,
                              dtype=O.DT_TO_NP[a["to"]])
        if op == "Shape":
            return self._emit(node, "shape", ins)
        if op == "Expand":
            try:
                shape = self._const_of(ins[1])
            except ValueError:
                return self._emit(node, "broadcast_to_dynamic",
                                  ins[:2])
            return self._emit(node, "broadcast_to", ins[:1],
                              shape=[int(s) for s in shape])
        if op in ("LSTM", "GRU"):
            defaults = (["Sigmoid", "Tanh", "Tanh"] if op == "LSTM"
                        else ["Sigmoid", "Tanh"])
            acts = a.get("activations")
            n_dir = 2 if a.get("direction") == "bidirectional" else 1
            if acts and acts != defaults * n_dir:
                raise NotImplementedError(
                    f"ONNX {op} with non-default activations {acts}")
            if float(a.get("clip", 0.0) or 0.0) != 0.0:
                raise NotImplementedError(f"ONNX {op} clip attribute")
            if op == "LSTM" and int(a.get("input_forget", 0)):
                raise NotImplementedError("ONNX LSTM input_forget")
            if int(a.get("layout", 0)):
                raise NotImplementedError(
                    f"ONNX {op} layout=1 (batch-major)")
            present = [i for i, v in enumerate(ins) if v is not None]
            hs = a.get("hidden_size")      # optional; ops derive from W
            kw = {"present": present,
                  "hidden_size": None if hs is None else int(hs),
                  "direction": a.get("direction", "forward")}
            if op == "GRU":
                kw["linear_before_reset"] = int(
                    a.get("linear_before_reset", 0))
            # Position-preserving outputs: exporters prune unused
            # trailing outputs and blank unused middles; the op always
            # returns the full tuple, so synthesize names for holes
            # (the executor's multi-output zip binds by position).
            n_out = 3 if op == "LSTM" else 2
            decl = list(node.get("output", []))
            while len(decl) < n_out:
                decl.append("")
            base = next((o for o in decl if o), "rnn")
            outs = [o if o else f"{base}/unused_{i}"
                    for i, o in enumerate(decl[:n_out])]
            self.sd.ops.append(OpNode(
                f"onnx_{op.lower()}",
                [ins[i].name for i in present], outs, kw))
            for o in outs:
                self.tensors[o] = self.sd._register(o, "ARRAY")
            return [self.tensors[o] for o in outs]
        if op == "Softmax":
            # Opset>=13: elementwise softmax over `axis` (default -1).
            # Pre-13: default axis=1 with flatten-to-2D semantics
            # (advisor r3 — opset_import was parsed but never consulted).
            if self.opset >= 13:
                return self._emit(node, "softmax", ins,
                                  axis=a.get("axis", -1))
            return self._emit(node, "softmax_onnx_pre13", ins,
                              axis=a.get("axis", 1))
        if op == "LeakyRelu":
            return self._emit(node, "leaky_relu", ins,
                              alpha=a.get("alpha", 0.01))
        if op == "Clip":
            lo, hi = a.get("min", -np.inf), a.get("max", np.inf)
            if len(ins) >= 2 and ins[1] is not None:
                lo = float(self._const_of(ins[1]).reshape(()))
            if len(ins) >= 3 and ins[2] is not None:
                hi = float(self._const_of(ins[2]).reshape(()))
            return self._emit(node, "clip_scalar", ins[:1], lo=lo, hi=hi)
        if op in ("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin",
                  "ReduceProd"):
            axes = a.get("axes")
            if axes is None and len(ins) > 1:
                axes = [int(v) for v in self._const_of(ins[1])]
            return self._emit(node, f"reduce_{op[6:].lower()}", ins[:1],
                              axis=axes,
                              keep_dims=bool(a.get("keepdims", 1)))
        if op == "Dropout":
            return self._emit(node, "identity", ins[:1])
        if op == "Conv":
            return self._emit(
                node, "onnx_conv", ins,
                strides=a.get("strides") or [1, 1],
                pads=a.get("pads") or None,
                auto_pad=a.get("auto_pad", "NOTSET"),
                dilations=a.get("dilations") or [1, 1],
                group=a.get("group", 1))
        if op in ("MaxPool", "AveragePool"):
            if a.get("ceil_mode", 0):
                raise NotImplementedError(f"{op} ceil_mode=1")
            extra = {}
            if op == "AveragePool":
                extra["count_include_pad"] = a.get("count_include_pad", 0)
            return self._emit(
                node, "onnx_max_pool" if op == "MaxPool"
                else "onnx_avg_pool", ins, n_out=1,
                kernel_shape=a["kernel_shape"],
                strides=a.get("strides") or [1] * len(a["kernel_shape"]),
                pads=a.get("pads") or None,
                auto_pad=a.get("auto_pad", "NOTSET"), **extra)
        if op == "GlobalAveragePool":
            return self._emit(node, "onnx_global_avg_pool", ins)
        if op == "BatchNormalization":
            return self._emit(node, "onnx_batch_norm", ins, n_out=1,
                              eps=a.get("epsilon", 1e-5))
        if op == "LayerNormalization":
            return self._emit(node, "onnx_layer_norm", ins, n_out=1,
                              axis=a.get("axis", -1),
                              eps=a.get("epsilon", 1e-5))
        if op == "Pad":
            mode = a.get("mode", "constant")
            pads = a.get("pads")
            if pads is None:
                pads = [int(v) for v in self._const_of(ins[1])]
            cv = 0.0
            if len(ins) >= 3 and ins[2] is not None:
                cv = float(self._const_of(ins[2]).reshape(()))
            return self._emit(node, "onnx_pad", ins[:1], pads=pads,
                              mode=mode, value=cv)
        if op == "Split":
            axis = a.get("axis", 0)
            n = len(node["output"])
            sizes = a.get("split")
            if sizes is None and len(ins) > 1 and ins[1] is not None:
                sizes = [int(v) for v in self._const_of(ins[1])]
            return self._emit(node, "split", ins[:1], n_out=n,
                              num_split=(list(sizes) if sizes else n),
                              axis=axis)
        if op == "Slice":
            starts = [int(v) for v in self._const_of(ins[1])]
            ends = [int(v) for v in self._const_of(ins[2])]
            axes = ([int(v) for v in self._const_of(ins[3])]
                    if len(ins) > 3 and ins[3] is not None
                    else list(range(len(starts))))
            steps = ([int(v) for v in self._const_of(ins[4])]
                     if len(ins) > 4 and ins[4] is not None
                     else [1] * len(starts))
            return self._emit(node, "onnx_slice", ins[:1], starts=starts,
                              ends=ends, axes=axes, steps=steps)
        raise NotImplementedError(
            f"ONNX op {op!r} (node {node.get('name')!r}) has no import "
            "mapping — register one in "
            "deeplearning4j_torch/autodiff/onnx_import.py")


def import_onnx(path: str, trainable_consts: bool = True,
                trainable_filter: Optional[Callable] = None,
                device=None) -> SameDiff:
    """ONNX file → SameDiff IR on ``device`` (default ``"cuda"``;
    ``samediff-import-onnx`` analogue)."""
    return _OnnxImporter(O.load_model(path), trainable_consts,
                         trainable_filter, device=device).run()


def import_onnx_model(model: dict, **kw) -> SameDiff:
    return _OnnxImporter(model, **kw).run()
