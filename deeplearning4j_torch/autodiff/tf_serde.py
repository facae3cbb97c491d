"""Minimal TensorFlow GraphDef wire codec (reader) — the port's stand-in
for what the ``tensorflow`` package gives the reference importer
(``GraphDef.ParseFromString``, ``dtypes``, ``tensor_util.MakeNdarray``
and ``function_def_to_graph``), written in ``onnx_serde``'s style.

The field numbers are those of TensorFlow's ``.proto`` files
(``framework/graph.proto``: GraphDef node=1 library=2 version=3
versions=4; ``node_def.proto``: name=1 op=2 input=3 device=4 attr=5;
``attr_value.proto``: AttrValue list=1 s=2 i=3 f=4 b=5 type=6 shape=7
tensor=8 placeholder=9 func=10, ListValue s=2 i=3 f=4 b=5 type=6 shape=7
tensor=8 func=9, NameAttrList name=1 attr=2; ``tensor_shape.proto``:
dim=2 (size=1 name=2) unknown_rank=3; ``tensor.proto``: dtype=1
tensor_shape=2 version_number=3 tensor_content=4 float_val=5
double_val=6 int_val=7 string_val=8 scomplex_val=9 int64_val=10
bool_val=11 dcomplex_val=12 half_val=13 uint32_val=16 uint64_val=17;
``function.proto``: FunctionDefLibrary function=1, FunctionDef
signature=1 node_def=3 ret=4 attr=5 control_ret=6 arg_attr=7;
``op_def.proto``: OpDef name=1 input_arg=2 output_arg=3, ArgDef name=1
type=3 type_attr=4 number_attr=5 type_list_attr=6).  A test pins them
against TensorFlow's own parse: both importers give the same IR.

Messages decode into plain dicts (repeated fields as lists, maps as
dicts); unknown fields are skipped, as protobuf does.
"""
from __future__ import annotations

import heapq
import struct
from typing import Any, Dict, List, Tuple

import numpy as np

# kind: "int" varint (signed 64), "bool" varint, "float32" fixed32,
# "string"/"bytes" length-delimited, ("msg", S) / ("*msg", S) nested,
# ("map", key_kind, value_kind) a map field (entries key=1, value=2);
# "*..." repeated, "*packedint"/"*packedf32"/"*packedf64" packed scalars.
DIM = {1: ("size", "int"), 2: ("name", "string")}
SHAPE = {2: ("dim", ("*msg", DIM)), 3: ("unknown_rank", "bool")}
TENSOR = {
    1: ("dtype", "int"),
    2: ("tensor_shape", ("msg", SHAPE)),
    3: ("version_number", "int"),
    4: ("tensor_content", "bytes"),
    5: ("float_val", "*packedf32"),
    6: ("double_val", "*packedf64"),
    7: ("int_val", "*packedint"),
    8: ("string_val", "*bytes"),
    9: ("scomplex_val", "*packedf32"),
    10: ("int64_val", "*packedint"),
    11: ("bool_val", "*packedint"),
    12: ("dcomplex_val", "*packedf64"),
    13: ("half_val", "*packedint"),
    16: ("uint32_val", "*packedint"),
    17: ("uint64_val", "*packedint"),
}
ATTR: Dict[int, Tuple[str, Any]] = {}
NAME_ATTR_LIST = {1: ("name", "string"), 2: ("attr", ("map", "string", ATTR))}
LIST_VALUE = {
    2: ("s", "*bytes"),
    3: ("i", "*packedint"),
    4: ("f", "*packedf32"),
    5: ("b", "*packedint"),
    6: ("type", "*packedint"),
    7: ("shape", ("*msg", SHAPE)),
    8: ("tensor", ("*msg", TENSOR)),
    9: ("func", ("*msg", NAME_ATTR_LIST)),
}
ATTR.update({
    1: ("list", ("msg", LIST_VALUE)),
    2: ("s", "bytes"),
    3: ("i", "int"),
    4: ("f", "float32"),
    5: ("b", "bool"),
    6: ("type", "int"),
    7: ("shape", ("msg", SHAPE)),
    8: ("tensor", ("msg", TENSOR)),
    9: ("placeholder", "string"),
    10: ("func", ("msg", NAME_ATTR_LIST)),
})
#: the members of AttrValue's ``value`` oneof
ATTR_ONEOF = ("list", "s", "i", "f", "b", "type", "shape", "tensor",
              "placeholder", "func")
NODE = {
    1: ("name", "string"),
    2: ("op", "string"),
    3: ("input", "*string"),
    4: ("device", "string"),
    5: ("attr", ("map", "string", ATTR)),
}
ARG_DEF = {
    1: ("name", "string"),
    2: ("description", "string"),
    3: ("type", "int"),
    4: ("type_attr", "string"),
    5: ("number_attr", "string"),
    6: ("type_list_attr", "string"),
}
OP_DEF = {
    1: ("name", "string"),
    2: ("input_arg", ("*msg", ARG_DEF)),
    3: ("output_arg", ("*msg", ARG_DEF)),
}
ARG_ATTRS = {1: ("attr", ("map", "string", ATTR))}
FUNCTION = {
    1: ("signature", ("msg", OP_DEF)),
    3: ("node_def", ("*msg", NODE)),
    4: ("ret", ("map", "string", "string")),
    5: ("attr", ("map", "string", ATTR)),
    6: ("control_ret", ("map", "string", "string")),
    7: ("arg_attr", ("map", "int", ARG_ATTRS)),
}
LIBRARY = {1: ("function", ("*msg", FUNCTION))}
GRAPH = {
    1: ("node", ("*msg", NODE)),
    2: ("library", ("msg", LIBRARY)),
    3: ("version", "int"),
}

# DataType enum -> the numpy dtype name TensorFlow's
# ``as_dtype(t).as_numpy_dtype.__name__`` gives (reference types, +100,
# read as their base type)
DTYPE_NAMES = {1: "float32", 2: "float64", 3: "int32", 4: "uint8",
               5: "int16", 6: "int8", 7: "object", 8: "complex64",
               9: "int64", 10: "bool", 14: "bfloat16", 17: "uint16",
               18: "complex128", 19: "float16", 22: "uint32",
               23: "uint64"}
DT_FLOAT, DT_DOUBLE, DT_STRING, DT_INT64 = 1, 2, 7, 9
DT_BOOL, DT_BFLOAT16, DT_HALF = 10, 14, 19


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------
def _read_varint(buf, pos: int) -> Tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _signed64(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed(payload, wire, kind):
    if kind == "*packedint":
        if wire == 0:
            return [_signed64(payload)]
        out, p = [], 0
        while p < len(payload):
            v, p = _read_varint(payload, p)
            out.append(_signed64(v))
        return out
    if kind == "*packedf32":
        if wire == 5:
            return [payload]
        return list(struct.unpack(f"<{len(payload) // 4}f", payload))
    if wire == 1:                                   # *packedf64
        return [payload]
    return list(struct.unpack(f"<{len(payload) // 8}d", payload))


def _scalar(payload, wire, kind):
    if kind == "int":
        return _signed64(payload)
    if kind == "bool":
        return bool(payload)
    if kind == "float32":
        return payload if wire == 5 else \
            struct.unpack("<f", struct.pack("<I", payload))[0]
    if kind in ("string", "*string"):
        return bytes(payload).decode("utf-8")
    if kind in ("bytes", "*bytes"):
        return bytes(payload)
    raise ValueError(f"Unknown kind {kind!r}")


def _map_entry(payload, key_kind, value_kind):
    key, value = ("" if key_kind == "string" else 0), None
    pos = 0
    while pos < len(payload):
        tag, pos = _read_varint(payload, pos)
        field, wire = tag >> 3, tag & 7
        raw, pos = _read_raw(payload, pos, wire)
        kind = key_kind if field == 1 else value_kind
        if field == 1:
            key = _scalar(raw, wire, kind)
        elif field == 2:
            value = (decode(raw, kind) if isinstance(kind, dict)
                     else _scalar(raw, wire, kind))
    if value is None:
        value = {} if isinstance(value_kind, dict) else ""
    return key, value


def _read_raw(buf, pos, wire):
    if wire == 0:
        return _read_varint(buf, pos)
    if wire == 5:
        return struct.unpack("<f", buf[pos:pos + 4])[0], pos + 4
    if wire == 1:
        return struct.unpack("<d", buf[pos:pos + 8])[0], pos + 8
    if wire == 2:
        ln, pos = _read_varint(buf, pos)
        return buf[pos:pos + ln], pos + ln
    raise ValueError(f"Unsupported wire type {wire}")


def decode(buf, schema: Dict[int, Tuple[str, Any]]) -> dict:
    buf = memoryview(buf)
    msg: Dict[str, Any] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        payload, pos = _read_raw(buf, pos, wire)
        entry = schema.get(field)
        if entry is None:
            continue
        name, kind = entry
        if isinstance(kind, tuple) and kind[0] == "map":
            k, v = _map_entry(payload, kind[1], kind[2])
            msg.setdefault(name, {})[k] = v
        elif isinstance(kind, tuple):
            sub = decode(payload, kind[1])
            if kind[0] == "*msg":
                msg.setdefault(name, []).append(sub)
            else:
                msg[name] = sub
        elif kind.startswith("*packed"):
            msg.setdefault(name, []).extend(_packed(payload, wire, kind))
        elif kind.startswith("*"):
            msg.setdefault(name, []).append(_scalar(payload, wire, kind))
        else:
            msg[name] = _scalar(payload, wire, kind)
    return msg


def decode_graph_def(buf) -> dict:
    """Serialized ``GraphDef`` bytes -> dict (``node``, ``library``)."""
    return decode(buf, GRAPH)


def load_graph_def(path: str) -> dict:
    with open(path, "rb") as f:
        return decode_graph_def(f.read())


# ---------------------------------------------------------------------------
# Values
# ---------------------------------------------------------------------------
def dtype_name(enum: int) -> str:
    """``dtypes.as_dtype(enum).as_numpy_dtype.__name__``."""
    name = DTYPE_NAMES.get(int(enum) % 100)
    if name is None:
        raise NotImplementedError(f"TF DataType {enum} has no mapping")
    return name


def attr_kind(value: dict):
    """The set member of AttrValue's ``value`` oneof (``WhichOneof``)."""
    return next((k for k in ATTR_ONEOF if k in value), None)


def shape_dims(shape: dict) -> List[int]:
    return [int(d.get("size", 0)) for d in shape.get("dim", [])]


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    # numpy has no bfloat16: widen the bits to float32 (exact)
    return (bits.astype(np.uint32) << 16).view(np.float32)


def make_ndarray(t: dict) -> np.ndarray:
    """``tensor_util.MakeNdarray``: ``tensor_content`` if present, else
    the typed ``*_val`` field; an empty value list gives zeros of the
    shape, fewer values than elements repeat the last one.  bfloat16
    comes back as float32 (numpy has no bfloat16; the widening is
    exact)."""
    shape = shape_dims(t.get("tensor_shape", {}))
    n = int(np.prod(shape, dtype=np.int64))
    dt = int(t.get("dtype", 0)) % 100
    name = dtype_name(dt)
    content = t.get("tensor_content")
    if content:
        if dt == DT_BFLOAT16:
            return _bf16_bits_to_f32(
                np.frombuffer(content, np.uint16)).reshape(shape)
        return np.frombuffer(content, name).copy().reshape(shape)
    if dt == DT_STRING:
        values = list(t.get("string_val", []))
        if n - len(values) > 0:
            values.extend([values[-1] if values else b""]
                          * (n - len(values)))
        return np.array(values, dtype=object).reshape(shape)
    if dt in (DT_HALF, DT_BFLOAT16):
        bits = np.asarray(t.get("half_val", []), np.int64).astype(np.uint16)
        values = (bits.view(np.float16) if dt == DT_HALF
                  else _bf16_bits_to_f32(bits))
    else:
        if name.startswith("complex"):
            raise NotImplementedError("complex TF constants")
        field = {DT_FLOAT: "float_val", DT_DOUBLE: "double_val",
                 DT_INT64: "int64_val", DT_BOOL: "bool_val",
                 22: "uint32_val", 23: "uint64_val"}.get(dt, "int_val")
        raw = t.get(field, [])
        values = np.asarray(raw).astype(name) if raw else np.zeros(0, name)
    if values.size == 0:
        return np.zeros(shape, values.dtype)
    if values.size != n:
        values = np.pad(values, (0, n - values.size), "edge")
    return values.reshape(shape)


# ---------------------------------------------------------------------------
# function_def_to_graph
# ---------------------------------------------------------------------------
# The output args of the mapped ops that have more than one (each of
# length 1); every other op has one output arg, so "node:arg:i" is
# flat output i.
_OUTPUT_ARGS = {
    "TopKV2": ("values", "indices"),
    "FusedBatchNorm": ("y", "batch_mean", "batch_variance",
                       "reserve_space_1", "reserve_space_2"),
    "FusedBatchNormV2": ("y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2"),
    "FusedBatchNormV3": ("y", "batch_mean", "batch_variance",
                         "reserve_space_1", "reserve_space_2",
                         "reserve_space_3"),
    "LSTMBlockCell": ("i", "cs", "f", "o", "ci", "co", "h"),
    "BlockLSTM": ("i", "cs", "f", "o", "ci", "co", "h"),
    "BlockLSTMV2": ("i", "cs", "f", "o", "ci", "co", "h"),
    "GRUBlockCell": ("r", "u", "c", "h"),
    "SoftmaxCrossEntropyWithLogits": ("loss", "backprop"),
    "SparseSoftmaxCrossEntropyWithLogits": ("loss", "backprop"),
    "Unique": ("y", "idx"),
}

# Attr defaults TensorFlow's graph import adds to function-body nodes
# that omit them, where the importer's own default differs.
_BODY_DEFAULTS = {
    "Placeholder": {"shape": {"shape": {"unknown_rank": True}}},
    "ResizeBilinear": {"half_pixel_centers": {"b": False},
                       "align_corners": {"b": False}},
    "ResizeNearestNeighbor": {"half_pixel_centers": {"b": False},
                              "align_corners": {"b": False}},
    "FusedBatchNorm": {"epsilon": {"f": 1e-4}},
    "FusedBatchNormV2": {"epsilon": {"f": 1e-4}},
    "FusedBatchNormV3": {"epsilon": {"f": 1e-4}},
}


def _flat_ref(ref: str, ops: Dict[str, str]) -> str:
    """A function-body tensor ref ``node:out_arg:i`` -> ``node:k``; an
    argument ``arg`` -> ``arg:0``; control refs unchanged."""
    if ref.startswith("^"):
        return ref
    parts = ref.split(":")
    if len(parts) == 1:
        return f"{ref}:0"
    if len(parts) != 3:
        raise ValueError(f"unexpected function tensor ref {ref!r}")
    node, arg, i = parts[0], parts[1], int(parts[2])
    args = _OUTPUT_ARGS.get(ops.get(node, ""))
    if args is None:
        return f"{node}:{i}"
    if arg not in args:
        raise ValueError(f"{ops[node]} has no output arg {arg!r}")
    return f"{node}:{args.index(arg) + i}"


def _topological(nodes: List[dict]) -> List[dict]:
    """TensorFlow's graph-import order: Kahn's algorithm taking the
    lowest-index ready node first (data and control edges)."""
    index = {n["name"]: i for i, n in enumerate(nodes)}
    pending = [0] * len(nodes)
    users: List[List[int]] = [[] for _ in nodes]
    for i, n in enumerate(nodes):
        for ref in n.get("input", []):
            src = index.get(ref.lstrip("^").split(":")[0])
            if src is not None:
                pending[i] += 1
                users[src].append(i)
    ready = [i for i, c in enumerate(pending) if c == 0]
    heapq.heapify(ready)
    order = []
    while ready:
        i = heapq.heappop(ready)
        order.append(nodes[i])
        for u in users[i]:
            pending[u] -= 1
            if pending[u] == 0:
                heapq.heappush(ready, u)
    if len(order) != len(nodes):
        raise ValueError("cyclic function body")
    return order


def function_def_to_graph(fdef: dict) -> Tuple[dict, List[str]]:
    """A ``FunctionDef`` -> (the GraphDef dict TensorFlow's
    ``function_def_to_graph(fdef).as_graph_def()`` gives, the function's
    output tensor names in signature order as the reference names them:
    ``node`` for output 0, ``node:k`` otherwise).

    Arguments become Placeholders (dtype from the arg, shape from the
    function's ``_input_shapes`` or the arg's ``_output_shapes``, else
    unknown rank); body refs ``node:out_arg:i`` are flattened; nodes are
    ordered as TensorFlow's import orders them."""
    sig = fdef.get("signature", {})
    in_args = sig.get("input_arg", [])
    fattr = fdef.get("attr", {})
    in_shapes = fattr.get("_input_shapes", {}).get("list", {}).get("shape")
    nodes = []
    for i, arg in enumerate(in_args):
        attr = {"dtype": {"type": arg.get("type", 0)}}
        if in_shapes and i < len(in_shapes):
            attr["shape"] = {"shape": in_shapes[i]}
        arg_attr = fdef.get("arg_attr", {}).get(i, {}).get("attr", {})
        out_shapes = arg_attr.get("_output_shapes")
        if out_shapes is not None:
            kind = attr_kind(out_shapes)
            if kind == "list" and out_shapes["list"].get("shape"):
                attr["shape"] = {"shape": out_shapes["list"]["shape"][0]}
            elif kind == "shape":
                attr["shape"] = {"shape": out_shapes["shape"]}
        attr.setdefault("shape", {"shape": {"unknown_rank": True}})
        nodes.append({"name": arg["name"], "op": "Placeholder",
                      "attr": attr})
    ops = {n["name"]: n["op"] for n in fdef.get("node_def", [])}
    for n in fdef.get("node_def", []):
        attr = dict(n.get("attr", {}))
        for k, v in _BODY_DEFAULTS.get(n["op"], {}).items():
            attr.setdefault(k, v)
        nodes.append(dict(n, attr=attr, input=[
            _flat_ref(r, ops) for r in n.get("input", [])]))
    rets = fdef.get("ret", {})
    outputs = []
    for arg in sig.get("output_arg", []):
        node, _, k = _flat_ref(rets[arg["name"]], ops).partition(":")
        outputs.append(node if k in ("", "0") else f"{node}:{k}")
    return {"node": _topological(nodes)}, outputs
