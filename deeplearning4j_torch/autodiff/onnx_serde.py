"""Minimal ONNX protobuf wire codec (reader + writer) — a copy of
``deeplearning4j_tpu/autodiff/onnx_serde.py`` (pure Python; the copy
exists because the JAX package's ``__init__`` imports jax).

No ``onnx`` package is needed: this module implements the protobuf WIRE
FORMAT directly against the ONNX IR field schema — the field numbers
below are the ONNX IR spec's, stable since IR version 3 (ModelProto.graph=7,
GraphProto.node=1/initializer=5/input=11/output=12, NodeProto
input=1/output=2/op_type=4/attribute=5, AttributeProto
f=2/i=3/s=4/t=5/ints=8/type=20, TensorProto dims=1/data_type=2/
float_data=4/int64_data=7/name=8/raw_data=9).  PROVENANCE: written from
the published schema, not copied from generated code; files produced by
real onnx tooling parse here because the wire format is fixed by these
numbers, and files written here parse with real onnx.  Round-trip and
torch-golden tests in ``tests/test_onnx_import.py``.

Messages decode into plain ``dict``s: scalar fields hold values,
repeated fields hold lists; unknown field numbers are skipped (forward
compatibility, exactly like protobuf).
"""
from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# kind: "int" varint, "float32" fixed32, "bytes"/"string" length-delim,
# ("msg", Schema) nested; prefix "*" = repeated; "*packedint"/"*packedf32"
# are packed repeated scalars (proto3 default for ONNX's numeric lists).
TENSOR = {
    1: ("dims", "*packedint"),
    2: ("data_type", "int"),
    4: ("float_data", "*packedf32"),
    5: ("int32_data", "*packedint"),
    7: ("int64_data", "*packedint"),
    8: ("name", "string"),
    9: ("raw_data", "bytes"),
    10: ("double_data", "*packedf64"),
}
DIMENSION = {1: ("dim_value", "int"), 2: ("dim_param", "string")}
SHAPE = {1: ("dim", ("*msg", DIMENSION))}
TENSOR_TYPE = {1: ("elem_type", "int"), 2: ("shape", ("msg", SHAPE))}
TYPE = {1: ("tensor_type", ("msg", TENSOR_TYPE))}
VALUE_INFO = {1: ("name", "string"), 2: ("type", ("msg", TYPE))}
ATTRIBUTE: Dict[int, Tuple[str, Any]] = {
    1: ("name", "string"),
    2: ("f", "float32"),
    3: ("i", "int"),
    4: ("s", "bytes"),
    5: ("t", ("msg", TENSOR)),
    7: ("floats", "*packedf32"),
    8: ("ints", "*packedint"),
    9: ("strings", "*bytes"),
    20: ("type", "int"),
}
NODE = {
    1: ("input", "*string"),
    2: ("output", "*string"),
    3: ("name", "string"),
    4: ("op_type", "string"),
    5: ("attribute", ("*msg", ATTRIBUTE)),
    7: ("domain", "string"),
}
GRAPH = {
    1: ("node", ("*msg", NODE)),
    2: ("name", "string"),
    5: ("initializer", ("*msg", TENSOR)),
    11: ("input", ("*msg", VALUE_INFO)),
    12: ("output", ("*msg", VALUE_INFO)),
    13: ("value_info", ("*msg", VALUE_INFO)),
}
OPSET = {1: ("domain", "string"), 2: ("version", "int")}
MODEL = {
    1: ("ir_version", "int"),
    2: ("producer_name", "string"),
    3: ("producer_version", "string"),
    5: ("model_version", "int"),
    7: ("graph", ("msg", GRAPH)),
    8: ("opset_import", ("*msg", OPSET)),
}

# AttributeProto.type enum
ATTR_FLOAT, ATTR_INT, ATTR_STRING, ATTR_TENSOR = 1, 2, 3, 4
ATTR_FLOATS, ATTR_INTS, ATTR_STRINGS = 6, 7, 8
# TensorProto.data_type enum (subset)
DT_FLOAT, DT_UINT8, DT_INT8, DT_INT32, DT_INT64 = 1, 2, 3, 6, 7
DT_BOOL, DT_FLOAT16, DT_DOUBLE, DT_BF16 = 9, 10, 11, 16


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------
def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
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


def decode(buf: bytes, schema: Dict[int, Tuple[str, Any]]) -> dict:
    msg: Dict[str, Any] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        entry = schema.get(field)
        # read the payload regardless (skipping unknown fields)
        if wire == 0:
            val, pos = _read_varint(buf, pos)
            payload: Any = val
        elif wire == 5:
            payload = struct.unpack("<f", buf[pos:pos + 4])[0]
            pos += 4
        elif wire == 1:
            payload = struct.unpack("<d", buf[pos:pos + 8])[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            payload = buf[pos:pos + ln]
            pos += ln
        else:
            raise ValueError(f"Unsupported wire type {wire}")
        if entry is None:
            continue
        name, kind = entry
        rep = isinstance(kind, str) and kind.startswith("*") or \
            isinstance(kind, tuple) and kind[0] == "*msg"
        if isinstance(kind, tuple):
            sub = decode(payload, kind[1])
            val2: Any = sub
        elif kind in ("int",):
            val2 = _signed64(payload)
        elif kind == "float32":
            val2 = payload if wire == 5 else \
                struct.unpack("<f", struct.pack("<I", payload))[0]
        elif kind in ("string", "*string"):
            val2 = payload.decode("utf-8")
        elif kind in ("bytes", "*bytes"):
            val2 = payload
        elif kind == "*packedint":
            if wire == 0:                 # unpacked single element
                val2 = [_signed64(payload)]
            else:
                val2, p2 = [], 0
                while p2 < len(payload):
                    v, p2 = _read_varint(payload, p2)
                    val2.append(_signed64(v))
            msg.setdefault(name, []).extend(val2)
            continue
        elif kind == "*packedf32":
            if wire == 5:
                val2 = [payload]
            else:
                val2 = list(struct.unpack(f"<{len(payload)//4}f", payload))
            msg.setdefault(name, []).extend(val2)
            continue
        elif kind == "*packedf64":
            if wire == 1:
                val2 = [payload]
            else:
                val2 = list(struct.unpack(f"<{len(payload)//8}d", payload))
            msg.setdefault(name, []).extend(val2)
            continue
        else:
            raise ValueError(f"Unknown kind {kind!r}")
        if rep:
            msg.setdefault(name, []).append(val2)
        else:
            msg[name] = val2
    return msg


def load_model(path: str) -> dict:
    with open(path, "rb") as f:
        return decode(f.read(), MODEL)


# ---------------------------------------------------------------------------
# Writer (fixture generation + framework export)
# ---------------------------------------------------------------------------
def _varint(v: int) -> bytes:
    if v < 0:
        v += 1 << 64
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire: int) -> bytes:
    return _varint((field << 3) | wire)


def _ld(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def encode(msg: dict, schema: Dict[int, Tuple[str, Any]]) -> bytes:
    by_name = {name: (field, kind)
               for field, (name, kind) in schema.items()}
    out = bytearray()
    for name, value in msg.items():
        if name not in by_name or value is None:
            continue
        field, kind = by_name[name]
        if isinstance(kind, tuple):
            sub_schema = kind[1]
            vals = value if kind[0] == "*msg" else [value]
            for v in vals:
                out += _ld(field, encode(v, sub_schema))
        elif kind == "int":
            out += _tag(field, 0) + _varint(int(value))
        elif kind == "float32":
            out += _tag(field, 5) + struct.pack("<f", float(value))
        elif kind == "string":
            out += _ld(field, str(value).encode("utf-8"))
        elif kind == "bytes":
            out += _ld(field, bytes(value))
        elif kind == "*string":
            for v in value:
                out += _ld(field, str(v).encode("utf-8"))
        elif kind == "*bytes":
            for v in value:
                out += _ld(field, bytes(v))
        elif kind == "*packedint":
            out += _ld(field, b"".join(_varint(int(v)) for v in value))
        elif kind == "*packedf32":
            out += _ld(field, struct.pack(f"<{len(value)}f", *value))
        elif kind == "*packedf64":
            out += _ld(field, struct.pack(f"<{len(value)}d", *value))
        else:
            raise ValueError(f"Unknown kind {kind!r}")
    return bytes(out)


def save_model(model: dict, path: str):
    with open(path, "wb") as f:
        f.write(encode(model, MODEL))


# ---------------------------------------------------------------------------
# Convenience builders (fixture generation)
# ---------------------------------------------------------------------------
import numpy as np

_NP_TO_DT = {"float32": DT_FLOAT, "float64": DT_DOUBLE, "int32": DT_INT32,
             "int64": DT_INT64, "uint8": DT_UINT8, "int8": DT_INT8,
             "bool": DT_BOOL, "float16": DT_FLOAT16}
DT_TO_NP = {v: k for k, v in _NP_TO_DT.items()}
DT_TO_NP[DT_BF16] = "bfloat16"


def tensor(name: str, arr: np.ndarray) -> dict:
    arr = np.ascontiguousarray(arr)
    return {"name": name, "dims": list(arr.shape),
            "data_type": _NP_TO_DT[arr.dtype.name],
            "raw_data": arr.tobytes()}


def tensor_to_numpy(t: dict) -> np.ndarray:
    import numpy as np
    dt = DT_TO_NP[t.get("data_type", DT_FLOAT)]
    dims = t.get("dims", [])
    if "raw_data" in t and t["raw_data"]:
        if dt == "bfloat16":
            # numpy has no bfloat16: widen the bits to float32 (exact)
            bits = np.frombuffer(t["raw_data"], np.uint16).astype(np.uint32)
            return (bits << 16).view(np.float32).reshape(dims)
        return np.frombuffer(t["raw_data"], dt).reshape(dims).copy()
    if t.get("float_data"):
        return np.asarray(t["float_data"], np.float32).reshape(dims)
    if t.get("int64_data"):
        return np.asarray(t["int64_data"], np.int64).reshape(dims)
    if t.get("int32_data"):
        return np.asarray(t["int32_data"], dt if dt != "float32"
                          else np.int32).reshape(dims)
    if t.get("double_data"):
        return np.asarray(t["double_data"], np.float64).reshape(dims)
    return np.zeros(dims, dt)


def attr(name: str, value) -> dict:
    if isinstance(value, float):
        return {"name": name, "type": ATTR_FLOAT, "f": value}
    if isinstance(value, (bool, int, np.integer)):
        return {"name": name, "type": ATTR_INT, "i": int(value)}
    if isinstance(value, str):
        return {"name": name, "type": ATTR_STRING,
                "s": value.encode("utf-8")}
    if isinstance(value, np.ndarray):
        return {"name": name, "type": ATTR_TENSOR,
                "t": tensor(name, value)}
    if isinstance(value, (list, tuple)):
        if all(isinstance(v, (int, np.integer)) for v in value):
            return {"name": name, "type": ATTR_INTS,
                    "ints": [int(v) for v in value]}
        if all(isinstance(v, float) for v in value):
            return {"name": name, "type": ATTR_FLOATS,
                    "floats": list(value)}
    raise ValueError(f"Unsupported attr {name}={value!r}")


def node(op_type: str, inputs, outputs, name: str = "", **attrs) -> dict:
    return {"op_type": op_type, "input": list(inputs),
            "output": list(outputs), "name": name or outputs[0],
            "attribute": [attr(k, v) for k, v in attrs.items()]}


def value_info(name: str, shape, elem_type: int = DT_FLOAT) -> dict:
    dims = [{"dim_param": "N"} if d is None else {"dim_value": int(d)}
            for d in shape]
    return {"name": name,
            "type": {"tensor_type": {"elem_type": elem_type,
                                     "shape": {"dim": dims}}}}


def model(graph_nodes, inputs, outputs, initializers,
          opset_version: int = 17, name: str = "g") -> dict:
    return {"ir_version": 8, "producer_name": "deeplearning4j_torch",
            "opset_import": [{"domain": "", "version": opset_version}],
            "graph": {"name": name, "node": list(graph_nodes),
                      "input": list(inputs), "output": list(outputs),
                      "initializer": list(initializers)}}
