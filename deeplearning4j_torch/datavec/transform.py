"""TransformProcess (port of ``deeplearning4j_tpu/datavec/transform.py``:
``org.datavec.api.transform.TransformProcess``): an ordered, serializable list of schema-aware column transforms applied
record-by-record on the host.

Implemented transform subset (the ones the reference examples lean on):
remove/keep columns, categorical→integer, categorical→one-hot,
integer→categorical, double math ops, min-max normalize, string map,
filter rows, conditional replace.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Callable, Dict, List, Optional, Sequence

from deeplearning4j_torch.datavec.schema import ColumnMeta, Schema

_MATH_OPS = {
    "add": lambda a, b: a + b, "subtract": lambda a, b: a - b,
    "multiply": lambda a, b: a * b, "divide": lambda a, b: a / b,
    "modulus": lambda a, b: a % b, "reverse_subtract": lambda a, b: b - a,
    "reverse_divide": lambda a, b: b / a, "scalar_max": max,
    "scalar_min": min,
}


@dataclasses.dataclass
class _Step:
    kind: str
    args: Dict[str, Any]


class TransformProcess:
    """Built fluently against an input Schema; ``execute`` maps records,
    ``final_schema`` reports the output schema; JSON round-trips."""

    def __init__(self, initial_schema: Schema,
                 steps: Optional[List[_Step]] = None):
        self.initial_schema = initial_schema
        self.steps = steps or []

    class Builder:
        def __init__(self, schema: Schema):
            self._tp = TransformProcess(schema)

        def _add(self, kind, **args):
            self._tp.steps.append(_Step(kind, args))
            return self

        def remove_columns(self, *names):
            return self._add("remove_columns", names=list(names))

        def keep_columns(self, *names):
            return self._add("keep_columns", names=list(names))

        def categorical_to_integer(self, *names):
            return self._add("categorical_to_integer", names=list(names))

        def categorical_to_one_hot(self, *names):
            return self._add("categorical_to_one_hot", names=list(names))

        def integer_to_categorical(self, name, categories):
            return self._add("integer_to_categorical", name=name,
                             categories=list(categories))

        def double_math_op(self, name, op, scalar):
            if op not in _MATH_OPS:
                raise ValueError(f"Unknown math op {op!r}")
            return self._add("double_math_op", name=name, op=op,
                             scalar=scalar)

        def normalize_min_max(self, name, min_val, max_val):
            return self._add("normalize_min_max", name=name,
                             min=min_val, max=max_val)

        def string_map(self, name, mapping: Dict[str, str]):
            return self._add("string_map", name=name, mapping=dict(mapping))

        def filter_invalid(self, *names):
            """Drop records with NaN/None/empty in the named columns."""
            return self._add("filter_invalid", names=list(names))

        def replace_less_than(self, name, threshold, replacement):
            return self._add("replace_less_than", name=name,
                             threshold=threshold, replacement=replacement)

        def build(self) -> "TransformProcess":
            self._tp.final_schema()  # validate the chain eagerly
            return self._tp

    @staticmethod
    def builder(schema: Schema) -> "TransformProcess.Builder":
        return TransformProcess.Builder(schema)

    # ------------------------------------------------------------------
    def _apply_schema(self, schema: Schema, step: _Step) -> Schema:
        cols = list(schema.columns)
        k, a = step.kind, step.args
        if k in ("remove_columns", "keep_columns"):
            for n in a["names"]:
                schema.index_of(n)  # KeyError on unknown column
            if k == "remove_columns":
                return Schema([c for c in cols if c.name not in a["names"]])
            return Schema([c for c in cols if c.name in a["names"]])
        if k == "categorical_to_integer":
            out = []
            for c in cols:
                if c.name in a["names"]:
                    if c.col_type != "categorical":
                        raise ValueError(f"{c.name} is not categorical")
                    out.append(ColumnMeta(c.name, "integer"))
                else:
                    out.append(c)
            return Schema(out)
        if k == "categorical_to_one_hot":
            out = []
            for c in cols:
                if c.name in a["names"]:
                    if c.col_type != "categorical":
                        raise ValueError(f"{c.name} is not categorical")
                    out.extend(ColumnMeta(f"{c.name}[{cat}]", "double")
                               for cat in c.categories)
                else:
                    out.append(c)
            return Schema(out)
        if k == "integer_to_categorical":
            return Schema([ColumnMeta(c.name, "categorical",
                                      list(a["categories"]))
                           if c.name == a["name"] else c for c in cols])
        if k in ("double_math_op", "normalize_min_max",
                 "replace_less_than"):
            schema.index_of(a["name"])
            return schema
        if k in ("string_map", "filter_invalid"):
            for n in (a.get("names") or [a.get("name")]):
                schema.index_of(n)
            return schema
        raise ValueError(f"Unknown step kind {k!r}")

    def final_schema(self) -> Schema:
        s = self.initial_schema
        for step in self.steps:
            s = self._apply_schema(s, step)
        return s

    # ------------------------------------------------------------------
    def _apply_record(self, schema: Schema, step: _Step, rec: List):
        k, a = step.kind, step.args
        if k == "remove_columns":
            keep = [i for i, c in enumerate(schema.columns)
                    if c.name not in a["names"]]
            return [rec[i] for i in keep]
        if k == "keep_columns":
            keep = [i for i, c in enumerate(schema.columns)
                    if c.name in a["names"]]
            return [rec[i] for i in keep]
        if k == "categorical_to_integer":
            rec = list(rec)
            for n in a["names"]:
                i = schema.index_of(n)
                cats = schema.columns[i].categories
                try:
                    rec[i] = cats.index(str(rec[i]))
                except ValueError:
                    raise ValueError(
                        f"Value {rec[i]!r} not in categories of {n}: {cats}")
            return rec
        if k == "categorical_to_one_hot":
            out = []
            for i, c in enumerate(schema.columns):
                if c.name in a["names"]:
                    hot = [0.0] * len(c.categories)
                    hot[c.categories.index(str(rec[i]))] = 1.0
                    out.extend(hot)
                else:
                    out.append(rec[i])
            return out
        if k == "integer_to_categorical":
            i = schema.index_of(a["name"])
            rec = list(rec)
            rec[i] = a["categories"][int(rec[i])]
            return rec
        if k == "double_math_op":
            i = schema.index_of(a["name"])
            rec = list(rec)
            rec[i] = _MATH_OPS[a["op"]](float(rec[i]), a["scalar"])
            return rec
        if k == "normalize_min_max":
            i = schema.index_of(a["name"])
            rec = list(rec)
            rng = a["max"] - a["min"]
            rec[i] = (float(rec[i]) - a["min"]) / (rng or 1.0)
            return rec
        if k == "string_map":
            i = schema.index_of(a["name"])
            rec = list(rec)
            rec[i] = a["mapping"].get(str(rec[i]), rec[i])
            return rec
        if k == "filter_invalid":
            for n in a["names"]:
                v = rec[schema.index_of(n)]
                if v is None or v == "" or (
                        isinstance(v, float) and math.isnan(v)):
                    return None
            return rec
        if k == "replace_less_than":
            i = schema.index_of(a["name"])
            rec = list(rec)
            if float(rec[i]) < a["threshold"]:
                rec[i] = a["replacement"]
            return rec
        raise ValueError(f"Unknown step kind {k!r}")

    def execute(self, records) -> List[List]:
        """Apply all steps to an iterable of records (drops filtered)."""
        # Schemas are record-independent: compute the per-step input
        # schema chain once, not once per record.
        schemas = [self.initial_schema]
        for step in self.steps:
            schemas.append(self._apply_schema(schemas[-1], step))
        out = []
        for rec in records:
            cur: Optional[List] = list(rec)
            for schema, step in zip(schemas, self.steps):
                cur = self._apply_record(schema, step, cur)
                if cur is None:
                    break
            if cur is not None:
                out.append(cur)
        return out

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        return json.dumps({
            "initial_schema": self.initial_schema.to_dict(),
            "steps": [{"kind": s.kind, "args": s.args} for s in self.steps],
        })

    @staticmethod
    def from_json(s: str) -> "TransformProcess":
        d = json.loads(s)
        return TransformProcess(
            Schema.from_dict(d["initial_schema"]),
            [_Step(x["kind"], x["args"]) for x in d["steps"]])
