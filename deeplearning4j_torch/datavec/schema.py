"""Column schema (port of ``deeplearning4j_tpu/datavec/schema.py``:
``org.datavec.api.transform.schema.Schema``): named, typed columns with a
fluent builder; TransformProcess validates against and rewrites it."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

COLUMN_TYPES = ("double", "integer", "long", "categorical", "string",
                "time", "bytes")


@dataclasses.dataclass
class ColumnMeta:
    name: str
    col_type: str
    categories: Optional[List[str]] = None  # for categorical


class Schema:
    def __init__(self, columns: Optional[List[ColumnMeta]] = None):
        self.columns: List[ColumnMeta] = columns or []

    # -- fluent builder (Schema.Builder.addColumn*) --
    class Builder:
        def __init__(self):
            self._cols: List[ColumnMeta] = []

        def add_column_double(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "double"))
            return self

        def add_column_integer(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "integer"))
            return self

        def add_column_string(self, *names):
            for n in names:
                self._cols.append(ColumnMeta(n, "string"))
            return self

        def add_column_categorical(self, name, categories: Sequence[str]):
            self._cols.append(ColumnMeta(name, "categorical",
                                         list(categories)))
            return self

        def build(self) -> "Schema":
            return Schema(self._cols)

    @staticmethod
    def builder() -> "Schema.Builder":
        return Schema.Builder()

    def names(self) -> List[str]:
        return [c.name for c in self.columns]

    def index_of(self, name: str) -> int:
        for i, c in enumerate(self.columns):
            if c.name == name:
                return i
        raise KeyError(f"No column {name!r}; have {self.names()}")

    def column(self, name: str) -> ColumnMeta:
        return self.columns[self.index_of(name)]

    def to_dict(self) -> dict:
        return {"columns": [dataclasses.asdict(c) for c in self.columns]}

    @staticmethod
    def from_dict(d: dict) -> "Schema":
        return Schema([ColumnMeta(**c) for c in d["columns"]])
