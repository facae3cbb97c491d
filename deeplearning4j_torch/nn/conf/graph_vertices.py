"""Graph vertices: the non-layer nodes of a ComputationGraph (port of
``deeplearning4j_tpu/nn/conf/graph_vertices.py``).

``MergeVertex``, ``ElementWiseVertex``, ``SubsetVertex``, ``ScaleVertex``,
``ShiftVertex``, ``StackVertex``, ``UnstackVertex``, ``L2NormalizeVertex``,
``ReshapeVertex`` and ``PreprocessorVertex``, with the same fields and
JSON as the reference's.  A vertex is a function of tensors; autograd
gives its backward.  Shapes follow the layer configs: batch-major, NHWC
images, [batch, time, features] sequences.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from deeplearning4j_torch.nn.conf.inputs import InputType, Preprocessor

_VERTEX_REGISTRY: Dict[str, type] = {}


def register_vertex(cls):
    _VERTEX_REGISTRY[cls.__name__] = cls
    return cls


def vertex_from_dict(d: Dict[str, Any]) -> "BaseGraphVertex":
    d = dict(d)
    type_name = d.pop("type")
    cls = _VERTEX_REGISTRY.get(type_name)
    if cls is None:
        raise ValueError(f"Unknown vertex type {type_name!r} in config")
    field_names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in d.items() if k in field_names}
    if "preprocessor" in kwargs and isinstance(kwargs["preprocessor"], dict):
        kwargs["preprocessor"] = Preprocessor.from_dict(kwargs["preprocessor"])
    return cls(**kwargs)


@dataclasses.dataclass
class BaseGraphVertex:
    """A parameterless DAG node combining/reshaping one or more inputs."""

    def n_inputs(self) -> Tuple[int, Optional[int]]:
        """(min, max) accepted fan-in; max None = unbounded."""
        return (1, 1)

    def infer_shapes(self, input_types: List[InputType]) -> InputType:
        return input_types[0]

    def apply(self, inputs: List[torch.Tensor]) -> torch.Tensor:
        raise NotImplementedError

    def to_dict(self) -> Dict[str, Any]:
        d = {"type": type(self).__name__}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v is not None and v != f.default:
                d[f.name] = v.to_dict() if hasattr(v, "to_dict") else v
        return d


@register_vertex
@dataclasses.dataclass
class MergeVertex(BaseGraphVertex):
    """Concatenate along the feature axis (the last axis here; DL4J's
    dim 1 of NCHW / [b, f, t] is the same semantic axis)."""

    def n_inputs(self):
        return (1, None)

    def infer_shapes(self, input_types):
        kinds = {it.kind for it in input_types}
        if len(kinds) != 1:
            raise ValueError(
                f"MergeVertex inputs must share a kind, got {kinds}")
        first = input_types[0]
        feat = sum(it.shape[-1] for it in input_types)
        return InputType(first.kind, first.shape[:-1] + (feat,))

    def apply(self, inputs):
        return inputs[0] if len(inputs) == 1 else torch.cat(inputs, -1)


@register_vertex
@dataclasses.dataclass
class ElementWiseVertex(BaseGraphVertex):
    """Pointwise combine — the residual-add vertex of ResNet
    (``ElementWiseVertex.Op.{Add,Subtract,Product,Average,Max}``)."""

    op: str = "add"

    def n_inputs(self):
        return (1, None) if self.op in ("add", "average", "product",
                                        "max") else (2, 2)

    def infer_shapes(self, input_types):
        shapes = {it.shape for it in input_types}
        if len(shapes) != 1:
            raise ValueError(
                f"ElementWiseVertex inputs must share a shape, got {shapes}")
        return input_types[0]

    def apply(self, inputs):
        op = self.op
        acc = inputs[0]
        for x in inputs[1:]:
            if op in ("add", "average"):
                acc = acc + x
            elif op == "subtract":
                acc = acc - x
            elif op == "product":
                acc = acc * x
            elif op == "max":
                acc = torch.maximum(acc, x)
            else:
                raise ValueError(f"Unknown ElementWiseVertex op {op!r}")
        if op == "average":
            acc = acc / len(inputs)
        return acc


@register_vertex
@dataclasses.dataclass
class SubsetVertex(BaseGraphVertex):
    """Feature-axis slice [from, to] INCLUSIVE (DL4J ``SubsetVertex``)."""

    from_index: int = 0
    to_index: int = 0

    def infer_shapes(self, input_types):
        it = input_types[0]
        n = self.to_index - self.from_index + 1
        return InputType(it.kind, it.shape[:-1] + (n,))

    def apply(self, inputs):
        return inputs[0][..., self.from_index:self.to_index + 1]


@register_vertex
@dataclasses.dataclass
class ScaleVertex(BaseGraphVertex):
    scale_factor: float = 1.0

    def apply(self, inputs):
        return inputs[0] * self.scale_factor


@register_vertex
@dataclasses.dataclass
class ShiftVertex(BaseGraphVertex):
    shift_factor: float = 0.0

    def apply(self, inputs):
        return inputs[0] + self.shift_factor


@register_vertex
@dataclasses.dataclass
class StackVertex(BaseGraphVertex):
    """Stack along the BATCH axis (DL4J ``StackVertex`` — shared weights
    over several inputs; ``UnstackVertex`` splits back)."""

    def n_inputs(self):
        return (1, None)

    def infer_shapes(self, input_types):
        return input_types[0]

    def apply(self, inputs):
        return torch.cat(inputs, 0)


@register_vertex
@dataclasses.dataclass
class UnstackVertex(BaseGraphVertex):
    """Take batch-slab ``from_index`` of ``stack_size`` equal slabs
    (DL4J ``UnstackVertex``)."""

    from_index: int = 0
    stack_size: int = 1

    def apply(self, inputs):
        x = inputs[0]
        step = x.shape[0] // self.stack_size
        return x[self.from_index * step:(self.from_index + 1) * step]


@register_vertex
@dataclasses.dataclass
class L2NormalizeVertex(BaseGraphVertex):
    """Normalize each example to unit L2 norm over all non-batch axes
    (DL4J ``L2NormalizeVertex``)."""

    eps: float = 1e-8

    def apply(self, inputs):
        x = inputs[0]
        axes = tuple(range(1, x.ndim))
        n = torch.sqrt(torch.sum(torch.square(x), dim=axes, keepdim=True))
        return x / (n + self.eps)


@register_vertex
@dataclasses.dataclass
class ReshapeVertex(BaseGraphVertex):
    """Reshape to ``new_shape`` (batch-free; the batch dim is kept, as in
    the reference)."""

    new_shape: Sequence[int] = ()
    kind: str = "ff"  # InputType kind of the result

    def infer_shapes(self, input_types):
        return InputType(self.kind, tuple(self.new_shape))

    def apply(self, inputs):
        x = inputs[0]
        return x.reshape((x.shape[0],) + tuple(self.new_shape))


@register_vertex
@dataclasses.dataclass
class PreprocessorVertex(BaseGraphVertex):
    """Wrap an InputPreProcessor as a standalone vertex
    (DL4J ``PreprocessorVertex``)."""

    preprocessor: Optional[Preprocessor] = None

    def infer_shapes(self, input_types):
        it = input_types[0]
        name = self.preprocessor.name
        if name == "cnn_to_ff":
            return InputType("ff", (it.flat_size(),))
        if name == "ff_to_cnn":
            return InputType("cnn", tuple(self.preprocessor.spec))
        if name == "rnn_to_ff":
            return InputType("ff", (it.shape[-1],))
        if name == "ff_to_rnn":
            (t,) = self.preprocessor.spec
            return InputType("rnn", (t, it.shape[-1]))
        if name == "cnn_to_rnn":
            h, w, c = it.shape
            return InputType("rnn", (w, h * c))
        return it

    def apply(self, inputs):
        return self.preprocessor(inputs[0])
