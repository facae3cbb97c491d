"""Input types and shape preprocessors (port of
``deeplearning4j_tpu/nn/conf/inputs.py``, trimmed to what the transformer
stacks' configurations read and write: the feed-forward and recurrent
input types, the one preprocessor the builder inserts between them, and
their JSON round trip; the convolutional kinds come with the conv
stack).

Recurrent data is [batch, time, features] (DL4J uses [batch, features,
time]; iterators adapt)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    """kind: 'ff' (features,), 'rnn' (time, features).  Shapes are
    batch-free; time may be None."""

    kind: str
    shape: Tuple[Optional[int], ...]

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", (int(size),))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", (timesteps, int(size)))

    def to_dict(self):
        return {"kind": self.kind, "shape": list(self.shape)}

    @staticmethod
    def from_dict(d):
        return InputType(d["kind"], tuple(d["shape"]))


@dataclasses.dataclass(frozen=True)
class Preprocessor:
    """name identifies the reshape; spec carries static dims it needs."""

    name: str
    spec: Tuple[int, ...] = ()

    def __call__(self, x):
        if self.name == "rnn_to_ff":          # [b,t,f] -> [b*t, f]
            return x.reshape(-1, x.shape[-1])
        raise ValueError(f"Preprocessor {self.name!r} is not ported yet")

    def to_dict(self):
        return {"name": self.name, "spec": list(self.spec)}

    @staticmethod
    def from_dict(d):
        return Preprocessor(d["name"], tuple(d.get("spec", ())))


def adapt(input_type: InputType, wanted_kind: str):
    """(preprocessor | None, new InputType) adapting ``input_type`` to the
    kind a layer wants ('ff'/'rnn'/'any') — DL4J's automatic
    InputPreProcessor insertion.  ff -> rnn has no automatic adapter, as
    in the reference."""
    kind = input_type.kind
    if wanted_kind in ("any", kind):
        return None, input_type
    if kind == "rnn" and wanted_kind == "ff":
        t, f = input_type.shape
        # Dense over every timestep: fold time into batch (DL4J
        # RnnToFeedForwardPreProcessor semantics).
        return Preprocessor("rnn_to_ff"), InputType("ff", (f,))
    raise ValueError(f"No preprocessor from {kind!r} to {wanted_kind!r}")
