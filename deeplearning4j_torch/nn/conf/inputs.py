"""Input types and automatic shape preprocessors (port of
``deeplearning4j_tpu/nn/conf/inputs.py``): the feed-forward, recurrent,
convolutional, flat-convolutional and volumetric (``cnn3d``, NDHWC)
input types, the reshapes between them, and their JSON round trip.

Images are NHWC end to end, as in the reference: "convolutional(h, w,
c)" is a [batch, h, w, c] tensor.  Recurrent data is [batch, time,
features] (DL4J uses [batch, features, time]; iterators adapt)."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    """kind: 'ff' (features,), 'cnn' (h, w, c), 'cnn_flat' (h, w, c)
    arriving flattened, 'cnn3d' (d, h, w, c), 'rnn' (time, features).
    Shapes are batch-free; time may be None."""

    kind: str
    shape: Tuple[Optional[int], ...]

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", (int(size),))

    @staticmethod
    def convolutional(height: int, width: int,
                      channels: int) -> "InputType":
        return InputType("cnn", (int(height), int(width), int(channels)))

    @staticmethod
    def convolutional_flat(height: int, width: int,
                           channels: int) -> "InputType":
        """DL4J's convolutionalFlat: data arrives flattened, the first
        layer is a convolution."""
        return InputType("cnn_flat", (int(height), int(width),
                                      int(channels)))

    @staticmethod
    def convolutional3d(depth: int, height: int, width: int,
                        channels: int) -> "InputType":
        """NDHWC volumetric input (DL4J InputType.convolutional3D)."""
        return InputType("cnn3d", (int(depth), int(height), int(width),
                                   int(channels)))

    @staticmethod
    def recurrent(size: int, timesteps: Optional[int] = None) -> "InputType":
        return InputType("rnn", (timesteps, int(size)))

    def flat_size(self) -> int:
        n = 1
        for s in self.shape:
            if s is not None:
                n *= s
        return n

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
        if self.name == "cnn_to_ff":          # [b,h,w,c] -> [b, h*w*c]
            return x.reshape(x.shape[0], -1)
        if self.name == "ff_to_cnn":          # [b, n] -> [b,h,w,c]
            h, w, c = self.spec
            return x.reshape(x.shape[0], h, w, c)
        if self.name == "rnn_to_ff":          # [b,t,f] -> [b*t, f]
            return x.reshape(-1, x.shape[-1])
        if self.name == "ff_to_rnn":          # [b*t, f] -> [b,t,f]
            (t,) = self.spec
            return x.reshape(-1, t, x.shape[-1])
        if self.name == "cnn_to_rnn":         # [b,h,w,c] -> [b, w, h*c]
            # width is time, as in the reference
            return x.permute(0, 2, 1, 3).reshape(x.shape[0], x.shape[2], -1)
        if self.name == "cnn3d_to_ff":        # [b,d,h,w,c] -> [b, d*h*w*c]
            return x.reshape(x.shape[0], -1)
        if self.name == "identity":
            return x
        raise ValueError(f"Unknown preprocessor {self.name!r}")

    def to_dict(self):
        return {"name": self.name, "spec": list(self.spec)}

    @staticmethod
    def from_dict(d):
        return Preprocessor(d["name"], tuple(d.get("spec", ())))


def adapt(input_type: InputType, wanted_kind: str):
    """(preprocessor | None, new InputType) adapting ``input_type`` to the
    kind a layer wants ('ff'/'cnn'/'rnn'/'any') — DL4J's automatic
    InputPreProcessor insertion.  ff -> cnn needs an explicit
    ``convolutional_flat`` and ff -> rnn has no adapter, as in the
    reference."""
    kind = input_type.kind
    if wanted_kind in ("any", kind):
        return None, input_type
    if kind == "cnn_flat" and wanted_kind == "cnn":
        h, w, c = input_type.shape
        return (Preprocessor("ff_to_cnn", (h, w, c)),
                InputType("cnn", (h, w, c)))
    if kind == "cnn_flat" and wanted_kind == "ff":
        return None, InputType("ff", (input_type.flat_size(),))
    if kind == "cnn" and wanted_kind == "ff":
        return (Preprocessor("cnn_to_ff"),
                InputType("ff", (input_type.flat_size(),)))
    if kind == "ff" and wanted_kind == "cnn":
        raise ValueError(
            "ff->cnn requires explicit InputType.convolutional_flat")
    if kind == "cnn" and wanted_kind == "rnn":
        h, w, c = input_type.shape
        return Preprocessor("cnn_to_rnn"), InputType("rnn", (w, h * c))
    if kind == "cnn3d" and wanted_kind == "ff":
        return (Preprocessor("cnn3d_to_ff"),
                InputType("ff", (input_type.flat_size(),)))
    if kind == "rnn" and wanted_kind == "ff":
        t, f = input_type.shape
        # Dense over every timestep: fold time into batch (DL4J
        # RnnToFeedForwardPreProcessor semantics).
        return Preprocessor("rnn_to_ff"), InputType("ff", (f,))
    raise ValueError(f"No preprocessor from {kind!r} to {wanted_kind!r}")
