"""Fluent network-configuration builder (port of
``deeplearning4j_tpu/nn/conf/builder.py``: what builds, reads and writes
a sequential stack's ``configuration.json``, and ``graph()``, which hands
the global defaults to ``models.computation_graph.GraphBuilder``).

The build step resolves global-default inheritance (``activation`` and
friends) and propagates InputType shapes, auto-filling ``n_in``, exactly
as the reference does — so the same builder calls produce the same JSON
in both packages.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional

from deeplearning4j_torch.nn.conf.base import (BaseLayerConf, GlobalConf,
                                               layer_from_dict)
from deeplearning4j_torch.nn.conf.inputs import (InputType, Preprocessor,
                                                 adapt)


class NeuralNetConfiguration:
    """Entry point: ``NeuralNetConfiguration.builder()`` (DL4J idiom)."""

    @staticmethod
    def builder() -> "Builder":
        return Builder()


class Builder:
    def __init__(self):
        self._g = GlobalConf()
        self.grad_normalization: Optional[str] = None
        self.grad_norm_threshold: float = 1.0

    def seed(self, s: int) -> "Builder":
        self._g.seed = int(s)
        return self

    def activation(self, a: str) -> "Builder":
        self._g.activation = a
        return self

    def weight_init(self, w: str,
                    distribution: Optional[dict] = None) -> "Builder":
        self._g.weight_init = str(w).lower()
        self._g.weight_distribution = distribution
        return self

    def updater(self, u) -> "Builder":
        """An updater (``optimize.updaters``) or its plain dict
        (``{"type": "Adam", ...}``), stored as the dict."""
        self._g.updater = u.to_dict() if hasattr(u, "to_dict") else dict(u)
        return self

    def l1(self, v: float) -> "Builder":
        self._g.l1 = float(v)
        return self

    def l2(self, v: float) -> "Builder":
        self._g.l2 = float(v)
        return self

    def weight_decay(self, v: float) -> "Builder":
        self._g.weight_decay = float(v)
        return self

    def dropout(self, rate: float) -> "Builder":
        self._g.dropout = float(rate)
        return self

    def dtype(self, d: str) -> "Builder":
        self._g.dtype = str(d)
        return self

    def compute_dtype(self, d: str) -> "Builder":
        """Matmul compute dtype ('bfloat16'); params stay in ``dtype``."""
        self._g.compute_dtype = str(d)
        return self

    def minimize(self, m: bool = True) -> "Builder":
        self._g.minimize = bool(m)
        return self

    def gradient_normalization(self, kind: str,
                               threshold: float = 1.0) -> "Builder":
        """DL4J ``GradientNormalization``: 'clip_l2_per_layer',
        'clip_element_wise_absolute_value', 'renormalize_l2_per_layer',
        'clip_l2_per_param_type', or 'clip_global_norm'."""
        self.grad_normalization = str(kind).lower()
        self.grad_norm_threshold = float(threshold)
        return self

    def list(self) -> "ListBuilder":
        return ListBuilder(self)

    def graph(self):
        """The DAG builder (DL4J ``graphBuilder()``), building a
        ``ComputationGraphConfiguration``."""
        from deeplearning4j_torch.models.computation_graph import (
            GraphBuilder)
        return GraphBuilder(self)


class ListBuilder:
    """Sequential-stack builder (DL4J ``NeuralNetConfiguration.ListBuilder``)."""

    def __init__(self, parent: Builder):
        self._parent = parent
        self._layers: List[BaseLayerConf] = []
        self._input_type: Optional[InputType] = None
        self._backprop_type: str = "standard"
        self._tbptt_fwd: Optional[int] = None
        self._tbptt_bwd: Optional[int] = None

    def layer(self, conf: BaseLayerConf) -> "ListBuilder":
        self._layers.append(conf)
        return self

    def set_input_type(self, it: InputType) -> "ListBuilder":
        self._input_type = it
        return self

    def backprop_type(self, kind: str, tbptt_fwd: int = None,
                      tbptt_bwd: int = None) -> "ListBuilder":
        """'standard' | 'truncated_bptt' (DL4J ``BackpropType`` and the
        tBPTT lengths)."""
        self._backprop_type = str(kind).lower()
        self._tbptt_fwd = tbptt_fwd
        self._tbptt_bwd = tbptt_bwd or tbptt_fwd
        return self

    def build(self) -> "MultiLayerConfiguration":
        if not self._layers:
            raise ValueError("No layers configured")
        g = self._parent._g
        for ly in self._layers:
            ly.resolve_defaults(g)
        preprocessors: List[Optional[Preprocessor]] = [None] * len(
            self._layers)
        it = self._input_type
        if it is None:
            n_in = getattr(self._layers[0], "n_in", None)
            if n_in is None:
                raise ValueError("Either set_input_type(...) or n_in on "
                                 "the first layer is required")
            it = InputType.feed_forward(n_in)
        input_type = it
        for i, ly in enumerate(self._layers):
            pre = None
            if "any" in ly.WANTED_KINDS or it.kind in ly.WANTED_KINDS:
                adapted = it
            else:
                err = None
                for kind in ly.WANTED_KINDS:
                    try:
                        pre, adapted = adapt(it, kind)
                        break
                    except ValueError as e:
                        err = e
                else:
                    raise ValueError(f"Layer {i} ({type(ly).__name__}): {err}")
            preprocessors[i] = pre
            out_shape = ly.infer_shapes(adapted.shape)
            out_kind = getattr(ly, "OUTPUT_KIND", None) or adapted.kind
            it = InputType(out_kind, tuple(out_shape))
        return MultiLayerConfiguration(
            global_conf=g, layers=self._layers, preprocessors=preprocessors,
            input_type=input_type, backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            grad_normalization=self._parent.grad_normalization,
            grad_norm_threshold=self._parent.grad_norm_threshold)


@dataclasses.dataclass
class MultiLayerConfiguration:
    """The serializable model IR — the JSON stored inside every
    checkpoint zip, key for key the reference's."""

    global_conf: GlobalConf
    layers: List[BaseLayerConf]
    preprocessors: List[Optional[Preprocessor]]
    input_type: Optional[InputType] = None
    backprop_type: str = "standard"
    tbptt_fwd_length: Optional[int] = None
    tbptt_bwd_length: Optional[int] = None
    grad_normalization: Optional[str] = None
    grad_norm_threshold: float = 1.0
    frozen_layers: List[int] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format": "deeplearning4j_tpu/MultiLayerConfiguration/v1",
            "global_conf": dataclasses.asdict(self.global_conf),
            "layers": [ly.to_dict() for ly in self.layers],
            "preprocessors": [p.to_dict() if p else None
                              for p in self.preprocessors],
            "input_type": (self.input_type.to_dict()
                           if self.input_type else None),
            "backprop_type": self.backprop_type,
            "tbptt_fwd_length": self.tbptt_fwd_length,
            "tbptt_bwd_length": self.tbptt_bwd_length,
            "grad_normalization": self.grad_normalization,
            "grad_norm_threshold": self.grad_norm_threshold,
            "frozen_layers": list(self.frozen_layers),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @staticmethod
    def from_dict(d: Dict[str, Any]) -> "MultiLayerConfiguration":
        g = GlobalConf(**d["global_conf"])
        layers = [layer_from_dict(ld) for ld in d["layers"]]
        pres = [Preprocessor.from_dict(p) if p else None
                for p in d["preprocessors"]]
        it = (InputType.from_dict(d["input_type"])
              if d.get("input_type") else None)
        return MultiLayerConfiguration(
            global_conf=g, layers=layers, preprocessors=pres, input_type=it,
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length"),
            tbptt_bwd_length=d.get("tbptt_bwd_length"),
            grad_normalization=d.get("grad_normalization"),
            grad_norm_threshold=d.get("grad_norm_threshold", 1.0),
            frozen_layers=list(d.get("frozen_layers", [])),
        )

    @staticmethod
    def from_json(s: str) -> "MultiLayerConfiguration":
        return MultiLayerConfiguration.from_dict(json.loads(s))
