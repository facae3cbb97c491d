"""ComputationGraph: the DAG model, multi-input and multi-output (port of
``deeplearning4j_tpu/models/computation_graph.py``).

Named vertices wired by name, executed in topological order; a layer
with several inputs gets an implicit merge; the losses of several output
layers sum.  ``GraphBuilder`` and ``ComputationGraphConfiguration`` build,
read and write the reference's ``configuration.json``
(``deeplearning4j_tpu/ComputationGraphConfiguration/v1``), cycle check
included.

``params_tree`` and ``state_tree`` are keyed by vertex name (every
vertex has an entry, empty for vertices without parameters or state),
as plain dictionaries of tensors on ``self.device`` with the reference's
leaf names and layouts, so checkpoints and JAX trees carry over leaf by
leaf.  Training is the eager ``Solver.step`` (forward, loss, autograd,
updater, in-place update) behind ``fit`` and ``compiled_train_step``;
both store the new state the forward returns (batch-norm statistics; a
recurrent vertex's carry, which flows across the tBPTT chunks of a batch
— ``rnn_clear_previous_state`` comes from ``BaseNetwork``).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Union

import torch

from deeplearning4j_torch.data.dataset import DataSet, MultiDataSet
from deeplearning4j_torch.models.network import BaseNetwork
from deeplearning4j_torch.nn.conf.base import (BaseLayerConf, GlobalConf,
                                               apply_layer, layer_from_dict)
from deeplearning4j_torch.nn.conf.graph_vertices import (BaseGraphVertex,
                                                         MergeVertex,
                                                         vertex_from_dict)
from deeplearning4j_torch.nn.conf.inputs import InputType, Preprocessor, adapt
from deeplearning4j_torch.nn.conf.layers_core import BaseOutputLayerConf
from deeplearning4j_torch.runtime.backend import resolve_device
from deeplearning4j_torch.runtime.rng import fold_in, split
from deeplearning4j_torch.utils.trees import iter_leaves, map_leaves


@dataclasses.dataclass
class VertexSpec:
    """One named DAG node: a layer (with an optional auto-inserted
    preprocessor — DL4J's ``LayerVertex``) or a combining GraphVertex."""

    layer: Optional[BaseLayerConf] = None
    vertex: Optional[BaseGraphVertex] = None
    preprocessor: Optional[Preprocessor] = None

    def to_dict(self):
        d: Dict[str, Any] = {}
        if self.layer is not None:
            d["layer"] = self.layer.to_dict()
        if self.vertex is not None:
            d["vertex"] = self.vertex.to_dict()
        if self.preprocessor is not None:
            d["preprocessor"] = self.preprocessor.to_dict()
        return d

    @staticmethod
    def from_dict(d):
        return VertexSpec(
            layer=layer_from_dict(d["layer"]) if d.get("layer") else None,
            vertex=vertex_from_dict(d["vertex"]) if d.get("vertex") else None,
            preprocessor=(Preprocessor.from_dict(d["preprocessor"])
                          if d.get("preprocessor") else None),
        )


def _topological_order(network_inputs: Sequence[str],
                       vertex_inputs: Dict[str, Sequence[str]]) -> List[str]:
    """Kahn's algorithm over vertex names, ready vertices in sorted order
    (DL4J ``ComputationGraph.topologicalSortOrder``)."""
    produced = set(network_inputs)
    remaining = dict(vertex_inputs)
    order: List[str] = []
    while remaining:
        ready = [n for n, ins in remaining.items()
                 if all(i in produced for i in ins)]
        if not ready:
            unresolved = {n: [i for i in ins if i not in produced]
                          for n, ins in remaining.items()}
            raise ValueError(
                f"Graph has a cycle or missing inputs: {unresolved}")
        for n in sorted(ready):
            order.append(n)
            produced.add(n)
            del remaining[n]
    return order


class GraphBuilder:
    """Fluent DAG builder (DL4J
    ``ComputationGraphConfiguration.GraphBuilder``)."""

    def __init__(self, parent):
        self._parent = parent  # nn.conf.builder.Builder (global defaults)
        self._inputs: List[str] = []
        self._outputs: List[str] = []
        self._vertices: Dict[str, VertexSpec] = {}
        self._vertex_inputs: Dict[str, List[str]] = {}
        self._input_types: Dict[str, InputType] = {}
        self._backprop_type: str = "standard"
        self._tbptt_fwd: Optional[int] = None
        self._tbptt_bwd: Optional[int] = None

    def add_inputs(self, *names: str) -> "GraphBuilder":
        for n in names:
            self._check_name(n)
            self._inputs.append(n)
        return self

    def set_input_types(self, *types: InputType) -> "GraphBuilder":
        """Positional, matching ``add_inputs`` order (DL4J setInputTypes)."""
        for name, it in zip(self._inputs, types):
            self._input_types[name] = it
        return self

    def _check_name(self, name: str):
        if name in self._vertices or name in self._inputs:
            raise ValueError(f"Duplicate vertex name {name!r}")
        return name

    def add_layer(self, name: str, layer: BaseLayerConf,
                  *inputs: str) -> "GraphBuilder":
        self._check_name(name)
        if layer.name is None:
            layer.name = name
        self._vertices[name] = VertexSpec(layer=layer)
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name: str, vertex: BaseGraphVertex,
                   *inputs: str) -> "GraphBuilder":
        self._check_name(name)
        self._vertices[name] = VertexSpec(vertex=vertex)
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names: str) -> "GraphBuilder":
        self._outputs = list(names)
        return self

    def backprop_type(self, kind: str, tbptt_fwd: int = None,
                      tbptt_bwd: int = None) -> "GraphBuilder":
        self._backprop_type = str(kind).lower()
        self._tbptt_fwd = tbptt_fwd
        self._tbptt_bwd = tbptt_bwd or tbptt_fwd
        return self

    def build(self) -> "ComputationGraphConfiguration":
        if not self._inputs:
            raise ValueError("add_inputs(...) required")
        if not self._outputs:
            raise ValueError("set_outputs(...) required")
        for name in self._outputs:
            if name not in self._vertices:
                raise ValueError(f"Output {name!r} is not a vertex")
        for name, ins in self._vertex_inputs.items():
            for i in ins:
                if i not in self._vertices and i not in self._inputs:
                    raise ValueError(f"Vertex {name!r} input {i!r} undefined")
            spec = self._vertices[name]
            if spec.vertex is not None:
                lo, hi = spec.vertex.n_inputs()
                if len(ins) < lo or (hi is not None and len(ins) > hi):
                    raise ValueError(
                        f"Vertex {name!r} ({type(spec.vertex).__name__}) "
                        f"accepts {lo}..{hi if hi is not None else 'N'} "
                        f"inputs, got {len(ins)}")
        g = self._parent._g
        for spec in self._vertices.values():
            if spec.layer is not None:
                spec.layer.resolve_defaults(g)

        order = _topological_order(self._inputs, self._vertex_inputs)

        # InputType propagation + preprocessor insertion + n_in auto-fill
        # (DL4J GraphBuilder#build with setInputTypes); skipped when no
        # input types were given — every layer is then fully specified
        if self._input_types:
            types: Dict[str, InputType] = dict(self._input_types)
            missing = [n for n in self._inputs if n not in types]
            if missing:
                raise ValueError(f"set_input_types missing for {missing}")
            for name in order:
                spec = self._vertices[name]
                in_types = [types[i] for i in self._vertex_inputs[name]]
                if spec.layer is None:
                    types[name] = spec.vertex.infer_shapes(in_types)
                    continue
                it = (in_types[0] if len(in_types) == 1
                      else MergeVertex().infer_shapes(in_types))
                ly = spec.layer
                if "any" in ly.WANTED_KINDS or it.kind in ly.WANTED_KINDS:
                    adapted = it
                else:
                    err = None
                    for kind in ly.WANTED_KINDS:
                        try:
                            spec.preprocessor, adapted = adapt(it, kind)
                            break
                        except ValueError as e:
                            err = e
                    else:
                        raise ValueError(f"Vertex {name!r}: {err}")
                out_shape = ly.infer_shapes(adapted.shape)
                out_kind = getattr(ly, "OUTPUT_KIND", None) or adapted.kind
                types[name] = InputType(out_kind, tuple(out_shape))

        return ComputationGraphConfiguration(
            global_conf=g,
            network_inputs=list(self._inputs),
            network_outputs=list(self._outputs),
            vertices=self._vertices,
            vertex_inputs=self._vertex_inputs,
            input_types=dict(self._input_types),
            topological_order=order,
            backprop_type=self._backprop_type,
            tbptt_fwd_length=self._tbptt_fwd,
            tbptt_bwd_length=self._tbptt_bwd,
            grad_normalization=self._parent.grad_normalization,
            grad_norm_threshold=self._parent.grad_norm_threshold,
        )


@dataclasses.dataclass
class ComputationGraphConfiguration:
    """Serializable DAG config (DL4J ``ComputationGraphConfiguration`` —
    the JSON inside every graph checkpoint), key for key the
    reference's."""

    global_conf: GlobalConf
    network_inputs: List[str]
    network_outputs: List[str]
    vertices: Dict[str, VertexSpec]
    vertex_inputs: Dict[str, List[str]]
    input_types: Dict[str, InputType] = dataclasses.field(
        default_factory=dict)
    topological_order: List[str] = dataclasses.field(default_factory=list)
    backprop_type: str = "standard"
    tbptt_fwd_length: Optional[int] = None
    tbptt_bwd_length: Optional[int] = None
    grad_normalization: Optional[str] = None
    grad_norm_threshold: float = 1.0
    # layer-vertex names whose parameters never update (a fine-tune's
    # frozen feature extractor); persisted with the configuration
    frozen_layers: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        return {
            "format": "deeplearning4j_tpu/ComputationGraphConfiguration/v1",
            "global_conf": dataclasses.asdict(self.global_conf),
            "network_inputs": self.network_inputs,
            "network_outputs": self.network_outputs,
            "vertices": {n: s.to_dict() for n, s in self.vertices.items()},
            "vertex_inputs": self.vertex_inputs,
            "input_types": {n: t.to_dict()
                            for n, t in self.input_types.items()},
            "topological_order": self.topological_order,
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
    def from_dict(d: Dict[str, Any]) -> "ComputationGraphConfiguration":
        conf = ComputationGraphConfiguration(
            global_conf=GlobalConf(**d["global_conf"]),
            network_inputs=list(d["network_inputs"]),
            network_outputs=list(d["network_outputs"]),
            vertices={n: VertexSpec.from_dict(s)
                      for n, s in d["vertices"].items()},
            vertex_inputs={n: list(v)
                           for n, v in d["vertex_inputs"].items()},
            input_types={n: InputType.from_dict(t)
                         for n, t in d.get("input_types", {}).items()},
            topological_order=list(d.get("topological_order", [])),
            backprop_type=d.get("backprop_type", "standard"),
            tbptt_fwd_length=d.get("tbptt_fwd_length"),
            tbptt_bwd_length=d.get("tbptt_bwd_length"),
            grad_normalization=d.get("grad_normalization"),
            grad_norm_threshold=d.get("grad_norm_threshold", 1.0),
            frozen_layers=list(d.get("frozen_layers", [])),
        )
        if not conf.topological_order:
            conf.topological_order = _topological_order(
                conf.network_inputs, conf.vertex_inputs)
        return conf

    @staticmethod
    def from_json(s: str) -> "ComputationGraphConfiguration":
        return ComputationGraphConfiguration.from_dict(json.loads(s))


class TrainState(NamedTuple):
    """Carried state of ``compiled_train_step``."""

    params: Any
    opt_state: Any
    model_state: Any
    step: int


class ComputationGraph(BaseNetwork):
    """Runtime twin of the configuration (DL4J
    ``org.deeplearning4j.nn.graph.ComputationGraph``)."""

    # ------------------------------------------------------------------
    def vertex_names(self) -> List[str]:
        return list(self.conf.topological_order)

    def _named_layers(self):
        """(vertex name, layer) of every layer vertex, in topological
        order."""
        return [(name, self.conf.vertices[name].layer)
                for name in self.conf.topological_order
                if self.conf.vertices[name].layer is not None]

    def _frozen_keys(self):
        return set(getattr(self.conf, "frozen_layers", ()) or ())

    @property
    def output_layers(self) -> List[BaseOutputLayerConf]:
        return [self.conf.vertices[n].layer
                for n in self.conf.network_outputs]

    # ------------------------------------------------------------------
    def init(self, seed: Optional[int] = None,
             device="cuda") -> "ComputationGraph":
        """Initialize parameters and state on ``device`` from an explicit
        generator seeded with ``seed`` (default: the configuration's
        seed).  The values differ from the JAX package's for the same
        seed; carry weights across with ``utils.convert``."""
        dev = resolve_device(device)
        if seed is not None:
            self._rng.reset(seed)
        seed = self.conf.global_conf.seed if seed is None else seed
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = {n: {} for n in self.conf.topological_order}
        states = {n: {} for n in self.conf.topological_order}
        for name, ly in self._named_layers():
            params[name] = ly.init(gen, self._dtype, dev)
            states[name] = ly.init_state(dev)
        self.params_tree = params
        self.state_tree = states
        self.opt_state = None        # built at the first fit
        self.device = dev
        return self

    # ------------------------------------------------------------------
    # Forward
    # ------------------------------------------------------------------
    def _as_input_dict(self, x) -> Dict[str, Any]:
        if isinstance(x, dict):
            return x
        if isinstance(x, (list, tuple)):
            return dict(zip(self.conf.network_inputs, x))
        return {self.conf.network_inputs[0]: x}

    def _forward_all(self, params, state, inputs: Dict[str, Any], training,
                     rng, masks: Optional[Dict[str, Any]] = None,
                     stop_before_output: bool = False):
        """Topological walk; returns (activations dict, new_state, masks,
        head_inputs).  With ``stop_before_output=True``, ``head_inputs``
        maps each output-layer vertex to the activation FEEDING it (the
        training path computes the loss from logits); ``acts`` still
        holds the real output activation whenever a downstream vertex
        consumes it, so consumers never see pre-output values."""
        acts: Dict[str, Any] = dict(inputs)
        act_masks: Dict[str, Any] = dict(masks or {})
        head_inputs: Dict[str, Any] = {}
        new_state = dict(state)
        layer_names = [n for n, _ in self._named_layers()]
        keys = (dict(zip(layer_names, split(rng, max(len(layer_names), 1))))
                if rng is not None else {})
        out_set = (set(self.conf.network_outputs) if stop_before_output
                   else set())
        consumed = {i for ins in self.conf.vertex_inputs.values()
                    for i in ins}
        for name in self.conf.topological_order:
            spec = self.conf.vertices[name]
            xs = [acts[i] for i in self.conf.vertex_inputs[name]]
            # a vertex's mask is the AND (pointwise min) of its inputs'
            # masks (DL4J feedForwardMaskArrays)
            mask = None
            for i in self.conf.vertex_inputs[name]:
                m = act_masks.get(i)
                if m is not None:
                    mask = m if mask is None else torch.minimum(mask, m)
            if spec.layer is not None:
                x = xs[0] if len(xs) == 1 else MergeVertex().apply(xs)
                if spec.preprocessor is not None:
                    x = spec.preprocessor(x)
                if name in out_set:
                    head_inputs[name] = x
                    if name not in consumed:
                        acts[name] = x
                        continue
                    # fall through: a downstream vertex reads this output
                    # layer's real activation during training too
                ly = spec.layer
                kwargs = {"mask": mask} if getattr(ly, "USES_MASK", False) \
                    else {}
                acts[name], new_state[name] = apply_layer(
                    ly, params[name], state[name], x,
                    compute_dtype=self._compute_dtype, training=training,
                    rng=keys.get(name), **kwargs)
            else:
                acts[name] = spec.vertex.apply(xs)
            if mask is not None:
                act_masks[name] = mask
        return acts, new_state, act_masks, head_inputs

    def _forward_infer(self, params, state, inputs, masks=None):
        """The inference forward on the given trees (no dropout, state
        left as it is); returns {output vertex: activation}.  What
        ``ParallelInference`` and ``QuantizedInference`` call."""
        inputs = {k: self._tensor(v)
                  for k, v in self._as_input_dict(inputs).items()}
        acts, _, _, _ = self._forward_all(params, state, inputs, False, None,
                                          masks=masks)
        return {n: acts[n] for n in self.conf.network_outputs}

    def _score_batch(self, params, state, batch, rng, training):
        """Sum of per-output mean losses + regularization (DL4J
        ``ComputationGraph.score``: output-layer scores summed); returns
        (loss, new state tree)."""
        inputs = self._as_input_dict(batch["features"])
        labels = batch["labels"]
        if not isinstance(labels, dict):
            labels = {self.conf.network_outputs[0]: labels}
        fmasks = batch.get("features_mask")
        if fmasks is not None and not isinstance(fmasks, dict):
            fmasks = {self.conf.network_inputs[0]: fmasks}
        lmasks = batch.get("labels_mask")
        if lmasks is None:
            lmasks = {}
        elif not isinstance(lmasks, dict):
            lmasks = {self.conf.network_outputs[0]: lmasks}
        _, new_state, _, head_inputs = self._forward_all(
            params, state, inputs, training, rng, masks=fmasks,
            stop_before_output=True)
        loss = 0.0
        for head_i, name in enumerate(self.conf.network_outputs):
            out_layer = self.conf.vertices[name].layer
            if not isinstance(out_layer, BaseOutputLayerConf):
                raise ValueError(
                    f"Output vertex {name!r} must be an output/loss layer")
            z = out_layer.pre_output(params[name], head_inputs[name],
                                     self._compute_dtype)
            lmask = lmasks.get(name)
            # each head's own key (a VAE's draws), apart from the
            # per-vertex dropout keys ``rng`` parented
            head_rng = (None if rng is None
                        else fold_in(rng, 0x5eed + head_i))
            scores = out_layer.per_example_score(
                labels[name], z, lmask, head_input=head_inputs[name],
                rng=head_rng, params=params[name])
            if lmask is not None:
                loss = loss + scores.sum() / torch.clamp(lmask.sum(), min=1.0)
            else:
                loss = loss + scores.mean()
        return loss + self._regularization_score(params), new_state

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------
    def _named(self, v, names):
        """A list/tuple -> dict keyed positionally by input/output name;
        a dict keeps its keys; one array stays one tensor."""
        if v is None:
            return None
        if isinstance(v, dict):
            return {k: self._tensor(a) for k, a in v.items()
                    if a is not None}
        if isinstance(v, (list, tuple)):
            return {n: self._tensor(a) for n, a in zip(names, v)
                    if a is not None}
        return self._tensor(v)

    def _make_batch(self, features, labels, features_mask=None,
                    labels_mask=None):
        ins, outs = self.conf.network_inputs, self.conf.network_outputs
        b = {"features": self._named(features, ins),
             "labels": self._named(labels, outs)}
        fmask = self._named(features_mask, ins)
        lmask = self._named(labels_mask, outs)
        if fmask is not None and (not isinstance(fmask, dict) or fmask):
            b["features_mask"] = fmask
        if lmask is not None and (not isinstance(lmask, dict) or lmask):
            b["labels_mask"] = lmask
        return b

    def _batch_dict(self, ds: Union[DataSet, MultiDataSet]):
        fmask = getattr(ds, "features_mask",
                        getattr(ds, "features_masks", None))
        lmask = getattr(ds, "labels_mask", getattr(ds, "labels_masks", None))
        return self._make_batch(ds.features, ds.labels, fmask, lmask)

    def compiled_train_step(self):
        """A reusable full train step on a ``TrainState`` — the benchmark
        loop's entry.  ``step.init()`` copies the model's trees (the step
        updates parameters and optimizer state in place, as the
        reference's donated buffers update in HBM); ``step(st, features,
        labels[, features_mask, labels_mask])`` returns (new state, loss
        tensor).  Features may already be tensors on the device."""
        self._check_init()
        self._build_solver(alloc_opt_state=False)
        model = self

        class _Step:
            def init(self) -> TrainState:
                params = map_leaves(torch.clone, model.params_tree)
                mstate = map_leaves(torch.clone, model.state_tree)
                return TrainState(params,
                                  model._solver.init_opt_state(params),
                                  mstate, 0)

            def __call__(self, st: TrainState, features, labels,
                         features_mask=None, labels_mask=None):
                batch = model._make_batch(features, labels, features_mask,
                                          labels_mask)
                params, opt_state, mstate, loss = model._solver.step(
                    st.params, st.opt_state, st.model_state, st.step, batch,
                    model._rng.next_key())
                return TrainState(params, opt_state, mstate,
                                  st.step + 1), loss

        return _Step()

    # ------------------------------------------------------------------
    # Inference / scoring
    # ------------------------------------------------------------------
    @torch.no_grad()
    def output(self, *inputs, training: bool = False, features_mask=None):
        """Forward pass (DL4J ``ComputationGraph.output(INDArray...)``) as
        tensors on ``self.device``: one tensor for a single-output net,
        else a list in ``network_outputs`` order."""
        self._check_init()
        x = inputs[0] if len(inputs) == 1 else list(inputs)
        ins = {k: self._tensor(v) for k, v in self._as_input_dict(x).items()}
        masks = None
        if features_mask is not None:
            masks = {k: self._tensor(v) for k, v in
                     self._as_input_dict(features_mask).items()}
        rng = self._rng.next_key() if training else None
        acts, _, _, _ = self._forward_all(self.params_tree, self.state_tree,
                                          ins, training, rng, masks=masks)
        vals = [acts[n] for n in self.conf.network_outputs]
        return vals[0] if len(vals) == 1 else vals

    @torch.no_grad()
    def feed_forward(self, inputs, training: bool = False) -> Dict[str, Any]:
        """All vertex activations by name (DL4J ``feedForward``)."""
        self._check_init()
        ins = {k: self._tensor(v)
               for k, v in self._as_input_dict(inputs).items()}
        rng = self._rng.next_key() if training else None
        acts, _, _, _ = self._forward_all(self.params_tree, self.state_tree,
                                          ins, training, rng)
        return acts

    @torch.no_grad()
    def score(self, ds: Union[DataSet, MultiDataSet]) -> float:
        self._check_init()
        loss, _ = self._score_batch(self.params_tree, self.state_tree,
                                    self._batch_dict(ds), None, False)
        return float(loss)

    # ------------------------------------------------------------------
    # Parameter access (DL4J flattened-vector views)
    # ------------------------------------------------------------------
    def _leaf_order(self):
        """((vertex, path...), leaf) pairs: topological order, then
        name-sorted within a vertex — the reference's order."""
        for name in self.conf.topological_order:
            for path, leaf in iter_leaves(self.params_tree.get(name, {})):
                yield (name,) + path, leaf

    def summary(self) -> str:
        self._check_init()
        rows = [f"{'name':<28} {'type':<26} {'inputs':<30} {'#params':>10}"]
        total = 0
        for name in self.conf.topological_order:
            spec = self.conf.vertices[name]
            kind = (type(spec.layer).__name__ if spec.layer is not None
                    else type(spec.vertex).__name__)
            n = sum(a.numel() for _, a in
                    iter_leaves(self.params_tree.get(name, {})))
            total += n
            ins = ",".join(self.conf.vertex_inputs[name])
            rows.append(f"{name:<28} {kind:<26} {ins:<30} {n:>10}")
        rows.append(f"Total params: {total}")
        return "\n".join(rows)

    @staticmethod
    def load(path, load_updater: bool = True,
             device="cuda") -> "ComputationGraph":
        """Restore a graph checkpoint zip (either package's) onto
        ``device``."""
        from deeplearning4j_torch.utils.model_serializer import (
            restore_computation_graph)
        return restore_computation_graph(path, device=device,
                                         load_updater=load_updater)
