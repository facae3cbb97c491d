"""Transfer learning (port of
``deeplearning4j_torch/models/transfer_learning.py``;
``org.deeplearning4j.nn.transferlearning.TransferLearning`` +
``FrozenLayer``): take a trained ``MultiLayerNetwork`` or
``ComputationGraph``, freeze a feature-extractor prefix, replace /
remove / append head layers, and fine-tune under a new training
configuration — the workflow of the zoo's pretrained examples.

Freezing is the networks' own 0/1 mask tree (``_frozen_keys``): frozen
gradients are zeroed before normalization and the updater, and the
frozen-layer list persists in the serialized configuration, so a
reloaded fine-tune keeps its freeze.  Retained parameters and state are
COPIED onto the new model, on the source model's device: the solver
updates parameters in place, so a shared tensor would change the
source model at the first fine-tune step.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import List, Optional

from deeplearning4j_torch.models.multi_layer_network import MultiLayerNetwork
from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.optimize.updaters import BaseUpdater
from deeplearning4j_torch.utils.trees import map_leaves


def _copy(tree):
    """A copy of a parameter or state tree, tensor by tensor."""
    return map_leaves(lambda a: a.detach().clone(), tree)


class TransferLearning:
    """Namespace matching upstream: ``TransferLearning.Builder(model)``."""

    class Builder:
        def __init__(self, model: MultiLayerNetwork):
            model._check_init()
            self._src = model
            self._layers: List = [copy.deepcopy(ly)
                                  for ly in model.layers]
            # which source layer each new slot copies params from
            self._param_src: List[Optional[int]] = list(
                range(len(self._layers)))
            self._freeze_upto = -1
            self._global_overrides = {}

        # -- upstream builder surface ---------------------------------
        def fine_tune_configuration(self, updater=None, l2=None,
                                    seed=None):
            """New training hyperparameters for the fine-tune phase
            (upstream ``FineTuneConfiguration``)."""
            if updater is not None:
                self._global_overrides["updater"] = (
                    updater.to_dict() if isinstance(updater, BaseUpdater)
                    else dict(updater))
            if l2 is not None:
                self._global_overrides["l2"] = float(l2)
                # copied layers carry the SOURCE build's resolved l2;
                # reset so the new global value re-resolves onto them
                for ly in self._layers:
                    if hasattr(ly, "l2"):
                        ly.l2 = None
            if seed is not None:
                self._global_overrides["seed"] = int(seed)
            return self

        def set_feature_extractor(self, layer_idx: int):
            """Freeze layers [0..layer_idx] (inclusive) — they forward
            but never update (upstream ``setFeatureExtractor``)."""
            self._freeze_upto = int(layer_idx)
            return self

        def n_out_replace(self, layer_idx: int, n_out: int):
            """Change layer ``layer_idx``'s output width; that layer
            AND the next layer re-initialize (their shapes change) —
            upstream ``nOutReplace`` semantics."""
            i = int(layer_idx)
            ly = self._layers[i]
            if not hasattr(ly, "n_out"):
                raise ValueError(
                    f"layer {i} ({type(ly).__name__}) has no n_out")
            ly.n_out = int(n_out)
            self._param_src[i] = None
            # Downstream: reset resolved n_in so the rebuild re-infers
            # shapes, through any non-parameterized layers (pooling /
            # activation); the FIRST parameterized consumer is the one
            # whose weights change shape and must re-initialize.
            for j in range(i + 1, len(self._layers)):
                nxt = self._layers[j]
                if hasattr(nxt, "n_in"):
                    nxt.n_in = None
                if nxt.has_params():
                    self._param_src[j] = None
                    break
            return self

        def remove_output_layer_and_processing(self):
            """Drop the last layer (upstream
            ``removeOutputLayerAndProcessing``)."""
            self._layers.pop()
            self._param_src.pop()
            return self

        def remove_layers_from_output(self, n: int):
            for _ in range(int(n)):
                self.remove_output_layer_and_processing()
            return self

        def add_layer(self, layer_conf):
            """Append a fresh (randomly initialized) layer."""
            self._layers.append(layer_conf)
            self._param_src.append(None)
            return self

        # -- build ----------------------------------------------------
        def build(self) -> MultiLayerNetwork:
            if self._freeze_upto >= len(self._layers):
                raise ValueError(
                    f"set_feature_extractor({self._freeze_upto}) is out "
                    f"of range for {len(self._layers)} layers")
            for i in range(self._freeze_upto + 1):
                if self._param_src[i] is None and \
                        self._layers[i].has_params():
                    raise ValueError(
                        f"layer {i} is frozen but replaced/added — a "
                        "fresh random layer inside the feature "
                        "extractor would never train; lower "
                        "set_feature_extractor or move the change "
                        "past it")
            src = self._src
            g = dataclasses.replace(src.conf.global_conf,
                                    **self._global_overrides)
            b = NeuralNetConfiguration.builder()
            b._g = g
            lst = b.list()
            if src.conf.input_type is not None:
                lst.set_input_type(src.conf.input_type)
            if src.conf.backprop_type != "standard":
                lst.backprop_type(src.conf.backprop_type,
                                  src.conf.tbptt_fwd_length,
                                  src.conf.tbptt_bwd_length)
            for ly in self._layers:
                lst.layer(ly)
            model = MultiLayerNetwork(lst.build()).init(device=src.device)

            # COPY retained parameters: the solver updates in place, so
            # a shared tensor would move the source model at the first
            # ft.fit()
            for i, src_i in enumerate(self._param_src):
                if src_i is None:
                    continue
                model.params_tree[f"layer_{i}"] = _copy(
                    src.params_tree[f"layer_{src_i}"])
                model.state_tree[f"layer_{i}"] = _copy(
                    src.state_tree[f"layer_{src_i}"])

            if self._freeze_upto >= 0:
                # persisted in the conf: save/load keeps the freeze
                model.conf.frozen_layers = list(
                    range(self._freeze_upto + 1))
            return model


def frozen_layer_indices(model: MultiLayerNetwork) -> List[int]:
    """Which layers are frozen (from the persisted conf)."""
    return sorted(getattr(model.conf, "frozen_layers", ()) or ())


def freeze_graph_layers(graph, layer_names) -> None:
    """ComputationGraph freezing (the ``TransferLearning.GraphBuilder``
    ``setFeatureExtractor`` essential): mark the named layer vertices
    frozen — persisted in the graph conf, applied as the same update
    mask the MLN path uses.  Call before the first fit (or rebuild the
    solver) so the mask reaches the compiled step."""
    names = [layer_names] if isinstance(layer_names, str) \
        else list(layer_names)
    known = set(graph.params_tree)
    missing = [n for n in names if n not in known]
    if missing:
        raise ValueError(
            f"unknown layer vertices {missing}; parameterized vertices: "
            f"{sorted(known)}")
    graph.conf.frozen_layers = sorted(set(
        list(getattr(graph.conf, "frozen_layers", []) or []) + names))
    graph._solver = None            # rebuild with the new mask


def _graph_ancestors(vertex_inputs, names, network_inputs):
    """Closure of ``names`` under the input relation (excluding the
    network inputs themselves)."""
    seen, stack = set(), list(names)
    ins = set(network_inputs)
    while stack:
        n = stack.pop()
        if n in seen or n in ins:
            continue
        seen.add(n)
        stack.extend(vertex_inputs.get(n, ()))
    return seen


class GraphBuilder:
    """``TransferLearning.GraphBuilder`` for :class:`ComputationGraph`
    (upstream ``org.deeplearning4j.nn.transferlearning.TransferLearning
    .GraphBuilder`` [UNVERIFIED]): vertex-addressed freeze,
    ``n_out_replace`` on a DAG layer, remove/add vertices, new outputs,
    fine-tune config — same param-copy + 0/1-mask mechanics as the MLN
    builder (no wrapper layers)."""

    def __init__(self, graph):
        graph._check_init()
        self._src = graph
        c = graph.conf
        self._vertices = {n: dataclasses.replace(
            s, layer=copy.deepcopy(s.layer),
            vertex=copy.deepcopy(s.vertex), preprocessor=None)
            for n, s in c.vertices.items()}
        self._vertex_inputs = {n: list(v)
                               for n, v in c.vertex_inputs.items()}
        self._inputs = list(c.network_inputs)
        self._outputs = list(c.network_outputs)
        self._input_types = dict(c.input_types)
        # which source vertex each retained vertex copies params from
        self._param_src = {n: n for n in graph.params_tree
                           if graph.params_tree.get(n)}
        self._freeze = set(c.frozen_layers or ())
        self._global_overrides = {}

    # -- upstream builder surface -------------------------------------
    def fine_tune_configuration(self, updater=None, l2=None, seed=None):
        if updater is not None:
            self._global_overrides["updater"] = (
                updater.to_dict() if isinstance(updater, BaseUpdater)
                else dict(updater))
        if l2 is not None:
            self._global_overrides["l2"] = float(l2)
            for s in self._vertices.values():
                if s.layer is not None and hasattr(s.layer, "l2"):
                    s.layer.l2 = None
        if seed is not None:
            self._global_overrides["seed"] = int(seed)
        return self

    def set_feature_extractor(self, *vertex_names):
        """Freeze the named vertices AND everything upstream of them
        (upstream semantics: the sub-DAG up to the named vertex is the
        frozen featurizer)."""
        missing = [n for n in vertex_names if n not in self._vertices]
        if missing:
            raise ValueError(f"unknown vertices {missing}; have "
                             f"{sorted(self._vertices)}")
        closure = _graph_ancestors(self._vertex_inputs, vertex_names,
                                   self._inputs)
        self._freeze |= {n for n in closure if n in self._param_src
                         or (self._vertices[n].layer is not None
                             and self._vertices[n].layer.has_params())}
        return self

    def n_out_replace(self, vertex_name, n_out, seed=None):
        """New output width for a layer vertex: fresh params there and
        in every direct layer consumer (their input widths change —
        upstream nOutReplace's dual re-initialization)."""
        s = self._vertices.get(vertex_name)
        if s is None or s.layer is None:
            raise ValueError(f"{vertex_name!r} is not a layer vertex")
        if not hasattr(s.layer, "n_out"):
            raise ValueError(
                f"{type(s.layer).__name__} has no n_out to replace")
        s.layer.n_out = int(n_out)
        self._param_src.pop(vertex_name, None)
        for cname, ins in self._vertex_inputs.items():
            if vertex_name in ins:
                cs = self._vertices[cname]
                if cs.layer is not None:
                    self._param_src.pop(cname, None)
                    if hasattr(cs.layer, "n_in"):
                        cs.layer.n_in = None   # re-infer from new width
        if seed is not None:
            self._global_overrides["seed"] = int(seed)
        return self

    def remove_vertex_and_connections(self, vertex_name):
        if vertex_name not in self._vertices:
            raise ValueError(f"unknown vertex {vertex_name!r}")
        self._vertices.pop(vertex_name)
        self._vertex_inputs.pop(vertex_name, None)
        for ins in self._vertex_inputs.values():
            while vertex_name in ins:
                ins.remove(vertex_name)
        self._outputs = [o for o in self._outputs if o != vertex_name]
        self._param_src.pop(vertex_name, None)
        self._freeze.discard(vertex_name)
        return self

    def add_layer(self, name, layer_conf, *inputs):
        if name in self._vertices:
            raise ValueError(f"vertex {name!r} already exists")
        from deeplearning4j_torch.models.computation_graph import VertexSpec
        self._vertices[name] = VertexSpec(layer=layer_conf)
        self._vertex_inputs[name] = list(inputs)
        return self

    def add_vertex(self, name, vertex, *inputs):
        if name in self._vertices:
            raise ValueError(f"vertex {name!r} already exists")
        from deeplearning4j_torch.models.computation_graph import VertexSpec
        self._vertices[name] = VertexSpec(vertex=vertex)
        self._vertex_inputs[name] = list(inputs)
        return self

    def set_outputs(self, *names):
        self._outputs = list(names)
        return self

    # -- build --------------------------------------------------------
    def build(self):
        from deeplearning4j_torch.models.computation_graph import (
            ComputationGraph, _topological_order)
        src = self._src
        for n in self._freeze:
            if n not in self._param_src:
                raise ValueError(
                    f"vertex {n!r} is frozen but replaced/removed/"
                    "fresh — a random frozen vertex would never train; "
                    "unfreeze it or keep its source params")
        g = dataclasses.replace(src.conf.global_conf,
                                **self._global_overrides)
        b = NeuralNetConfiguration.builder()
        b._g = g
        b.grad_normalization = src.conf.grad_normalization
        b.grad_norm_threshold = src.conf.grad_norm_threshold
        gb = b.graph()
        gb.add_inputs(*self._inputs)
        if self._input_types:
            gb.set_input_types(*[self._input_types[i]
                                 for i in self._inputs])
        if src.conf.backprop_type != "standard":
            gb.backprop_type(src.conf.backprop_type,
                             src.conf.tbptt_fwd_length,
                             src.conf.tbptt_bwd_length)
        order = _topological_order(self._inputs, self._vertex_inputs)
        for n in order:
            s = self._vertices[n]
            if s.layer is not None:
                gb.add_layer(n, s.layer, *self._vertex_inputs[n])
            else:
                gb.add_vertex(n, s.vertex, *self._vertex_inputs[n])
        gb.set_outputs(*self._outputs)
        model = ComputationGraph(gb.build()).init(device=src.device)

        for n, src_n in self._param_src.items():
            if n in model.params_tree:
                model.params_tree[n] = _copy(src.params_tree[src_n])
                model.state_tree[n] = _copy(src.state_tree[src_n])
        if self._freeze:
            model.conf.frozen_layers = sorted(self._freeze)
        return model


TransferLearning.GraphBuilder = GraphBuilder


class TransferLearningHelper:
    """Featurizer split (upstream ``TransferLearningHelper``
    [UNVERIFIED]): run the frozen sub-DAG ONCE per dataset and fine-tune
    only the head on the cached activations — the cheap-epochs workflow
    for frozen-base transfer learning."""

    def __init__(self, graph, frozen_boundary: str):
        graph._check_init()
        if frozen_boundary not in graph.conf.vertices:
            raise ValueError(f"unknown vertex {frozen_boundary!r}")
        self._graph = graph
        self._boundary = frozen_boundary

    def featurize(self, features):
        """Activations at the frozen boundary for a [b, ...] batch —
        feed these to the head-only graph as its input features."""
        acts = self._graph.feed_forward(features)
        return acts[self._boundary]


def mln_to_graph(model: MultiLayerNetwork):
    """Convert a (possibly trained) MultiLayerNetwork into the
    equivalent linear ComputationGraph, copying parameters — upstream
    ``MultiLayerNetwork#toComputationGraph`` [UNVERIFIED].  Layer
    vertices are named ``layer_0..layer_{n-1}``; frozen layers carry
    over by name.  The zoo's published weight sets are MLN-based, so
    this is the bridge into the DAG-side TransferLearning builder."""
    from deeplearning4j_torch.models.computation_graph import (
        ComputationGraph)
    model._check_init()
    b = NeuralNetConfiguration.builder()
    b._g = copy.deepcopy(model.conf.global_conf)
    gb = b.graph().add_inputs("input")
    if model.conf.input_type is not None:
        gb.set_input_types(model.conf.input_type)
    prev = "input"
    names = []
    for i, ly in enumerate(model.layers):
        name = f"layer_{i}"
        gb.add_layer(name, copy.deepcopy(ly), prev)
        prev = name
        names.append(name)
    if model.conf.backprop_type != "standard":
        gb.backprop_type(model.conf.backprop_type,
                         model.conf.tbptt_fwd_length,
                         model.conf.tbptt_bwd_length)
    graph = ComputationGraph(gb.set_outputs(prev).build()).init(
        device=model.device)
    for i, name in enumerate(names):
        graph.params_tree[name] = _copy(model.params_tree[f"layer_{i}"])
        graph.state_tree[name] = _copy(model.state_tree[f"layer_{i}"])
    frozen = sorted(getattr(model.conf, "frozen_layers", ()) or ())
    if frozen:
        graph.conf.frozen_layers = [f"layer_{i}" for i in frozen]
    return graph
