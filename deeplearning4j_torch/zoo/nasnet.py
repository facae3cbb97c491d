"""NASNet-A (``org.deeplearning4j.zoo.model.NASNet`` [UNVERIFIED]):
the learned normal/reduction cell architecture.  Faithful cell
structure — each cell combines hidden states via pairs drawn from
{separable 3x3/5x5/7x7, avg 3x3, max 3x3, identity} with elementwise
adds, concatenating the block outputs; reduction cells stride 2 —
parameterized by ``penultimate_filters``/``n_cells`` so tests run a
shrunken stack (upstream NASNet-A-mobile is filters=1056, N=4).

Simplification noted in-code: upstream inserts 1x1 "adjust" convs when
a cell's two inputs disagree in spatial size; here every cell feeds on
(prev, cur) of the SAME resolution because the reduction output is the
next stage's single source — the cell wiring (the architecture's
substance) is preserved, the skip-adjust plumbing is not.

Port of ``deeplearning4j_tpu/zoo/nasnet.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_vertices import (ElementWiseVertex,
                                                       MergeVertex)
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    SeparableConvolution2D, SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class NASNet(ZooModel):
    n_classes: int = 1000
    input_shape: Tuple[int, int, int] = (224, 224, 3)
    # cell width basis: f = filters // 6 (block concat is a multiple of
    # f, so "penultimate" is nominal here, NOT the exact final width —
    # upstream's 1056 derives its stem differently)
    penultimate_filters: int = 96
    n_cells: int = 2                # normal cells per stage (mobile: 4)
    updater: object = None

    def _sep(self, g, name, inp, n_out, kernel, stride=(1, 1)):
        """relu -> separable conv -> BN (upstream applies it twice per
        branch; once keeps tests fast and the wiring identical)."""
        g.add_layer(name, SeparableConvolution2D(
            kernel_size=kernel, stride=stride, n_out=n_out,
            convolution_mode="same", activation="relu"), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(
            activation="identity"), name)
        return f"{name}_bn"

    def _fit_width(self, g, name, inp, n_out):
        """1x1 relu-conv-BN so every add/concat operand is n_out wide."""
        g.add_layer(name, ConvolutionLayer(
            kernel_size=(1, 1), n_out=n_out, convolution_mode="same",
            activation="relu"), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(
            activation="identity"), name)
        return f"{name}_bn"

    def _normal_cell(self, g, tag, prev, cur, f):
        """NASNet-A normal cell: 5 add-blocks over (prev, cur)."""
        p = self._fit_width(g, f"{tag}_pw", prev, f)
        h = self._fit_width(g, f"{tag}_hw", cur, f)
        blocks = []
        # block 1: sep3x3(h) + identity(h)
        b = self._sep(g, f"{tag}_b1s", h, f, (3, 3))
        g.add_vertex(f"{tag}_b1", ElementWiseVertex("add"), b, h)
        blocks.append(f"{tag}_b1")
        # block 2: sep3x3(p) + sep5x5(h)
        b1 = self._sep(g, f"{tag}_b2a", p, f, (3, 3))
        b2 = self._sep(g, f"{tag}_b2b", h, f, (5, 5))
        g.add_vertex(f"{tag}_b2", ElementWiseVertex("add"), b1, b2)
        blocks.append(f"{tag}_b2")
        # block 3: avg3x3(h) + identity(p)
        g.add_layer(f"{tag}_b3p", SubsamplingLayer(
            kernel_size=(3, 3), stride=(1, 1), pooling_type="avg",
            convolution_mode="same"), h)
        g.add_vertex(f"{tag}_b3", ElementWiseVertex("add"),
                     f"{tag}_b3p", p)
        blocks.append(f"{tag}_b3")
        # block 4: avg3x3(p) + avg3x3(p)  (two avg pools, as upstream)
        g.add_layer(f"{tag}_b4p", SubsamplingLayer(
            kernel_size=(3, 3), stride=(1, 1), pooling_type="avg",
            convolution_mode="same"), p)
        g.add_layer(f"{tag}_b4q", SubsamplingLayer(
            kernel_size=(3, 3), stride=(1, 1), pooling_type="avg",
            convolution_mode="same"), p)
        g.add_vertex(f"{tag}_b4", ElementWiseVertex("add"),
                     f"{tag}_b4p", f"{tag}_b4q")
        blocks.append(f"{tag}_b4")
        # block 5: sep5x5(p) + sep3x3(p)
        b1 = self._sep(g, f"{tag}_b5a", p, f, (5, 5))
        b2 = self._sep(g, f"{tag}_b5b", p, f, (3, 3))
        g.add_vertex(f"{tag}_b5", ElementWiseVertex("add"), b1, b2)
        blocks.append(f"{tag}_b5")
        g.add_vertex(f"{tag}_out", MergeVertex(), *blocks)
        return f"{tag}_out"

    def _reduction_cell(self, g, tag, prev, cur, f):
        """NASNet-A reduction cell: stride-2 pairs, 3 concat blocks."""
        p = self._fit_width(g, f"{tag}_pw", prev, f)
        h = self._fit_width(g, f"{tag}_hw", cur, f)
        # block 1: sep5x5/2(h) + sep7x7/2(p)
        a1 = self._sep(g, f"{tag}_b1a", h, f, (5, 5), (2, 2))
        a2 = self._sep(g, f"{tag}_b1b", p, f, (7, 7), (2, 2))
        g.add_vertex(f"{tag}_b1", ElementWiseVertex("add"), a1, a2)
        # block 2: max3x3/2(h) + sep7x7/2(p)
        g.add_layer(f"{tag}_b2m", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
            convolution_mode="same"), h)
        b2 = self._sep(g, f"{tag}_b2s", p, f, (7, 7), (2, 2))
        g.add_vertex(f"{tag}_b2", ElementWiseVertex("add"),
                     f"{tag}_b2m", b2)
        # block 3: avg3x3/2(h) + sep5x5/2(p)
        g.add_layer(f"{tag}_b3a", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="avg",
            convolution_mode="same"), h)
        c2 = self._sep(g, f"{tag}_b3s", p, f, (5, 5), (2, 2))
        g.add_vertex(f"{tag}_b3", ElementWiseVertex("add"),
                     f"{tag}_b3a", c2)
        g.add_vertex(f"{tag}_out", MergeVertex(), f"{tag}_b1",
                     f"{tag}_b2", f"{tag}_b3")
        return f"{tag}_out"

    def conf(self):
        h, w, c = self.input_shape
        f = self.penultimate_filters // 6
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("stem", ConvolutionLayer(
            kernel_size=(3, 3), stride=(2, 2), n_out=f,
            convolution_mode="same", activation="identity"), "input")
        g.add_layer("stem_bn", BatchNormalization(
            activation="identity"), "stem")
        prev = cur = "stem_bn"
        width = f
        for stage in range(2):
            for i in range(self.n_cells):
                nxt = self._normal_cell(g, f"s{stage}n{i}", prev, cur,
                                        width)
                prev, cur = cur, nxt
            width *= 2
            red = self._reduction_cell(g, f"s{stage}r", prev, cur,
                                       width)
            prev = cur = red      # see module docstring: same-res feeds
        for i in range(self.n_cells):
            nxt = self._normal_cell(g, f"s2n{i}", prev, cur, width)
            prev, cur = cur, nxt
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), cur)
        g.add_layer("output", OutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent"),
            "gap")
        return g.set_outputs("output").build()
