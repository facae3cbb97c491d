"""Xception (``org.deeplearning4j.zoo.model.Xception`` [UNVERIFIED]):
depthwise-separable convolutions throughout — entry flow with strided
residual skips, a repeated middle flow, and an exit flow — shrunken by
``width``/``middle_blocks`` for tests.

Port of ``deeplearning4j_tpu/zoo/xception.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    SeparableConvolution2D, SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import (ActivationLayer,
                                                    OutputLayer)
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class Xception(ZooModel):
    n_classes: int = 1000
    input_shape: Tuple[int, int, int] = (299, 299, 3)
    width: int = 32               # stem width; upstream 32
    middle_blocks: int = 8        # upstream 8
    updater: object = None

    def _sep_bn(self, g, name, inp, n_out, act_first=True):
        src = inp
        if act_first:
            g.add_layer(f"{name}_act", ActivationLayer(
                activation="relu"), src)
            src = f"{name}_act"
        g.add_layer(name, SeparableConvolution2D(
            kernel_size=(3, 3), n_out=n_out, convolution_mode="same",
            activation="identity"), src)
        g.add_layer(f"{name}_bn", BatchNormalization(
            activation="identity"), name)
        return f"{name}_bn"

    def _entry_block(self, g, i, inp, n_out, first_act):
        x = self._sep_bn(g, f"en{i}a", inp, n_out, act_first=first_act)
        x = self._sep_bn(g, f"en{i}b", x, n_out)
        g.add_layer(f"en{i}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
            convolution_mode="same"), x)
        g.add_layer(f"en{i}_skip", ConvolutionLayer(
            kernel_size=(1, 1), stride=(2, 2), n_out=n_out,
            convolution_mode="same", activation="identity"), inp)
        g.add_layer(f"en{i}_skip_bn", BatchNormalization(
            activation="identity"), f"en{i}_skip")
        g.add_vertex(f"en{i}_add", ElementWiseVertex("add"),
                     f"en{i}_pool", f"en{i}_skip_bn")
        return f"en{i}_add"

    def conf(self):
        h, w_, c = self.input_shape
        w = self.width
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w_, c)))
        g.add_layer("stem1", ConvolutionLayer(
            kernel_size=(3, 3), stride=(2, 2), n_out=w,
            convolution_mode="truncate", activation="identity"),
            "input")
        g.add_layer("stem1_bn", BatchNormalization(activation="relu"),
                    "stem1")
        g.add_layer("stem2", ConvolutionLayer(
            kernel_size=(3, 3), n_out=2 * w,
            convolution_mode="truncate", activation="identity"),
            "stem1_bn")
        g.add_layer("stem2_bn", BatchNormalization(activation="relu"),
                    "stem2")
        x = "stem2_bn"
        for i, mult in enumerate((4, 8, 23)):     # 128/256/728 @ w=32
            x = self._entry_block(g, i, x, mult * w, first_act=i > 0)
        mid_w = 23 * w
        for m in range(self.middle_blocks):
            inp = x
            y = inp
            for k in range(3):
                y = self._sep_bn(g, f"mid{m}_{k}", y, mid_w)
            g.add_vertex(f"mid{m}_add", ElementWiseVertex("add"),
                         inp, y)
            x = f"mid{m}_add"
        # exit flow
        y = self._sep_bn(g, "ex_a", x, 23 * w)
        y = self._sep_bn(g, "ex_b", y, 32 * w)
        g.add_layer("ex_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
            convolution_mode="same"), y)
        g.add_layer("ex_skip", ConvolutionLayer(
            kernel_size=(1, 1), stride=(2, 2), n_out=32 * w,
            convolution_mode="same", activation="identity"), x)
        g.add_layer("ex_skip_bn", BatchNormalization(
            activation="identity"), "ex_skip")
        g.add_vertex("ex_add", ElementWiseVertex("add"), "ex_pool",
                     "ex_skip_bn")
        y = self._sep_bn(g, "ex_c", "ex_add", 48 * w, act_first=False)
        g.add_layer("ex_c_act", ActivationLayer(activation="relu"),
                    y)
        y = self._sep_bn(g, "ex_d", "ex_c_act", 64 * w,
                         act_first=False)
        g.add_layer("ex_d_act", ActivationLayer(activation="relu"), y)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"),
                    "ex_d_act")
        g.add_layer("output", OutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent"),
            "gap")
        return g.set_outputs("output").build()
