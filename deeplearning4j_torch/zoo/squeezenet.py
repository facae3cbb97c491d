"""SqueezeNet v1.1 (``org.deeplearning4j.zoo.model.SqueezeNet``
[UNVERIFIED]): fire modules — a 1x1 squeeze feeding concatenated 1x1
and 3x3 expands — ending in a 1x1 class-conv + global average pool
(no dense head).

Port of ``deeplearning4j_tpu/zoo/squeezenet.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (ConvolutionLayer,
                                                    GlobalPoolingLayer,
                                                    SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class SqueezeNet(ZooModel):
    n_classes: int = 1000
    input_shape: Tuple[int, int, int] = (227, 227, 3)
    # (squeeze, expand) per fire module; v1.1 schedule
    fire_plan: Tuple[Tuple[int, int], ...] = (
        (16, 64), (16, 64), (32, 128), (32, 128),
        (48, 192), (48, 192), (64, 256), (64, 256))
    pool_after: Tuple[int, ...] = (1, 3)   # maxpool after these fires
    updater: object = None

    def _fire(self, g, i, inp, squeeze, expand):
        g.add_layer(f"fire{i}_sq", ConvolutionLayer(
            kernel_size=(1, 1), n_out=squeeze,
            convolution_mode="same", activation="relu"), inp)
        g.add_layer(f"fire{i}_e1", ConvolutionLayer(
            kernel_size=(1, 1), n_out=expand,
            convolution_mode="same", activation="relu"), f"fire{i}_sq")
        g.add_layer(f"fire{i}_e3", ConvolutionLayer(
            kernel_size=(3, 3), n_out=expand,
            convolution_mode="same", activation="relu"), f"fire{i}_sq")
        g.add_vertex(f"fire{i}_cat", MergeVertex(),
                     f"fire{i}_e1", f"fire{i}_e3")
        return f"fire{i}_cat"

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("conv1", ConvolutionLayer(
            kernel_size=(3, 3), stride=(2, 2), n_out=64,
            convolution_mode="truncate", activation="relu"), "input")
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max"),
            "conv1")
        x = "pool1"
        for i, (sq, ex) in enumerate(self.fire_plan):
            x = self._fire(g, i, x, sq, ex)
            if i in self.pool_after:
                g.add_layer(f"pool_f{i}", SubsamplingLayer(
                    kernel_size=(3, 3), stride=(2, 2),
                    pooling_type="max"), x)
                x = f"pool_f{i}"
        g.add_layer("conv10", ConvolutionLayer(
            kernel_size=(1, 1), n_out=self.n_classes,
            convolution_mode="same", activation="relu"), x)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"),
                    "conv10")
        g.add_layer("output", OutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent"),
            "gap")
        return g.set_outputs("output").build()
