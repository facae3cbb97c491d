"""InceptionResNetV1 (``org.deeplearning4j.zoo.model.InceptionResNetV1``
— the FaceNet backbone): stem → n x inception-resnet-A blocks (residual
adds with branch concat + 1x1 projection, residual scaling) → reduction
→ global pool → embedding head.  ``blocks``/``filters`` scale it down
for tests; the block structure is the upstream topology.

Port of ``deeplearning4j_tpu/zoo/inception.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_vertices import (
    ElementWiseVertex, MergeVertex, ScaleVertex)
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import (
    ActivationLayer, OutputLayer)
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class InceptionResNetV1(ZooModel):
    n_classes: int = 128  # embedding size upstream; softmax head here
    blocks: int = 2
    filters: int = 32
    residual_scale: float = 0.17
    updater: object = None

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1),
                 mode="same"):
        g.add_layer(name, ConvolutionLayer(
            kernel_size=kernel, stride=stride, n_out=n_out,
            convolution_mode=mode, activation="identity"), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation="relu"),
                    name)
        return f"{name}_bn"

    def _block_a(self, g, i, inp):
        """Inception-ResNet-A: three branches concat -> 1x1 up-project ->
        scaled residual add."""
        f = self.filters
        b0 = self._conv_bn(g, f"a{i}_b0", inp, f, (1, 1))
        b1 = self._conv_bn(g, f"a{i}_b1a", inp, f, (1, 1))
        b1 = self._conv_bn(g, f"a{i}_b1b", b1, f, (3, 3))
        b2 = self._conv_bn(g, f"a{i}_b2a", inp, f, (1, 1))
        b2 = self._conv_bn(g, f"a{i}_b2b", b2, f, (3, 3))
        b2 = self._conv_bn(g, f"a{i}_b2c", b2, f, (3, 3))
        g.add_vertex(f"a{i}_cat", MergeVertex(), b0, b1, b2)
        g.add_layer(f"a{i}_up", ConvolutionLayer(
            kernel_size=(1, 1), n_out=4 * f, convolution_mode="same",
            activation="identity"), f"a{i}_cat")
        g.add_vertex(f"a{i}_scale", ScaleVertex(self.residual_scale),
                     f"a{i}_up")
        g.add_vertex(f"a{i}_add", ElementWiseVertex("add"), inp,
                     f"a{i}_scale")
        g.add_layer(f"a{i}_out", ActivationLayer(activation="relu"),
                    f"a{i}_add")
        return f"a{i}_out"

    def conf(self):
        h, w, c = self.input_shape
        f = self.filters
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = self._conv_bn(g, "stem1", "input", f, (3, 3), (2, 2))
        x = self._conv_bn(g, "stem2", x, 4 * f, (3, 3))
        for i in range(self.blocks):
            x = self._block_a(g, i, x)
        g.add_layer("red_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
            convolution_mode="same"), x)
        x = self._conv_bn(g, "red_conv", "red_pool", 8 * f, (3, 3))
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent"),
            "gap")
        return g.set_outputs("output").build()
