"""UNet (``org.deeplearning4j.zoo.model.UNet``): encoder/decoder with
skip connections (MergeVertex concat), transposed-conv upsampling, and a
per-pixel ``CnnLossLayer`` head.  ``depth``/``base_filters`` shrink the
standard 4-level architecture for small inputs/tests.

Port of ``deeplearning4j_tpu/zoo/unet.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_vertices import MergeVertex
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    CnnLossLayer, ConvolutionLayer, Deconvolution2D, SubsamplingLayer)
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class UNet(ZooModel):
    n_classes: int = 2
    depth: int = 3
    base_filters: int = 16
    updater: object = None

    def _double_conv(self, g, name, inp, filters):
        g.add_layer(f"{name}_c1", ConvolutionLayer(
            kernel_size=(3, 3), n_out=filters, convolution_mode="same",
            activation="relu"), inp)
        g.add_layer(f"{name}_c2", ConvolutionLayer(
            kernel_size=(3, 3), n_out=filters, convolution_mode="same",
            activation="relu"), f"{name}_c1")
        return f"{name}_c2"

    def conf(self):
        h, w, c = self.input_shape
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        skips = []
        x = "input"
        f = self.base_filters
        for d in range(self.depth):
            x = self._double_conv(g, f"enc{d}", x, f * (2 ** d))
            skips.append(x)
            g.add_layer(f"pool{d}", SubsamplingLayer(
                kernel_size=(2, 2), stride=(2, 2), pooling_type="max"), x)
            x = f"pool{d}"
        x = self._double_conv(g, "bottleneck", x, f * (2 ** self.depth))
        for d in reversed(range(self.depth)):
            g.add_layer(f"up{d}", Deconvolution2D(
                kernel_size=(2, 2), stride=(2, 2), n_out=f * (2 ** d),
                convolution_mode="same", activation="relu"), x)
            g.add_vertex(f"skip{d}", MergeVertex(), f"up{d}", skips[d])
            x = self._double_conv(g, f"dec{d}", f"skip{d}", f * (2 ** d))
        g.add_layer("logits", ConvolutionLayer(
            kernel_size=(1, 1), n_out=self.n_classes,
            convolution_mode="same", activation="identity"), x)
        g.add_layer("output", CnnLossLayer(
            activation="softmax", loss="mcxent"), "logits")
        return g.set_outputs("output").build()
