"""FaceNetNN4Small2 (``org.deeplearning4j.zoo.model.FaceNetNN4Small2``
[UNVERIFIED]): the NN4-small-2 inception-variant face-embedding net —
conv stem, inception 3a/3b-style multi-branch blocks (1x1 / 3x3 / 5x5
/ pool paths concatenated), a dense embedding, L2 normalization, and a
center-loss softmax head (DL4J trains this zoo model with
``CenterLossOutputLayer``).

Port of ``deeplearning4j_tpu/zoo/facenet.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_vertices import (L2NormalizeVertex,
                                                       MergeVertex)
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import DenseLayer
from deeplearning4j_torch.nn.conf.layers_misc import CenterLossOutputLayer
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class FaceNetNN4Small2(ZooModel):
    n_classes: int = 10           # identities
    embedding_size: int = 128
    input_shape: Tuple[int, int, int] = (96, 96, 3)
    width: int = 16               # stem width (upstream 64)
    inception_blocks: int = 2
    center_loss_lambda: float = 0.003
    updater: object = None

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1)):
        g.add_layer(name, ConvolutionLayer(
            kernel_size=kernel, stride=stride, n_out=n_out,
            convolution_mode="same", activation="identity"), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(activation="relu"),
                    name)
        return f"{name}_bn"

    def _inception(self, g, i, inp, f):
        b1 = self._conv_bn(g, f"i{i}_1x1", inp, 2 * f, (1, 1))
        b3 = self._conv_bn(g, f"i{i}_3r", inp, f, (1, 1))
        b3 = self._conv_bn(g, f"i{i}_3x3", b3, 2 * f, (3, 3))
        b5 = self._conv_bn(g, f"i{i}_5r", inp, f // 2, (1, 1))
        b5 = self._conv_bn(g, f"i{i}_5x5", b5, f, (5, 5))
        g.add_layer(f"i{i}_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(1, 1), pooling_type="max",
            convolution_mode="same"), inp)
        bp = self._conv_bn(g, f"i{i}_pp", f"i{i}_pool", f, (1, 1))
        g.add_vertex(f"i{i}_cat", MergeVertex(), b1, b3, b5, bp)
        return f"i{i}_cat"

    def conf(self):
        h, w, c = self.input_shape
        f = self.width
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = self._conv_bn(g, "stem1", "input", f, (7, 7), (2, 2))
        g.add_layer("stem_pool", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
            convolution_mode="same"), x)
        x = self._conv_bn(g, "stem2", "stem_pool", 3 * f, (3, 3))
        for i in range(self.inception_blocks):
            x = self._inception(g, i, x, f)
            if i == 0:
                g.add_layer("mid_pool", SubsamplingLayer(
                    kernel_size=(3, 3), stride=(2, 2),
                    pooling_type="max", convolution_mode="same"), x)
                x = "mid_pool"
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("embedding", DenseLayer(
            n_out=self.embedding_size, activation="identity"), "gap")
        g.add_vertex("l2", L2NormalizeVertex(), "embedding")
        g.add_layer("output", CenterLossOutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent",
            lambda_=self.center_loss_lambda), "l2")
        return g.set_outputs("output").build()
