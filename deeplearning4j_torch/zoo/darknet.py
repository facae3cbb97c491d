"""Darknet19 and TinyYOLO (``org.deeplearning4j.zoo.model.Darknet19`` /
``TinyYOLO``) + the ``Yolo2OutputLayer`` detection loss
(``org.deeplearning4j.nn.layers.objdetect.Yolo2OutputLayer``).

The detection head here is the single-box-per-cell YOLOv2 formulation:
labels arrive as a grid tensor [b, gh, gw, 5 + C] =
(objectness, cx, cy, w, h, one-hot class); the loss is the standard
weighted sum of coordinate MSE (object cells), object/no-object
confidence, and per-cell class cross-entropy.  DL4J's multi-anchor
encoding reduces to this with B=1; anchors/B>1 extend the channel
count without changing the structure.

Port of ``deeplearning4j_tpu/zoo/darknet.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    BatchNormalization, ConvolutionLayer, GlobalPoolingLayer,
    SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import OutputLayer
from deeplearning4j_torch.nn.conf.layers_objdetect import Yolo2OutputLayer
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


def _dn_conv(g, name, inp, n_out, kernel=(3, 3)):
    g.add_layer(name, ConvolutionLayer(
        kernel_size=kernel, n_out=n_out, convolution_mode="same",
        activation="identity", has_bias=False), inp)
    g.add_layer(f"{name}_bn", BatchNormalization(activation="leakyrelu"),
                name)
    return f"{name}_bn"


@dataclasses.dataclass
class Darknet19(ZooModel):
    """Darknet19 classifier backbone (conv/BN/leaky-relu + maxpools +
    1x1 bottlenecks, global-avg head).  ``width`` scales filters."""

    width: int = 32
    updater: object = None

    def conf(self):
        h, w, c = self.input_shape
        f = self.width
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _dn_conv(g, "c1", "input", f)
        g.add_layer("p1", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c2", "p1", 2 * f)
        g.add_layer("p2", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c3a", "p2", 4 * f)
        x = _dn_conv(g, "c3b", x, 2 * f, (1, 1))
        x = _dn_conv(g, "c3c", x, 4 * f)
        g.add_layer("p3", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c4a", "p3", 8 * f)
        x = _dn_conv(g, "c4b", x, 4 * f, (1, 1))
        x = _dn_conv(g, "c4c", x, 8 * f)
        g.add_layer("gap", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent"),
            "gap")
        return g.set_outputs("output").build()


@dataclasses.dataclass
class TinyYOLO(ZooModel):
    """TinyYOLO detector: darknet-style backbone downsampling to a
    gh x gw grid + a 1x1 conv emitting (5 + n_classes) channels into
    ``Yolo2OutputLayer``."""

    n_classes: int = 4
    width: int = 16
    updater: object = None

    def conf(self):
        h, w, c = self.input_shape
        f = self.width
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _dn_conv(g, "c1", "input", f)
        g.add_layer("p1", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c2", "p1", 2 * f)
        g.add_layer("p2", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c3", "p2", 4 * f)
        g.add_layer("p3", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c4", "p3", 8 * f)
        g.add_layer("det", ConvolutionLayer(
            kernel_size=(1, 1), n_out=5 + self.n_classes,
            convolution_mode="same", activation="identity"), x)
        g.add_layer("output", Yolo2OutputLayer(n_classes=self.n_classes),
                    "det")
        return g.set_outputs("output").build()


@dataclasses.dataclass
class YOLO2(ZooModel):
    """YOLOv2 (``org.deeplearning4j.zoo.model.YOLO2`` [UNVERIFIED]):
    Darknet19-style backbone plus the PASSTHROUGH route — the
    higher-resolution mid-backbone feature map space-to-depth-reorged
    (``SpaceToDepthLayer``, upstream's own choice for this graph) and
    concatenated with the deep features before the 1x1 detection conv
    into ``Yolo2OutputLayer``."""

    n_classes: int = 4
    width: int = 16
    updater: object = None

    def conf(self):
        from deeplearning4j_torch.nn.conf.graph_vertices import MergeVertex
        from deeplearning4j_torch.nn.conf.layers_conv import (
            SpaceToDepthLayer)
        h, w, c = self.input_shape
        f = self.width
        g = (NeuralNetConfiguration.builder().seed(self.seed)
             .updater(self.updater or Adam(learning_rate=1e-3))
             .weight_init("relu")
             .graph().add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        x = _dn_conv(g, "c1", "input", f)
        g.add_layer("p1", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c2", "p1", 2 * f)
        g.add_layer("p2", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c3", "p2", 4 * f)
        fine = x                     # passthrough source (higher res)
        g.add_layer("p3", SubsamplingLayer(kernel_size=(2, 2),
                                           stride=(2, 2)), x)
        x = _dn_conv(g, "c4", "p3", 8 * f)
        x = _dn_conv(g, "c5", x, 8 * f)
        g.add_layer("reorg", SpaceToDepthLayer(block_size=2),
                    fine)
        g.add_vertex("route", MergeVertex(), "reorg", x)
        x = _dn_conv(g, "c6", "route", 8 * f)
        g.add_layer("det", ConvolutionLayer(
            kernel_size=(1, 1), n_out=5 + self.n_classes,
            convolution_mode="same", activation="identity"), x)
        g.add_layer("output", Yolo2OutputLayer(n_classes=self.n_classes),
                    "det")
        return g.set_outputs("output").build()
