"""ResNet-50 (port of ``deeplearning4j_tpu/zoo/resnet.py``;
``org.deeplearning4j.zoo.model.ResNet50``).

A ComputationGraph of bottleneck residual blocks (a projection shortcut
in each stage's first block, identity after, joined by
``ElementWiseVertex("add")``), stages [3, 4, 6, 3]: zero-pad 3 ->
conv 7x7/2 -> bn -> relu -> max-pool 3x3/2 ('same', padded (0, 1) on
112) -> 4 stages -> global average pool -> dense softmax.  The
reference's defaults: NHWC, f32 master weights with bf16 compute,
AdaDelta, and the same ``configuration.json``.
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.graph_vertices import ElementWiseVertex
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (BatchNormalization,
                                                      ConvolutionLayer,
                                                      GlobalPoolingLayer,
                                                      SubsamplingLayer,
                                                      ZeroPaddingLayer)
from deeplearning4j_torch.nn.conf.layers_core import (ActivationLayer,
                                                      OutputLayer)
from deeplearning4j_torch.optimize.updaters import AdaDelta
from deeplearning4j_torch.zoo.base import ZooModel

# (stage, bottleneck filters, blocks, first block's stride)
STAGES = ((2, (64, 64, 256), 3, (1, 1)),
          (3, (128, 128, 512), 4, (2, 2)),
          (4, (256, 256, 1024), 6, (2, 2)),
          (5, (512, 512, 2048), 3, (2, 2)))


@dataclasses.dataclass
class ResNet50(ZooModel):
    updater: object = None
    compute_dtype: str = "bfloat16"

    def _conv_bn_relu(self, g, name, inp, n_out, kernel, stride, relu=True,
                      mode="truncate", padding=(0, 0)):
        g.add_layer(name, ConvolutionLayer(
            kernel_size=kernel, stride=stride, padding=padding,
            convolution_mode=mode, n_out=n_out, activation="identity"), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(), name)
        if not relu:
            return f"{name}_bn"
        g.add_layer(f"{name}_relu", ActivationLayer(activation="relu"),
                    f"{name}_bn")
        return f"{name}_relu"

    def _bottleneck(self, g, stage, block, inp, filters, stride):
        """One bottleneck unit; block 0 of a stage takes the projection
        shortcut, the others the identity."""
        f1, f2, f3 = filters
        base = f"s{stage}b{block}"
        a = self._conv_bn_relu(g, f"{base}_a", inp, f1, (1, 1), stride)
        b = self._conv_bn_relu(g, f"{base}_b", a, f2, (3, 3), (1, 1),
                               mode="same")
        c = self._conv_bn_relu(g, f"{base}_c", b, f3, (1, 1), (1, 1),
                               relu=False)
        if block == 0:
            shortcut = self._conv_bn_relu(
                g, f"{base}_sc", inp, f3, (1, 1), stride, relu=False)
        else:
            shortcut = inp
        g.add_vertex(f"{base}_add", ElementWiseVertex("add"), c, shortcut)
        g.add_layer(f"{base}_out", ActivationLayer(activation="relu"),
                    f"{base}_add")
        return f"{base}_out"

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed)
             .updater(self.updater or AdaDelta())
             .compute_dtype(self.compute_dtype)
             .weight_init("xavier"))
        g = (b.graph()
             .add_inputs("input")
             .set_input_types(InputType.convolutional(h, w, c)))
        g.add_layer("pad1", ZeroPaddingLayer(padding=(3, 3)), "input")
        stem = self._conv_bn_relu(g, "conv1", "pad1", 64, (7, 7), (2, 2))
        g.add_layer("pool1", SubsamplingLayer(
            kernel_size=(3, 3), stride=(2, 2), pooling_type="max",
            convolution_mode="same"), stem)
        x = "pool1"
        for stage, filters, blocks, stride in STAGES:
            for blk in range(blocks):
                x = self._bottleneck(g, stage, blk, x, filters,
                                     stride if blk == 0 else (1, 1))
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(
            n_out=self.n_classes, activation="softmax", loss="mcxent"),
            "avgpool")
        return g.set_outputs("output").build()

    def flops_per_image_train(self) -> float:
        """Training flops per image from the conv and dense shapes: 2
        flops per multiply-add in the forward, times 3 for a step (the
        backward's input and weight gradients).  Batch norm, pooling,
        activations and the updater are not counted."""
        h, w, c = self.input_shape
        oh, ow = (h + 6 - 7) // 2 + 1, (w + 6 - 7) // 2 + 1
        macs = oh * ow * 64 * 7 * 7 * c                     # conv1
        oh, ow = -(-oh // 2), -(-ow // 2)                    # pool1
        c_in = 64
        for _, (f1, f2, f3), blocks, (s, _) in STAGES:
            for blk in range(blocks):
                st = s if blk == 0 else 1
                oh, ow = (oh - 1) // st + 1, (ow - 1) // st + 1
                macs += oh * ow * (c_in * f1 + 9 * f1 * f2 + f2 * f3)
                if blk == 0:                                 # projection
                    macs += oh * ow * c_in * f3
                c_in = f3
        macs += c_in * self.n_classes                        # output
        return 6.0 * macs
