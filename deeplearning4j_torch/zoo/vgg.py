"""VGG16 / VGG19 (``org.deeplearning4j.zoo.model.{VGG16,VGG19}``):
3x3-conv stacks [2,2,3,3,3] (VGG16) / [2,2,4,4,4] (VGG19) with maxpools,
then dense(4096) x2 and softmax.

Port of ``deeplearning4j_tpu/zoo/vgg.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    ConvolutionLayer, SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import DenseLayer, OutputLayer
from deeplearning4j_torch.optimize.updaters import Nesterovs
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class VGG16(ZooModel):
    updater: object = None
    BLOCKS = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

    def conf(self):
        h, w, c = self.input_shape
        lb = (NeuralNetConfiguration.builder()
              .seed(self.seed)
              .updater(self.updater or Nesterovs(learning_rate=1e-2,
                                                 momentum=0.9))
              .weight_init("xavier")
              .list())
        for n_convs, n_out in self.BLOCKS:
            for _ in range(n_convs):
                lb.layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                          convolution_mode="same",
                                          n_out=n_out, activation="relu"))
            lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                      pooling_type="max"))
        return (lb
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(OutputLayer(n_out=self.n_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())


@dataclasses.dataclass
class VGG19(VGG16):
    BLOCKS = ((2, 64), (2, 128), (4, 256), (4, 512), (4, 512))
