"""SimpleCNN (port of ``deeplearning4j_tpu/zoo/simple_cnn.py``;
``org.deeplearning4j.zoo.model.SimpleCNN``): the small image classifier
upstream uses for quick experiments — conv7x7x16 + bn, then 3x3
conv/bn/pool blocks (32, 64, 128), dropout, dense, softmax head."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (BatchNormalization,
                                                      ConvolutionLayer,
                                                      SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import (DenseLayer,
                                                      DropoutLayer,
                                                      OutputLayer)
from deeplearning4j_torch.optimize.updaters import AdaDelta
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class SimpleCNN(ZooModel):
    n_classes: int = 10
    input_shape: Tuple[int, int, int] = (48, 48, 3)
    updater: object = None

    def conf(self):
        h, w, c = self.input_shape
        lb = (NeuralNetConfiguration.builder()
              .seed(self.seed)
              .updater(self.updater or AdaDelta())
              .weight_init("xavier")
              .activation("relu")
              .list()
              .layer(ConvolutionLayer(kernel_size=(7, 7), stride=(2, 2),
                                      convolution_mode="same", n_out=16))
              .layer(BatchNormalization()))
        for n_out in (32, 64, 128):
            lb.layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                      convolution_mode="same", n_out=n_out))
            lb.layer(BatchNormalization())
            lb.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                      pooling_type="max"))
        return (lb
                .layer(DropoutLayer(rate=0.5))
                .layer(DenseLayer(n_out=256, activation="relu"))
                .layer(OutputLayer(n_out=self.n_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())
