"""LeNet (port of ``deeplearning4j_tpu/zoo/lenet.py``;
``org.deeplearning4j.zoo.model.LeNet``): conv5x5x20 -> maxpool ->
conv5x5x50 -> maxpool -> dense(500, relu) -> softmax, a
MultiLayerNetwork with AdaDelta, as upstream builds it."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (ConvolutionLayer,
                                                      SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import DenseLayer, OutputLayer
from deeplearning4j_torch.optimize.updaters import AdaDelta
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class LeNet(ZooModel):
    n_classes: int = 10
    input_shape: Tuple[int, int, int] = (28, 28, 1)
    updater: object = None

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or AdaDelta())
                .weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", n_out=20,
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", n_out=50,
                                        activation="identity"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2),
                                        pooling_type="max"))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.n_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())
