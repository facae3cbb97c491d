"""AlexNet (``org.deeplearning4j.zoo.model.AlexNet``): the one-tower
variant upstream ships — 5 convs with LRN after conv1/conv2, 3 maxpools,
two dropout+dense(4096) heads.

Port of ``deeplearning4j_tpu/zoo/alexnet.py``: the same configuration,
field for field (its JSON equals the reference's).
"""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_conv import (
    ConvolutionLayer, LocalResponseNormalization, SubsamplingLayer)
from deeplearning4j_torch.nn.conf.layers_core import DenseLayer, OutputLayer
from deeplearning4j_torch.optimize.updaters import Nesterovs
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class AlexNet(ZooModel):
    updater: object = None

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater or Nesterovs(learning_rate=1e-2,
                                                   momentum=0.9))
                .weight_init("normal")
                .list()
                .layer(ConvolutionLayer(kernel_size=(11, 11), stride=(4, 4),
                                        padding=(3, 3), n_out=96,
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(kernel_size=(5, 5), stride=(1, 1),
                                        padding=(2, 2), n_out=256,
                                        activation="relu"))
                .layer(LocalResponseNormalization())
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type="max"))
                .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        padding=(1, 1), n_out=384,
                                        activation="relu"))
                .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        padding=(1, 1), n_out=384,
                                        activation="relu"))
                .layer(ConvolutionLayer(kernel_size=(3, 3), stride=(1, 1),
                                        padding=(1, 1), n_out=256,
                                        activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                        pooling_type="max"))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                .layer(OutputLayer(n_out=self.n_classes,
                                   activation="softmax", loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())
