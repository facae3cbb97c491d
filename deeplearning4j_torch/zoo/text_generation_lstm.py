"""TextGenerationLSTM (port of ``deeplearning4j_tpu/zoo/text_generation_lstm.py``;
``org.deeplearning4j.zoo.model.TextGenerationLSTM``): the stacked
GravesLSTM char-level language model of the char-RNN baseline — two
256-unit layers, a per-timestep softmax, tBPTT 50, Adam 1e-3 and
element-wise gradient clipping at 1.0, as dl4j-examples
``LSTMCharModellingExample``."""
from __future__ import annotations

import dataclasses

from deeplearning4j_torch.nn.conf.builder import NeuralNetConfiguration
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_recurrent import (GravesLSTM,
                                                           RnnOutputLayer)
from deeplearning4j_torch.optimize.updaters import Adam
from deeplearning4j_torch.zoo.base import ZooModel


@dataclasses.dataclass
class TextGenerationLSTM(ZooModel):
    vocab_size: int = 77
    hidden: int = 256
    n_layers: int = 2
    tbptt_length: int = 50
    updater: object = None

    def conf(self):
        lb = (NeuralNetConfiguration.builder()
              .seed(self.seed)
              .updater(self.updater or Adam(learning_rate=1e-3))
              .weight_init("xavier")
              .gradient_normalization("clip_element_wise_absolute_value", 1.0)
              .list())
        for _ in range(self.n_layers):
            lb.layer(GravesLSTM(n_out=self.hidden, activation="tanh"))
        return (lb
                .layer(RnnOutputLayer(n_out=self.vocab_size,
                                      activation="softmax", loss="mcxent"))
                .set_input_type(InputType.recurrent(self.vocab_size))
                .backprop_type("truncated_bptt", self.tbptt_length)
                .build())
