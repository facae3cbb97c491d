"""Layer configurations and the network-configuration builder (port of
``deeplearning4j_tpu.nn.conf``, the decoder stack's layers so far)."""
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, GlobalConf
from deeplearning4j_torch.nn.conf.builder import (MultiLayerConfiguration,
                                                  NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.layers_core import DenseLayer, OutputLayer
from deeplearning4j_torch.nn.conf.layers_recurrent import RnnOutputLayer
from deeplearning4j_torch.nn.conf.layers_transformer import (
    EmbeddingSequenceLayer, TransformerEncoderBlock)

__all__ = ["BaseLayerConf", "GlobalConf", "MultiLayerConfiguration",
           "NeuralNetConfiguration", "InputType", "DenseLayer",
           "OutputLayer", "RnnOutputLayer", "EmbeddingSequenceLayer",
           "TransformerEncoderBlock"]
