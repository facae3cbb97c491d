"""Layer configurations and the network-configuration builder (port of
``deeplearning4j_tpu.nn.conf``: every layer family — core, conv,
recurrent, transformer, the remaining DL4J layers of ``layers_misc``
and the YOLO2 detection head — and the graph vertices)."""
from deeplearning4j_torch.nn.conf.base import BaseLayerConf, GlobalConf
from deeplearning4j_torch.nn.conf.builder import (MultiLayerConfiguration,
                                                  NeuralNetConfiguration)
from deeplearning4j_torch.nn.conf.inputs import InputType
from deeplearning4j_torch.nn.conf.graph_vertices import (
    ElementWiseVertex, L2NormalizeVertex, MergeVertex, PreprocessorVertex,
    ReshapeVertex, ScaleVertex, ShiftVertex, StackVertex, SubsetVertex,
    UnstackVertex)
from deeplearning4j_torch.nn.conf.layers_conv import (
    BatchNormalization, CnnLossLayer, Convolution1DLayer, ConvolutionLayer,
    Cropping2D, Deconvolution2D, DepthwiseConvolution2D, GlobalPoolingLayer,
    LocalResponseNormalization, SeparableConvolution2D, SpaceToDepthLayer,
    SubsamplingLayer, Upsampling2D, ZeroPaddingLayer)
from deeplearning4j_torch.nn.conf.layers_core import (ActivationLayer,
                                                      DenseLayer,
                                                      DropoutLayer,
                                                      EmbeddingLayer,
                                                      LossLayer, OutputLayer)
from deeplearning4j_torch.nn.conf.layers_misc import (
    CenterLossOutputLayer, Convolution3D, ElementWiseMultiplicationLayer,
    LearnedSelfAttentionLayer, LocallyConnected1D, LocallyConnected2D,
    PReLULayer, SelfAttentionLayer, Subsampling3DLayer,
    VariationalAutoencoder)
from deeplearning4j_torch.nn.conf.layers_objdetect import Yolo2OutputLayer
from deeplearning4j_torch.nn.conf.layers_recurrent import (
    GRU, LSTM, Bidirectional, GravesLSTM, LastTimeStep, RnnOutputLayer,
    SimpleRnn)
from deeplearning4j_torch.nn.conf.layers_transformer import (
    EmbeddingSequenceLayer, TransformerEncoderBlock)

__all__ = ["BaseLayerConf", "GlobalConf", "MultiLayerConfiguration",
           "NeuralNetConfiguration", "InputType", "ActivationLayer",
           "DenseLayer", "DropoutLayer", "EmbeddingLayer",
           "GlobalPoolingLayer", "LossLayer", "OutputLayer",
           "RnnOutputLayer", "LSTM", "GravesLSTM", "GRU", "SimpleRnn",
           "Bidirectional", "LastTimeStep", "EmbeddingSequenceLayer",
           "TransformerEncoderBlock", "BatchNormalization", "CnnLossLayer",
           "Convolution1DLayer", "ConvolutionLayer", "Cropping2D",
           "Deconvolution2D", "DepthwiseConvolution2D",
           "LocalResponseNormalization", "SeparableConvolution2D",
           "SpaceToDepthLayer", "SubsamplingLayer", "Upsampling2D",
           "ZeroPaddingLayer", "ElementWiseVertex", "L2NormalizeVertex",
           "MergeVertex", "PreprocessorVertex", "ReshapeVertex",
           "ScaleVertex", "ShiftVertex", "StackVertex", "SubsetVertex",
           "UnstackVertex", "CenterLossOutputLayer", "Convolution3D",
           "ElementWiseMultiplicationLayer", "LearnedSelfAttentionLayer",
           "LocallyConnected1D", "LocallyConnected2D", "PReLULayer",
           "SelfAttentionLayer", "Subsampling3DLayer",
           "VariationalAutoencoder", "Yolo2OutputLayer"]
