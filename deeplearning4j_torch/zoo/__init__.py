"""Model zoo (port of ``deeplearning4j_tpu.zoo``: the decoder, the BERT
encoder, ResNet-50, LeNet, SimpleCNN and the GravesLSTM char-RNN so
far)."""
from deeplearning4j_torch.zoo.base import ZooModel
from deeplearning4j_torch.zoo.bert import Bert
from deeplearning4j_torch.zoo.gpt import Gpt
from deeplearning4j_torch.zoo.lenet import LeNet
from deeplearning4j_torch.zoo.resnet import ResNet50
from deeplearning4j_torch.zoo.simple_cnn import SimpleCNN
from deeplearning4j_torch.zoo.text_generation_lstm import TextGenerationLSTM

__all__ = ["ZooModel", "Bert", "Gpt", "LeNet", "ResNet50", "SimpleCNN",
           "TextGenerationLSTM"]
