"""Model zoo (port of ``deeplearning4j_tpu.zoo``): every zoo model of the
reference — the decoder, the BERT encoder, the CNNs (LeNet, SimpleCNN,
AlexNet, VGG16/19, ResNet-50, UNet, InceptionResNetV1, Darknet19,
TinyYOLO, YOLO2, FaceNetNN4Small2, SqueezeNet, Xception, NASNet), the
GravesLSTM char-RNN — and the pretrained registry."""
from deeplearning4j_torch.zoo.base import ZooModel
from deeplearning4j_torch.zoo.lenet import LeNet
from deeplearning4j_torch.zoo.alexnet import AlexNet
from deeplearning4j_torch.zoo.vgg import VGG16, VGG19
from deeplearning4j_torch.zoo.resnet import ResNet50
from deeplearning4j_torch.zoo.simple_cnn import SimpleCNN
from deeplearning4j_torch.zoo.text_generation_lstm import TextGenerationLSTM
from deeplearning4j_torch.zoo.unet import UNet
from deeplearning4j_torch.zoo.inception import InceptionResNetV1
from deeplearning4j_torch.zoo.darknet import (Darknet19, TinyYOLO, YOLO2,
                                              Yolo2OutputLayer)
from deeplearning4j_torch.zoo.facenet import FaceNetNN4Small2
from deeplearning4j_torch.zoo.bert import Bert
from deeplearning4j_torch.zoo.gpt import Gpt
from deeplearning4j_torch.zoo.squeezenet import SqueezeNet
from deeplearning4j_torch.zoo.xception import Xception
from deeplearning4j_torch.zoo.nasnet import NASNet
from deeplearning4j_torch.zoo.pretrained import (load_pretrained, register,
                                                 save_pretrained)

__all__ = ["ZooModel", "LeNet", "AlexNet", "VGG16", "VGG19", "ResNet50",
           "SimpleCNN", "TextGenerationLSTM", "UNet", "InceptionResNetV1",
           "Darknet19", "TinyYOLO", "YOLO2", "FaceNetNN4Small2",
           "Yolo2OutputLayer", "Bert", "Gpt",
           "SqueezeNet", "Xception", "NASNet",
           "save_pretrained", "load_pretrained", "register"]
