"""Zoo models of the port (the JAX package's ``models`` exports)."""

from deeplearning4j_tpu_torch.models.alexnet import AlexNet
from deeplearning4j_tpu_torch.models.darknet import Darknet19, TinyYOLO
from deeplearning4j_tpu_torch.models.facenet import FaceNetNN4Small2, InceptionResNetV1
from deeplearning4j_tpu_torch.models.googlenet import GoogLeNet
from deeplearning4j_tpu_torch.models.lenet import LeNet
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50
from deeplearning4j_tpu_torch.models.simplecnn import SimpleCNN
from deeplearning4j_tpu_torch.models.textgenlstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19
from deeplearning4j_tpu_torch.models.zoo import ZooModel

__all__ = ["AlexNet", "Darknet19", "FaceNetNN4Small2", "GoogLeNet", "InceptionResNetV1",
           "LeNet", "ResNet50", "SimpleCNN", "TextGenerationLSTM", "TinyYOLO", "VGG16",
           "VGG19", "ZooModel"]
