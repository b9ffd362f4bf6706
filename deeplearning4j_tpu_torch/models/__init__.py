"""Zoo models of the port."""

from deeplearning4j_tpu_torch.models.lenet import LeNet
from deeplearning4j_tpu_torch.models.resnet50 import ResNet50
from deeplearning4j_tpu_torch.models.textgenlstm import TextGenerationLSTM
from deeplearning4j_tpu_torch.models.vgg import VGG16, VGG19

__all__ = ["LeNet", "ResNet50", "TextGenerationLSTM", "VGG16", "VGG19"]
