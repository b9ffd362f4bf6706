"""Darknet19 and TinyYOLO (counterpart of
``deeplearning4j_tpu/models/darknet.py``; reference zoo/model/Darknet19.java,
TinyYOLO.java). Every conv is a bias-free 'same' conv → BatchNormalization
→ leaky ReLU, which ``conf.fused()`` turns into one
``FusedConvBNActivation``. ``TinyYOLO.detection_conf(boxes)`` puts the
Yolo2OutputLayer head, with the given (w, h) anchor priors in grid units,
on the backbone; ``conf()`` puts a classification head on it. Same
configurations and JSON as the JAX package's."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.normalization import BatchNormalization
from deeplearning4j_tpu_torch.nn.conf.objdetect import Yolo2OutputLayer
from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs


def _dark_conv(b, n_out, kernel=(3, 3)):
    b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=kernel, convolution_mode="same",
                                 has_bias=False, activation="identity"))
    b = b.layer(BatchNormalization())
    return b.layer(ActivationLayer(activation="leakyrelu"))


def _pool(b, stride=(2, 2), mode="truncate"):
    return b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=stride, convolution_mode=mode))


def _classifier(b, num_classes, input_shape):
    h, w, c = input_shape
    return (b.layer(GlobalPoolingLayer(pooling_type="avg"))
             .layer(OutputLayer(n_out=num_classes, activation="softmax", loss="mcxent"))
             .set_input_type(InputType.convolutional(h, w, c))
             .build())


class _Darknet(ZooModel):
    def __init__(self, num_classes: int, seed: int = 12345, input_shape=None, updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Nesterovs(learning_rate=1e-3, momentum=0.9)

    def _builder(self):
        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self.updater).weight_init("relu")
                .list())


class Darknet19(_Darknet):
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape, updater)

    def conf(self):
        b = _dark_conv(self._builder(), 32)
        b = _pool(b)
        b = _pool(_dark_conv(b, 64))
        for n in (128, 256, 512):
            b = _dark_conv(b, n)
            b = _dark_conv(b, n // 2, kernel=(1, 1))
            b = _pool(_dark_conv(b, n))
        for n, k in ((1024, 3), (512, 1), (1024, 3), (512, 1), (1024, 3)):
            b = _dark_conv(b, n, kernel=(k, k))
        return _classifier(b, self.num_classes, self.input_shape)


class TinyYOLO(_Darknet):
    """Tiny YOLO: seven leaky-ReLU conv blocks of 16 to 1024 channels over
    a 416 x 416 input, a 13 x 13 grid."""

    input_shape = (416, 416, 3)

    def __init__(self, num_classes: int = 20, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape, updater)

    def backbone(self, b):
        for n in (16, 32, 64, 128, 256):
            b = _pool(_dark_conv(b, n))
        b = _dark_conv(b, 512)
        b = _pool(b, stride=(1, 1), mode="same")
        return _dark_conv(b, 1024)

    def conf(self):
        return _classifier(self.backbone(self._builder()), self.num_classes,
                           self.input_shape)

    def detection_conf(self, boxes):
        """The detection configuration: a 1x1 conv to boxes * (5 + classes)
        channels and the Yolo2OutputLayer over ``boxes``."""
        h, w, c = self.input_shape
        b = self.backbone(self._builder())
        b = b.layer(ConvolutionLayer(n_out=len(boxes) * (5 + self.num_classes),
                                     kernel_size=(1, 1), activation="identity"))
        b = b.layer(Yolo2OutputLayer(boxes=tuple(tuple(x) for x in boxes)))
        return b.set_input_type(InputType.convolutional(h, w, c)).build()
