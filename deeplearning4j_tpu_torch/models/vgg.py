"""VGG16 / VGG19 (counterpart of ``deeplearning4j_tpu/models/vgg.py``;
reference zoo/model/VGG16.java, VGG19.java). Same configuration, so the
JSON of the two packages' VGG16 is the same."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs

_VGG16_BLOCKS = [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]
_VGG19_BLOCKS = [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]


class VGG16(ZooModel):
    input_shape = (224, 224, 3)
    _blocks = _VGG16_BLOCKS

    def __init__(self, num_classes: int = 1000, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Nesterovs(learning_rate=1e-2, momentum=0.9)

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(self.updater).weight_init("relu")
             .list())
        for n_out, reps in self._blocks:
            for _ in range(reps):
                b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                             convolution_mode="same",
                                             activation="relu"))
            b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        return (b.layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                 .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5))
                 .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                    loss="mcxent"))
                 .set_input_type(InputType.convolutional(h, w, c))
                 .build())


class VGG19(VGG16):
    _blocks = _VGG19_BLOCKS
