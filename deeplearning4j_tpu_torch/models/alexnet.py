"""AlexNet (counterpart of ``deeplearning4j_tpu/models/alexnet.py``;
reference zoo/model/AlexNet.java, the one-weird-trick variant):
conv11x11/4 -> LRN -> pool -> conv5x5 -> LRN -> pool -> 3x conv3x3 -> pool
-> 2x dense(4096) with dropout -> softmax. Same configuration and JSON as
the JAX package's."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.normalization import LocalResponseNormalization
from deeplearning4j_tpu_torch.optimize.updaters import Nesterovs


class AlexNet(ZooModel):
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Nesterovs(learning_rate=1e-2, momentum=0.9)

    def conf(self):
        h, w, c = self.input_shape

        def conv(n_out, kernel, bias_init=0.0, **kw):
            return ConvolutionLayer(n_out=n_out, kernel_size=kernel, activation="relu",
                                    bias_init=bias_init, **kw)

        def pool():
            return SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2))

        return (NeuralNetConfiguration.builder()
                .seed(self.seed).updater(self.updater).weight_init("normal")
                .list()
                .layer(conv(96, (11, 11), stride=(4, 4)))
                .layer(LocalResponseNormalization())
                .layer(pool())
                .layer(conv(256, (5, 5), 1.0, convolution_mode="same"))
                .layer(LocalResponseNormalization())
                .layer(pool())
                .layer(conv(384, (3, 3), convolution_mode="same"))
                .layer(conv(384, (3, 3), 1.0, convolution_mode="same"))
                .layer(conv(256, (3, 3), 1.0, convolution_mode="same"))
                .layer(pool())
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
                .layer(DenseLayer(n_out=4096, activation="relu", dropout=0.5, bias_init=1.0))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional(h, w, c))
                .build())
