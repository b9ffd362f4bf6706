"""SimpleCNN (counterpart of ``deeplearning4j_tpu/models/simplecnn.py``;
reference zoo/model/SimpleCNN.java): a small VGG-style stack with batch
norm after each ReLU conv. Same configuration and JSON as the JAX
package's."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.normalization import BatchNormalization
from deeplearning4j_tpu_torch.optimize.updaters import AdaDelta


class SimpleCNN(ZooModel):
    input_shape = (48, 48, 3)

    def __init__(self, num_classes: int = 10, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or AdaDelta()

    def conf(self):
        h, w, c = self.input_shape
        b = (NeuralNetConfiguration.builder()
             .seed(self.seed).updater(self.updater).weight_init("relu")
             .list())
        for n_out, pool in ((16, False), (16, True), (32, False), (32, True),
                            (64, False), (64, True)):
            b = b.layer(ConvolutionLayer(n_out=n_out, kernel_size=(3, 3),
                                         convolution_mode="same", activation="relu"))
            b = b.layer(BatchNormalization())
            if pool:
                b = b.layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
        return (b.layer(DenseLayer(n_out=256, activation="relu", dropout=0.5))
                 .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                    loss="mcxent"))
                 .set_input_type(InputType.convolutional(h, w, c))
                 .build())
