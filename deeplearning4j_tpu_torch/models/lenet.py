"""LeNet (counterpart of ``deeplearning4j_tpu/models/lenet.py``; reference
zoo/model/LeNet.java): conv5x5(20) -> maxpool -> conv5x5(50) -> maxpool ->
dense(500) -> softmax, on 28x28x1 images fed flat (784). BASELINE
configs[0]."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
from deeplearning4j_tpu_torch.optimize.updaters import Adam


class LeNet(ZooModel):
    input_shape = (28, 28, 1)

    def __init__(self, num_classes: int = 10, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Adam(learning_rate=1e-3)

    def conf(self):
        h, w, c = self.input_shape
        return (NeuralNetConfiguration.builder()
                .seed(self.seed)
                .updater(self.updater)
                .weight_init("xavier")
                .list()
                .layer(ConvolutionLayer(n_out=20, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(ConvolutionLayer(n_out=50, kernel_size=(5, 5), stride=(1, 1),
                                        convolution_mode="same", activation="relu"))
                .layer(SubsamplingLayer(kernel_size=(2, 2), stride=(2, 2)))
                .layer(DenseLayer(n_out=500, activation="relu"))
                .layer(OutputLayer(n_out=self.num_classes, activation="softmax",
                                   loss="mcxent"))
                .set_input_type(InputType.convolutional_flat(h, w, c))
                .build())
