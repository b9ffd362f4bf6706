"""GoogLeNet (Inception v1) as a ComputationGraph (counterpart of
``deeplearning4j_tpu/models/googlenet.py``; reference
zoo/model/GoogLeNet.java): the stem with two LRNs, nine four-branch
inception modules concatenated on channels (MergeVertex), global average
pooling, dense(1024) with dropout and softmax. Same graph, vertex names and
JSON as the JAX package's."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.graph import GraphBuilder, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import Builder
from deeplearning4j_tpu_torch.nn.conf.normalization import LocalResponseNormalization
from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.optimize.updaters import Adam

# name -> [[1x1], [3x3 reduce, 3x3], [5x5 reduce, 5x5], [pool proj]], and
# the max pool after the module, if any (GoogLeNet.java:156-170)
_INCEPTION = [
    ("3a", [[64], [96, 128], [16, 32], [32]], None),
    ("3b", [[128], [128, 192], [32, 96], [64]], "max"),
    ("4a", [[192], [96, 208], [16, 48], [64]], None),
    ("4b", [[160], [112, 224], [24, 64], [64]], None),
    ("4c", [[128], [128, 256], [24, 64], [64]], None),
    ("4d", [[112], [144, 288], [32, 64], [64]], None),
    ("4e", [[256], [160, 320], [32, 128], [128]], "max"),
    ("5a", [[256], [160, 320], [32, 128], [128]], None),
    ("5b", [[384], [192, 384], [48, 128], [128]], None),
]


class GoogLeNet(ZooModel):
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Adam(learning_rate=1e-3)

    def _conv(self, g, name, inp, n_out, kernel, stride=(1, 1)):
        g.add_layer(name, ConvolutionLayer(n_out=n_out, kernel_size=kernel, stride=stride,
                                           convolution_mode="same", activation="relu",
                                           bias_init=0.2), inp)
        return name

    def _maxpool(self, g, name, inp, stride=2):
        g.add_layer(name, SubsamplingLayer(kernel_size=(3, 3), stride=(stride, stride),
                                           convolution_mode="same"), inp)
        return name

    def _inception(self, g, name, inp, config):
        b1 = self._conv(g, f"{name}-cnn1", inp, config[0][0], (1, 1))
        r3 = self._conv(g, f"{name}-cnn2", inp, config[1][0], (1, 1))
        b2 = self._conv(g, f"{name}-cnn3", r3, config[1][1], (3, 3))
        r5 = self._conv(g, f"{name}-cnn4", inp, config[2][0], (1, 1))
        b3 = self._conv(g, f"{name}-cnn5", r5, config[2][1], (5, 5))
        mp = self._maxpool(g, f"{name}-max1", inp, stride=1)
        b4 = self._conv(g, f"{name}-cnn6", mp, config[3][0], (1, 1))
        g.add_vertex(f"{name}-depthconcat1", MergeVertex(), b1, b2, b3, b4)
        return f"{name}-depthconcat1"

    def conf(self):
        h, w, c = self.input_shape
        parent = Builder()
        parent.seed(self.seed).updater(self.updater).weight_init("xavier").l2(2e-4)
        g = GraphBuilder(parent)
        g.add_inputs("input")
        x = self._conv(g, "cnn1", "input", 64, (7, 7), stride=(2, 2))
        x = self._maxpool(g, "max1", x)
        g.add_layer("lrn1", LocalResponseNormalization(), x)
        x = self._conv(g, "cnn2", "lrn1", 64, (1, 1))
        x = self._conv(g, "cnn3", x, 192, (3, 3))
        g.add_layer("lrn2", LocalResponseNormalization(), x)
        x = self._maxpool(g, "max2", "lrn2")
        for name, config, pool_after in _INCEPTION:
            x = self._inception(g, name, x, config)
            if pool_after:
                x = self._maxpool(g, f"max-{name}", x)
        g.add_layer("avg3", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("fc1", DenseLayer(n_out=1024, activation="relu", dropout=0.4), "avg3")
        g.add_layer("output", OutputLayer(n_out=self.num_classes, activation="softmax",
                                          loss="mcxent"), "fc1")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()
