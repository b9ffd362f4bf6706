"""ResNet50 as a ComputationGraph (counterpart of
``deeplearning4j_tpu/models/resnet50.py``; reference zoo/model/ResNet50.java).
Same graph, vertex names and JSON as the JAX package's: a 7x7/2 stem,
bottleneck stages [3, 4, 6, 3], global average pooling, softmax output."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, GraphBuilder
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.conf.network import Builder
from deeplearning4j_tpu_torch.nn.conf.normalization import BatchNormalization
from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.optimize.updaters import Adam


class ResNet50(ZooModel):
    input_shape = (224, 224, 3)

    def __init__(self, num_classes: int = 1000, seed: int = 12345, input_shape=None,
                 updater=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Adam(learning_rate=1e-3)

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1), pad_same=True,
                 act="relu"):
        g.add_layer(f"{name}_conv",
                    ConvolutionLayer(n_out=n_out, kernel_size=kernel, stride=stride,
                                     convolution_mode="same" if pad_same else "truncate",
                                     activation="identity", has_bias=False), inp)
        g.add_layer(f"{name}_bn", BatchNormalization(), f"{name}_conv")
        if act is None:
            return f"{name}_bn"
        g.add_layer(f"{name}_act", ActivationLayer(activation=act), f"{name}_bn")
        return f"{name}_act"

    def _identity_block(self, g, name, inp, filters):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_2a", inp, f1, (1, 1))
        x = self._conv_bn(g, f"{name}_2b", x, f2, (3, 3))
        x = self._conv_bn(g, f"{name}_2c", x, f3, (1, 1), act=None)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, inp)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
        return f"{name}_out"

    def _conv_block(self, g, name, inp, filters, stride=(2, 2)):
        f1, f2, f3 = filters
        x = self._conv_bn(g, f"{name}_2a", inp, f1, (1, 1), stride=stride)
        x = self._conv_bn(g, f"{name}_2b", x, f2, (3, 3))
        x = self._conv_bn(g, f"{name}_2c", x, f3, (1, 1), act=None)
        sc = self._conv_bn(g, f"{name}_1", inp, f3, (1, 1), stride=stride, act=None)
        g.add_vertex(f"{name}_add", ElementWiseVertex(op="add"), x, sc)
        g.add_layer(f"{name}_out", ActivationLayer(activation="relu"), f"{name}_add")
        return f"{name}_out"

    def conf(self):
        h, w, c = self.input_shape
        parent = Builder()
        parent.seed(self.seed).updater(self.updater).weight_init("relu")
        g = GraphBuilder(parent)
        g.add_inputs("input")
        # stem: 7x7/2 conv -> bn -> relu -> 3x3/2 max pool
        stem = self._conv_bn(g, "stem", "input", 64, (7, 7), stride=(2, 2))
        g.add_layer("stem_pool", SubsamplingLayer(kernel_size=(3, 3), stride=(2, 2),
                                                  convolution_mode="same"), stem)
        x = "stem_pool"
        stages = [
            ("2", (64, 64, 256), 3, (1, 1)),
            ("3", (128, 128, 512), 4, (2, 2)),
            ("4", (256, 256, 1024), 6, (2, 2)),
            ("5", (512, 512, 2048), 3, (2, 2)),
        ]
        for sname, filters, reps, stride in stages:
            x = self._conv_block(g, f"res{sname}a", x, filters, stride=stride)
            for i in range(1, reps):
                x = self._identity_block(g, f"res{sname}{'bcdefghij'[i-1]}", x, filters)
        g.add_layer("avg_pool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("output", OutputLayer(n_out=self.num_classes, activation="softmax",
                                          loss="mcxent"), "avg_pool")
        g.set_outputs("output")
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()
