"""Face-embedding zoo models, InceptionResNetV1 and FaceNetNN4Small2
(counterpart of ``deeplearning4j_tpu/models/facenet.py``; reference
zoo/model/InceptionResNetV1.java and FaceNetNN4Small2.java). Every conv is
a bias-free conv → BatchNormalization(eps 1e-3, decay 0.995) (→ ReLU),
which ``conf.fused()`` turns into one ``FusedConvBNActivation``; the
embedding tail is global average pooling, a 128-wide bottleneck, L2
normalisation and a CenterLossOutputLayer (alpha 0.9, lambda 1e-4). Same
graphs, vertex names and JSON as the JAX package's."""

from __future__ import annotations

from deeplearning4j_tpu_torch.models.zoo import ZooModel
from deeplearning4j_tpu_torch.nn.conf.convolutional import ConvolutionLayer, SubsamplingLayer
from deeplearning4j_tpu_torch.nn.conf.graph import (ElementWiseVertex, GraphBuilder,
                                                    L2NormalizeVertex, MergeVertex,
                                                    ScaleVertex)
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (ActivationLayer, CenterLossOutputLayer,
                                                     DenseLayer)
from deeplearning4j_tpu_torch.nn.conf.network import Builder
from deeplearning4j_tpu_torch.nn.conf.normalization import BatchNormalization
from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.optimize.updaters import Adam


class _FaceNetBase(ZooModel):
    embedding_size = 128

    def __init__(self, num_classes: int = 1000, seed: int = 12345, input_shape=None,
                 updater=None, embedding_size=None):
        super().__init__(num_classes, seed, input_shape)
        self.updater = updater or Adam(learning_rate=1e-3)
        if embedding_size is not None:
            self.embedding_size = embedding_size

    def _conv_bn(self, g, name, inp, n_out, kernel, stride=(1, 1), act="relu", mode="same"):
        g.add_layer(name, ConvolutionLayer(n_out=n_out, kernel_size=kernel, stride=stride,
                                           convolution_mode=mode, activation="identity",
                                           has_bias=False), inp)
        g.add_layer(f"{name}-bn", BatchNormalization(eps=0.001, decay=0.995), name)
        if act is None:
            return f"{name}-bn"
        g.add_layer(f"{name}-act", ActivationLayer(activation=act), f"{name}-bn")
        return f"{name}-act"

    def _maxpool(self, g, name, inp, kernel=3, stride=2):
        g.add_layer(name, SubsamplingLayer(kernel_size=(kernel, kernel), stride=(stride, stride),
                                           convolution_mode="same"), inp)
        return name

    def _graph(self):
        parent = Builder()
        parent.seed(self.seed).updater(self.updater).weight_init("relu")
        g = GraphBuilder(parent)
        g.add_inputs("input")
        return g

    def _embedding_tail(self, g, x):
        """avgpool -> bottleneck dense -> L2 normalize -> center-loss softmax."""
        g.add_layer("avgpool", GlobalPoolingLayer(pooling_type="avg"), x)
        g.add_layer("bottleneck", DenseLayer(n_out=self.embedding_size, activation="identity"),
                    "avgpool")
        g.add_vertex("embeddings", L2NormalizeVertex(), "bottleneck")
        g.add_layer("lossLayer", CenterLossOutputLayer(n_out=self.num_classes,
                                                       activation="softmax", loss="mcxent",
                                                       alpha=0.9, lamda=1e-4), "embeddings")
        g.set_outputs("lossLayer")
        h, w, c = self.input_shape
        g.set_input_types(InputType.convolutional(h, w, c))
        return g.build()


class InceptionResNetV1(_FaceNetBase):
    """Scaled-residual Inception: stem, 5 block35, reduction A, 10 block17,
    reduction B, 5 block8."""

    input_shape = (160, 160, 3)

    def _residual(self, g, name, inp, branch_out, scale):
        g.add_vertex(f"{name}-scale", ScaleVertex(scale=scale), branch_out)
        g.add_vertex(f"{name}-add", ElementWiseVertex(op="add"), inp, f"{name}-scale")
        g.add_layer(f"{name}-out", ActivationLayer(activation="relu"), f"{name}-add")
        return f"{name}-out"

    def _block(self, g, name, inp, branches, up, scale):
        """Parallel conv branches (each a list of (n_out, kernel)), concat,
        a 1x1 up-projection without activation, then the scaled residual."""
        outs = []
        for bi, convs in enumerate(branches, 1):
            x = inp
            for ci, (n_out, kernel) in enumerate(convs):
                suffix = "" if len(convs) == 1 else "abc"[ci]
                x = self._conv_bn(g, f"{name}-b{bi}{suffix}", x, n_out, kernel)
            outs.append(x)
        g.add_vertex(f"{name}-concat", MergeVertex(), *outs)
        u = self._conv_bn(g, f"{name}-up", f"{name}-concat", up, (1, 1), act=None)
        return self._residual(g, name, inp, u, scale)

    def _reduction_a(self, g, inp):
        b1 = self._conv_bn(g, "redA-b1", inp, 384, (3, 3), stride=(2, 2))
        b2 = self._conv_bn(g, "redA-b2a", inp, 192, (1, 1))
        b2 = self._conv_bn(g, "redA-b2b", b2, 192, (3, 3))
        b2 = self._conv_bn(g, "redA-b2c", b2, 256, (3, 3), stride=(2, 2))
        b3 = self._maxpool(g, "redA-pool", inp)
        g.add_vertex("redA", MergeVertex(), b1, b2, b3)
        return "redA"

    def _reduction_b(self, g, inp):
        b1 = self._conv_bn(g, "redB-b1a", inp, 256, (1, 1))
        b1 = self._conv_bn(g, "redB-b1b", b1, 384, (3, 3), stride=(2, 2))
        b2 = self._conv_bn(g, "redB-b2a", inp, 256, (1, 1))
        b2 = self._conv_bn(g, "redB-b2b", b2, 256, (3, 3), stride=(2, 2))
        b3 = self._conv_bn(g, "redB-b3a", inp, 256, (1, 1))
        b3 = self._conv_bn(g, "redB-b3b", b3, 256, (3, 3))
        b3 = self._conv_bn(g, "redB-b3c", b3, 256, (3, 3), stride=(2, 2))
        b4 = self._maxpool(g, "redB-pool", inp)
        g.add_vertex("redB", MergeVertex(), b1, b2, b3, b4)
        return "redB"

    def conf(self):
        g = self._graph()
        x = self._conv_bn(g, "stem-1", "input", 32, (3, 3), stride=(2, 2))
        x = self._conv_bn(g, "stem-2", x, 32, (3, 3))
        x = self._conv_bn(g, "stem-3", x, 64, (3, 3))
        x = self._maxpool(g, "stem-pool", x)
        x = self._conv_bn(g, "stem-4", x, 80, (1, 1))
        x = self._conv_bn(g, "stem-5", x, 192, (3, 3))
        x = self._conv_bn(g, "stem-6", x, 256, (3, 3), stride=(2, 2))
        for i in range(5):
            x = self._block(g, f"b35-{i}", x, [[(32, (1, 1))], [(32, (1, 1)), (32, (3, 3))],
                                               [(32, (1, 1)), (32, (3, 3)), (32, (3, 3))]],
                            256, 0.17)
        x = self._reduction_a(g, x)
        for i in range(10):
            x = self._block(g, f"b17-{i}", x, [[(128, (1, 1))], [(128, (1, 1)), (128, (1, 7)),
                                                                 (128, (7, 1))]], 896, 0.10)
        x = self._reduction_b(g, x)
        for i in range(5):
            x = self._block(g, f"b8-{i}", x, [[(192, (1, 1))], [(192, (1, 1)), (192, (1, 3)),
                                                                (192, (3, 1))]], 1792, 0.20)
        return self._embedding_tail(g, x)


# NN4-small2 inception table (FaceNetNN4Small2.java:96-326):
# name -> (c1x1, r3x3, c3x3, r5x5, c5x5, pool_type, pool_proj, stride)
_NN4_MODULES = [
    ("3a", 64, 96, 128, 16, 32, "max", 32, 1),
    ("3b", 64, 96, 128, 32, 64, "avg", 64, 1),
    ("3c", 0, 128, 256, 32, 64, "max", 0, 2),
    ("4a", 256, 96, 192, 32, 64, "avg", 128, 1),
    ("4e", 0, 160, 256, 64, 128, "max", 0, 2),
    ("5a", 256, 96, 384, 0, 0, "avg", 96, 1),
    ("5b", 256, 96, 384, 0, 0, "max", 96, 1),
]


class FaceNetNN4Small2(_FaceNetBase):
    """NN4-small2 inception variant on 96 x 96 faces."""

    input_shape = (96, 96, 3)

    def _module(self, g, name, inp, c1, r3, c3, r5, c5, pool, proj, stride):
        s = (stride, stride)
        branches = []
        if c1:
            branches.append(self._conv_bn(g, f"{name}-1x1", inp, c1, (1, 1), stride=s))
        if c3:
            b = self._conv_bn(g, f"{name}-3x3r", inp, r3, (1, 1))
            branches.append(self._conv_bn(g, f"{name}-3x3", b, c3, (3, 3), stride=s))
        if c5:
            b = self._conv_bn(g, f"{name}-5x5r", inp, r5, (1, 1))
            branches.append(self._conv_bn(g, f"{name}-5x5", b, c5, (5, 5), stride=s))
        g.add_layer(f"{name}-pool", SubsamplingLayer(kernel_size=(3, 3), stride=s,
                                                     pooling_type=pool,
                                                     convolution_mode="same"), inp)
        if proj:
            branches.append(self._conv_bn(g, f"{name}-poolproj", f"{name}-pool", proj, (1, 1)))
        else:
            branches.append(f"{name}-pool")
        g.add_vertex(f"{name}-concat", MergeVertex(), *branches)
        return f"{name}-concat"

    def conf(self):
        g = self._graph()
        x = self._conv_bn(g, "stem-cnn1", "input", 64, (7, 7), stride=(2, 2))
        x = self._maxpool(g, "stem-pool1", x)
        x = self._conv_bn(g, "stem-cnn2", x, 64, (1, 1))
        x = self._conv_bn(g, "stem-cnn3", x, 192, (3, 3))
        x = self._maxpool(g, "stem-pool2", x)
        for row in _NN4_MODULES:
            x = self._module(g, row[0], x, *row[1:])
        return self._embedding_tail(g, x)
