"""Keras layer -> framework layer converters (counterpart of
``deeplearning4j_tpu/modelimport/keras_layers.py``: the same registry,
converters and weight functions; the port's layers keep the JAX package's
layouts, ``interop.py``, so the arrays land as they are).

Parity surface: reference ``keras/KerasLayer.java:45`` (base conversion
contract), ``keras/utils/KerasLayerUtils.java:142`` (getKerasLayerFromConfig
registry dispatch) and the per-family converters in
``keras/layers/{core,convolutional,pooling,recurrent,embeddings,normalization}``.

Each converter maps one Keras layer-config dict to a :class:`KerasLayerSpec`:
the framework layer (or vertex, or None for transparent layers like Flatten —
shape adapters are auto-inserted preprocessors here), plus a weight-mapping
function from the Keras weight list to the layer's param dict.

Weight layout notes (TF/channels_last — the import target):
- Dense kernel (n_in, n_out)            == DenseLayer W          (no transpose)
- Conv2D kernel (kh, kw, in, out)       == ConvolutionLayer HWIO (no transpose)
- LSTM kernel (n_in, 4n), gate order (i, f, c, o) == our fused (i, f, g, o)
- Flatten on NHWC flattens (h, w, c)    == CnnToFeedForwardPreProcessor reshape
Keras 1 Theano dim-ordering kernels ((out, in, kh, kw)) are transposed on read
(reference keras/preprocessors dim-ordering handling).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from deeplearning4j_tpu_torch.nn.conf.convolutional import (
    Convolution1DLayer, ConvolutionLayer, Cropping1D, Cropping2D,
    SeparableConvolution2D, Subsampling1DLayer, SubsamplingLayer,
    Upsampling1D, Upsampling2D, ZeroPadding1DLayer, ZeroPaddingLayer,
)
from deeplearning4j_tpu_torch.nn.conf.graph import ElementWiseVertex, MergeVertex
from deeplearning4j_tpu_torch.nn.conf.layers import (
    ActivationLayer, DenseLayer, DropoutLayer, PReLULayer,
)
from deeplearning4j_tpu_torch.nn.conf.normalization import (
    BatchNormalization, LocalResponseNormalization,
)
from deeplearning4j_tpu_torch.nn.conf.pooling import GlobalPoolingLayer
from deeplearning4j_tpu_torch.nn.conf.recurrent import (
    EmbeddingSequenceLayer, GRU, LSTM, LastTimeStep, SimpleRnn,
)


class KerasImportError(Exception):
    """reference keras/exceptions/InvalidKerasConfigurationException +
    UnsupportedKerasConfigurationException collapsed into one type."""


@dataclasses.dataclass
class KerasLayerSpec:
    """Result of converting one Keras layer."""

    layer: object = None          # framework Layer, GraphVertex, or None
    weights: Optional[Callable[[List[np.ndarray]], dict]] = None
    is_input: bool = False
    input_shape: Optional[tuple] = None  # from batch_input_shape when present


_ACTIVATION_MAP = {
    "linear": "identity",
    "relu": "relu",
    "relu6": "relu6",
    "elu": "elu",
    "selu": "selu",
    "gelu": "gelu",
    "softmax": "softmax",
    "softplus": "softplus",
    "softsign": "softsign",
    "sigmoid": "sigmoid",
    "hard_sigmoid": "hardsigmoid",
    "tanh": "tanh",
    "swish": "swish",
    "silu": "swish",
    "leaky_relu": "leakyrelu",
    "log_softmax": "logsoftmax",
}


def map_activation(name: str) -> str:
    if name is None:
        return "identity"
    key = str(name).lower()
    if key not in _ACTIVATION_MAP:
        raise KerasImportError(f"Unsupported Keras activation '{name}'")
    return _ACTIVATION_MAP[key]


_LOSS_MAP = {
    "categorical_crossentropy": "mcxent",
    "sparse_categorical_crossentropy": "mcxent",
    "binary_crossentropy": "xent",
    "mean_squared_error": "mse",
    "mse": "mse",
    "mean_absolute_error": "mae",
    "mae": "mae",
    "mean_absolute_percentage_error": "mape",
    "mean_squared_logarithmic_error": "msle",
    "kullback_leibler_divergence": "kld",
    "kl_divergence": "kld",
    "poisson": "poisson",
    "cosine_proximity": "cosine_proximity",
    "cosine_similarity": "cosine_proximity",
    "hinge": "hinge",
    "squared_hinge": "squared_hinge",
}


def map_loss(name: str) -> str:
    key = str(name).lower()
    if key not in _LOSS_MAP:
        raise KerasImportError(f"Unsupported Keras loss '{name}'")
    return _LOSS_MAP[key]


def _scalar(v) -> int:
    """Keras configs store 1-D sizes as either ints or length-1 lists."""
    return int(v[0]) if isinstance(v, (list, tuple)) else int(v)


def _pair(v):
    if isinstance(v, (list, tuple)):
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


def _batch_shape(cfg: dict) -> Optional[tuple]:
    # Keras 2: batch_input_shape; Keras 3: batch_shape; both lead with None
    bs = cfg.get("batch_input_shape") or cfg.get("batch_shape")
    if bs is None:
        return None
    return tuple(bs[1:])


def _maybe_th_kernel(w: np.ndarray, ctx) -> np.ndarray:
    """Keras 1 Theano dim ordering stores conv kernels (out, in, kh, kw);
    convert to HWIO (reference dim-ordering preprocessing in
    keras/layers/convolutional converters)."""
    if ctx.get("dim_ordering") == "th" and w.ndim == 4:
        return np.transpose(w, (2, 3, 1, 0))
    return w


# ----------------------------------------------------------------- registry
KERAS_LAYER_REGISTRY: Dict[str, Callable] = {}


def register_keras_layer(class_name: str, converter: Callable = None):
    """Register a converter for a Keras layer class name (the custom-layer
    hook — reference KerasLayer.registerCustomLayer, KerasLayer.java:149).
    Usable as a decorator: ``@register_keras_layer("MyLayer")``."""
    if converter is None:
        def deco(fn):
            KERAS_LAYER_REGISTRY[class_name] = fn
            return fn
        return deco
    KERAS_LAYER_REGISTRY[class_name] = converter
    return converter


def convert_layer(class_name: str, cfg: dict, ctx: dict) -> KerasLayerSpec:
    """Dispatch one Keras layer config (reference
    KerasLayerUtils.getKerasLayerFromConfig)."""
    fn = KERAS_LAYER_REGISTRY.get(class_name)
    if fn is None:
        raise KerasImportError(
            f"Unsupported Keras layer type '{class_name}'. Register a custom "
            f"converter with register_keras_layer('{class_name}', fn)")
    spec = fn(cfg, ctx)
    if spec.input_shape is None:
        spec.input_shape = _batch_shape(cfg)
    return spec


# ------------------------------------------------------------------ core
@register_keras_layer("InputLayer")
def _input_layer(cfg, ctx):
    return KerasLayerSpec(is_input=True, input_shape=_batch_shape(cfg))


@register_keras_layer("Dense")
def _dense(cfg, ctx):
    use_bias = cfg.get("use_bias", True)
    layer = DenseLayer(
        name=cfg.get("name"),
        n_out=int(cfg["units"]),
        activation=map_activation(cfg.get("activation", "linear")),
        has_bias=use_bias,
    )

    def weights(ws):
        p = {"W": np.asarray(ws[0])}
        if use_bias:
            p["b"] = np.asarray(ws[1])
        return p

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("Activation")
def _activation(cfg, ctx):
    return KerasLayerSpec(layer=ActivationLayer(
        name=cfg.get("name"), activation=map_activation(cfg.get("activation"))))


@register_keras_layer("Dropout")
def _dropout(cfg, ctx):
    # Keras rate = drop probability; our field = retain probability
    return KerasLayerSpec(layer=DropoutLayer(
        name=cfg.get("name"), dropout=1.0 - float(cfg.get("rate", 0.5))))


@register_keras_layer("Flatten")
def _flatten(cfg, ctx):
    # transparent: the framework auto-inserts CnnToFeedForwardPreProcessor,
    # whose NHWC row-major reshape equals Keras channels_last Flatten
    return KerasLayerSpec(layer=None)


@register_keras_layer("Reshape")
def _reshape(cfg, ctx):
    # only flatten-equivalent reshapes are transparent
    target = tuple(cfg.get("target_shape", ()))
    if len(target) == 1:
        return KerasLayerSpec(layer=None)
    raise KerasImportError(
        f"Reshape to {target} is not supported in sequential import")


# ------------------------------------------------------------- convolution
def _check_data_format(cfg, ctx):
    df = cfg.get("data_format") or ctx.get("data_format") or "channels_last"
    if df == "channels_first" and ctx.get("dim_ordering") != "th":
        raise KerasImportError(
            "channels_first data_format is not supported (the build is NHWC); "
            "re-save the model with channels_last")


@register_keras_layer("Conv2D")
@register_keras_layer("Convolution2D")
@register_keras_layer("AtrousConvolution2D")
def _conv2d(cfg, ctx):
    _check_data_format(cfg, ctx)
    use_bias = cfg.get("use_bias", True)
    padding = cfg.get("padding", cfg.get("border_mode", "valid"))
    layer = ConvolutionLayer(
        name=cfg.get("name"),
        n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
        kernel_size=_pair(cfg.get("kernel_size",
                                  (cfg.get("nb_row", 3), cfg.get("nb_col", 3)))),
        stride=_pair(cfg.get("strides", cfg.get("subsample", (1, 1)))),
        convolution_mode="same" if padding == "same" else "truncate",
        dilation=_pair(cfg.get("dilation_rate", cfg.get("atrous_rate", (1, 1)))),
        has_bias=use_bias,
        activation=map_activation(cfg.get("activation", "linear")),
    )

    def weights(ws):
        p = {"W": _maybe_th_kernel(np.asarray(ws[0]), ctx)}
        if use_bias:
            p["b"] = np.asarray(ws[1])
        return p

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("SeparableConv2D")
def _sepconv2d(cfg, ctx):
    _check_data_format(cfg, ctx)
    use_bias = cfg.get("use_bias", True)
    layer = SeparableConvolution2D(
        name=cfg.get("name"),
        n_out=int(cfg["filters"]),
        kernel_size=_pair(cfg["kernel_size"]),
        stride=_pair(cfg.get("strides", (1, 1))),
        convolution_mode="same" if cfg.get("padding") == "same" else "truncate",
        depth_multiplier=int(cfg.get("depth_multiplier", 1)),
        has_bias=use_bias,
        activation=map_activation(cfg.get("activation", "linear")),
    )

    def weights(ws):
        dw = np.asarray(ws[0])  # (kh, kw, c_in, mult)
        kh, kw, c_in, mult = dw.shape
        p = {
            # grouped-conv HWIO: O ordered c*mult+m == C-order reshape
            "W_dw": dw.reshape(kh, kw, 1, c_in * mult),
            "W_pw": np.asarray(ws[1]),
        }
        if use_bias:
            p["b"] = np.asarray(ws[2])
        return p

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("Conv1D")
@register_keras_layer("Convolution1D")
@register_keras_layer("AtrousConvolution1D")
def _conv1d(cfg, ctx):
    use_bias = cfg.get("use_bias", True)
    k = cfg.get("kernel_size", cfg.get("filter_length", 3))
    k = _scalar(k)
    s = cfg.get("strides", cfg.get("subsample_length", 1))
    s = _scalar(s)
    padding = cfg.get("padding", cfg.get("border_mode", "valid"))
    if padding == "causal":
        raise KerasImportError("causal Conv1D padding is not supported")
    d = _scalar(cfg.get("dilation_rate", cfg.get("atrous_rate", 1)))
    layer = Convolution1DLayer(
        name=cfg.get("name"),
        n_out=int(cfg.get("filters", cfg.get("nb_filter", 0))),
        kernel_size=k, stride=s,
        convolution_mode="same" if padding == "same" else "truncate",
        dilation=d,
        has_bias=use_bias,
        activation=map_activation(cfg.get("activation", "linear")),
    )

    def weights(ws):
        p = {"W": np.asarray(ws[0])}  # (k, in, out) == WIO
        if use_bias:
            p["b"] = np.asarray(ws[1])
        return p

    return KerasLayerSpec(layer=layer, weights=weights)


# ----------------------------------------------------------------- pooling
def _pool2d(cfg, ctx, mode):
    _check_data_format(cfg, ctx)
    pool = _pair(cfg.get("pool_size", (2, 2)))
    strides = cfg.get("strides") or pool
    return KerasLayerSpec(layer=SubsamplingLayer(
        name=cfg.get("name"),
        kernel_size=pool, stride=_pair(strides),
        convolution_mode="same" if cfg.get("padding") == "same" else "truncate",
        pooling_type=mode,
    ))


@register_keras_layer("MaxPooling2D")
def _maxpool2d(cfg, ctx):
    return _pool2d(cfg, ctx, "max")


@register_keras_layer("AveragePooling2D")
def _avgpool2d(cfg, ctx):
    return _pool2d(cfg, ctx, "avg")


def _pool1d(cfg, ctx, mode):
    pool = _scalar(cfg.get("pool_size", 2))
    strides = _scalar(cfg.get("strides") or pool)
    return KerasLayerSpec(layer=Subsampling1DLayer(
        name=cfg.get("name"), kernel_size=pool, stride=strides,
        convolution_mode="same" if cfg.get("padding") == "same" else "truncate",
        pooling_type=mode,
    ))


@register_keras_layer("MaxPooling1D")
def _maxpool1d(cfg, ctx):
    return _pool1d(cfg, ctx, "max")


@register_keras_layer("AveragePooling1D")
def _avgpool1d(cfg, ctx):
    return _pool1d(cfg, ctx, "avg")


@register_keras_layer("GlobalMaxPooling2D")
def _gmaxpool2d(cfg, ctx):
    return KerasLayerSpec(layer=GlobalPoolingLayer(
        name=cfg.get("name"), pooling_type="max"))


@register_keras_layer("GlobalAveragePooling2D")
def _gavgpool2d(cfg, ctx):
    return KerasLayerSpec(layer=GlobalPoolingLayer(
        name=cfg.get("name"), pooling_type="avg"))


@register_keras_layer("GlobalMaxPooling1D")
def _gmaxpool1d(cfg, ctx):
    return KerasLayerSpec(layer=GlobalPoolingLayer(
        name=cfg.get("name"), pooling_type="max"))


@register_keras_layer("GlobalAveragePooling1D")
def _gavgpool1d(cfg, ctx):
    return KerasLayerSpec(layer=GlobalPoolingLayer(
        name=cfg.get("name"), pooling_type="avg"))


@register_keras_layer("UpSampling2D")
def _upsampling2d(cfg, ctx):
    return KerasLayerSpec(layer=Upsampling2D(
        name=cfg.get("name"), size=_pair(cfg.get("size", (2, 2)))))


@register_keras_layer("UpSampling1D")
def _upsampling1d(cfg, ctx):
    return KerasLayerSpec(layer=Upsampling1D(
        name=cfg.get("name"), size=_scalar(cfg.get("size", cfg.get("length", 2)))))


@register_keras_layer("LRN")
def _lrn(cfg, ctx):
    """Caffe-style local response normalization shipped as a Keras custom
    layer in GoogLeNet-era model files (reference keras/layers/custom/
    KerasLRN.java — pre-registered, no user hook needed)."""
    return KerasLayerSpec(layer=LocalResponseNormalization(
        name=cfg.get("name"),
        k=float(cfg.get("k", 2.0)), n=int(cfg.get("n", 5)),
        alpha=float(cfg.get("alpha", 1e-4)),
        beta=float(cfg.get("beta", 0.75))))


@register_keras_layer("PoolHelper")
def _pool_helper(cfg, ctx):
    """Crops the first row/column (Caffe->Keras GoogLeNet pooling alignment
    shim; reference keras/layers/custom/KerasPoolHelper.java)."""
    return KerasLayerSpec(layer=Cropping2D(
        name=cfg.get("name"), cropping=(1, 0, 1, 0)))


@register_keras_layer("ZeroPadding2D")
def _zeropad2d(cfg, ctx):
    pad = cfg.get("padding", (1, 1))
    if isinstance(pad, int):
        pads = (pad, pad, pad, pad)
    elif isinstance(pad[0], (list, tuple)):
        (t, b), (l, r) = pad
        pads = (int(t), int(b), int(l), int(r))
    else:
        pads = (int(pad[0]), int(pad[0]), int(pad[1]), int(pad[1]))
    return KerasLayerSpec(layer=ZeroPaddingLayer(name=cfg.get("name"), padding=pads))


# ----------------------------------------------------------- normalization
@register_keras_layer("BatchNormalization")
def _batchnorm(cfg, ctx):
    axis = cfg.get("axis", -1)
    if isinstance(axis, (list, tuple)):
        axis = axis[0]
    scale = cfg.get("scale", True)
    center = cfg.get("center", True)
    if not (scale and center):
        raise KerasImportError(
            "BatchNormalization without scale+center is not supported")
    layer = BatchNormalization(
        name=cfg.get("name"),
        decay=float(cfg.get("momentum", 0.99)),
        eps=float(cfg.get("epsilon", 1e-3)),
    )

    def weights(ws):
        # order: gamma, beta, moving_mean, moving_variance
        return {"gamma": np.asarray(ws[0]), "beta": np.asarray(ws[1]),
                "__state__mean": np.asarray(ws[2]),
                "__state__var": np.asarray(ws[3])}

    return KerasLayerSpec(layer=layer, weights=weights)


# -------------------------------------------------------------- recurrent
@register_keras_layer("LSTM")
def _lstm(cfg, ctx):
    act = map_activation(cfg.get("activation", "tanh"))
    rec_act = map_activation(cfg.get("recurrent_activation",
                                     cfg.get("inner_activation", "sigmoid")))
    use_bias = cfg.get("use_bias", True)
    if not use_bias:
        raise KerasImportError("LSTM without bias is not supported")
    inner = LSTM(
        name=cfg.get("name"),
        n_out=int(cfg.get("units", cfg.get("output_dim", 0))),
        activation=act, gate_activation=rec_act,
    )
    ret_seq = cfg.get("return_sequences", False)
    layer = inner if ret_seq else LastTimeStep(name=cfg.get("name"), layer=inner)

    def weights(ws):
        # Keras: kernel (n_in, 4n), recurrent_kernel (n, 4n), bias (4n,)
        # gate order (i, f, c, o) == our fused (i, f, g, o)
        return {"W": np.asarray(ws[0]), "U": np.asarray(ws[1]),
                "b": np.asarray(ws[2])}

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("Embedding")
def _embedding(cfg, ctx):
    layer = EmbeddingSequenceLayer(
        name=cfg.get("name"),
        n_in=int(cfg["input_dim"]), n_out=int(cfg["output_dim"]))

    def weights(ws):
        return {"W": np.asarray(ws[0])}

    spec = KerasLayerSpec(layer=layer, weights=weights)
    # Keras 2 embeddings may carry input_length instead of batch_input_shape
    if _batch_shape(cfg) is None and cfg.get("input_length"):
        spec.input_shape = (int(cfg["input_length"]),)
    return spec


# ------------------------------------------------------- merges (functional)
@register_keras_layer("Add")
def _add(cfg, ctx):
    return KerasLayerSpec(layer=ElementWiseVertex(op="add"))


@register_keras_layer("Subtract")
def _subtract(cfg, ctx):
    return KerasLayerSpec(layer=ElementWiseVertex(op="subtract"))


@register_keras_layer("Multiply")
def _multiply(cfg, ctx):
    return KerasLayerSpec(layer=ElementWiseVertex(op="product"))


@register_keras_layer("Average")
def _average(cfg, ctx):
    return KerasLayerSpec(layer=ElementWiseVertex(op="average"))


@register_keras_layer("Maximum")
def _maximum(cfg, ctx):
    return KerasLayerSpec(layer=ElementWiseVertex(op="max"))


@register_keras_layer("Concatenate")
@register_keras_layer("Merge")
def _concatenate(cfg, ctx):
    axis = cfg.get("axis", -1)
    mode = cfg.get("mode")  # Keras 1 Merge layer
    if mode in (None, "concat"):
        if axis not in (-1, 3, 2):
            raise KerasImportError(f"Concatenate on axis {axis} is not supported")
        return KerasLayerSpec(layer=MergeVertex())
    if mode == "sum":
        return KerasLayerSpec(layer=ElementWiseVertex(op="add"))
    if mode == "mul":
        return KerasLayerSpec(layer=ElementWiseVertex(op="product"))
    raise KerasImportError(f"Unsupported Keras 1 Merge mode '{mode}'")


@register_keras_layer("GRU")
def _gru(cfg, ctx):
    """Keras GRU (beyond the reference's converter set — KerasLayerConfiguration
    has no GRU; gate order z, r, h matches our fused layout)."""
    if not cfg.get("use_bias", True):
        raise KerasImportError("GRU without bias is not supported")
    reset_after = bool(cfg.get("reset_after", False))
    inner = GRU(
        name=cfg.get("name"),
        n_out=int(cfg.get("units", cfg.get("output_dim", 0))),
        activation=map_activation(cfg.get("activation", "tanh")),
        gate_activation=map_activation(
            cfg.get("recurrent_activation",
                    cfg.get("inner_activation", "sigmoid"))),
        reset_after=reset_after,
    )
    layer = inner if cfg.get("return_sequences", False) \
        else LastTimeStep(name=cfg.get("name"), layer=inner)

    def weights(ws):
        out = {"W": np.asarray(ws[0]), "U": np.asarray(ws[1])}
        b = np.asarray(ws[2])
        if reset_after:
            # Keras stores (2, 3n): input bias row + recurrent bias row
            if b.ndim != 2:
                raise KerasImportError(
                    f"reset_after GRU expects bias shape (2, 3n); got {b.shape}")
            out["b"], out["br"] = b[0], b[1]
        else:
            out["b"] = b.reshape(-1)
        return out

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("SimpleRNN")
def _simple_rnn(cfg, ctx):
    if not cfg.get("use_bias", True):
        raise KerasImportError("SimpleRNN without bias is not supported")
    inner = SimpleRnn(
        name=cfg.get("name"),
        n_out=int(cfg.get("units", cfg.get("output_dim", 0))),
        activation=map_activation(cfg.get("activation", "tanh")),
    )
    layer = inner if cfg.get("return_sequences", False) \
        else LastTimeStep(name=cfg.get("name"), layer=inner)

    def weights(ws):
        return {"W": np.asarray(ws[0]), "U": np.asarray(ws[1]),
                "b": np.asarray(ws[2]).reshape(-1)}

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("LeakyReLU")
def _leaky_relu(cfg, ctx):
    # reference KerasLayerConfiguration LEAKY_RELU -> ActivationLayer
    # (Keras 1/2 call the slope "alpha"; Keras 3 "negative_slope")
    slope = cfg.get("negative_slope", cfg.get("alpha", 0.3))
    return KerasLayerSpec(layer=ActivationLayer(
        name=cfg.get("name"), activation="leakyrelu",
        activation_param=float(slope)))


@register_keras_layer("ELU")
def _elu_layer(cfg, ctx):
    alpha = float(cfg.get("alpha", 1.0))
    return KerasLayerSpec(layer=ActivationLayer(
        name=cfg.get("name"), activation="elu",
        activation_param=None if alpha == 1.0 else alpha))


@register_keras_layer("ThresholdedReLU")
def _thresholded_relu(cfg, ctx):
    return KerasLayerSpec(layer=ActivationLayer(
        name=cfg.get("name"), activation="thresholdedrelu",
        activation_param=float(cfg.get("theta", 1.0))))


@register_keras_layer("PReLU")
def _prelu(cfg, ctx):
    shared = cfg.get("shared_axes")
    layer = PReLULayer(name=cfg.get("name"),
                       shared_axes=None if not shared else tuple(shared))

    def weights(ws):
        return {"alpha": np.asarray(ws[0])}

    return KerasLayerSpec(layer=layer, weights=weights)


@register_keras_layer("Cropping2D")
def _cropping2d(cfg, ctx):
    c = cfg.get("cropping", ((0, 0), (0, 0)))
    if isinstance(c, int):
        crops = (c, c, c, c)
    elif isinstance(c[0], (list, tuple)):
        crops = (c[0][0], c[0][1], c[1][0], c[1][1])
    else:
        crops = (c[0], c[0], c[1], c[1])
    return KerasLayerSpec(layer=Cropping2D(
        name=cfg.get("name"), cropping=tuple(int(v) for v in crops)))


@register_keras_layer("Cropping1D")
def _cropping1d(cfg, ctx):
    c = cfg.get("cropping", (1, 1))
    if isinstance(c, int):
        c = (c, c)
    return KerasLayerSpec(layer=Cropping1D(
        name=cfg.get("name"), cropping=(int(c[0]), int(c[1]))))


@register_keras_layer("ZeroPadding1D")
def _zero_padding1d(cfg, ctx):
    p = cfg.get("padding", 1)
    if isinstance(p, int):
        p = (p, p)
    return KerasLayerSpec(layer=ZeroPadding1DLayer(
        name=cfg.get("name"), padding=(int(p[0]), int(p[1]))))
