"""The port's sklearn-contract estimators (``mlpipeline.py``) against the JAX
package's, on the CPU: fitted on the same data, then given the JAX
estimator's weights (``interop.params_from_jax``), the port's predictions
match the JAX package's (probabilities within 1e-6, labels equal);
``get_params`` / ``set_params`` / ``clone`` behave the same (the port's
parameters add ``device``, its device rule); a port estimator fits in a
Pipeline and scores as its own network; and ``fit`` is bitwise a
MultiLayerNetwork ``fit`` from the same seed over the same batches.
"""

import numpy as np
import pytest

from deeplearning4j_tpu import mlpipeline as jml
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.optimize.updaters import Adam as JAdam

from deeplearning4j_tpu_torch import mlpipeline as pml
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _jconf(n_in, n_out, act, loss):
    return (JNNC.builder().seed(7).updater(JAdam(0.02)).weight_init("xavier").list()
            .layer(JDense(n_out=16, activation="tanh"))
            .layer(JOutput(n_out=n_out, activation=act, loss=loss))
            .set_input_type(JInputType.feed_forward(n_in)).build())


def _jcls():
    return _jconf(4, 3, "softmax", "mcxent")


def _pcls():
    return conf_from_jax_json(_jcls().to_json())


def _jreg():
    return _jconf(3, 1, "identity", "mse")


def _preg():
    return conf_from_jax_json(_jreg().to_json())


def _data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.argmax(X[:, :3] + 0.3 * rng.standard_normal((n, 3)), axis=1)
    return X, y


def _carry(port_est, jax_est):
    """The JAX estimator's fitted weights into the port estimator's network."""
    port_est.model_.set_params(params_from_jax(
        [{k: np.asarray(v) for k, v in p.items()} for p in jax_est.model_.params],
        device="cpu"))


@pytest.mark.parametrize("labels", ["ints", "strings", "one_hot"])
def test_classifier_predictions_match_jax_on_the_same_weights(labels):
    X, y = _data()
    if labels == "strings":
        y = np.array(["cat", "dog", "eel"])[y]
    elif labels == "one_hot":
        y = np.eye(3, dtype=np.float32)[y]
    jc = jml.DL4JClassifier(conf=_jcls, epochs=3, batch_size=16).fit(X, y)
    pc = pml.DL4JClassifier(conf=_pcls, epochs=3, batch_size=16, device="cpu").fit(X, y)
    np.testing.assert_array_equal(pc.classes_, jc.classes_)
    _carry(pc, jc)
    np.testing.assert_allclose(pc.predict_proba(X), jc.predict_proba(X), atol=1e-6)
    np.testing.assert_array_equal(pc.predict(X), jc.predict(X))
    assert pc.score(X, y) == jc.score(X, y)
    assert pc.n_features_in_ == jc.n_features_in_


def test_regressor_predictions_match_jax_on_the_same_weights():
    rng = np.random.default_rng(2)
    X = rng.standard_normal((40, 3)).astype(np.float32)
    y = (X @ np.array([1.0, -2.0, 0.5]) + 0.1).astype(np.float32)
    jr = jml.DL4JRegressor(conf=_jreg, epochs=2, batch_size=8).fit(X, y)
    pr = pml.DL4JRegressor(conf=_preg, epochs=2, batch_size=8, device="cpu").fit(X, y)
    _carry(pr, jr)
    np.testing.assert_allclose(pr.predict(X), jr.predict(X), atol=1e-5)
    assert pr.predict(X).shape == (40,)
    np.testing.assert_allclose(pr.score(X, y), jr.score(X, y), rtol=1e-5)


def test_params_contract_alike():
    from sklearn.base import clone
    j = jml.DL4JClassifier(conf=_jcls, epochs=5)
    p = pml.DL4JClassifier(conf=_pcls, epochs=5, device="cpu")
    jp, pp = j.get_params(), p.get_params()
    assert set(pp) == set(jp) | {"device"} and pp["device"] == "cpu"
    assert {k: v for k, v in pp.items() if k not in ("conf", "device")} == \
        {k: v for k, v in jp.items() if k != "conf"}
    assert p.set_params(epochs=2, seed=3) is p and (p.epochs, p.seed) == (2, 3)
    for est in (j, p):
        with pytest.raises(ValueError, match="Invalid parameter"):
            est.set_params(learning_rate=1.0)
        with pytest.raises(RuntimeError, match="not fitted"):
            est.predict(np.zeros((1, 4), np.float32))
    c = clone(p)
    assert type(c) is type(p) and c.get_params() == p.get_params() and c is not p
    assert not hasattr(c, "model_")
    with pytest.raises(ValueError, match="needs a network configuration"):
        pml.DL4JClassifier(device="cpu").fit(*_data())


def test_pipeline_and_fit_bitwise_a_plain_fit():
    """Inside a Pipeline the estimator scores as its own network; and its
    fit is the MultiLayerNetwork fit over the same shuffled batches."""
    from sklearn.base import is_classifier, is_regressor
    from sklearn.pipeline import Pipeline
    from sklearn.preprocessing import StandardScaler
    X, y = _data(80, 1)
    pipe = Pipeline([("scale", StandardScaler()),
                     ("net", pml.DL4JClassifier(conf=_pcls, epochs=4, batch_size=16,
                                                device="cpu"))]).fit(X, y)
    assert pipe.score(X, y) == pipe.named_steps["net"].score(
        pipe.named_steps["scale"].transform(X), y)
    assert is_classifier(pml.DL4JClassifier()) and is_regressor(pml.DL4JRegressor())

    est = pml.DL4JClassifier(conf=_pcls, epochs=2, batch_size=16, seed=5,
                             device="cpu").fit(X, y)
    net = MultiLayerNetwork(_pcls(), device="cpu").init(5)
    onehot = np.eye(3, dtype=np.float32)[y]
    rng = np.random.default_rng(5)
    for _ in range(2):
        order = rng.permutation(len(X))
        for s in range(0, len(X), 16):
            net.fit(DataSet(X[order[s:s + 16]], onehot[order[s:s + 16]]))
    np.testing.assert_array_equal(est.predict_proba(X), net.output(X).numpy())
