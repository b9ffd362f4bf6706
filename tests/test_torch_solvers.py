"""The port's full-batch solvers (``optimize/solvers.py``) against the JAX
package's, on the CPU: the counterparts of tests/test_solvers.py.

The same Iris-shaped network (4 -> 10 tanh -> 3 softmax, the JAX
package's weights crossed by ``interop.params_from_jax``) and the same
full batch go through both packages' ``Solver``. Tolerances: the Armijo
step on a quadratic is equal; conjugate gradient and line gradient descent
(host-driven backtracking on float32 losses) agree on their first 10
scores within rtol 1e-5; LBFGS (the port's two-loop recursion and zoom
line search after optax's, where the JAX package runs optax in one
compiled program) within rtol 1e-5 on the first 5 scores and 1e-4 on the
score after 20 iterations. Summation orders differ between XLA and
torch, so none of it is bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JaxDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JaxOutput
from deeplearning4j_tpu.nn.conf.regularization import MaxNormConstraint as JaxMaxNorm
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxMLN
from deeplearning4j_tpu.optimize import solvers as jsolvers
from deeplearning4j_tpu.optimize.updaters import Sgd as JaxSgd

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax, state_from_jax
from deeplearning4j_tpu_torch.nn.conf.network import MultiLayerConfiguration
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.listeners import TrainingListener
from deeplearning4j_tpu_torch.optimize.solvers import BackTrackLineSearch, Solver

ALGOS = ["lbfgs", "conjugate_gradient", "line_gradient_descent"]


def _pair(algo, constraints=None, seed=42):
    dense = dict(n_out=10, activation="tanh")
    if constraints:
        dense["constraints"] = constraints
    conf = (JaxNNC.builder().seed(seed).updater(JaxSgd(learning_rate=0.1))
            .weight_init("xavier").list().optimization_algo(algo)
            .layer(JaxDense(**dense))
            .layer(JaxOutput(n_out=3, activation="softmax", loss="mcxent"))
            .set_input_type(JaxInputType.feed_forward(4)).build())
    jnet = JaxMLN(conf).init()
    net = MultiLayerNetwork(conf_from_jax_json(conf.to_json()), device="cpu")
    host = jax.tree_util.tree_map(np.asarray, (jnet.params, jnet.state))
    net.set_params(params_from_jax(host[0], device="cpu"), state_from_jax(host[1], "cpu"))
    return jnet, net


def _data(n=150, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] + 0.5 * x[:, 1] > 0).astype(int)
                                    + (x[:, 2] > 1).astype(int)]
    return x, y


def test_backtrack_line_search_quadratic_equals_jax():
    jls = jsolvers.BackTrackLineSearch(max_iterations=10)
    pls = BackTrackLineSearch(max_iterations=10)

    def jvalue(w):
        return jnp.sum((w - 2.0) ** 2)

    def pvalue(w):
        return torch.sum((w - 2.0) ** 2)

    for w0 in (np.zeros(3, np.float32), np.array([5.0, -1.0, 2.5], np.float32)):
        jw, pw = jnp.asarray(w0), torch.from_numpy(w0)
        jg, pg = 2.0 * (jw - 2.0), 2.0 * (pw - 2.0)
        for sign in (-1.0, 1.0):  # a descent direction, then a non-descent one
            want = jls.optimize(jvalue, jw, jvalue(jw), jg, sign * jg)
            got = pls.optimize(pvalue, pw, pvalue(pw), pg, sign * pg)
            assert got == want
    assert pls.optimize(pvalue, pw, pvalue(pw), pg, pg) == 0.0


@pytest.mark.parametrize("algo", ALGOS)
def test_scores_match_jax_solver(algo):
    x, y = _data()
    jnet, net = _pair(algo)
    js = jsolvers.Solver(algo, max_iterations=20)
    js.optimize(jnet, JaxDataSet(x, y))
    ps = Solver(algo, max_iterations=20)
    final = ps.optimize(net, DataSet(x, y))
    want, got = np.array(js.score_history), np.array(ps.score_history)
    head = 5 if algo == "lbfgs" else 10
    np.testing.assert_allclose(got[:head], want[:head], rtol=1e-5)
    assert got[-1] < got[0]
    if algo == "lbfgs":
        assert len(got) == len(want) == 20
        np.testing.assert_allclose(final, float(jnet.score()), rtol=1e-4)
        np.testing.assert_allclose(net.score_dataset(DataSet(x, y)),
                                   float(jnet.score_dataset(JaxDataSet(x, y))), rtol=1e-4)


def test_constraints_projected_as_jax():
    x, y = _data(seed=1)
    jnet, net = _pair("lbfgs", constraints=(JaxMaxNorm(max_norm=0.4),))
    js = jsolvers.Solver("lbfgs", max_iterations=6)
    js.optimize(jnet, JaxDataSet(x, y))
    ps = Solver("lbfgs", max_iterations=6)
    ps.optimize(net, DataSet(x, y))
    norms = torch.linalg.vector_norm(net.params[0]["W"], dim=0)
    assert bool((norms <= 0.4 + 1e-4).all())
    np.testing.assert_allclose(ps.score_history[:5], js.score_history[:5], rtol=1e-5)


class _Recorder(TrainingListener):
    def __init__(self):
        self.events = []

    def on_epoch_start(self, model):
        self.events.append("start")

    def on_epoch_end(self, model):
        self.events.append("end")

    def iteration_done(self, model, iteration, epoch):
        self.events.append("iter")


def test_fit_routes_through_solver_with_epoch_listeners():
    """fit runs Solver(optimization_algo), with its defaults, once a batch:
    two epochs of fit equal two optimize calls of that solver on a copy,
    bitwise, with the epoch listeners around each."""
    x, y = _data()
    _, net = _pair("line_gradient_descent")
    _, copy = _pair("line_gradient_descent")
    rec = _Recorder()
    net.set_listeners(rec)
    before = net.score_dataset(DataSet(x, y))
    net.fit(DataSet(x, y), num_epochs=2)
    assert rec.events == ["start", "iter", "end"] * 2
    assert net.iteration == 2 and net.epoch == 2
    solver = Solver("line_gradient_descent")
    for _ in range(2):
        solver.optimize(copy, DataSet(x, y))
    for got, want in zip(net.params, copy.params):
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert net.score() == copy.score() < before
    with pytest.raises(ValueError, match="SGD-family"):
        net.fit_fused([DataSet(x, y)])


def test_unknown_algo_rejected_and_json_round_trips():
    with pytest.raises(ValueError, match="Unknown solver"):
        Solver("newton")
    _, net = _pair("conjugate_gradient")
    back = MultiLayerConfiguration.from_json(net.conf.to_json())
    assert back.optimization_algo == "conjugate_gradient"
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    from deeplearning4j_tpu_torch.nn.conf.layers import OutputLayer
    from deeplearning4j_tpu_torch.nn.conf.network import NeuralNetConfiguration
    conf = (NeuralNetConfiguration.builder().list().optimization_algo("LBFGS")
            .layer(OutputLayer(n_out=3)).set_input_type(InputType.feed_forward(4)).build())
    from deeplearning4j_tpu.nn.conf.network import MultiLayerConfiguration as JaxMLC
    assert JaxMLC.from_json(conf.to_json()).optimization_algo == "lbfgs"
