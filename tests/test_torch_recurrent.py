"""The PyTorch port's recurrent family against the JAX package, on the CPU.

Layers (LSTM, GravesLSTM, Bidirectional in its four modes,
GravesBidirectionalLSTM, LastTimeStep, SimpleRnn, GRU in both forms), the
four RNN preprocessors, a 2-layer GravesLSTM network's loss and gradients,
truncated-BPTT training with RmsProp, ``rnn_time_step``, the float64
gradient check and the char-RNN zoo model. Every configuration is built by
the JAX package and carried to the port through its JSON; weights cross
with ``interop.params_from_jax``; inputs and masks come from numpy with
fixed seeds; dropout is off (JAX's threefry and torch's Philox differ).

Sizes: n_in 7, n_out 5-9, t 6-13, batch 3. Tolerances (float32): layer
outputs rtol 1e-5 / atol 1e-6 and preprocessors exact (reshapes); losses
rtol 1e-5, gradients and trained parameters atol 1e-5 (torch and XLA sum
the products in other orders, and the recurrence carries the difference
through every step).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.datasets.dataset import DataSet as JaxDataSet
from deeplearning4j_tpu.models.textgenlstm import TextGenerationLSTM as JaxTextGen
from deeplearning4j_tpu.nn.conf import InputType as JaxInputType
from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration as JaxNNC
from deeplearning4j_tpu.nn.conf import preprocessors as jpre
from deeplearning4j_tpu.nn.conf import recurrent as jrec
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JaxNet
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.interop import (conf_from_jax_json, params_from_jax,
                                              updater_state_from_jax)
from deeplearning4j_tpu_torch.models import TextGenerationLSTM
from deeplearning4j_tpu_torch.nn.conf import preprocessors as ppre
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_dict
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.utils.gradient_check import check_gradients

N_IN, BATCH = 7, 3


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _ragged_mask(t, lengths=(None, 4, 1)):
    """(BATCH, t) float32 prefix mask: full, 4 steps, 1 step."""
    m = np.zeros((BATCH, t), np.float32)
    for i, n in enumerate(lengths):
        m[i, :t if n is None else n] = 1.0
    return m


LAYERS = {
    "lstm": lambda: jrec.LSTM(n_in=N_IN, n_out=5),
    "graves_lstm": lambda: jrec.GravesLSTM(n_in=N_IN, n_out=5),
    "bidirectional_add": lambda: jrec.Bidirectional(layer=jrec.LSTM(n_in=N_IN, n_out=5),
                                                    mode="add"),
    "bidirectional_mul": lambda: jrec.Bidirectional(layer=jrec.LSTM(n_in=N_IN, n_out=5),
                                                    mode="mul"),
    "bidirectional_average": lambda: jrec.Bidirectional(
        layer=jrec.GRU(n_in=N_IN, n_out=5, reset_after=True), mode="average"),
    "bidirectional_concat": lambda: jrec.Bidirectional(
        layer=jrec.SimpleRnn(n_in=N_IN, n_out=5), mode="concat"),
    "graves_bidirectional_lstm": lambda: jrec.GravesBidirectionalLSTM(
        layer=jrec.GravesLSTM(n_in=N_IN, n_out=6)),
    "last_time_step": lambda: jrec.LastTimeStep(layer=jrec.GravesLSTM(n_in=N_IN, n_out=5)),
    "simple_rnn": lambda: jrec.SimpleRnn(n_in=N_IN, n_out=9),
    "gru": lambda: jrec.GRU(n_in=N_IN, n_out=5),
    "gru_reset_after": lambda: jrec.GRU(n_in=N_IN, n_out=5, reset_after=True),
}


def _layer_pair(name, t, seed=0):
    jl = LAYERS[name]()
    params, _ = jl.init(jax.random.key(seed), JaxInputType.recurrent(N_IN, t))
    # small random biases and peepholes, so that every parameter matters
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + (0.1 * rng.standard_normal(a.shape)).astype(np.float32),
        _host(params))
    return jl, layer_from_dict(jl.to_dict()), params


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_forward_matches_jax(name, masked):
    t = 9
    jl, pl, params = _layer_pair(name, t, seed=len(name))
    assert type(pl).__name__ == type(jl).__name__
    x = np.random.default_rng(1).standard_normal((BATCH, t, N_IN)).astype(np.float32)
    m = _ragged_mask(t) if masked else None
    want, _ = jl.apply(jax.tree_util.tree_map(jnp.asarray, params), {}, jnp.asarray(x),
                       mask=None if m is None else jnp.asarray(m))
    got, _ = pl.apply(params_from_jax([params], device="cpu")[0], {}, _t(x),
                      mask=None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert pl.regularizable() == jl.regularizable()
    assert pl.output_type(InputType.recurrent(N_IN, t)).to_dict() == \
        jl.output_type(JaxInputType.recurrent(N_IN, t)).to_dict()


@pytest.mark.parametrize("name", ["lstm", "graves_lstm", "gru_reset_after", "simple_rnn"])
def test_apply_seq_carries_continue_a_sequence(name):
    """Two halves through apply_seq with the carry handed on equal the whole
    sequence, as the JAX layer's scan gives it."""
    t = 10
    jl, pl, params = _layer_pair(name, t, seed=3)
    x = np.random.default_rng(2).standard_normal((BATCH, t, N_IN)).astype(np.float32)
    p = params_from_jax([params], device="cpu")[0]
    carry = pl.init_carry(BATCH, torch.float32, "cpu")
    a, carry = pl.apply_seq(p, carry, _t(x[:, :6]))
    b, carry = pl.apply_seq(p, carry, _t(x[:, 6:]))
    jout, jcarry = jl.apply_seq(jax.tree_util.tree_map(jnp.asarray, params),
                                jl.init_carry(BATCH), jnp.asarray(x))
    np.testing.assert_allclose(torch.cat([a, b], 1).numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    for k in jcarry:
        np.testing.assert_allclose(carry[k].numpy(), np.asarray(jcarry[k]), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("name", ["RnnToFeedForwardPreProcessor",
                                  "FeedForwardToRnnPreProcessor", "RnnToCnnPreProcessor",
                                  "CnnToRnnPreProcessor"])
def test_rnn_preprocessors_with_masks(name):
    rng = np.random.default_rng(4)
    t = 6
    m = _ragged_mask(t)
    cases = {"RnnToFeedForwardPreProcessor": ({}, (BATCH, t, N_IN), m),
             "FeedForwardToRnnPreProcessor": ({"timeseries_length": t}, (BATCH * t, N_IN),
                                              m.reshape(-1)),
             "RnnToCnnPreProcessor": ({"height": 2, "width": 3, "channels": 2},
                                      (BATCH, t, 12), m),
             "CnnToRnnPreProcessor": ({"timeseries_length": t}, (BATCH * t, 2, 3, 2),
                                      m.reshape(-1))}
    kw, shape, mask = cases[name]
    jp = getattr(jpre, name)(**kw)
    pp = ppre.preprocessor_from_dict(jpre.preprocessor_to_dict(jp))
    x = rng.standard_normal(shape).astype(np.float32)
    for msk in (mask, None):
        jx, jm = jp.apply(jnp.asarray(x), None if msk is None else jnp.asarray(msk))
        px, pm = pp.apply(_t(x), None if msk is None else _t(msk))
        np.testing.assert_array_equal(px.numpy(), np.asarray(jx))
        assert (pm is None) == (jm is None)
        if pm is not None:
            np.testing.assert_array_equal(pm.numpy(), np.asarray(jm))
    assert pp.output_type(InputType.recurrent(N_IN, t)).kind == \
        jp.output_type(JaxInputType.recurrent(N_IN, t)).kind


# ------------------------------------------------------------- networks
def _jax_conf(layers, n_out=5, updater=None, tbptt=None, l2=0.0, dtype="float32"):
    b = JaxNNC.builder().seed(11).updater(updater or jupd.Sgd(0.1)).weight_init("xavier")
    if l2:
        b = b.l2(l2)
    lb = b.dtype(dtype).list()
    for layer in layers:
        lb = lb.layer(layer)
    lb = lb.layer(jrec.RnnOutputLayer(n_out=n_out, activation="softmax", loss="mcxent"))
    lb = lb.set_input_type(JaxInputType.recurrent(N_IN))
    if tbptt:
        lb = lb.backprop_type("tbptt", tbptt, tbptt)
    return lb.build()


def _pair(jconf, device="cpu"):
    jnet = JaxNet(jconf).init()
    net = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device=device)
    net.set_params(params_from_jax(_host(jnet.params), device=device))
    return jnet, net


def _seq_batch(t, n_out=5, seed=0, masked=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, t, N_IN)).astype(np.float32)
    y = np.eye(n_out, dtype=np.float32)[rng.integers(0, n_out, (BATCH, t))]
    return x, y, (_ragged_mask(t, (None, t - 4, 2)) if masked else None)


def _assert_params_close(net, jnet, atol=1e-5):
    for p, jp in zip(net.params, _host(jnet.params)):
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
            a.detach().numpy(), b, rtol=0, atol=atol), p, jp)


GRAVES2 = lambda: [jrec.GravesLSTM(n_out=6), jrec.GravesLSTM(n_out=6)]  # noqa: E731


@pytest.mark.parametrize("masked", [False, True])
def test_graves_network_loss_and_gradients_match_jax(masked):
    jnet, net = _pair(_jax_conf(GRAVES2(), l2=1e-3))
    x, y, m = _seq_batch(8, masked=masked)
    lm = None if m is None else m[:, ::-1].copy()  # a labels mask unlike the features'
    jm = None if m is None else jnp.asarray(m)
    jlm = None if lm is None else jnp.asarray(lm)
    (jloss, _), jgrads = jax.value_and_grad(jnet._loss_fn, has_aux=True)(
        jnet.params, jnet.state, jnp.asarray(x), jnp.asarray(y), None, jm, jlm)
    loss, grads, _ = net._loss_and_grads(_t(x), _t(y), None,
                                         None if m is None else _t(m),
                                         None if lm is None else _t(lm))
    assert float(loss) == pytest.approx(float(jloss), rel=1e-5)
    for g, jg in zip(grads, _host(jgrads)):
        for k in jg:
            np.testing.assert_allclose(g[k].numpy(), jg[k], rtol=0, atol=1e-5)


@pytest.mark.parametrize("case", ["ragged_last_window", "masked_mid_window",
                                  "all_masked_window"])
def test_tbptt_fit_with_rmsprop_matches_jax(case):
    """3 windows a batch (lengths 4, 4, 3 at t = 11, or 4, 4, 4 at 12), two
    fits in a row, so RmsProp's state runs through six windows. Masks: one
    sequence ending mid-window; every sequence ending before the third
    window (a window with no unmasked step: loss 0, gradients 0)."""
    t = 11 if case == "ragged_last_window" else 12
    jnet, net = _pair(_jax_conf(GRAVES2(), updater=jupd.RmsProp(1e-2), tbptt=4))
    x, y, _ = _seq_batch(t, seed=5)
    m = {"ragged_last_window": None, "masked_mid_window": _ragged_mask(t, (None, 6, 3)),
         "all_masked_window": _ragged_mask(t, (8, 5, 2))}[case]
    for _ in range(2):
        jnet.fit(JaxDataSet(x, y, features_mask=m))
        net.fit(DataSet(x, y, features_mask=m))
    assert net.iteration == jnet.iteration == 6
    assert net.score() == pytest.approx(float(jnet.score()), rel=1e-5, abs=1e-7)
    if case == "all_masked_window":
        assert net.score() == 0.0
    _assert_params_close(net, jnet)
    for slot, jslot in zip(net.opt_state, jnet.opt_state):
        jax.tree_util.tree_map(lambda a, b: np.testing.assert_allclose(
            a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-9), slot["nu"], _host(jslot[0].nu))


def test_tbptt_fused_matches_fit_and_jax():
    """fit_tbptt_fused against the JAX package's (one scan over the windows
    there) within 1e-5 in float32, and against the port's own fit bitwise in
    float64; both refuse what the JAX package refuses."""
    jconf = _jax_conf(GRAVES2(), updater=jupd.RmsProp(1e-2), tbptt=4)
    jnet, net = _pair(jconf)
    x, y, _ = _seq_batch(12, seed=6)
    jnet.fit_tbptt_fused(x, y)
    net.fit_tbptt_fused(x, y)
    assert net.iteration == jnet.iteration == 3
    _assert_params_close(net, jnet)
    with pytest.raises(ValueError):
        net.fit_tbptt_fused(x[:, :10], y[:, :10])
    with pytest.raises(ValueError):
        net.fit_fused([DataSet(x, y)])

    conf64 = conf_from_jax_json(_jax_conf(GRAVES2(), updater=jupd.RmsProp(1e-2), tbptt=4,
                                          dtype="float64").to_json())
    nets = []
    for _ in range(2):
        n = MultiLayerNetwork(conf64, device="cpu")
        n.set_params([{k: v.double() for k, v in p.items()}
                      for p in params_from_jax(_host(jnet.params), device="cpu")])
        nets.append(n)
    nets[0].fit(DataSet(x, y))
    nets[1].fit_tbptt_fused(x, y)
    for a, b in zip(nets[0].params, nets[1].params):
        for k in a:
            assert a[k].dtype == torch.float64 and torch.equal(a[k], b[k])


def test_tbptt_carries_are_detached_between_windows():
    """The carries a window hands on hold no autograd history of the window
    before, and the next window's gradients are those from the same carries
    held as constants."""
    jconf = _jax_conf(GRAVES2(), tbptt=4)
    _, net = _pair(jconf)
    x, y, _ = _seq_batch(8, seed=7)
    carries = net._zero_carries(BATCH)
    xt, yt = _t(x), _t(y)
    carries = net._train_step(xt[:, :4], yt[:, :4], None, None, carries=carries)
    assert all(not v.requires_grad for c in carries for v in c.values())
    _, grads, _, _ = net._loss_and_grads(xt[:, 4:], yt[:, 4:], None, None, None,
                                         carries=carries)
    frozen = [{k: v.clone() for k, v in c.items()} for c in carries]
    _, grads2, _, _ = net._loss_and_grads(xt[:, 4:], yt[:, 4:], None, None, None,
                                          carries=frozen)
    for g, g2 in zip(grads, grads2):
        for k in g:
            assert torch.equal(g[k], g2[k])


def test_rnn_time_step_matches_full_sequence_and_jax():
    jnet, net = _pair(_jax_conf(GRAVES2()))
    x, _, _ = _seq_batch(6, seed=8)
    full = net.output(x)
    steps = [net.rnn_time_step(x[:, i]) for i in range(4)]
    rest = net.rnn_time_step(x[:, 4:])                     # a 2-step sequence call
    got = torch.cat([torch.stack(steps, 1), rest], 1)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-5, atol=1e-6)
    jsteps = [jnet.rnn_time_step(x[:, i]) for i in range(6)]
    np.testing.assert_allclose(got.numpy(), np.stack(jsteps, 1), rtol=1e-5, atol=1e-6)
    assert [set(c) for c in net.rnn_get_previous_state()] == [{"h", "c"}, {"h", "c"}, set()]
    with pytest.raises(ValueError):
        net.rnn_time_step(x[:2, 0])
    net.rnn_clear_previous_state()
    assert net.rnn_get_previous_state() is None
    np.testing.assert_allclose(net.rnn_time_step(x[:, 0]).numpy(), full[:, 0].numpy(),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("layer", [
    lambda: jrec.Bidirectional(layer=jrec.LSTM(n_out=4)),
    lambda: jrec.GravesBidirectionalLSTM(layer=jrec.GravesLSTM(n_out=4))])
def test_rnn_time_step_refuses_bidirectional(layer):
    jnet, net = _pair(_jax_conf([layer()]))
    x, _, _ = _seq_batch(5)
    with pytest.raises(NotImplementedError):
        jnet.rnn_time_step(x[:, 0])
    with pytest.raises(NotImplementedError):
        net.rnn_time_step(x[:, 0])


def test_bidirectional_network_trains_like_jax_and_carries_updater_state():
    """A Bidirectional GRU (reset_after: nested fwd/bwd trees holding br)
    under tBPTT, whose windows run from zero state; then RmsProp's state
    carried across with updater_state_from_jax and one more fit on both."""
    jconf = _jax_conf([jrec.Bidirectional(layer=jrec.GRU(n_out=5, reset_after=True),
                                          mode="concat")],
                      updater=jupd.RmsProp(1e-2), tbptt=4, l2=1e-3)
    jnet, net = _pair(jconf)
    x, y, m = _seq_batch(10, seed=9, masked=True)
    jnet.fit(JaxDataSet(x, y, features_mask=m))
    net.fit(DataSet(x, y, features_mask=m))
    _assert_params_close(net, jnet)
    other = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    other.set_params(params_from_jax(_host(jnet.params), device="cpu"))
    other.opt_state = [updater_state_from_jax(jnet.iteration, {"nu": _host(s[0].nu)},
                                              device="cpu") for s in jnet.opt_state]
    jnet.fit(JaxDataSet(x, y, features_mask=m))
    other.fit(DataSet(x, y, features_mask=m))
    _assert_params_close(other, jnet)


@pytest.mark.parametrize("name,kw", [("LSTM", {}), ("GravesLSTM", {}), ("GRU", {}),
                                     ("GRU", {"reset_after": True}), ("SimpleRnn", {})])
def test_gradient_check_float64(name, kw):
    layer = getattr(jrec, name)(n_out=4, **kw)
    jconf = _jax_conf([layer], n_out=3)
    _, net = _pair(jconf)
    x, y, m = _seq_batch(6, n_out=3, seed=10, masked=True)
    ds = DataSet(x, y, features_mask=m)
    # the reference's contract (GradientCheckTests): eps 1e-6, relative
    # error 1e-3 unless both gradients are under 1e-8
    assert check_gradients(net, ds, eps=1e-6, max_rel_error=1e-3, min_abs_error=1e-8,
                           print_failures=False)


def test_gradient_check_fails_on_a_planted_wrong_gradient(monkeypatch):
    """A loss whose value is untouched but whose gradient through U is
    wrong (0.01 * sum(U - U.detach()) adds 0.01 to dL/dU) must fail."""
    _, net = _pair(_jax_conf([jrec.GravesLSTM(n_out=4)], n_out=3))
    x, y, _ = _seq_batch(6, n_out=3, seed=11)
    ds = DataSet(x, y)
    assert check_gradients(net, ds, print_failures=False)
    loss_fn = net._loss_fn

    def planted(params, *a, **kw):
        loss, *rest = loss_fn(params, *a, **kw)
        U = params[0]["U"]
        return (loss + 0.01 * (U - U.detach()).sum(), *rest)

    monkeypatch.setattr(net, "_loss_fn", planted)
    assert not check_gradients(net, ds, print_failures=False)


def test_text_generation_lstm_conf_from_jax_builds_the_same_network():
    jconf = JaxTextGen().conf()
    conf = conf_from_jax_json(jconf.to_json())
    assert conf.to_json() == TextGenerationLSTM().conf().to_json()
    assert (conf.backprop_type, conf.tbptt_fwd_length) == ("tbptt", 50)
    net = MultiLayerNetwork(conf, device="cpu").init()
    jparams = _host(JaxNet(jconf).init().params)
    assert [{k: tuple(v.shape) for k, v in p.items()} for p in net.params] == \
        [{k: v.shape for k, v in p.items()} for p in jparams]
    assert net.num_params() == sum(v.size for p in jparams for v in p.values())
    assert [type(layer).__name__ for layer in net.layers] == \
        ["GravesLSTM", "GravesLSTM", "RnnOutputLayer"]


def test_text_generation_lstm_needs_a_card_unless_given_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves to it")
    with pytest.raises(RuntimeError):
        TextGenerationLSTM().init()
    with pytest.raises(RuntimeError):
        MultiLayerNetwork(TextGenerationLSTM().conf())
    assert TextGenerationLSTM(units=8).init(device="cpu").device.type == "cpu"
