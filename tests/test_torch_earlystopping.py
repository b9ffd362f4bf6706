"""The port's early stopping on the CPU against the JAX package's: an
``EarlyStoppingTrainer`` over a small MLP whose weights and data come from
the JAX package's network and numpy seeds. Every termination condition
and every saver (in memory, local zip files, a ``CheckpointManager``) ends
with the JAX trainer's number of epochs, termination reason and details,
and best epoch; scores within the training slice's step tolerance (rtol
1e-5: torch and XLA round the matrix products differently). The best model
each saver hands back scores its recorded best score.

Inputs come from numpy with fixed seeds.
"""

import math

import numpy as np
import pytest
import torch

import deeplearning4j_tpu.earlystopping as jes
import deeplearning4j_tpu_torch.earlystopping as pes
from deeplearning4j_tpu.checkpoint import CheckpointManager as JCM
from deeplearning4j_tpu.datasets import DataSet as JDataSet
from deeplearning4j_tpu.earlystopping.conditions import BestScoreEpochTerminationCondition as JBest
from deeplearning4j_tpu.nn.conf import InputType as JInputType
from deeplearning4j_tpu.nn.conf.layers import DenseLayer as JDense
from deeplearning4j_tpu.nn.conf.layers import OutputLayer as JOutput
from deeplearning4j_tpu.nn.conf.network import Builder as JBuilder
from deeplearning4j_tpu.nn.multilayer import MultiLayerNetwork as JMLN
from deeplearning4j_tpu.optimize import updaters as jupd

from deeplearning4j_tpu_torch.checkpoint import CheckpointManager as PCM
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.earlystopping.conditions import (
    BestScoreEpochTerminationCondition as PBest)
from deeplearning4j_tpu_torch.interop import conf_from_jax_json, params_from_jax
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork


def _pair(lr):
    jconf = (JBuilder().seed(21).updater(jupd.Sgd(learning_rate=lr)).weight_init("xavier")
             .list().layer(JDense(n_out=8, activation="tanh"))
             .layer(JOutput(n_out=3, activation="softmax", loss="mcxent"))
             .set_input_type(JInputType.feed_forward(4)).build())
    jnet = JMLN(jconf).init()
    pnet = MultiLayerNetwork(conf_from_jax_json(jconf.to_json()), device="cpu")
    pnet.set_params(params_from_jax([{k: np.asarray(v) for k, v in p.items()}
                                     for p in jnet.params], device="cpu"))
    return jnet, pnet


def _data(seed, n=40, nan=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] > 0).astype(int) + (x[:, 1] > 0.5)]
    if nan:
        x[12:] = np.nan
    return x, y


# case -> (learning rate, conditions(m), iteration conditions(m), config kw)
CASES = {
    "max_epochs": (0.1, lambda m, b: [m.MaxEpochsTerminationCondition(3)], lambda m: [], {}),
    "score_improvement": (
        4.0, lambda m, b: [m.ScoreImprovementEpochTerminationCondition(1, 1e-3),
                           m.MaxEpochsTerminationCondition(12)], lambda m: [], {}),
    "best_score": (0.5, lambda m, b: [b(0.9), m.MaxEpochsTerminationCondition(12)],
                   lambda m: [], {}),
    "max_score_iteration": (0.1, lambda m, b: [m.MaxEpochsTerminationCondition(5)],
                            lambda m: [m.MaxScoreIterationTerminationCondition(0.5)], {}),
    "invalid_score_iteration": (0.1, lambda m, b: [m.MaxEpochsTerminationCondition(5)],
                                lambda m: [m.InvalidScoreIterationTerminationCondition()],
                                {}),
    "max_time_iteration": (0.1, lambda m, b: [m.MaxEpochsTerminationCondition(5)],
                           lambda m: [m.MaxTimeIterationTerminationCondition(-1.0)], {}),
    "evaluate_every_2": (0.2, lambda m, b: [m.MaxEpochsTerminationCondition(5),
                                            m.ScoreImprovementEpochTerminationCondition(2)],
                         lambda m: [], dict(evaluate_every_n_epochs=2, save_last_model=True)),
}


def _run(m, net, case, saver, tmp, best):
    lr, epoch_conds, iter_conds, kw = CASES[case]
    cm = None
    conf = m.EarlyStoppingConfiguration(epoch_conds(m, best), iter_conds(m), **kw)
    if saver == "local_file":
        conf.model_saver = m.LocalFileModelSaver(str(tmp))
    elif saver == "checkpoint_manager":
        cm = (JCM(str(tmp)) if m is jes else PCM(str(tmp), device="cpu"))
    nan = case == "invalid_score_iteration"
    pkg_ds = JDataSet if m is jes else DataSet
    train = pkg_ds(*_data(1, nan=nan)).split(10)
    val = pkg_ds(*_data(2)).split(20)
    trainer = m.EarlyStoppingTrainer(conf, net, train, val, checkpoint_manager=cm)
    result = trainer.fit()
    if cm is not None:
        cm.close()
    return result, val


@pytest.mark.parametrize("saver", ["in_memory", "local_file", "checkpoint_manager"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_early_stopping_matches_jax(case, saver, tmp_path):
    jnet, pnet = _pair(CASES[case][0])
    jres, jval = _run(jes, jnet, case, saver, tmp_path / "j", JBest)
    pres, pval = _run(pes, pnet, case, saver, tmp_path / "p", PBest)
    assert (pres.termination_reason, pres.termination_details, pres.total_epochs,
            pres.best_model_epoch) == (jres.termination_reason, jres.termination_details,
                                       jres.total_epochs, jres.best_model_epoch)
    assert sorted(pres.score_vs_epoch) == sorted(jres.score_vs_epoch)
    for e, s in jres.score_vs_epoch.items():
        assert pres.score_vs_epoch[e] == pytest.approx(s, rel=1e-5)
    if jres.best_model_epoch < 0:
        assert math.isinf(pres.best_model_score)
        return
    assert pres.best_model_score == pytest.approx(jres.best_model_score, rel=1e-5)
    best = pres.best_model
    assert best is not None and best is not pnet
    score = sum(best.score_dataset(d) * d.num_examples() for d in pval) / 40
    # zips and checkpoints hold float32 parameters exactly: the same score
    assert score == pytest.approx(pres.best_model_score, rel=1e-6)


def test_in_memory_saver_keeps_a_copy_not_a_reference():
    """The port updates parameters in place: the saved best model must not
    follow later steps."""
    _, pnet = _pair(0.5)
    saver = pes.InMemoryModelSaver()
    saver.save_best_model(pnet, 1.0)
    before = [p["W"].clone() for p in pnet.params]
    pnet.fit(DataSet(*_data(3)))
    best = saver.get_best_model(pnet)
    assert all(np.array_equal(b.numpy(), p["W"].numpy()) for b, p in zip(before, best.params))
    assert not np.array_equal(before[0].numpy(), pnet.params[0]["W"].numpy())


def test_trainer_stages_training_batches_on_the_model_device():
    """The trainer hands fit tensors on the model's device (its prefetch),
    reads no step's score when no iteration condition needs it (a host
    read would wait for each step), and the scores equal a plain loop of
    fit over the host batches."""
    _, pnet = _pair(0.3)
    _, ref = _pair(0.3)
    seen, scores_read = [], []
    fit, score = pnet.fit, pnet.score

    def spy(ds, *a, **kw):
        seen.append(ds.features)
        return fit(ds, *a, **kw)

    def score_spy(*a, **kw):
        scores_read.append(1)
        return score(*a, **kw)

    pnet.fit, pnet.score = spy, score_spy
    train, val = DataSet(*_data(1)).split(10), DataSet(*_data(2)).split(20)
    conf = pes.EarlyStoppingConfiguration([pes.MaxEpochsTerminationCondition(2)])
    res = pes.EarlyStoppingTrainer(conf, pnet, train, val).fit()
    assert len(seen) == 8 and all(isinstance(t, torch.Tensor) and t.device == pnet.device
                                  for t in seen)
    assert not scores_read
    for epoch in range(2):
        for ds in train:
            ref.fit(ds)
        score = sum(ref.score_dataset(d) * d.num_examples() for d in val) / 40
        assert res.score_vs_epoch[epoch] == score
