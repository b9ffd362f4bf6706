"""The port's ``train_until_process`` on the CPU: the exit-code protocol of
the JAX package's supervisor (0 completes; ``ELASTIC_RESTART_EXIT`` (17)
respawns; a SIGKILL is a preemption, respawned only with
``respawn_preempted``; any other exit is a crash, respawned under the
budget), budget exhaustion, ``attempt_timeout_s``, and one worker that
trains a small MultiLayerNetwork, is killed by a real SIGKILL at step 7,
is respawned, resumes from its checkpoints and ends bitwise equal to the
uninterrupted run (``state_sha`` and the dropout generator).

Workers are ``python -c`` programs; every supervised run carries an
``attempt_timeout_s`` and an ``overall_timeout_s``, so no test can hang.
"""

import os
import sys

import pytest

from deeplearning4j_tpu_torch.checkpoint import (CheckpointManager, RestartBudgetExceeded,
                                                 RestartPolicy)
from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
from deeplearning4j_tpu_torch.checkpoint.supervisor import (ELASTIC_RESTART_EXIT,
                                                            ProcessCrashRecord,
                                                            train_until_process)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _counting(path, body):
    """A worker program that counts its own attempts in ``path``."""
    return (f"import os,sys,signal\np={path!r}\n"
            "n=int(open(p).read()) if os.path.exists(p) else 0\n"
            "open(p,'w').write(str(n+1))\n" + body)


def test_exit_code_protocol(tmp_path):
    """Three workers at once: one asks to be respawned (17) and then
    completes, one crashes (exit 3) and then completes, one is SIGKILLed
    and stays down (respawn_preempted=False)."""
    progs = [_counting(str(tmp_path / "a"), f"sys.exit(0 if n else {ELASTIC_RESTART_EXIT})"),
             _counting(str(tmp_path / "b"), "sys.exit(0 if n else 3)"),
             "import os,signal;os.kill(os.getpid(),signal.SIGKILL)"]
    s = train_until_process(lambda i, a: [sys.executable, "-c", progs[i]], num_workers=3,
                            restart_policy=RestartPolicy(max_restarts=4, backoff_s=0.0),
                            attempt_timeout_s=60, overall_timeout_s=120,
                            log_dir=str(tmp_path / "logs"))
    assert s.completed and s.restarts == 2 and s.model is None
    assert s.worker_status == {0: "completed", 1: "completed", 2: "down"}
    kinds = {c.worker: c.error_type for c in s.crashes}
    assert kinds == {0: "ElasticRestartRequired", 1: "ProcessCrash", 2: "Preempted"}
    assert all(isinstance(c, ProcessCrashRecord) for c in s.crashes)
    assert [len(s.logs[i]) for i in range(3)] == [2, 2, 1]
    assert ELASTIC_RESTART_EXIT == 17  # the JAX package's value


def test_sigkill_respawned_when_asked_and_budget_exhaustion(tmp_path):
    prog = _counting(str(tmp_path / "k"), "sys.exit(0) if n else "
                                          "os.kill(os.getpid(),signal.SIGKILL)")
    s = train_until_process([sys.executable, "-c", prog], respawn_preempted=True,
                            restart_policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                            attempt_timeout_s=60, overall_timeout_s=120,
                            log_dir=str(tmp_path / "logs"))
    assert s.completed and s.restarts == 1
    assert [(c.error_type, c.error) for c in s.crashes] == [("Preempted", "killed by SIGKILL")]
    with pytest.raises(RestartBudgetExceeded) as ei:
        train_until_process([sys.executable, "-c", "import sys; sys.exit(5)"],
                            restart_policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                            attempt_timeout_s=60, overall_timeout_s=120,
                            log_dir=str(tmp_path / "logs2"))
    summary = ei.value.summary
    assert not summary.completed and summary.restarts == 3
    assert [c.error for c in summary.crashes] == ["exit code 5"] * 3


def test_attempt_timeout_kills_and_counts_as_a_crash(tmp_path):
    with pytest.raises(RestartBudgetExceeded) as ei:
        train_until_process([sys.executable, "-c", "import time; time.sleep(60)"],
                            attempt_timeout_s=0.25, overall_timeout_s=30,
                            restart_policy=RestartPolicy(max_restarts=1, backoff_s=0.0),
                            log_dir=str(tmp_path / "logs"))
    assert [c.error_type for c in ei.value.summary.crashes] == ["AttemptTimeout"] * 2


# the network and data of the supervised run, defined once for the test and
# for its worker program
NET_SRC = """
import numpy as np
from deeplearning4j_tpu_torch.datasets import DataSet
from deeplearning4j_tpu_torch.nn.conf import InputType, NeuralNetConfiguration
from deeplearning4j_tpu_torch.nn.conf.layers import DenseLayer, OutputLayer
from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
from deeplearning4j_tpu_torch.optimize.updaters import Adam


def _net():
    conf = (NeuralNetConfiguration.builder()
            .seed(7).updater(Adam(0.01)).weight_init("xavier").list()
            .layer(DenseLayer(n_out=16, activation="tanh", dropout=0.8))
            .layer(OutputLayer(n_out=3, loss="mcxent"))
            .set_input_type(InputType.feed_forward(4))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


def _batches():
    rng = np.random.default_rng(0)
    x = rng.random((160, 4), np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 160)]
    return DataSet(x, y).split(32)
"""
exec(NET_SRC)

WORKER = """
import sys
sys.path.insert(0, {repo!r})
from deeplearning4j_tpu_torch.checkpoint import CheckpointManager, FaultInjector
from deeplearning4j_tpu_torch.checkpoint.sharded import state_sha
{net_src}
cm = CheckpointManager({ckpt!r}, save_every_n_steps=3, async_write=False, device="cpu")
net = cm.restore_latest()
if net is None:
    net = _net().set_listeners(FaultInjector(kill_at_step=7, kill_mode="process"))
net.fit(_batches(), num_epochs=2, checkpoint_manager=cm)
cm.close()
gen = net._gen.get_state().numpy().tobytes().hex()
open({out!r}, "w").write(state_sha(net) + " " + gen + " " + str(net.iteration))
"""


def test_sigkilled_worker_resumes_bitwise(tmp_path):
    """A real SIGKILL at step 7 (after the step-6 checkpoint), a respawn
    that restores step 6 and finishes: the same state as the run that was
    never killed."""
    ref = _net()  # noqa: F821 (defined by NET_SRC)
    ref.fit(_batches(), num_epochs=2)  # noqa: F821
    ckpt, out = str(tmp_path / "ckpt"), str(tmp_path / "done.txt")
    prog = WORKER.format(repo=REPO, net_src=NET_SRC, ckpt=ckpt, out=out)
    cm = CheckpointManager(ckpt, device="cpu")
    s = train_until_process([sys.executable, "-c", prog], respawn_preempted=True,
                            checkpoint_manager=cm,
                            restart_policy=RestartPolicy(max_restarts=2, backoff_s=0.0),
                            attempt_timeout_s=120, overall_timeout_s=240, cwd=REPO,
                            log_dir=str(tmp_path / "logs"))
    assert s.completed and s.restarts == 1, open(s.logs[0][-1]).read()
    (crash,) = s.crashes
    assert (crash.error_type, crash.error) == ("Preempted", "killed by SIGKILL")
    assert (crash.crashed_at_step, crash.restored_step) == (6, 6)
    sha, gen, iteration = open(out).read().split()
    assert sha == state_sha(ref)
    assert gen == ref._gen.get_state().numpy().tobytes().hex()
    assert int(iteration) == ref.iteration == 10
