"""The bn kernels' split launches: batch norm + activation over a data world
above 1, each direction two launches around one all-reduce
(``perf/kernels/bn_act.py::bn_act_fwd_split`` / ``bn_act_bwd_split``).

On the CPU the split entries take the plain versions, whose statistics and
backward sums go over the data group (``nn/data_parallel.py``). One spawn of
two gloo ranks (this file run as a script, ``python
tests/test_torch_bn_split.py cpu <rank> <port> <tmp>``) runs each case on
the rank's half of a batch, through the split entries and through the
dispatching wrappers, and the parent holds the two halves against the JAX
package's ``_bn_act_fwd_math`` / ``_fused_bn_act_bwd`` (the jnp arm) and the
port's plain versions on the whole batch: statistics within rtol 1e-5 /
atol 1e-6, out and dz within 1e-5 / 1e-6 in float32 and 1e-2 in bf16 (a
bf16 ulp or two; the halves' float32 sums run in another order), dpre the
same, the two ranks' dgamma and dbeta (each its own sums) summed within
rtol / atol 1e-5 of the whole batch's (1e-2 in bf16). In the same spawn
each rank's plain float32 partials (``bn_fwd_partials_plain``) go through
``data_parallel.sum_over_ranks`` and must come back identical on both
ranks, each rank's row its own.

``combine_rank_partials`` (the apply launch's combination of the ranks'
shifted sums) is held in one process, on 1-4 simulated ranks with unequal
row blocks and a channel offset of 1e3 times the spread, to a float64
reference of the whole batch (rtol 1e-6) and to the JAX package's
``_bn_train_stats`` (rtol 1e-5 / atol 1e-6); float32 Σz² − n·mean² misses
the float64 limit there.

The ``cuda``-marked tests (skipped without a card) hold the split kernels
at world 1 bitwise against the one launch in every dtype and both
directions, and two processes on one card over gloo against the plain
versions on the whole batch.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-5
CASES = [(96, 16, "float32", "relu", True), (96, 16, "bfloat16", "leakyrelu", False),
         (200, 130, "float32", "identity", False), (200, 130, "bfloat16", "relu", True),
         (64, 24, "float32", "leakyrelu", True)]
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
SUM_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": TOL["bfloat16"]}


def _operands(n, c, with_res, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, c)).astype(np.float32) * 2.0 + 0.5
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    res = rng.standard_normal((n, c)).astype(np.float32) if with_res else None
    dout = rng.standard_normal((n, c)).astype(np.float32)
    return z, gamma, beta, res, dout


def _tensors(arrays, dtype, device="cpu"):
    return [None if a is None else torch.from_numpy(a).to(device, getattr(torch, dtype))
            for a in arrays]


# ---------------------------------------------------------------- workers
def _run_case(bn_act, data_parallel, case, rank, world, device):
    n, c, dtype, act, with_res = case
    z, gamma, beta, res, dout = _tensors(_operands(n, c, with_res, n + c), dtype, device)
    k = n // world
    rows = slice(rank * k, (rank + 1) * k)
    z, dout = z[rows].contiguous(), dout[rows].contiguous()
    res = None if res is None else res[rows].contiguous()
    got = {}
    with data_parallel.data_group(None, world):
        for how, fwd, bwd in (("split", bn_act.bn_act_fwd_split, bn_act.bn_act_bwd_split),
                              ("wrapper", bn_act.bn_act_fwd, bn_act.bn_act_bwd)):
            out, mean, var, inv = fwd(act, EPS, z, gamma, beta, res)
            dz, dg, db, dpre = bwd(act, EPS, z, gamma, beta, res, mean, inv, dout)
            for name, t in (("out", out), ("mean", mean), ("var", var), ("inv", inv),
                            ("dz", dz), ("dg", dg), ("db", db), ("dpre", dpre)):
                if t is not None:
                    got[f"{how}_{name}"] = t.float().cpu().numpy()
    return got


def _partials_over_ranks(bn_act, data_parallel, case, rank, world, device):
    """This rank's plain float32 partials of its half of the case's z, alone
    and after the collective helper."""
    n, c, dtype, act, with_res = case
    z = _tensors(_operands(n, c, with_res, n + c)[:1], dtype, device)[0]
    k = n // world
    z = z[rank * k:(rank + 1) * k].contiguous()
    with data_parallel.data_group(None, world):
        buf = bn_act.bn_fwd_partials_plain(z, data_parallel.rank(), data_parallel.world())
        data_parallel.sum_over_ranks(buf)
    return {"partials": buf.cpu().numpy(), "own": bn_act.bn_fwd_partials_plain(z).cpu().numpy()}


def _worker(device, rank, port, tmp):
    import datetime

    import torch.distributed as dist

    from deeplearning4j_tpu_torch.nn import data_parallel
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=120))
    out = {}
    for i, case in enumerate(CASES):
        for key, v in _run_case(bn_act, data_parallel, case, rank, 2, device).items():
            out[f"{i}_{key}"] = v
        for key, v in _partials_over_ranks(bn_act, data_parallel, case, rank, 2,
                                           device).items():
            out[f"{i}_{key}"] = v
    np.savez(os.path.join(tmp, f"rank{rank}.npz"), **out)
    with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
        json.dump({"split_calls": [bn_act.fwd_split_launches, bn_act.bwd_split_launches],
                   "calls": [bn_act.fwd_launches, bn_act.bwd_launches]}, f)
    dist.barrier()
    dist.destroy_process_group()


# ------------------------------------------------------------------ parent
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(device, tmp):
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), device, str(rank),
                               str(port), str(tmp)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for rank in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("gloo workers timed out:\n" + "\n".join(o[-3000:] for o in outs))
    for rank, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{o[-4000:]}"
    return ([dict(np.load(tmp / f"rank{r}.npz")) for r in (0, 1)],
            [json.loads((tmp / f"rank{r}.json").read_text()) for r in (0, 1)])


def _hold_halves(i, case, got, want, how):
    """Rank halves (``got``) against whole-batch values (``want``, numpy)."""
    n, c, dtype, act, with_res = case
    for name in ("mean", "var", "inv"):
        for g in got:
            np.testing.assert_allclose(g[f"{i}_{how}_{name}"], want[name], rtol=1e-5,
                                       atol=1e-6, err_msg=f"{case} {how} {name}")
    names = ("out", "dz") + (("dpre",) if with_res else ())
    for name in names:
        whole = np.concatenate([g[f"{i}_{how}_{name}"] for g in got])
        np.testing.assert_allclose(whole, want[name], **TOL[dtype],
                                   err_msg=f"{case} {how} {name}")
    for name in ("dg", "db"):
        total = got[0][f"{i}_{how}_{name}"] + got[1][f"{i}_{how}_{name}"]
        np.testing.assert_allclose(total, want[name], **SUM_TOL[dtype],
                                   err_msg=f"{case} {how} {name}")


def _jax_whole(case):
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf import convolutional as jconv
    from deeplearning4j_tpu.perf import pallas as pk
    n, c, dtype, act, with_res = case
    jdt = getattr(jnp, dtype)
    jz, jg, jb, jr, jd = (None if a is None else jnp.asarray(a).astype(jdt)
                          for a in _operands(n, c, with_res, n + c))
    with pk.override(enabled=False):
        out, mean, var, inv = jconv._bn_act_fwd_math(act, EPS, jz, jg, jb, jr)
        dz, dg, db, dpre = jconv._fused_bn_act_bwd(act, EPS, (jz, jg, jb, jr, mean, inv),
                                                   (jd, None, None))
    return {k: None if v is None else np.asarray(v.astype(jnp.float32))
            for k, v in (("out", out), ("mean", mean), ("var", var), ("inv", inv),
                         ("dz", dz), ("dg", dg), ("db", db), ("dpre", dpre))}


def _plain_whole(bn_act, case, device="cpu"):
    n, c, dtype, act, with_res = case
    z, gamma, beta, res, dout = _tensors(_operands(n, c, with_res, n + c), dtype, device)
    out, mean, var, inv = bn_act.bn_act_fwd_plain(act, EPS, z, gamma, beta, res)
    dz, dg, db, dpre = bn_act.bn_act_bwd_plain(act, EPS, z, gamma, beta, res, mean, inv, dout)
    return {k: None if v is None else v.float().cpu().numpy()
            for k, v in (("out", out), ("mean", mean), ("var", var), ("inv", inv),
                         ("dz", dz), ("dg", dg), ("db", db), ("dpre", dpre))}


def test_split_plain_path_at_two_ranks_matches_the_whole_batch(tmp_path):
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    got, meta = _spawn("cpu", tmp_path)
    for i, case in enumerate(CASES):
        jax_want, plain_want = _jax_whole(case), _plain_whole(bn_act, case)
        for how in ("split", "wrapper"):
            _hold_halves(i, case, got, jax_want, how)
            _hold_halves(i, case, got, plain_want, how)
            # both ranks hold the global statistics, bit for bit
            for name in ("mean", "var", "inv"):
                np.testing.assert_array_equal(got[0][f"{i}_{how}_{name}"],
                                              got[1][f"{i}_{how}_{name}"])
        # the partials came back every rank's, identical on both ranks
        np.testing.assert_array_equal(got[0][f"{i}_partials"], got[1][f"{i}_partials"])
        for r in (0, 1):
            np.testing.assert_array_equal(got[r][f"{i}_partials"][r], got[r][f"{i}_own"][0])
        mean, var = bn_act.combine_rank_partials(torch.from_numpy(got[0][f"{i}_partials"]))
        for name, v in (("mean", mean), ("var", var)):
            np.testing.assert_allclose(v.numpy(), jax_want[name], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{case} combined {name}")
    # the CPU takes the plain versions: no launch is counted
    for m in meta:
        assert m["split_calls"] == [0, 0] and m["calls"] == [0, 0]


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_combine_rank_partials_holds_the_whole_batch(world):
    """Unequal row blocks on ``world`` simulated ranks, each channel offset
    by 1e3 times its spread, combined as the apply launch combines the
    all-reduced buffer (the zero-padded rows summed)."""
    import jax.numpy as jnp

    from deeplearning4j_tpu.nn.conf import convolutional as jconv
    from deeplearning4j_tpu_torch.perf.kernels import bn_act

    rng = np.random.default_rng(world)
    n, c = 1999, 16
    spread = rng.uniform(0.5, 2.0, c)
    z = (rng.standard_normal((n, c)) * spread + 1e3 * spread).astype(np.float32)
    cuts = np.sort(rng.choice(np.arange(1, n), world - 1, replace=False))
    parts = sum(bn_act.bn_fwd_partials_plain(torch.from_numpy(block), r, world)
                for r, block in enumerate(np.split(z, cuts)))
    mean, var = bn_act.combine_rank_partials(parts)
    zd = z.astype(np.float64)
    np.testing.assert_allclose(mean.numpy(), zd.mean(axis=0), rtol=1e-6)
    np.testing.assert_allclose(var.numpy(), zd.var(axis=0), rtol=1e-6)
    j_mean, j_var = jconv._bn_train_stats(jnp.asarray(z))
    np.testing.assert_allclose(mean.numpy(), np.asarray(j_mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(j_var), rtol=1e-5, atol=1e-6)
    # the one-pass float32 form misses the float64 limit at this offset
    zf = torch.from_numpy(z)
    m32 = zf.sum(dim=0) / n
    naive = (zf * zf).sum(dim=0) / n - m32 * m32
    assert not np.allclose(naive.numpy(), zd.var(axis=0), rtol=1e-6)


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the split bn kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1001, 130), (4096, 64), (25088, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("act,with_res", [("relu", True), ("identity", False),
                                          ("leakyrelu", True)])
def test_split_kernels_match_the_one_launch_at_world_1(cuda_device, shape, dtype, act,
                                                       with_res):
    from deeplearning4j_tpu_torch.perf.kernels import bn_act
    n, c = shape
    z, gamma, beta, res, dout = _tensors(_operands(n, c, with_res, 7), dtype, cuda_device)
    one = bn_act.bn_act_fwd(act, EPS, z, gamma, beta, res)
    calls = bn_act.fwd_split_launches, bn_act.bwd_split_launches
    spl = bn_act.bn_act_fwd_split(act, EPS, z, gamma, beta, res)
    bone = bn_act.bn_act_bwd(act, EPS, z, gamma, beta, res, one[1], one[3], dout)
    bspl = bn_act.bn_act_bwd_split(act, EPS, z, gamma, beta, res, one[1], one[3], dout)
    torch.cuda.synchronize()
    assert (bn_act.fwd_split_launches, bn_act.bwd_split_launches) == (calls[0] + 1,
                                                                      calls[1] + 1)
    for a, b in zip(one, spl):
        assert torch.equal(a, b)
    for a, b in zip(bone, bspl):
        assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.cuda
def test_two_processes_on_one_card_match_the_whole_batch(cuda_device, tmp_path):
    from deeplearning4j_tpu_torch.perf.kernels import _build, bn_act
    _build.build(["bn_act_fwd", "bn_act_bwd"])
    got, meta = _spawn("cuda", tmp_path)
    for i, case in enumerate(CASES):
        want = _plain_whole(bn_act, case, cuda_device)
        for how in ("split", "wrapper"):
            _hold_halves(i, case, got, want, how)
    # a split call a case and direction, through each entry point
    for m in meta:
        assert m["split_calls"] == [2 * len(CASES)] * 2
        assert m["calls"] == [2 * len(CASES)] * 2


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
