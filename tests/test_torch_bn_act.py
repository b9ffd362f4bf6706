"""bn_act_fwd / bn_act_bwd of the PyTorch port against the JAX package.

On the CPU the port's wrappers take their plain versions; the JAX side runs
``_bn_act_fwd_math`` / ``_fused_bn_act_bwd`` through both arms, its jnp
reference (``perf.pallas.override(enabled=False)``) and its Pallas kernels
in interpret mode (``enabled=True``), as tests/test_zz_pallas.py does.
Inputs come from numpy with fixed seeds. A few channels hold symmetric
small integers with beta = 0, so their mean is exactly 0 and the
pre-activation is exactly 0 wherever z is: the activations' derivatives at
the kink are taken there (relu' = 0, leakyrelu' = 1, as in JAX).

Tolerances: float32 rtol 1e-5 / atol 1e-6 (the two frameworks sum the
batch statistics in other orders); bfloat16 rtol 1e-2 / atol 1e-2 (XLA on
the CPU may keep excess precision between the bf16 multiply and add of the
normalisation, where PyTorch rounds each step to bf16: one bf16 ulp is
2**-8 relative). The kernels themselves run only on a CUDA card: those
tests carry the ``cuda`` marker and skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.perf import pallas as pk

from deeplearning4j_tpu_torch.nn.conf.convolutional import fused_bn_act_train
from deeplearning4j_tpu_torch.perf.kernels import bn_act

EPS = 1e-5
KINK_CHANNELS = 3
TOL = {"float32": dict(rtol=1e-5, atol=1e-6), "bfloat16": dict(rtol=1e-2, atol=1e-2)}
# dgamma/dbeta sum up to 200 terms of order 1 with cancellation: float32
# sums in other orders differ by a few 1e-6 absolute
SUM_TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": TOL["bfloat16"]}


def _operands(n, c, dtype, with_res, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, c)).astype(np.float32) * 2.0 + 0.5
    half = rng.integers(-2, 3, (n // 2, KINK_CHANNELS)).astype(np.float32)
    half[:3] = 0.0
    z[:2 * (n // 2), :KINK_CHANNELS] = np.concatenate([half, -half])
    z[2 * (n // 2):, :KINK_CHANNELS] = 0.0
    gamma = rng.standard_normal(c).astype(np.float32)
    beta = rng.standard_normal(c).astype(np.float32)
    beta[:KINK_CHANNELS] = 0.0
    res = None
    if with_res:
        res = rng.standard_normal((n, c)).astype(np.float32)
        res[:, :KINK_CHANNELS] = np.where(z[:, :KINK_CHANNELS] == 0, 0.0,
                                          res[:, :KINK_CHANNELS])
    dout = rng.standard_normal((n, c)).astype(np.float32)
    return z, gamma, beta, res, dout


def _jax(x, dtype):
    return None if x is None else jnp.asarray(x).astype(dtype)


def _torch(x, dtype):
    return None if x is None else torch.from_numpy(x).to(dtype)


def _close(got, want, dtype, what, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **tol[dtype], err_msg=what)


@pytest.mark.parametrize("shape", [(96, 16), (200, 130)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act,with_res", [("relu", True), ("relu", False),
                                          ("identity", True), ("leakyrelu", False),
                                          ("leakyrelu", True)])
def test_plain_matches_jax_both_arms(shape, dtype, act, with_res):
    n, c = shape
    z, gamma, beta, res, dout = _operands(n, c, dtype, with_res, seed=n + c)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tz, tg, tb, tr, td = (_torch(a, tdt) for a in (z, gamma, beta, res, dout))
    out, mean, var, inv = bn_act.bn_act_fwd(act, EPS, tz, tg, tb, tr)
    dz, dgamma, dbeta, dpre = bn_act.bn_act_bwd(act, EPS, tz, tg, tb, tr, mean, inv, td)
    # the kink: pre is exactly 0 where the symmetric channels hold 0
    assert bool((mean[:KINK_CHANNELS] == 0).all())
    assert bool((tz[:, :KINK_CHANNELS] == 0).any())
    assert mean.dtype == torch.float32 and dgamma.dtype == torch.float32
    assert out.dtype == tdt and dz.dtype == tdt
    assert (dpre is None) == (res is None)
    jz, jg, jb, jr, jd = (_jax(a, jdt) for a in (z, gamma, beta, res, dout))
    for flag in (False, True):
        with pk.override(enabled=flag):
            jout, jmean, jvar, jinv = jconv._bn_act_fwd_math(act, EPS, jz, jg, jb, jr)
            jdz, jdg, jdb, jdres = jconv._fused_bn_act_bwd(
                act, EPS, (jz, jg, jb, jr, jmean, jinv), (jd, None, None))
        arm = f"pallas={flag}"
        _close(out, jout, dtype, f"out {arm}")
        for got, want, what in ((mean, jmean, "mean"), (var, jvar, "var"),
                                (inv, jinv, "inv")):
            # float32 statistics in both dtypes
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                       atol=1e-6, err_msg=f"{what} {arm}")
        _close(dz, jdz, dtype, f"dz {arm}")
        _close(dgamma.to(tdt), jdg, dtype, f"dgamma {arm}", SUM_TOL)
        _close(dbeta.to(tdt), jdb, dtype, f"dbeta {arm}", SUM_TOL)
        if res is not None:
            _close(dpre, jdres, dtype, f"dres {arm}")


def test_kink_derivatives_are_jax_s():
    """relu has derivative 0 at 0, leakyrelu 1 (the where(x >= 0, ...) form)."""
    pre = torch.tensor([-1.0, 0.0, -0.0, 2.0])
    dout = torch.ones(4)
    assert bn_act._act_vjp("relu", pre, dout).tolist() == [0.0, 0.0, 0.0, 1.0]
    np.testing.assert_allclose(bn_act._act_vjp("leakyrelu", pre, dout).numpy(),
                               [0.01, 1.0, 1.0, 1.0], rtol=1e-7)


@pytest.mark.parametrize("act", ["relu", "identity", "leakyrelu", "tanh"])
@pytest.mark.parametrize("with_res", [False, True])
def test_gradcheck_fused_bn_act_train_float64(act, with_res):
    rng = np.random.default_rng(3)
    shape = (2, 3, 4, 5)
    args = [torch.tensor(rng.standard_normal(shape) * 1.5 + 0.3, requires_grad=True),
            torch.tensor(rng.standard_normal(5), requires_grad=True),
            torch.tensor(rng.standard_normal(5), requires_grad=True)]
    if with_res:
        args.append(torch.tensor(rng.standard_normal(shape), requires_grad=True))

    def f(z, gamma, beta, res=None):
        return fused_bn_act_train(act, EPS, z, gamma, beta, res)[0]

    assert torch.autograd.gradcheck(f, tuple(args), eps=1e-6, atol=1e-6)


def test_wrappers_check_their_operands():
    z = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="gamma"):
        bn_act.bn_act_fwd("relu", EPS, z, torch.ones(2), torch.zeros(3))
    with pytest.raises(ValueError, match="res"):
        bn_act.bn_act_fwd("relu", EPS, z, torch.ones(3), torch.zeros(3),
                          torch.zeros(4, 3, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="dout"):
        bn_act.bn_act_bwd("relu", EPS, z, torch.ones(3), torch.zeros(3), None,
                          torch.zeros(3), torch.ones(3), torch.zeros(3, 4))


@pytest.mark.parametrize("c,dtype,offsets,want", [
    (64, torch.bfloat16, (0, 0, 0), 8), (64, torch.float32, (0, 0, 0), 4),
    (2048, torch.float16, (0, 0, 0), 8), (130, torch.float32, (0, 0, 0), 1),
    (64, torch.bfloat16, (1, 0, 0), 1), (64, torch.bfloat16, (0, 8, 0), 8),
    (64, torch.bfloat16, (0, 3, 0), 1), (64, torch.float32, (0, 0, 2), 1)])
def test_vec_of_operands_takes_scalars_for_offset_views_and_ragged_rows(c, dtype, offsets,
                                                                       want):
    """Both wrappers pick the kernels' vector width from the operands they
    hand over (z, res, the output; offsets in elements into a fresh
    allocation): 16-byte vectors need whole 16-byte rows and every operand
    16-byte aligned; an absent residual does not count."""
    def view(offset, n=5):
        return torch.empty(n * c + offset, dtype=dtype)[offset:].view(n, c)

    z, res, out = (view(o) for o in offsets)
    assert bn_act._vec(z, res, out) == want
    assert c % want == 0
    z_aligned = offsets[0] * z.element_size() % 16 == 0
    assert bn_act._vec(z, None) == bn_act.vec_width(c, z.element_size(), z_aligned)


@pytest.mark.parametrize("c,esize,aligned,want", [
    (1, 4, True, 1), (130, 4, True, 1), (130, 2, True, 1), (64, 2, True, 8), (64, 4, True, 4),
    (64, 2, False, 1), (2048, 2, True, 8), (4096, 4, True, 4), (24, 2, True, 8),
    (8, 2, True, 8), (8, 4, False, 1)])
def test_bwd_vec_moves_16_bytes_where_rows_and_operands_allow(c, esize, aligned, want):
    """Both kernels' threads move 16-byte vectors of channels where every
    row starts 16-byte aligned, else single channels; the kernels plan their
    grids themselves (csrc/bn_act_common.cuh, plan_grid)."""
    vec = bn_act.vec_width(c, esize, aligned)
    assert vec == want and c % vec == 0
    assert vec == 1 or vec * esize == 16


# ------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the bn_act kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1001, 130), (4096, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("act,with_res", [("relu", True), ("identity", False),
                                          ("leakyrelu", True)])
def test_kernels_match_plain_on_card(cuda_device, shape, dtype, act, with_res):
    n, c = shape
    z, gamma, beta, res, dout = _operands(n, c, str(dtype), with_res, seed=7)
    tz, tg, tb, tr, td = (None if a is None else torch.from_numpy(a).to(cuda_device, dtype)
                          for a in (z, gamma, beta, res, dout))
    f0, b0 = bn_act.fwd_launches, bn_act.bwd_launches
    out, mean, var, inv = bn_act.bn_act_fwd(act, EPS, tz, tg, tb, tr)
    dz, dg, db, dpre = bn_act.bn_act_bwd(act, EPS, tz, tg, tb, tr, mean, inv, td)
    torch.cuda.synchronize()
    assert (bn_act.fwd_launches, bn_act.bwd_launches) == (f0 + 1, b0 + 1)
    pout, pmean, pvar, pinv = bn_act.bn_act_fwd_plain(act, EPS, tz, tg, tb, tr)
    for got, want in ((mean, pmean), (var, pvar), (inv, pinv)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    # at the kernel's own statistics the elementwise phase is the plain math
    scale = tg.float() * inv
    shift = tb.float() - mean * scale
    assert torch.equal(out, bn_act.bn_act_apply_plain(act, tz, scale, shift, tr))
    pdz, pdg, pdb, pdpre = bn_act.bn_act_bwd_plain(act, EPS, tz, tg, tb, tr, mean,
                                                   inv, td)
    if with_res:
        assert torch.equal(dpre, pdpre)
    torch.testing.assert_close(dg, pdg, rtol=1e-4, atol=1e-4 * float(pdg.abs().max()))
    torch.testing.assert_close(db, pdb, rtol=1e-4, atol=1e-4 * float(pdb.abs().max()))
    tol = 1e-4 if dtype == torch.float32 else 2e-2  # a few ulps of bf16 / f16
    torch.testing.assert_close(dz.float(), pdz.float(), rtol=tol,
                               atol=tol * float(pdz.float().abs().max()))
    # the reductions run in a fixed order: a second run agrees bitwise
    again = bn_act.bn_act_fwd(act, EPS, tz, tg, tb, tr)
    for a, b in zip((out, mean, var, inv), again):
        assert torch.equal(a, b)
    again = bn_act.bn_act_bwd(act, EPS, tz, tg, tb, tr, mean, inv, td)
    for a, b in zip((dz, dg, db), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_other_activation_raises_on_card(cuda_device):
    z = torch.zeros(8, 4, device=cuda_device)
    g, b = torch.ones(4, device=cuda_device), torch.zeros(4, device=cuda_device)
    with pytest.raises(NotImplementedError, match="tanh"):
        bn_act.bn_act_fwd("tanh", EPS, z, g, b)


@pytest.mark.cuda
def test_bwd_kernel_plans_its_grid_and_refuses_short_scratch(cuda_device):
    import ctypes
    n, c = 4096, 64
    z, gamma, beta, res, dout = _operands(n, c, "bfloat16", False, seed=3)
    tz, tg, tb, td = (torch.from_numpy(a).to(cuda_device, torch.bfloat16)
                      for a in (z, gamma, beta, dout))
    _, mean, _, inv = bn_act.bn_act_fwd("relu", EPS, tz, tg, tb)
    query = bn_act._kernel("bn_act_bwd", bn_act._SCRATCH_ARGS, "scratch", ctypes.c_longlong)
    need = query(1, 1, 0, n, c, 8)
    # partials of at least one row block, and the four per-channel rows
    assert need >= 2 * c + 4 * c and (need - 4 * c) % (2 * c) == 0
    assert query(1, 1, 0, n, c, 3) < 0  # no such vector width
    short = torch.empty(need - 1, dtype=torch.float32, device=cuda_device)
    out = [torch.empty_like(tz), torch.empty(c, device=cuda_device),
           torch.empty(c, device=cuda_device)]
    err = bn_act._kernel("bn_act_bwd", bn_act._BWD_ARGS)(
        1, 1, tz.data_ptr(), tg.data_ptr(), tb.data_ptr(), None, mean.data_ptr(),
        inv.data_ptr(), td.data_ptr(), n, c, out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr(), None, short.data_ptr(), need - 1, 8,
        torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,dtype,offset", [
    (1, 1, "float32", 0), (7, 130, "float32", 0), (1001, 130, "bfloat16", 0),
    (2000, 64, "bfloat16", 0), (2000, 64, "float32", 0), (2000, 64, "bfloat16", 1),
    (300, 2048, "bfloat16", 0), (40, 4096, "float32", 0), (97, 24, "bfloat16", 0),
    (5, 8, "bfloat16", 0), (333, 8, "float32", 1)])
def test_bwd_kernel_grid_covers_every_row_and_channel_once(cuda_device, n, c, dtype, offset):
    """The grid the kernel plans for itself: with the identity, a residual
    and dout = 1, dbeta counts the rows pass 1 read (exact in float32) and
    dpre = 1 where it wrote; dz and dpre start as NaN, so a (row, channel)
    a pass skipped stays NaN. offset 1 starts every operand one element
    past an aligned base (the scalar path)."""
    import ctypes
    dt = getattr(torch, dtype)

    def operand(fill):
        flat = torch.full((n * c + offset,), fill, dtype=dt, device=cuda_device)
        return flat[offset:].view(n, c)

    gen = torch.Generator().manual_seed(n * 7 + c)
    z, res, dout = operand(0.0), operand(0.0), operand(1.0)
    z.copy_(torch.randn(n, c, generator=gen))
    res.copy_(torch.randn(n, c, generator=gen))
    dz, dpre = operand(float("nan")), operand(float("nan"))
    gamma, beta = torch.ones(c, dtype=dt, device=cuda_device), torch.zeros(c, dtype=dt,
                                                                             device=cuda_device)
    mean, inv = torch.zeros(c, device=cuda_device), torch.ones(c, device=cuda_device)
    dg, db = torch.empty(c, device=cuda_device), torch.empty(c, device=cuda_device)
    vec = bn_act.vec_width(c, dz.element_size(), offset == 0)
    code, act = bn_act._DTYPES[dt], bn_act.KERNEL_ACTS["identity"]
    need = bn_act._kernel("bn_act_bwd", bn_act._SCRATCH_ARGS, "scratch",
                          ctypes.c_longlong)(code, act, 1, n, c, vec)
    assert need > 0
    scratch = torch.empty(need, device=cuda_device)
    err = bn_act._kernel("bn_act_bwd", bn_act._BWD_ARGS)(
        code, act, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(), res.data_ptr(),
        mean.data_ptr(), inv.data_ptr(), dout.data_ptr(), n, c, dz.data_ptr(), dg.data_ptr(),
        db.data_ptr(), dpre.data_ptr(), scratch.data_ptr(), need, vec,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(db, torch.full((c,), float(n), device=cuda_device))
    assert torch.equal(dpre, torch.ones_like(dpre))
    assert not bool(dz.isnan().any())


def _ulp(x, dtype):
    """One ulp of ``dtype`` at |x| (a power of two), at least the smallest
    normal's."""
    fi = torch.finfo(dtype)
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(fi.tiny)))) * fi.eps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,with_res", [("relu", True), ("identity", False)])
@pytest.mark.parametrize("n,c,offset", [(20000, 64, 0), (5000, 256, 0), (700, 2048, 0),
                                        (1001, 130, 0), (3001, 64, 1)])
def test_bwd_kernel_vector_and_scalar_paths(cuda_device, n, c, offset, dtype, act, with_res):
    """C = 64, 256, 2048 take 16-byte vectors; C = 130 and a view that
    starts one element past an aligned base take the scalar path."""
    z, gamma, beta, res, dout = _operands(n, c, str(dtype), with_res, seed=c + offset)

    def on_card(a):
        if a is None:
            return None
        flat = torch.empty(a.size + offset, dtype=dtype, device=cuda_device)
        view = flat[offset:].view(a.shape)  # offset 1: not 16-byte aligned
        view.copy_(torch.from_numpy(a))
        return view

    tz, tr, td = on_card(z), on_card(res), on_card(dout)
    tg, tb = (torch.from_numpy(a).to(cuda_device, dtype) for a in (gamma, beta))
    vec = bn_act.vec_width(c, tz.element_size(), offset == 0)
    assert (vec > 1) == (offset == 0 and c != 130)
    _, mean, _, inv = bn_act.bn_act_fwd(act, EPS, tz, tg, tb, tr)
    b0 = bn_act.bwd_launches
    got = bn_act.bn_act_bwd(act, EPS, tz, tg, tb, tr, mean, inv, td)
    again = bn_act.bn_act_bwd(act, EPS, tz, tg, tb, tr, mean, inv, td)
    dz, dg, db, dpre = got
    pdz, pdg, pdb, pdpre = bn_act.bn_act_bwd_plain(act, EPS, tz, tg, tb, tr, mean, inv, td)
    torch.cuda.synchronize()
    assert bn_act.bwd_launches == b0 + 2
    if with_res:
        assert torch.equal(dpre, pdpre)
    for got_s, want_s in ((dg, pdg), (db, pdb)):
        torch.testing.assert_close(got_s, want_s, rtol=1e-4,
                                   atol=1e-6 * float(want_s.abs().max()))
    floor = 1e-5 * float(pdz.float().abs().max())
    err = (dz.float() - pdz.float()).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-4 * pdz.abs() + floor).all())
    else:
        mag = torch.maximum(dz.float().abs(), pdz.float().abs())
        assert bool((err <= 2 * _ulp(mag, dtype) + floor).all())
    for a, b in zip(got, again):
        assert (a is None and b is None) or torch.equal(a, b)


def _fwd_launch(cuda_device, z, gamma, beta, res, out, act="identity", scratch_floats=None):
    """bn_act_fwd's C entry on given operands (out preallocated): (err,
    mean, var, inv)."""
    import ctypes
    c = z.shape[-1]
    n = z.numel() // c
    vec = bn_act._vec(z, res, out)
    code, act_code = bn_act._DTYPES[z.dtype], bn_act.KERNEL_ACTS[act]
    need = bn_act._kernel("bn_act_fwd", bn_act._SCRATCH_ARGS, "scratch", ctypes.c_longlong)(
        code, act_code, int(res is not None), n, c, vec)
    assert need > 0
    scratch = torch.empty(need if scratch_floats is None else scratch_floats,
                          device=cuda_device)
    mean, var, inv = torch.empty((3, c), device=cuda_device)
    err = bn_act._kernel("bn_act_fwd", bn_act._FWD_ARGS)(
        code, act_code, z.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        None if res is None else res.data_ptr(), n, c, EPS, out.data_ptr(), mean.data_ptr(),
        var.data_ptr(), inv.data_ptr(), scratch.data_ptr(), scratch.numel(), vec,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    return err, mean, var, inv


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("act,with_res", [("relu", True), ("identity", False)])
@pytest.mark.parametrize("n,c,offset", [(20000, 64, 0), (5000, 256, 0), (700, 2048, 0),
                                        (1001, 130, 0), (3001, 64, 1)])
def test_fwd_kernel_vector_and_scalar_paths(cuda_device, n, c, offset, dtype, act, with_res):
    """C = 64, 256, 2048 take 16-byte vectors; C = 130 and a view that
    starts one element past an aligned base take the scalar path. Stats
    within rtol 1e-5 / atol 1e-6 of the plain version, out bitwise the
    plain elementwise math at the kernel's own stats and within the plain
    version's limits (float32 rtol 1e-5 / atol 1e-6, else 2 ulps of the
    largest addend), two runs bitwise equal."""
    z, gamma, beta, res, _ = _operands(n, c, str(dtype), with_res, seed=c + offset)

    def on_card(a):
        if a is None:
            return None
        flat = torch.empty(a.size + offset, dtype=dtype, device=cuda_device)
        view = flat[offset:].view(a.shape)  # offset 1: not 16-byte aligned
        view.copy_(torch.from_numpy(a))
        return view

    tz, tr = on_card(z), on_card(res)
    tg, tb = (torch.from_numpy(a).to(cuda_device, dtype) for a in (gamma, beta))
    assert (bn_act._vec(tz, tr) > 1) == (offset == 0 and c != 130)
    f0 = bn_act.fwd_launches
    out, mean, var, inv = bn_act.bn_act_fwd(act, EPS, tz, tg, tb, tr)
    again = bn_act.bn_act_fwd(act, EPS, tz, tg, tb, tr)
    pout, pmean, pvar, pinv = bn_act.bn_act_fwd_plain(act, EPS, tz, tg, tb, tr)
    torch.cuda.synchronize()
    assert bn_act.fwd_launches == f0 + 2
    for got, want in ((mean, pmean), (var, pvar), (inv, pinv)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    scale = tg.float() * inv
    shift = tb.float() - mean * scale
    assert torch.equal(out, bn_act.bn_act_apply_plain(act, tz, scale, shift, tr))
    err = (out.float() - pout.float()).abs()
    if dtype == torch.float32:
        assert bool((err <= 1e-5 * pout.abs() + 1e-6).all())
    else:
        mag = torch.maximum((tz.float() * (tg.float() * pinv).to(dtype).float()).abs(),
                            (tb.float() - pmean * tg.float() * pinv).to(dtype).float().abs())
        if tr is not None:
            mag = torch.maximum(mag, tr.float().abs())
        mag = torch.maximum(mag, pout.float().abs())
        assert bool((err <= 2 * _ulp(mag, dtype)).all())
    for a, b in zip((out, mean, var, inv), again):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,dtype,offset", [
    (1, 1, "float32", 0), (7, 130, "float32", 0), (1001, 130, "bfloat16", 0),
    (100003, 64, "bfloat16", 0), (100003, 64, "float32", 0), (2000, 64, "bfloat16", 1),
    (300, 2048, "bfloat16", 0), (40, 4096, "float32", 0), (97, 24, "bfloat16", 0),
    (5, 8, "bfloat16", 0), (333, 8, "float32", 1)])
def test_fwd_kernel_grid_covers_every_row_and_channel_once(cuda_device, n, c, dtype, offset):
    """The grid the kernel plans for itself: small-integer z makes every
    float32 sum exact, so the mean is the correctly rounded S / n and the
    variance the exact one (float32: in double) exactly when pass 1 read
    every row once; out starts as NaN, so a (row, channel) pass 3 skipped
    stays NaN. offset 1 starts every operand one element past an aligned
    base (the scalar path)."""
    dt = getattr(torch, dtype)

    def operand(fill):
        flat = torch.full((n * c + offset,), fill, dtype=dt, device=cuda_device)
        return flat[offset:].view(n, c)

    rows = torch.arange(n, dtype=torch.float64)[:, None]
    zd = (rows * 3 + torch.arange(c, dtype=torch.float64)) % 9 - 4  # integers in [-4, 4]
    z, res, out = operand(0.0), operand(0.0), operand(float("nan"))
    z.copy_(zd)
    res.copy_(torch.ones(n, c, dtype=torch.float64))
    gamma = torch.ones(c, dtype=dt, device=cuda_device)
    beta = torch.zeros(c, dtype=dt, device=cuda_device)
    err, mean, var, inv = _fwd_launch(cuda_device, z, gamma, beta, res, out)
    assert err == 0
    s = zd.sum(0)
    want_mean = (s.float() / torch.tensor(float(n))).to(cuda_device)
    assert torch.equal(mean, want_mean)
    want_var = (zd * zd).sum(0) / n - (s / n) ** 2
    torch.testing.assert_close(var.double().cpu(), want_var, rtol=1e-6, atol=1e-7)
    assert not bool(out.isnan().any())


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(1 << 20, 64), ((1 << 20) + 7, 130)])
def test_fwd_float32_large_mean_statistics_against_float64(cuda_device, n, c):
    """z = 1000 + N(0, 1) in float32 over a million rows, where E[z^2] -
    mean^2 in float32 loses every digit of the variance and a badly
    shifted or merged sum loses some: the kernel's mean and variance are
    held against the float64 ones and the plain version's within rtol 1e-5
    / atol 1e-6, and out bitwise against the plain elementwise math at the
    kernel's own stats (z * scale and shift are of order 1000 here, so one
    float32 ulp of the mean, 6e-5, moves out by as much in either version)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + c)
    z = 1000.0 + torch.randn((n, c), generator=gen, device=cuda_device)
    gamma = torch.rand(c, generator=gen, device=cuda_device) + 0.5
    beta = torch.rand(c, generator=gen, device=cuda_device) - 0.5
    out, mean, var, inv = bn_act.bn_act_fwd("relu", EPS, z, gamma, beta)
    _, pmean, pvar, pinv = bn_act.bn_act_fwd_plain("relu", EPS, z, gamma, beta)
    zd = z.double()
    for got, want in ((mean, zd.mean(0)), (var, zd.var(0, unbiased=False)),
                      (mean, pmean), (var, pvar), (inv, pinv)):
        torch.testing.assert_close(got.double(), want.double(), rtol=1e-5, atol=1e-6)
    scale = gamma * inv
    assert torch.equal(out, bn_act.bn_act_apply_plain("relu", z, scale, beta - mean * scale))


@pytest.mark.cuda
def test_fwd_kernel_plans_its_grid_and_refuses_short_scratch(cuda_device):
    import ctypes
    n, c = 4096, 64
    z, gamma, beta, _, _ = _operands(n, c, "bfloat16", False, seed=3)
    tz, tg, tb = (torch.from_numpy(a).to(cuda_device, torch.bfloat16) for a in (z, gamma, beta))
    query = bn_act._kernel("bn_act_fwd", bn_act._SCRATCH_ARGS, "scratch", ctypes.c_longlong)
    need = query(1, 1, 0, n, c, 8)
    # double partials (S, Q) of at least one row block, then scale and shift
    assert need >= 4 * c + 2 * c and (need - 2 * c) % (4 * c) == 0
    assert query(1, 1, 0, n, c, 3) < 0  # no such vector width
    err, _, _, _ = _fwd_launch(cuda_device, tz, tg, tb, None, torch.empty_like(tz), "relu",
                               scratch_floats=need - 1)
    assert err != 0
