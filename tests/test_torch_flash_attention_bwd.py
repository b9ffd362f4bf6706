"""The flash attention backward of the PyTorch port: L, the plain dK/dV and
dQ versions, and the ``torch.autograd.Function`` that joins them.

On the CPU the Function runs the plain versions, so its wiring (saved
tensors, D, strides, dtypes) is tested here:
- the plain forward's L and the plain dK/dV and dQ against float64 autograd
  of ``reference_attention`` (ragged t and d, causal and not): within
  2e-5 of the float64 gradient's largest magnitude (float32 sums of up to
  t = 130 products);
- the Function against ``jax.vjp`` of the JAX package's
  ``flash_self_attention`` (its dense reference off the TPU), on head-split
  views and a transposed dO: rtol 1e-5, atol 2e-6 (float32, summed in
  another order; the gradients are O(1));
- no L under ``torch.inference_mode``, and the serving output unchanged.

The bf16 dK/dV and dQ kernels run their products on tensor cores from bf16
operands with float32 sums, P and dS (dK/dV) or dS (dQ) split into hi =
bf16(x) and lo = bf16(x - hi). A float emulation of that arithmetic runs
here: within the card's limit of 2 bf16 ulps of the plain version's
magnitude plus 1/8 ulp of its largest (chip_smoke.py's ``_bwd_limit``), and
closer than the same emulation without the split.

The kernels run only on a CUDA card: those tests carry the ``cuda`` marker
and skip here. There each kernel is held against its plain version:
float32 within 1e-5 of the plain float32 result's largest magnitude, bf16
within 2 bf16 ulps of each element's own magnitude plus 1e-3 of the largest
(the plain version computed in float32 from the same bf16 inputs; the
kernel rounds once, at the output); two launches agree bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.parallel import ring_attention as jring

from deeplearning4j_tpu_torch.parallel.ring_attention import (flash_self_attention,
                                                              reference_attention)
from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa

SHAPES = [(1, 1, 1, 1), (2, 3, 130, 16), (1, 2, 65, 40), (3, 2, 17, 7)]


def _randn(shape, seed, dtype=torch.float32):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(shape)
                            .astype(np.float32)).to(dtype)


def _qkv_do(shape, seed):
    return [_randn(shape, seed + i) for i in range(4)]


def _f64_grads(q, k, v, do, causal):
    leaves = [a.double().requires_grad_(True) for a in (q, k, v)]
    out = reference_attention(*leaves, causal=causal)
    return out, torch.autograd.grad(out, leaves, do.double())


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_plain_L_dkv_dq_match_float64_autograd(shape, causal):
    q, k, v, do = _qkv_do(shape, sum(shape) + causal)
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), k.double()) / np.sqrt(shape[-1])
    if causal:
        s = s.masked_fill(~torch.ones(s.shape[-2:], dtype=torch.bool).tril(), -np.inf)
    assert float((lse.double() - torch.logsumexp(s, -1)).abs().max()) <= 1e-5
    o64, (dq64, dk64, dv64) = _f64_grads(q, k, v, do, causal)
    assert torch.equal(o, reference_attention(q, k, v, causal=causal))
    delta = (do.double() * o64.detach()).sum(-1).float()
    dk, dv = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    dq = fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal)
    for got, want in ((dq, dq64), (dk, dk64), (dv, dv64)):
        assert got.dtype == torch.float32 and got.shape == shape
        assert float((got.double() - want).abs().max()) <= 2e-5 * float(want.abs().max())


@pytest.mark.parametrize("causal", [False, True])
def test_function_matches_jax_vjp_on_head_split_views(causal):
    # the attention layers' q, k, v: (b, t, h, d) in memory, seen as
    # (b, h, t, d); dO arrives as the transpose that _unheads' backward gives
    b, t, h, d = 2, 130, 3, 16
    q, k, v, do = (_randn((b, t, h, d), 20 + i) for i in range(4))
    jq, jk, jv, jdo = (jnp.asarray(a.numpy().transpose(0, 2, 1, 3)) for a in (q, k, v, do))
    want_o, vjp = jax.vjp(lambda a, c, e: jring.flash_self_attention(a, c, e, causal=causal),
                          jq, jk, jv)
    want = vjp(jdo)
    leaves = [a.requires_grad_(True) for a in (q, k, v)]
    views = [a.transpose(1, 2) for a in leaves]
    assert not views[0].is_contiguous()
    out = flash_self_attention(*views, causal=causal)
    saved = out.grad_fn.saved_tensors
    assert [tuple(a.shape) for a in saved] == [(b, h, t, d)] * 4 + [(b, h, t)]
    assert saved[-1].dtype == torch.float32 and saved[-1].is_contiguous()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_o), rtol=1e-6,
                               atol=1e-6)
    dkv, dq = fa.launches_bwd_dkv, fa.launches_bwd_dq
    got = torch.autograd.grad(out, leaves, do.transpose(1, 2))
    assert (fa.launches_bwd_dkv, fa.launches_bwd_dq) == (dkv, dq)  # no kernel on the CPU
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy().transpose(0, 2, 1, 3), np.asarray(w),
                                   rtol=1e-5, atol=2e-6)


def test_function_takes_a_dO_whose_last_axis_is_not_contiguous():
    q, k, v, do = _qkv_do((1, 2, 130, 8), 30)
    leaves = [a.requires_grad_(True) for a in (q, k, v)]
    out = fa.flash_attention(*leaves, causal=True)
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)  # last axis stride 130
    assert strided.stride(-1) != 1
    got = torch.autograd.grad(out, leaves, strided)
    _, want = _f64_grads(q, k, v, do, True)
    for g, w in zip(got, want):
        assert float((g.double() - w).abs().max()) <= 2e-5 * float(w.abs().max())


def test_no_L_under_inference_mode_and_the_serving_output_is_unchanged():
    q, k, v, _ = _qkv_do((2, 3, 130, 16), 40)
    with torch.inference_mode():
        served = fa.flash_attention(q, k, v, causal=True)
    assert served.grad_fn is None
    assert torch.equal(served, reference_attention(q, k, v, causal=True))
    leaves = [a.clone().requires_grad_(True) for a in (q, k, v)]
    with torch.no_grad():
        assert fa.flash_attention(*leaves, causal=True).grad_fn is None
    trained = fa.flash_attention(*leaves, causal=True)
    assert len(trained.grad_fn.saved_tensors) == 5  # q, k, v, o, L
    assert torch.equal(trained.detach(), served)


def test_float64_on_the_cpu_takes_the_dense_reference():
    q, k, v, do = _qkv_do((1, 2, 130, 8), 50)
    leaves = [a.double().requires_grad_(True) for a in (q, k, v)]
    out = flash_self_attention(*leaves, causal=True)
    assert out.dtype == torch.float64
    got = torch.autograd.grad(out, leaves, do.double())
    _, want = _f64_grads(q, k, v, do, True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with pytest.raises(TypeError):  # float64 is no kernel type
        fa.flash_attention(*leaves)


def test_backward_wrappers_check_their_operands():
    q, k, v, do = _qkv_do((1, 2, 8, 4), 60)
    o, lse = fa.flash_fwd(q, k, v)
    delta = (do * o).sum(-1)
    with pytest.raises(ValueError):  # dO of another shape
        fa.flash_bwd_dkv(q, k, v, do[:, :, :4], lse, delta)
    with pytest.raises(ValueError):  # dO of another dtype
        fa.flash_bwd_dq(q, k, v, do.bfloat16(), lse, delta)
    with pytest.raises(ValueError):  # L not float32
        fa.flash_bwd_dq(q, k, v, do, lse.double(), delta)
    with pytest.raises(ValueError):  # D not (b, h, t) contiguous
        fa.flash_bwd_dkv(q, k, v, do, lse, delta.transpose(1, 2).contiguous().transpose(1, 2))
    with pytest.raises(TypeError):
        fa.flash_bwd_dq(q.double(), k.double(), v.double(), do.double(), lse, delta)


def _bf16_ulp(x):
    """One bf16 ulp of |x| (a power of two), at least the smallest normal's."""
    e = torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def _bf16_over_limit(got, plain):
    """max |got - plain| over the bf16 limit: 2 bf16 ulps of |plain| there
    plus 1/8 ulp of max |plain| (chip_smoke.py's _bwd_limit)."""
    tol = 2 * _bf16_ulp(plain) + _bf16_ulp(plain.abs().max()) / 8
    return float(((got.float() - plain).abs() / tol).max())


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _emulate_bf16_dkv(q, k, v, do, lse, delta, causal, split=True):
    """The bf16 dK/dV kernel's arithmetic in float32 on bf16-valued inputs:
    S^T = K Q^T and dP^T = V dO^T as float32 sums of exact products;
    P^T = exp2(S^T c - L log2 e), c = log2(e)/sqrt(d); dS^T = P^T (dP^T - D);
    dV = P^T dO and dK = dS^T Q / sqrt(d), each of P^T and dS^T entering
    the products as hi + lo (or as hi alone); rounded once to bf16."""
    d = q.shape[-1]
    c = np.float32(np.log2(np.e) / np.sqrt(d))
    st = torch.einsum("bhkd,bhqd->bhkq", k, q)
    dpt = torch.einsum("bhkd,bhqd->bhkq", v, do)
    pt = torch.exp2(st * c - (lse * np.float32(np.log2(np.e)))[:, :, None, :])
    if causal:
        t = q.shape[2]
        pt = pt.masked_fill(torch.ones((t, t), dtype=torch.bool).tril(-1), 0.0)
    dst = pt * (dpt - delta[:, :, None, :])

    def product(a, m):
        hi = _bf16(a)
        out = torch.einsum("bhkq,bhqd->bhkd", hi, m)
        return out + torch.einsum("bhkq,bhqd->bhkd", _bf16(a - hi), m) if split else out

    dv = product(pt, do)
    dk = product(dst, q) / np.float32(np.sqrt(d))
    return dk.to(torch.bfloat16), dv.to(torch.bfloat16)


@pytest.mark.parametrize("shape,causal", [((1, 2, 130, 64), True), ((1, 2, 130, 64), False),
                                          ((2, 1, 97, 40), True), ((1, 1, 64, 128), False)])
def test_bf16_kernel_arithmetic_emulated_is_within_the_card_limit(shape, causal):
    q, k, v, do = (_bf16(a) for a in _qkv_do(shape, 80 + sum(shape)))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do * o).sum(-1)
    plain = fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta, causal)
    split = _emulate_bf16_dkv(q, k, v, do, lse, delta, causal)
    alone = _emulate_bf16_dkv(q, k, v, do, lse, delta, causal, split=False)
    for got, bare, want in zip(split, alone, plain):
        over = _bf16_over_limit(got, want)
        assert over <= 1.0
        # P and dS rounded to bf16 alone come nearer the limit (or past it)
        assert _bf16_over_limit(bare, want) > over


def _emulate_bf16_dq(q, k, v, do, lse, delta, causal, split=True):
    """The bf16 dQ kernel's arithmetic in float32 on bf16-valued inputs:
    S = Q K^T and dP = dO V^T as float32 sums of exact products;
    P = exp2(S c - L log2 e), c = log2(e)/sqrt(d); dS = P (dP - D);
    dQ = dS K / sqrt(d), dS entering the product as hi + lo (or as hi
    alone); rounded once to bf16."""
    d = q.shape[-1]
    c = np.float32(np.log2(np.e) / np.sqrt(d))
    s = torch.einsum("bhqd,bhkd->bhqk", q, k)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v)
    p = torch.exp2(s * c - (lse * np.float32(np.log2(np.e)))[..., None])
    if causal:
        t = q.shape[2]
        p = p.masked_fill(~torch.ones((t, t), dtype=torch.bool).tril(), 0.0)
    ds = p * (dp - delta[..., None])
    hi = _bf16(ds)
    dq = torch.einsum("bhqk,bhkd->bhqd", hi, k)
    if split:
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", _bf16(ds - hi), k)
    return (dq / np.float32(np.sqrt(d))).to(torch.bfloat16)


@pytest.mark.parametrize("shape,causal", [((1, 2, 130, 64), True), ((1, 2, 130, 64), False),
                                          ((2, 1, 97, 40), True), ((1, 1, 64, 128), False)])
def test_bf16_dq_arithmetic_emulated_is_within_the_card_limit(shape, causal):
    q, k, v, do = (_bf16(a) for a in _qkv_do(shape, 85 + sum(shape)))
    o, lse = fa.flash_fwd_plain(q, k, v, causal)
    delta = (do * o).sum(-1)
    # the plain dQ in float64 from the same L and D
    want = fa.flash_bwd_dq_plain(q.double(), k.double(), v.double(), do.double(),
                                 lse.double(), delta.double(), causal).float()
    split = _emulate_bf16_dq(q, k, v, do, lse, delta, causal)
    over = _bf16_over_limit(split, want)
    assert over <= 1.0
    # dS rounded to bf16 alone comes nearer the limit (or past it)
    assert _bf16_over_limit(_emulate_bf16_dq(q, k, v, do, lse, delta, causal, split=False),
                            want) > over


# ------------------------------------------------------------------ on a card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash backward kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal,dtype", [
    ((2, 12, 1024, 64), True, torch.float32),
    ((3, 5, 1000, 40), False, torch.float32),
    ((2, 3, 129, 256), True, torch.float32),
    ((1, 1, 1, 1), False, torch.float32),
    ((2, 4, 700, 128), True, torch.bfloat16),
])
def test_kernels_match_plain_and_repeat_bitwise(cuda_device, shape, causal, dtype):
    q, k, v, do = (a.to(cuda_device, dtype) for a in _qkv_do(shape, sum(shape)))
    counts = (fa.launches_bwd_dkv, fa.launches_bwd_dq)
    o, lse = fa.flash_fwd(q, k, v, causal)
    _, lse_plain = fa.flash_fwd_plain(q.float(), k.float(), v.float(), causal)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    got = (*fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
           fa.flash_bwd_dq(q, k, v, do, lse, delta, causal))
    again = (*fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
             fa.flash_bwd_dq(q, k, v, do, lse, delta, causal))
    f32 = [a.float() for a in (q, k, v, do)]
    want = (*fa.flash_bwd_dkv_plain(*f32, lse, delta, causal),
            fa.flash_bwd_dq_plain(*f32, lse, delta, causal))
    torch.cuda.synchronize()
    assert (fa.launches_bwd_dkv, fa.launches_bwd_dq) == tuple(c + 2 for c in counts)
    assert float((lse - lse_plain).abs().max()) <= 1e-5
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for g, a, w in zip(got, again, want):
        assert g.dtype == dtype and g.shape == shape
        assert torch.equal(g.view(bits), a.view(bits))
        top = float(w.abs().max())
        if dtype == torch.float32:
            assert float((g - w).abs().max()) <= 1e-5 * top
        else:
            assert bool(((g.float() - w).abs() <= 2 * _bf16_ulp(w) + 1e-3 * top).all())


@pytest.mark.cuda
def test_function_on_the_card_matches_the_cpu(cuda_device):
    b, t, h, d = 2, 300, 4, 64
    q, k, v, do = (_randn((b, t, h, d), 70 + i) for i in range(4))
    grads = []
    for dev in ("cpu", cuda_device):
        leaves = [a.to(dev).requires_grad_(True) for a in (q, k, v)]
        out = fa.flash_attention(*(a.transpose(1, 2) for a in leaves), causal=True)
        grads.append([g.cpu() for g in torch.autograd.grad(out, leaves,
                                                           do.to(dev).transpose(1, 2))])
    for c, g in zip(*grads):
        assert float((g - c).abs().max()) <= 1e-5 * float(c.abs().max())


def _dkv_over_limit(got, plain, ref, dtype):
    """chip_smoke.py's _bwd_limit: float32 within 2x the plain float32
    version's distance to the float64 referee, or 1e-5 of the referee's
    largest magnitude; bf16 as :func:`_bf16_over_limit`."""
    if dtype == torch.bfloat16:
        return _bf16_over_limit(got, plain)
    limit = max(2 * float((plain.double() - ref).abs().max()), 1e-5 * float(ref.abs().max()))
    return float((got.double() - ref).abs().max()) / limit


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1000, 129])
@pytest.mark.parametrize("d,layout", [(40, "bhtd"), (64, "bthd"), (128, "bthd"),
                                      (256, "bhtd")])
def test_dkv_kernel_within_limit_and_repeats_bitwise(cuda_device, d, layout, t, causal, dtype):
    b, h = 2, 3
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, do = (a.to(cuda_device, dtype) for a in _qkv_do(shape, d + t + causal))
    if layout == "bthd":  # head-split views, dO as _unheads' backward gives it
        q, k, v, do = (a.transpose(1, 2) for a in (q, k, v, do))
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    count = fa.launches_bwd_dkv
    got = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    again = fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal)
    f32 = [a.float() for a in (q, k, v, do)]
    plain = fa.flash_bwd_dkv_plain(*f32, lse, delta, causal)
    ref = fa.flash_bwd_dkv_plain(*(a.double() for a in f32), lse.double(), delta.double(),
                                 causal)
    torch.cuda.synchronize()
    assert fa.launches_bwd_dkv == count + 2
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for g, a, w, r, x in zip(got, again, plain, ref, (k, v)):
        assert g.dtype == dtype and g.shape == x.shape and g.stride() == x.stride()
        assert torch.equal(g.view(bits), a.view(bits))
        assert _dkv_over_limit(g, w, r, dtype) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dkv_kernel_takes_a_dO_whose_last_axis_is_not_contiguous(cuda_device, dtype):
    q, k, v, do = (a.to(cuda_device, dtype) for a in _qkv_do((1, 2, 300, 64), 90))
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.stride(-1) != 1
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    got = fa.flash_bwd_dkv(q, k, v, strided, lse, delta, True)
    want = fa.flash_bwd_dkv(q, k, v, do, lse, delta, True)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    for g, w in zip(got, want):
        assert torch.equal(g.view(bits), w.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("t", [1000, 129])
@pytest.mark.parametrize("d,layout", [(40, "bhtd"), (64, "bthd"), (128, "bthd"),
                                      (256, "bhtd")])
def test_dq_kernel_within_limit_and_repeats_bitwise(cuda_device, d, layout, t, causal, dtype):
    b, h = 2, 3
    shape = (b, t, h, d) if layout == "bthd" else (b, h, t, d)
    q, k, v, do = (a.to(cuda_device, dtype) for a in _qkv_do(shape, d + t + causal + 3))
    if layout == "bthd":  # head-split views, dO as _unheads' backward gives it
        q, k, v, do = (a.transpose(1, 2) for a in (q, k, v, do))
    o, lse = fa.flash_fwd(q, k, v, causal)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    count = fa.launches_bwd_dq
    got = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    again = fa.flash_bwd_dq(q, k, v, do, lse, delta, causal)
    f32 = [a.float() for a in (q, k, v, do)]
    plain = fa.flash_bwd_dq_plain(*f32, lse, delta, causal)
    ref = fa.flash_bwd_dq_plain(*(a.double() for a in f32), lse.double(), delta.double(),
                                causal)
    torch.cuda.synchronize()
    assert fa.launches_bwd_dq == count + 2
    assert got.dtype == dtype and got.shape == q.shape and got.stride() == q.stride()
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), again.view(bits))
    assert _dkv_over_limit(got, plain, ref, dtype) <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dq_kernel_takes_a_dO_whose_last_axis_is_not_contiguous(cuda_device, dtype):
    q, k, v, do = (a.to(cuda_device, dtype) for a in _qkv_do((1, 2, 300, 64), 95))
    strided = do.transpose(2, 3).contiguous().transpose(2, 3)
    assert strided.stride(-1) != 1
    o, lse = fa.flash_fwd(q, k, v, True)
    delta = (do.float() * o.float()).sum(-1).contiguous()
    got = fa.flash_bwd_dq(q, k, v, strided, lse, delta, True)
    want = fa.flash_bwd_dq(q, k, v, do, lse, delta, True)
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))
