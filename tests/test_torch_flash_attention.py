"""The ``flash_attn_fwd`` kernel's wrapper and plain version (PyTorch port).

On the CPU the wrapper checks its operands and takes the plain version,
``parallel/ring_attention.reference_attention``; here that plain version is
held against a float64 numpy transcription of softmax(q k^T / sqrt(d)) v at
the kernel's awkward shapes (t = 1, ragged t and d, causal or not), within
1e-5 of the largest |v| (float32 sums in another order).

The kernel itself runs only on a CUDA card: its tests carry the ``cuda``
marker and skip here. There it is held against the plain version within
``1e-5 * max|v|`` in float32, and in bf16, element by element, within one
bf16 ulp of the plain version computed in float32 from the same bf16 inputs
(the kernel rounds once, at the output) plus that float32 limit; two
launches agree bitwise, and head-split views give what their contiguous
copies give.
"""

import numpy as np
import pytest
import torch

from deeplearning4j_tpu_torch.parallel.ring_attention import reference_attention
from deeplearning4j_tpu_torch.perf.kernels import flash_attention as fa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attn_fwd kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(shape, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).to(dtype)
            for _ in range(3)]


def _numpy_attention(q, k, v, causal):
    q, k, v = (np.asarray(a, np.float64) for a in (q, k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(q.shape[-1])
    if causal:
        t = s.shape[-1]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    w = np.exp(s - s.max(-1, keepdims=True))
    return np.einsum("bhqk,bhkd->bhqd", w / w.sum(-1, keepdims=True), v)


SHAPES = [(1, 1, 1, 1), (2, 3, 129, 40), (1, 2, 64, 64), (1, 1, 70, 256), (3, 2, 17, 7)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_float64_attention(shape, causal):
    q, k, v = _qkv(shape, sum(shape) + causal)
    got = reference_attention(q, k, v, causal=causal).numpy()
    want = _numpy_attention(q, k, v, causal)
    assert got.shape == shape and got.dtype == np.float32
    assert np.abs(got - want).max() <= 1e-5 * float(v.abs().max())


def test_wrapper_on_cpu_takes_the_plain_version():
    q, k, v = _qkv((2, 3, 130, 16), 5)
    before = fa.launches
    for causal in (False, True):
        got = fa.flash_attention(q, k, v, causal=causal)
        assert torch.equal(got, reference_attention(q, k, v, causal=causal))
    assert fa.launches == before  # no kernel launch on a CPU tensor


def test_wrapper_takes_head_split_views():
    # the attention layers' q, k, v: (b, t, h, d) in memory, seen as (b, h, t, d)
    q, k, v = (a.transpose(1, 2) for a in _qkv((2, 130, 3, 16), 6))
    assert not q.is_contiguous()
    for causal in (False, True):
        got = fa.flash_attention(q, k, v, causal=causal)
        want = reference_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal)
        assert torch.allclose(got, want, rtol=0, atol=1e-6)


def test_wrapper_checks_its_operands():
    q, k, v = _qkv((1, 2, 8, 4), 1)
    with pytest.raises(TypeError):  # float64 is not a kernel type
        fa.flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(TypeError):  # mixed dtypes
        fa.flash_attention(q, k.bfloat16(), v)
    with pytest.raises(TypeError):
        fa.flash_attention(q.to(torch.int32), k.to(torch.int32), v.to(torch.int32))
    with pytest.raises(ValueError):  # shapes differ
        fa.flash_attention(q, k[:, :, :4], v)
    with pytest.raises(ValueError):  # not (b, h, t, d)
        fa.flash_attention(q[0], k[0], v[0])
    with pytest.raises(ValueError):  # the last axis is not contiguous
        qt = q.transpose(2, 3).contiguous().transpose(2, 3)
        fa.flash_attention(qt, k, v)
    big = torch.zeros((1, 1, 4, fa.MAX_HEAD_DIM + 1))
    with pytest.raises(ValueError):  # head dim past 256
        fa.flash_attention(big, big, big)
    with pytest.raises(ValueError):  # mixed devices
        fa.flash_attention(q, k.to("meta"), v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 12, 1024, 64), True),
                                          ((3, 5, 1000, 40), False),
                                          ((2, 3, 129, 256), True),
                                          ((1, 1, 1, 1), False)])
def test_kernel_matches_plain_float32(cuda_device, shape, causal):
    q, k, v = (a.to(cuda_device) for a in _qkv(shape, sum(shape)))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    want = reference_attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 2
    assert got.shape == shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(v.abs().max())
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_reads_head_split_views(cuda_device, causal):
    q, k, v = (a.to(cuda_device).transpose(1, 2) for a in _qkv((2, 1000, 12, 64), 7))
    got = fa.flash_attention(q, k, v, causal=causal)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), causal=causal)
    torch.cuda.synchronize()
    assert got.stride() == q.stride()  # written in the projections' layout
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape,causal", [((2, 8, 1024, 128), True),
                                          ((3, 5, 1000, 40), False)])
def test_kernel_matches_plain_bfloat16(cuda_device, shape, causal):
    q, k, v = (a.to(cuda_device) for a in _qkv(shape, sum(shape), torch.bfloat16))
    got = fa.flash_attention(q, k, v, causal=causal)
    want = reference_attention(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # one bf16 ulp of each element's own |want| (the kernel rounds once), on
    # top of the float32 limit for the other summation order
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    tol = ulp + 1e-5 * float(v.float().abs().max())
    assert bool(((got.float() - want).abs() <= tol).all())


def _bf16_limit(want, v):
    """chip_smoke.py's _flash_tol for bf16: one bf16 ulp of each element's
    own |want| plus 1e-5 of the largest |v|."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -126))) - 7)
    return ulp + 1e-5 * float(v.float().abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("t", [1, 63, 65, 1000])
@pytest.mark.parametrize("d", [40, 64, 128, 256])
@pytest.mark.parametrize("causal", [False, True])
def test_kernel_bfloat16_tile_edges_on_head_split_views(cuda_device, t, d, causal):
    # the tensor-core path at the edges of its 64-row query tiles and its key
    # tiles (64 wide, 32 at d = 256), on (b, t, h, d) memory seen as (b, h, t, d)
    q, k, v = (a.to(cuda_device).transpose(1, 2)
               for a in _qkv((2, t, 3, d), t * 7 + d + causal, torch.bfloat16))
    got = fa.flash_attention(q, k, v, causal=causal)
    again = fa.flash_attention(q, k, v, causal=causal)
    want = reference_attention(q.float(), k.float(), v.float(), causal=causal)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.stride() == q.stride()
    assert bool(((got.float() - want).abs() <= _bf16_limit(want, v)).all())
    assert torch.equal(got.view(torch.int16), again.view(torch.int16))
