"""int4_dot of the PyTorch port against the JAX package.

On the CPU the port's wrapper takes its plain version; the JAX side runs
its Pallas ``int4_matmul`` in interpret mode, as tests/test_zz_pallas.py
does. Integer results and packed tables must match BITWISE. The kernel
itself runs only on a CUDA card: its tests carry the ``cuda`` marker and
skip here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.perf import pallas as pk
from deeplearning4j_tpu.perf.pallas import adc as jax_adc
from deeplearning4j_tpu.quant import lowering as jax_lowering
from deeplearning4j_tpu.quant import pack as jax_pack

from deeplearning4j_tpu_torch.perf.kernels import int4_dot
from deeplearning4j_tpu_torch.quant import lowering as pt_lowering
from deeplearning4j_tpu_torch.quant import pack as pt_pack


def _operands(b, n, d, seed):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((n, d)).astype(np.float32)
    packed, _, _ = jax_pack.quantize_int4(table)
    qq = rng.integers(-127, 128, (b, d)).astype(np.int8)
    return qq, packed


def _random_operands(b, n, d, seed, device):
    # every byte value, so both nibbles take all 16 codes (and the padding
    # nibble of odd d is junk that must not count)
    rng = np.random.default_rng(seed)
    qq = rng.integers(-127, 128, (b, d)).astype(np.int8)
    packed = rng.integers(-128, 128, (n, (d + 1) // 2)).astype(np.int8)
    return torch.from_numpy(qq).to(device), torch.from_numpy(packed).to(device)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the int4_dot kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("b", [1, 6])
@pytest.mark.parametrize("n", [50, 513])
@pytest.mark.parametrize("d", [33, 64])
def test_plain_matches_jax_pallas_bitwise(b, n, d):
    qq, packed = _operands(b, n, d, seed=b * 1000 + n + d)
    with pk.override(enabled=True):
        want = np.asarray(jax_adc.int4_matmul(jnp.asarray(qq),
                                              jnp.asarray(packed), d))
    got = int4_dot.int4_matmul_plain(torch.from_numpy(qq),
                                     torch.from_numpy(packed), d)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_unpack_nibbles_all_bytes_match_jax():
    packed = np.arange(256, dtype=np.uint8).view(np.int8).reshape(16, 16)
    want = jax_pack.unpack_nibbles_host(packed, 32)
    got = pt_pack.unpack_nibbles(torch.from_numpy(packed), 32).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(pt_pack.unpack_nibbles_host(packed, 31), want[:, :31])


def test_padding_nibble_never_counts():
    qq, packed = _operands(3, 40, 33, seed=5)
    junk = packed.copy()
    junk[:, -1] = (junk[:, -1].view(np.uint8) | 0x70).view(np.int8)
    a = int4_dot.int4_matmul(torch.from_numpy(qq), torch.from_numpy(packed), 33)
    b = int4_dot.int4_matmul(torch.from_numpy(qq), torch.from_numpy(junk), 33)
    assert torch.equal(a, b)


def test_weight_quantizers_bitwise():
    rng = np.random.default_rng(11)
    for shape in [(33, 24), (3, 3, 5, 16)]:
        w = rng.standard_normal(shape).astype(np.float32)
        for fn in ("quantize_weights", "quantize_weights_int4"):
            jq, js = getattr(jax_lowering, fn)(w)
            pq, ps = getattr(pt_lowering, fn)(w)
            assert pq.dtype == np.int8 and np.array_equal(pq, np.asarray(jq))
            assert ps.dtype == np.float32 and np.array_equal(ps, np.asarray(js))
    table = rng.standard_normal((40, 33)).astype(np.float32)
    for observer in ("minmax", "percentile"):
        jp, jsc, jw = jax_pack.quantize_int4(table, observer=observer)
        pp, psc, pw = pt_pack.quantize_int4(table, observer=observer)
        assert np.array_equal(pp, jp) and np.array_equal(psc, jsc) and pw == jw


def test_cpu_wrapper_takes_plain_version_and_checks_inputs():
    qq, packed = _operands(2, 7, 9, seed=3)
    q, p = torch.from_numpy(qq), torch.from_numpy(packed)
    before = int4_dot.launches
    assert torch.equal(int4_dot.int4_matmul(q, p, 9),
                       int4_dot.int4_matmul_plain(q, p, 9))
    assert int4_dot.launches == before  # the plain version is no launch
    with pytest.raises(TypeError):
        int4_dot.int4_matmul(q.to(torch.int32), p, 9)
    with pytest.raises(ValueError):
        int4_dot.int4_matmul(q, p, 10)
    with pytest.raises(ValueError):
        int4_dot.int4_matmul(q[:, :8], p, 8)
    one_row = torch.from_numpy(np.repeat(qq[:1].T, 3, axis=1))[:, :1].t()
    assert one_row.shape == (1, 9) and one_row.stride(1) != 1
    with pytest.raises(ValueError, match="contiguous"):
        int4_dot.int4_matmul(one_row, p, 9)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,d", [(1, 4096, 25088), (16, 1000, 4096),
                                   (3, 1000, 33), (9, 130, 1000), (64, 77, 4097)])
def test_kernel_matches_plain_on_card_bitwise(cuda_device, b, n, d):
    qq, packed = _operands(b, n, d, seed=b + n + d)
    q = torch.from_numpy(qq).to(cuda_device)
    p = torch.from_numpy(packed).to(cuda_device)
    before = int4_dot.launches
    got = int4_dot.int4_matmul(q, p, d)
    torch.cuda.synchronize()
    assert int4_dot.launches == before + 1
    assert torch.equal(got, int4_dot.int4_matmul_plain(q, p, d))


@pytest.mark.cuda
def test_kernel_takes_row_strided_views(cuda_device):
    qq, packed = _operands(5, 64, 96, seed=9)
    q = torch.from_numpy(np.pad(qq, ((0, 0), (0, 32)))).to(cuda_device)[:, :96]
    p = torch.from_numpy(np.pad(packed, ((0, 0), (0, 16)))).to(cuda_device)[:, :48]
    got = int4_dot.int4_matmul(q, p, 96)
    want = int4_dot.int4_matmul_plain(q.contiguous(), p.contiguous(), 96)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 15, 16, 17, 33])
@pytest.mark.parametrize("d", [1, 33, 63, 64, 65, 25088])
def test_kernel_tile_edges_bitwise(cuda_device, b, d):
    # b <= 16 takes the one-fragment tile (64 table rows), b > 16 the 64 x 128
    # tile; n = 1000 is a multiple of neither N-tile. Few tiles at a long d
    # split k across blocks (int32 atomics), many tiles do not.
    n = 1000
    q, p = _random_operands(b, n, d, b * 7 + d, cuda_device)
    got = int4_dot.int4_matmul(q, p, d)
    again = int4_dot.int4_matmul(q, p, d)
    torch.cuda.synchronize()
    assert torch.equal(got, int4_dot.int4_matmul_plain(q, p, d))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n", [(8, 4096), (16, 4096), (64, 4096), (256, 20000)])
def test_kernel_split_k_and_many_tiles_bitwise(cuda_device, b, n):
    # fc1's shape (d = 25,088) at serving batches splits k; (256, 20000, 64)
    # has more tiles than the card holds blocks, so each block walks several
    d = 25088 if n == 4096 else 64
    q, p = _random_operands(b, n, d, b + n, cuda_device)
    got = int4_dot.int4_matmul(q, p, d)
    again = int4_dot.int4_matmul(q, p, d)
    torch.cuda.synchronize()
    assert torch.equal(got, int4_dot.int4_matmul_plain(q, p, d))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_kernel_takes_unaligned_row_strides(cuda_device):
    # row strides that are not multiples of 16 bytes take the byte-wise copy
    q, p = _random_operands(20, 300, 70, 4, cuda_device)
    qv = torch.nn.functional.pad(q, (0, 3))[:, :70]
    pv = torch.nn.functional.pad(p, (0, 5))[:, :35]
    assert qv.stride(0) % 16 and pv.stride(0) % 16
    got = int4_dot.int4_matmul(qv, pv, 70)
    assert torch.equal(got, int4_dot.int4_matmul_plain(q, p, 70))
