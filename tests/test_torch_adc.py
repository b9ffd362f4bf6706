"""The ADC kernels of the PyTorch port against the JAX package.

On the CPU the port's wrappers take their plain versions; the JAX side runs
its Pallas ``score_pq`` / ``score_ivf_pq`` in interpret mode under
``perf.pallas.override(enabled=True)``, as tests/test_zz_pallas.py does.

Tolerances:
- integer-valued codebooks, centroids and queries (small integers) make
  every LUT entry and every sum exact in float32, so the kernels' squared
  distances and the ids must match BITWISE, ties included, at k = the whole
  candidate axis. The returned distances are ``sqrt(d2)``, and XLA's float32
  sqrt on the CPU is not correctly rounded (sqrt(267) comes out one ulp
  above the IEEE result that torch gives), so they agree within 1 ulp;
- float data: the LUT is a matrix product that torch and XLA round
  differently, so ids must match and distances agree within rtol 1e-5;
- ``_csr_slots`` and the tie-stable top-k are exact, bitwise.

The kernels themselves run only on a CUDA card: their tests carry the
``cuda`` marker and skip here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl

from deeplearning4j_tpu.perf import pallas as pk
from deeplearning4j_tpu.perf.pallas import adc as jax_adc
from deeplearning4j_tpu.retrieval import index as jax_index

from deeplearning4j_tpu_torch.perf.kernels import adc
from deeplearning4j_tpu_torch.retrieval import index as pt_index
from deeplearning4j_tpu_torch.retrieval import pq as pt_pq


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ADC kernels have no CPU mode")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _pallas_d2(kernel, lut, *operands, out_cols):
    """The JAX package's Pallas kernel body alone, in interpret mode: the
    (b, out_cols) squared distances before the top-k."""
    return np.asarray(pl.pallas_call(
        kernel, interpret=True,
        out_shape=jax.ShapeDtypeStruct((lut.shape[0], out_cols), jnp.float32),
    )(jnp.asarray(lut), *map(jnp.asarray, operands)))


def _pq_operands(rng, b, n, M, ksub, dsub, integer):
    if integer:
        books = rng.integers(-3, 4, (M, ksub, dsub)).astype(np.float32)
        q = rng.integers(-4, 5, (b, M * dsub)).astype(np.float32)
    else:
        books = rng.standard_normal((M, ksub, dsub)).astype(np.float32)
        q = rng.standard_normal((b, M * dsub)).astype(np.float32)
    codes = rng.integers(0, ksub, (n, M)).astype(np.uint8)
    return q, books, codes


def _ivf_operands(rng, b, n_cells, M, ksub, dsub, nprobe, integer):
    counts = rng.integers(0, 30, n_cells)
    counts[rng.integers(0, n_cells)] = 0                  # an empty cell
    n = int(counts.sum())
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    q, books, codes = _pq_operands(rng, b, n, M, ksub, dsub, integer)
    d = M * dsub
    if integer:
        cents = rng.integers(-2, 3, (n_cells, d)).astype(np.float32)
    else:
        cents = rng.standard_normal((n_cells, d)).astype(np.float32)
    flat_ids = rng.permutation(n).astype(np.int32)
    worst = int(np.sort(counts)[-nprobe:].sum())
    cand_pad = jax_index._pow2ceil(max(1, worst))
    return q, cents, books, codes, flat_ids, offsets, cand_pad


@pytest.mark.parametrize("M,ksub,dsub", [(4, 16, 2), (3, 5, 1), (8, 2, 3)])
def test_score_pq_integer_data_bitwise_full_order(M, ksub, dsub):
    rng = np.random.default_rng(M * 100 + ksub)
    n = 257
    q, books, codes = _pq_operands(rng, 5, n, M, ksub, dsub, integer=True)
    with pk.override(enabled=True):
        jd, ji = jax_adc.score_pq(jnp.asarray(q), jnp.asarray(books),
                                  jnp.asarray(codes), n)
    pd, pi = pt_pq._score_pq(_t(q), _t(books), _t(codes), n)
    assert np.array_equal(pi.numpy(), np.asarray(ji))   # ties included
    np.testing.assert_array_max_ulp(pd.numpy(), np.asarray(jd), maxulp=1)
    # integer data collides a lot: the order above pinned real ties
    assert len(np.unique(pd.numpy()[0])) < n // 2
    # the kernel bodies themselves, on the same LUT: bitwise
    lut = pt_pq._adc_lut(_t(q).reshape(5, M, dsub), _t(books))
    want = _pallas_d2(functools.partial(jax_adc._adc_kernel, M), lut.numpy(),
                      codes, out_cols=n)
    assert np.array_equal(adc.adc_pq(lut, _t(codes)).numpy(), want)


def test_score_pq_float_data_within_tolerance():
    rng = np.random.default_rng(7)
    q, books, codes = _pq_operands(rng, 6, 300, 4, 16, 4, integer=False)
    with pk.override(enabled=True):
        jd, ji = jax_adc.score_pq(jnp.asarray(q), jnp.asarray(books),
                                  jnp.asarray(codes), 10)
    pd, pi = pt_pq._score_pq(_t(q), _t(books), _t(codes), 10)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5)


@pytest.mark.parametrize("nprobe", [1, 3])
def test_score_ivf_pq_integer_data_bitwise_full_order(nprobe):
    rng = np.random.default_rng(40 + nprobe)
    q, cents, books, codes, ids, offs, cand_pad = _ivf_operands(
        rng, 6, 8, 4, 8, 2, nprobe, integer=True)
    args = (q, cents, books, codes, ids, offs)
    with pk.override(enabled=True):
        jd, ji = jax_adc.score_ivf_pq(*map(jnp.asarray, args), cand_pad,
                                      nprobe, cand_pad)
    pd, pi = pt_pq._score_ivf_pq(*map(_t, args), cand_pad, nprobe, cand_pad)
    assert np.array_equal(pi.numpy(), np.asarray(ji))   # -1 pads and ties too
    np.testing.assert_array_max_ulp(pd.numpy(), np.asarray(jd), maxulp=1)
    assert np.isinf(pd.numpy()).any()                    # padded slots reached
    # the kernel bodies themselves, on the same LUT and slots: bitwise
    lut = torch.from_numpy(rng.integers(-9, 10, (6, nprobe, 4, 8)).astype(np.float32))
    seg = rng.integers(0, nprobe, (6, cand_pad)).astype(np.int32)
    pos = rng.integers(0, len(codes), (6, cand_pad)).astype(np.int32)
    want = _pallas_d2(functools.partial(jax_adc._ivf_adc_kernel, 4, 8),
                      lut.numpy(), codes, seg, pos, out_cols=cand_pad)
    got = adc.adc_ivf_pq(lut, _t(codes), _t(seg), _t(pos))
    assert np.array_equal(got.numpy(), want)


def test_score_ivf_pq_float_data_within_tolerance():
    rng = np.random.default_rng(9)
    q, cents, books, codes, ids, offs, cand_pad = _ivf_operands(
        rng, 5, 8, 4, 16, 3, 3, integer=False)
    args = (q, cents, books, codes, ids, offs)
    with pk.override(enabled=True):
        jd, ji = jax_adc.score_ivf_pq(*map(jnp.asarray, args), 10, 3, cand_pad)
    pd, pi = pt_pq._score_ivf_pq(*map(_t, args), 10, 3, cand_pad)
    assert np.array_equal(pi.numpy(), np.asarray(ji))
    np.testing.assert_allclose(pd.numpy(), np.asarray(jd), rtol=1e-5)


def test_csr_slots_bitwise_and_int32():
    rng = np.random.default_rng(3)
    counts = rng.integers(0, 9, 12)
    counts[[2, 5]] = 0
    offsets = np.concatenate([[0], np.cumsum(counts)]).astype(np.int32)
    probe = np.stack([rng.permutation(12)[:4] for _ in range(7)]).astype(np.int32)
    probe[0] = [2, 5, 0, 1]                               # empty cells first
    cand_pad = 32
    js, jp, jv = jax_index._csr_slots(jnp.asarray(offsets), jnp.asarray(probe),
                                      cand_pad)
    ps, pp, pv = pt_index._csr_slots(_t(offsets), _t(probe).long(), cand_pad)
    assert ps.dtype == pp.dtype == torch.int32 and pv.dtype == torch.bool
    assert np.array_equal(ps.numpy(), np.asarray(js))
    assert np.array_equal(pp.numpy(), np.asarray(jp))
    assert np.array_equal(pv.numpy(), np.asarray(jv))


def test_topk_smallest_is_lax_top_k_order():
    """Ties, +/-0.0 and inf, against lax.top_k(-d2, k) on the CPU: ascending
    in float32's total order (-0.0 before +0.0), ties lower index first."""
    rng = np.random.default_rng(0)
    d2 = rng.integers(0, 4, (6, 40)).astype(np.float32)
    d2[0, ::3] = np.inf
    d2[1, :] = np.where(rng.random(40) < 0.5, -0.0, 0.0).astype(np.float32)
    d2[2, :20] = np.inf
    d2[3] = rng.standard_normal(40).astype(np.float32)
    d2[4, 5:9] = [-1.5, np.inf, -0.0, 0.0]
    for k in (1, 7, 40):
        neg, want_i = lax.top_k(-jnp.asarray(d2), k)
        want_v = -np.asarray(neg)
        got_v, got_i = pt_index._topk_smallest(_t(d2), k)
        assert got_i.dtype == torch.int64
        assert np.array_equal(got_i.numpy(), np.asarray(want_i))
        # bitwise, so the sign of each zero counts too
        assert np.array_equal(got_v.numpy().view(np.int32), want_v.view(np.int32))


def test_plain_versions_match_a_numpy_gather_and_wrappers_check():
    rng = np.random.default_rng(5)
    lut = rng.standard_normal((3, 5, 7)).astype(np.float32)
    codes = rng.integers(0, 7, (11, 5)).astype(np.uint8)
    want = np.zeros((3, 11), np.float32)
    for m in range(5):
        want = want + lut[:, m, :][:, codes[:, m]]
    before = adc.pq_launches
    got = adc.adc_pq(_t(lut), _t(codes))
    assert adc.pq_launches == before            # the plain version is no launch
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(TypeError):
        adc.adc_pq(_t(lut).double(), _t(codes))
    with pytest.raises(ValueError, match="subspaces"):
        adc.adc_pq(_t(lut), _t(codes[:, :4]))
    lut4 = rng.standard_normal((2, 3, 5, 7)).astype(np.float32)
    seg = rng.integers(0, 3, (2, 9)).astype(np.int32)
    pos = rng.integers(0, 11, (2, 9)).astype(np.int32)
    want = np.zeros((2, 9), np.float32)
    for m in range(5):
        want = want + lut4[np.arange(2)[:, None], seg, m, codes[pos, m]]
    got = adc.adc_ivf_pq(_t(lut4), _t(codes), _t(seg), _t(pos))
    assert np.array_equal(got.numpy(), want)
    with pytest.raises(TypeError, match="int32"):
        adc.adc_ivf_pq(_t(lut4), _t(codes), _t(seg).long(), _t(pos))


# ------------------------------------------------------------ on the card
def _card_pq(rng, dev, b, n, M, ksub):
    lut = torch.from_numpy(rng.standard_normal((b, M, ksub)).astype(np.float32)).to(dev)
    codes = torch.from_numpy(rng.integers(0, ksub, (n, M)).astype(np.uint8)).to(dev)
    return lut, codes


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,M,ksub", [(3, 1001, 1, 2), (3, 1001, 3, 17),
                                        (3, 1001, 16, 256), (9, 1001, 8, 256),
                                        (17, 4099, 8, 17), (2, 300, 300, 256)])
def test_adc_pq_kernel_bitwise_on_card(cuda_device, b, n, M, ksub):
    # (2, 300, 300, 256): a 300 KB LUT per query, read from global memory
    lut, codes = _card_pq(np.random.default_rng(b + n + M), cuda_device, b, n, M, ksub)
    before = adc.pq_launches
    got = adc.adc_pq(lut, codes)
    again = adc.adc_pq(lut, codes)
    torch.cuda.synchronize()
    assert adc.pq_launches == before + 2
    assert torch.equal(got, adc.adc_pq_plain(lut, codes))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,C,p,M,ksub", [(3, 1001, 3, 1, 2), (3, 1001, 5, 3, 17),
                                          (3, 1001, 32, 8, 256), (4, 777, 8, 8, 256),
                                          (2, 513, 4, 16, 17)])
def test_adc_ivf_pq_kernel_bitwise_on_card(cuda_device, b, C, p, M, ksub):
    # p = 32, M = 8, ksub = 256: a 256 KB LUT per query, read from global memory
    rng = np.random.default_rng(b + C + p)
    n = 2000
    lut = torch.from_numpy(rng.standard_normal((b, p, M, ksub)).astype(np.float32))
    codes = torch.from_numpy(rng.integers(0, ksub, (n, M)).astype(np.uint8))
    seg = torch.from_numpy(rng.integers(0, p, (b, C)).astype(np.int32))
    pos = torch.from_numpy(rng.integers(0, n, (b, C)).astype(np.int32))
    args = [t.to(cuda_device) for t in (lut, codes, seg, pos)]
    before = adc.ivf_pq_launches
    got = adc.adc_ivf_pq(*args)
    again = adc.adc_ivf_pq(*args)
    torch.cuda.synchronize()
    assert adc.ivf_pq_launches == before + 2
    assert torch.equal(got, adc.adc_ivf_pq_plain(*args))
    assert torch.equal(got, again)


@pytest.mark.cuda
def test_indexes_on_card_match_cpu(cuda_device, tmp_path):
    """An index built on the CPU and loaded on the card answers the same:
    ids equal apart from near-ties, distances within rtol 1e-5 (the LUT and
    norms are products that cuBLAS and the CPU round differently)."""
    from deeplearning4j_tpu_torch.retrieval import (BruteForceIndex, IVFPQIndex,
                                                    PQIndex, load_index,
                                                    synthetic_corpus)
    V, Q = synthetic_corpus(3000, 32, n_clusters=30, seed=4, queries=16)
    for cls, kw in ((PQIndex, dict(M=8, ksub=32)),
                    (IVFPQIndex, dict(M=8, ksub=32, n_cells=16, nprobe=4)),
                    (BruteForceIndex, dict(int4=True))):
        cpu = cls(V, device="cpu", **kw)
        card = load_index(cpu.save(str(tmp_path / f"{cls.kind}.npz")), cuda_device)
        ci, cd = cpu.search(Q, 10)
        gi, gd = card.search(Q, 10)
        np.testing.assert_allclose(gd, cd, rtol=1e-5)
        diff = gi != ci
        assert np.allclose(gd[diff], cd[diff], rtol=1e-5)
