"""The ``scatter_add`` kernel of the PyTorch port against the JAX package.

``table[idx[n]] += grads[n]`` in n order. The JAX package's
``scatter_add_pallas`` runs ``.at[idx].add`` off the TPU (as its own test
in tests/test_nlp.py runs it), and XLA's CPU scatter adds the updates one
after another in n order. The port's plain version adds the same values in
the same order, one float32 rounding per add, so the two agree BITWISE:
no tolerance, signed zeros included (the cases put -0.0 in the table and
+0.0 in the gradients, where a skipped or reordered add would show).

The kernel itself runs only on a CUDA card: its test carries the ``cuda``
marker and skips here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deeplearning4j_tpu.nlp.pallas_scatter import scatter_add_pallas

from deeplearning4j_tpu_torch.perf.kernels import scatter_add as sa


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the scatter_add kernel has no CPU mode")
    return torch.device("cuda")


def _zipf_idx(rng, V, N):
    p = 1.0 / np.arange(1, V + 1)
    return rng.choice(V, N, p=p / p.sum()).astype(np.int32)


def _operands(seed, V, D, N, idx_kind="zipf"):
    """Table and gradients with magnitudes over ~40 decades and signed
    zeros; indices Zipf-distributed, uniform, or all into one row."""
    rng = np.random.default_rng(seed)

    def spread(shape):
        a = rng.standard_normal(shape) * 10.0 ** rng.integers(-20, 20, shape)
        return a.astype(np.float32)

    table, grads = spread((V, D)), spread((N, D))
    table[rng.random((V, D)) < 0.1] = -0.0
    grads[rng.random((N, D)) < 0.1] = 0.0
    grads[rng.random((N, D)) < 0.05] = -0.0
    if idx_kind == "zipf":
        idx = _zipf_idx(rng, V, N)
    elif idx_kind == "one_row":
        idx = np.full(N, V // 2, np.int32)
    else:
        idx = rng.integers(0, V, N).astype(np.int32)
    return table, idx, grads


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


CASES = [
    (50, 8, 96, "uniform"), (50, 8, 50, "uniform"), (10_000, 128, 8192, "zipf"),
    (40, 1, 300, "zipf"), (40, 33, 300, "zipf"), (1, 16, 64, "uniform"),
    (30, 12, 200, "one_row"), (7, 128, 1, "uniform"),
]


@pytest.mark.parametrize("V,D,N,kind", CASES)
def test_plain_matches_jax_bitwise(V, D, N, kind):
    table, idx, grads = _operands(V * 7 + D * 3 + N, V, D, N, kind)
    want = np.asarray(scatter_add_pallas(jnp.asarray(table), jnp.asarray(idx),
                                         jnp.asarray(grads)))
    t = torch.from_numpy(table.copy())
    out = sa.scatter_add_plain(t, torch.from_numpy(idx), torch.from_numpy(grads))
    assert out is t  # in place
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))


def test_plain_int64_indices_and_out_of_range_rows_dropped():
    """int64 indices give the same bits; an index past the table is
    dropped, as XLA's scatter drops it."""
    table, idx, grads = _operands(3, 20, 4, 120, "uniform")
    idx[[5, 17, 90]] = [20, 25, 1000]
    want = np.asarray(jnp.asarray(table).at[jnp.asarray(idx)].add(jnp.asarray(grads)))
    for dt in (torch.int32, torch.int64):
        out = sa.scatter_add_plain(torch.from_numpy(table.copy()),
                                   torch.from_numpy(idx).to(dt), torch.from_numpy(grads))
        np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))


def test_wrapper_on_cpu_takes_the_plain_version():
    table, idx, grads = _operands(11, 60, 16, 500)
    before = sa.launches
    got = sa.scatter_add(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                         torch.from_numpy(grads))
    want = sa.scatter_add_plain(torch.from_numpy(table.copy()), torch.from_numpy(idx),
                                torch.from_numpy(grads))
    assert torch.equal(got, want)
    assert sa.launches == before  # no kernel launch on a CPU tensor
    # empty updates leave the table as it was
    t = torch.from_numpy(table.copy())
    sa.scatter_add(t, torch.zeros(0, dtype=torch.int32), torch.zeros((0, 16)))
    np.testing.assert_array_equal(_bits(t.numpy()), _bits(table))


def test_wrapper_checks_its_operands():
    t = torch.zeros((4, 3))
    i = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        sa.scatter_add(t.double(), i, torch.zeros((2, 3), dtype=torch.float64))
    with pytest.raises(TypeError):
        sa.scatter_add(t, i.float(), torch.zeros((2, 3)))
    with pytest.raises(ValueError):
        sa.scatter_add(t, i, torch.zeros((3, 3)))
    with pytest.raises(ValueError):
        sa.scatter_add(t.t(), i, torch.zeros((2, 4)))  # not contiguous


@pytest.mark.cuda
@pytest.mark.parametrize("V,D,N,kind", CASES + [(10_000, 128, 40_960, "zipf"),
                                                (1000, 130, 1001, "uniform")])
def test_kernel_matches_plain_bitwise(cuda_device, V, D, N, kind):
    table, idx, grads = _operands(V + D + N, V, D, N, kind)
    args = (torch.from_numpy(idx).to(cuda_device), torch.from_numpy(grads).to(cuda_device))
    before = sa.launches
    got = sa.scatter_add(torch.from_numpy(table).to(cuda_device), *args)
    again = sa.scatter_add(torch.from_numpy(table).to(cuda_device), *args)
    want = sa.scatter_add_plain(torch.from_numpy(table).to(cuda_device), *args)
    torch.cuda.synchronize()
    assert sa.launches == before + 2
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
