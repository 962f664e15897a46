"""PyTorch port: the byte histogram and table lookup against the JAX
package's Pallas kernels in interpret mode (the cases of
``tests/test_pallas_kernels.py`` and of ``tests/byte_cases.py``), plus
the wrappers' shape checks."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from zeekstd_tpu.ops.pallas_kernels import byte_histogram_pallas, table_lookup_pallas
from zeekstd_tpu_torch.ops import byte_kernels as bk

from . import byte_cases
from .torch_threads import two_torch_threads  # noqa: F401


@pytest.mark.parametrize("case", ["seed0-1block", "seed1-4blocks", "skewed"])
def test_byte_histogram_equals_reference(case):
    block = 1 << 13
    if case == "skewed":
        # Heavily skewed data (long runs): the shape real literals take.
        data = np.repeat(np.arange(8, dtype=np.uint8), 1 << 11)
    else:
        seed, blocks = (0, 1) if case == "seed0-1block" else (1, 4)
        data = np.random.default_rng(seed).integers(0, 256, block * blocks).astype(np.uint8)
    got = bk.byte_histogram(torch.from_numpy(data), block=block)
    ref = byte_histogram_pallas(jnp.asarray(data), block=block, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("case", ["random-table", "huffman-shape"])
def test_table_lookup_equals_reference(case):
    if case == "random-table":
        rng = np.random.default_rng(2)
        data = rng.integers(0, 256, 4096).astype(np.uint8)
        tab = rng.integers(0, 1 << 30, 256).astype(np.int32)
    else:
        # A realistic Huffman nb_bits table (values 1..11).
        rng = np.random.default_rng(3)
        data = rng.integers(0, 64, 2048).astype(np.uint8)
        tab = np.clip(rng.integers(1, 12, 256), 1, 11).astype(np.int32)
    got = bk.table_lookup(torch.from_numpy(data), torch.from_numpy(tab))
    ref = table_lookup_pallas(jnp.asarray(data), jnp.asarray(tab), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), tab[data])


def test_wrappers_refuse_the_reference_kernels_shapes():
    data = torch.zeros(3000, dtype=torch.uint8)
    with pytest.raises(ValueError):
        bk.byte_histogram(data, block=1000)  # n % block != 0
    with pytest.raises(ValueError):
        bk.byte_histogram(torch.zeros(3000, dtype=torch.uint8), block=1500)  # block % 128
    with pytest.raises(ValueError):
        bk.table_lookup(data, torch.zeros(256, dtype=torch.int32))  # n % 1024 != 0
    with pytest.raises(ValueError):
        bk.table_lookup(torch.zeros(1024, dtype=torch.uint8), torch.zeros(128, dtype=torch.int32))


@pytest.mark.parametrize("name", list(byte_cases.HIST))
def test_histogram_cases_equal_reference(name):
    data, block = byte_cases.HIST[name]
    got = bk.byte_histogram(torch.from_numpy(data), block=block)
    ref = byte_histogram_pallas(jnp.asarray(data), block=block, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert got.dtype == torch.int32


@pytest.mark.parametrize("name", list(byte_cases.LOOKUP))
def test_lookup_cases_equal_reference(name):
    """Tables of any integer dtype, and strided ones, give the reference's
    int32 outputs (the reference casts the table with ``astype``)."""
    data, tab = byte_cases.LOOKUP[name]
    got = bk.table_lookup(torch.from_numpy(data), torch.from_numpy(tab))
    ref = table_lookup_pallas(jnp.asarray(data), jnp.asarray(tab), interpret=True)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(got.numpy(), tab.astype(np.int32)[data])
