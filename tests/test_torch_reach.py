"""PyTorch port: the parallel parse against the JAX package.

- The plain versions of the chunked-reachability kernels
  (``reach_kernel.chunk_pointer_tables``/``chunk_mark``) equal the JAX
  Pallas kernels in interpret mode exactly, and the whole chunked pass
  equals the serial greedy chain.
- The pointer-doubling branches and the chunked dispatch of the port's
  ``greedy_reachability`` equal the JAX function.
- Hashes, candidate search (both scatter branches) and ``parse_frame``
  (levels 1, 3, 9, 19, and with a prefix region) equal the JAX functions
  on all outputs.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

from zeekstd_tpu.ops import match_tpu as ref_mt
from zeekstd_tpu.ops import pallas_kernels as ref_pk
from zeekstd_tpu_torch.ops import match_tpu as mt
from zeekstd_tpu_torch.ops import reach_kernel as rk

from .torch_threads import two_torch_threads  # noqa: F401

BLOCK = 32 << 10


def _reach_serial(step, n, block):
    """Serial greedy chain per block: the ground truth."""
    reach = np.zeros(n, bool)
    for b0 in range(0, n, block):
        p, end = b0, min(b0 + block, n)
        while p < end:
            reach[p] = True
            p += step[p]
    return reach


def _steps(seed, n, block, parse_like=False):
    rng = np.random.default_rng(seed)
    if parse_like:
        # Literal runs (1) and capped matches, as a real parse gives.
        step = np.ones(n, np.int32)
        idx = rng.choice(n, n // 5, replace=False)
        step[idx] = rng.integers(4, 25, len(idx))
    else:
        step = rng.integers(1, rk.SMAX + 1, n).astype(np.int32)
    room = block - (np.arange(n) % block)  # steps never cross a block
    return np.minimum(step, room).astype(np.int32)


# The cases of tests/test_pallas_kernels.py, and a parse-shaped one.
CASES = [(0, 1024, 1024, False), (1, 4096, 1024, False), (2, 8192, 8192, False),
         (3, 16384, 4096, False), (42, 32768, 8192, True)]


@pytest.mark.parametrize("seed,n,block,parse_like", CASES)
def test_reach_kernels_equal_jax_kernels_and_serial_chain(seed, n, block, parse_like):
    step = _steps(seed, n, block, parse_like)
    step2 = step.reshape(-1, rk.CHUNK)
    tables = rk.chunk_pointer_tables(torch.from_numpy(step2))
    ref_tables = np.asarray(ref_pk.chunk_pointer_tables(jnp.asarray(step2), interpret=True))
    np.testing.assert_array_equal(tables.numpy(), ref_tables)

    rng = np.random.default_rng(seed + 100)
    entry2 = np.repeat(rng.integers(0, rk.SMAX, (step2.shape[0], 1)), rk.CHUNK, axis=1)
    entry2 = entry2.astype(np.int32)
    mask = rk.chunk_mark(tables, torch.from_numpy(entry2))
    ref_mask = ref_pk.chunk_mark(jnp.asarray(ref_tables), jnp.asarray(entry2), interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))

    got = rk.reachability_chunked(torch.from_numpy(step), n, block).numpy()
    want = np.asarray(ref_pk.reachability_chunked(jnp.asarray(step), n, block, interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _reach_serial(step, n, block))


def test_reach_tables_saturate_like_jax():
    """Values past the chunk stay put; odd steps (0, negative, past SMAX)
    index like the TPU kernel (clip to the chunk)."""
    rng = np.random.default_rng(9)
    step2 = rng.integers(-40, 200, (16, rk.CHUNK)).astype(np.int32)
    tables = rk.chunk_pointer_tables(torch.from_numpy(step2))
    ref_tables = np.asarray(ref_pk.chunk_pointer_tables(jnp.asarray(step2), interpret=True))
    np.testing.assert_array_equal(tables.numpy(), ref_tables)
    entry2 = rng.integers(-5, 140, (16, rk.CHUNK)).astype(np.int32)
    mask = rk.chunk_mark(tables, torch.from_numpy(entry2))
    ref_mask = ref_pk.chunk_mark(jnp.asarray(ref_tables), jnp.asarray(entry2), interpret=True)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.mark.parametrize("n,block,step_max", [
    (3000, None, None),     # one row, no block factoring
    (3000, 32768, None),    # block larger than the row
    (10000, 4096, None),    # block rows with a padded tail
    (16384, 4096, 24),      # the chunked route
    (16384, 4096, 40),      # step cap over SMAX: pointer doubling
])
def test_greedy_reachability_equals_jax(n, block, step_max):
    blk = block or n
    steps = np.stack([_steps(s, n, blk, parse_like=True) for s in (5, 6)])
    got = mt.greedy_reachability(torch.from_numpy(steps), n, block, step_max=step_max)
    for f in range(2):
        want = ref_mt.greedy_reachability(jnp.asarray(steps[f]), n, block, step_max=step_max)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))
        np.testing.assert_array_equal(got[f].numpy(), _reach_serial(steps[f], n, blk))


def _text(n, seed=12):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    text = b" ".join(words[rng.integers(0, 300)] for _ in range(n // 4))
    mixed = (text[: n // 2] + b"Q" * 700 + bytes(rng.integers(0, 256, n // 8, dtype=np.uint8))
             + b"0123,4567," * (n // 10) + text[n // 2 :])
    return np.frombuffer(mixed[:n], np.uint8).copy()


def test_hashes_and_words_equal_jax():
    data = _text(5000)
    t = torch.from_numpy(data)[None, :]
    d = jnp.asarray(data)
    np.testing.assert_array_equal(mt.precompute_words(t)[0].numpy(),
                                  np.asarray(ref_mt.precompute_words(d)))
    for fn, ref in ((mt.hash_positions_tpu, ref_mt.hash_positions_tpu),
                    (mt.hash_positions_4, ref_mt.hash_positions_4),
                    (mt.hash_positions_long, ref_mt.hash_positions_long)):
        np.testing.assert_array_equal(fn(t)[0].numpy(), np.asarray(ref(d)))


@pytest.mark.parametrize("cap,cont_words,depths", [(16, 1, 2), (32, 2, 4), (64, 2, 2)])
def test_sorted_hash_matches_equal_jax(cap, cont_words, depths):
    """cap 64 takes the three-scatter branch (mlen_max over 63)."""
    data = _text(12000)
    t = torch.from_numpy(data)[None, :]
    h = mt.hash_positions_tpu(t)
    got = mt.sorted_hash_matches(t, h, depths, 4096, torch.tensor([11000]), cap=cap,
                                 cont_words=cont_words)
    want = ref_mt.sorted_hash_matches(jnp.asarray(data), ref_mt.hash_positions_tpu(jnp.asarray(data)),
                                      depths, 4096, 11000, cap=cap, cont_words=cont_words)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


@pytest.mark.parametrize("level,start", [(1, 0), (3, 0), (9, 0), (19, 0), (3, BLOCK)])
def test_parse_frame_equals_jax(level, start):
    n = 2 * BLOCK
    rows = np.stack([_text(n, 12), _text(n, 13)])
    if start:
        rows[1, :start] = rows[0, start:]  # the prefix region repeats frame bytes
    n_valid = np.array([n, start + 20000], np.int64)
    seq_bound = 4096
    got = mt.parse_frame(torch.from_numpy(rows), BLOCK, seq_bound,
                         n_valid=torch.from_numpy(n_valid), level=level, start=start)
    for f in range(2):
        want = ref_mt.parse_frame(jnp.asarray(rows[f]), BLOCK, seq_bound,
                                  n_valid=int(n_valid[f]), level=level, start=start)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[f].numpy(), np.asarray(w))


def test_rep1_offset_values_equal_jax():
    rng = np.random.default_rng(4)
    sb = 256
    lls = rng.integers(0, 40, (2, sb))
    written = np.where(rng.random((2, sb)) < 0.2, 0, lls)
    mls = rng.integers(4, 60, (2, sb))
    offs = np.where(rng.random((2, sb)) < 0.4, 17, rng.integers(1, 5000, (2, sb)))
    n_seq = np.array([200, 256])
    got = mt.rep1_offset_values(*(torch.from_numpy(a) for a in (lls, written, mls, offs, n_seq)),
                                2048, sb)
    for f in range(2):
        want = ref_mt.rep1_offset_values(
            *(jnp.asarray(a[f].astype(np.int32)) for a in (lls, written, mls, offs)),
            int(n_seq[f]), 2048, sb)
        np.testing.assert_array_equal(got[f].numpy(), np.asarray(want))
