"""PyTorch port: the FSE sequence encoder against the JAX FSE kernel.

The inputs are the ones the port's level-1 encode gives the kernel (match
rows, job records and encode-table pool staged by ``_fse_kernel_inputs``);
the same numpy arrays go through the JAX kernel in interpret mode. Words
must be equal up to each job's bit count, and the bit counts exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu import tpu_archive as ref_archive
from zeekstd_tpu.ops import fse_kernel as ref_fk
from zeekstd_tpu_torch import archive
from zeekstd_tpu_torch.ops import fse_kernel as fk

from .torch_threads import two_torch_threads  # noqa: F401


def _data():
    rng = np.random.default_rng(33)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    text = b" ".join(words[rng.integers(0, 300)] for _ in range(12000))
    return (text[:60000] + b"Z" * 2000 + bytes(rng.integers(0, 256, 8000, dtype=np.uint8))
            + b"abcd" * 3000 + text[60000:])[: 96 << 10]


@pytest.fixture(scope="module")
def case():
    calls = []
    orig = fk.fse_encode

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    fk.fse_encode = rec
    try:
        archive.compress_archive(_data(), frame_size=64 << 10, level=1, device="cpu")
    finally:
        fk.fse_encode = orig
    (a, k), = calls
    consts, meta, lm, ofv, tables = (t.numpy() for t in a)
    nrecj = meta.shape[0]
    kern = ref_fk.get_fse_kernel(k["SBd"], k["WBo"], nrecj, interpret=True)
    words, bits = kern(consts, meta, lm.reshape(-1), ofv.reshape(-1), tables)
    return {"args": a, "kw": k, "ref_words": np.asarray(words), "ref_bits": np.asarray(bits)}


def test_consts_tables_and_buckets_match_reference():
    np.testing.assert_array_equal(fk.make_consts(), ref_fk.make_consts())
    rng = np.random.default_rng(1)
    dnb, dfs, stt = (rng.integers(-999, 999, n).astype(np.int32) for n in (64, 64, 512))
    np.testing.assert_array_equal(fk.pack_enc_table(dnb, dfs, stt),
                                  ref_fk.pack_enc_table(dnb, dfs, stt))
    for n in (1, 9, 300, 5000):
        assert fk.bucket_nrecj(n) == ref_fk.bucket_nrecj(n)
    SBd = 8192
    assert fk.word_bound(SBd) == 1 << (((SBd * 88) // 32 + 16) - 1).bit_length()


def test_bit_counts_equal(case):
    _words, bits = fk.fse_encode(*case["args"], **case["kw"])
    np.testing.assert_array_equal(bits.numpy(), case["ref_bits"])
    assert (case["ref_bits"] > 0).sum() == 3  # every block of the input


def test_words_equal_up_to_bits(case):
    words, _bits = fk.fse_encode(*case["args"], **case["kw"])
    got = words.numpy().view(np.uint32)
    for j, nb in enumerate(case["ref_bits"]):
        if nb:
            n = int(nb) // 32 + 1
            np.testing.assert_array_equal(got[j, :n], case["ref_words"][j, :n])


def test_job_staging_matches_reference():
    """``_fse_kernel_inputs`` builds the same records and table pool as the
    reference's from the same job list."""
    calls = {}
    orig = archive._fse_kernel_inputs

    def rec(jobs, B):
        calls["jobs"], calls["B"] = jobs, B
        return orig(jobs, B)

    archive._fse_kernel_inputs = rec
    try:
        archive.compress_archive(_data()[:40000], frame_size=32 << 10, level=1,
                                 device="cpu")
    finally:
        archive._fse_kernel_inputs = orig
    got = orig(calls["jobs"], calls["B"])
    ref = ref_archive._fse_kernel_inputs(calls["jobs"], calls["B"])
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(r))


def test_plain_version_on_tensors_of_the_given_device(case):
    words, bits = fk.fse_encode(*case["args"], **case["kw"])
    assert words.dtype == torch.int32 and bits.dtype == torch.int32
    assert words.device.type == "cpu"
