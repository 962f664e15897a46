"""PyTorch port: the level-1 match finder against the JAX match kernel.

The JAX kernel runs as its own tests run it on the CPU (Pallas interpret
mode, one hash table shared by every record in order); the port's plain
version keeps one table per frame, as the CUDA kernel does. Three frames,
the later ones repeating the first one's bytes, show that the two agree:
every cross-frame candidate must be rejected by its tag. Exact equality.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.ops import fse_kernel as ref_fk
from zeekstd_tpu.ops import match_kernel as ref_mk
from zeekstd_tpu_torch.ops import fse_kernel as fk
from zeekstd_tpu_torch.ops import match_kernel as mk

from .torch_threads import two_torch_threads  # noqa: F401

BLK = 32 << 10
SBd = BLK // 4
FR = 64 << 10


def _frames():
    """Three 64 KiB frame rows, 96 KiB of data: text, an RLE run, random
    bytes and "abc" repeats; frames 1 and 2 reuse frame 0's bytes."""
    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(120)]
    text = b" ".join(words[rng.integers(0, 120)] for _ in range(6000))
    f0 = (text[:24000] + b"A" * 3000 + bytes(rng.integers(0, 256, 9000, dtype=np.uint8))
          + b"abc" * 4000)[: 48 << 10]
    f1 = (f0[:10000] + text[30000:40000])[: 24 << 10]
    f2 = (b"abcabcab" * 1000 + f0[20000:24000] + bytes(rng.integers(0, 256, 4000, dtype=np.uint8))
          + text[:20000])[: 24 << 10]
    rows = np.zeros((3, FR), np.uint8)
    lengths = np.zeros(3, np.int32)
    for i, f in enumerate((f0, f1, f2)):
        rows[i, : len(f)] = np.frombuffer(f, np.uint8)
        lengths[i] = len(f)
    return rows, lengths


@pytest.fixture(scope="module")
def case():
    rows, lengths = _frames()
    F, B = rows.shape[0], FR // BLK
    nrecp = ref_mk.bucket_nrecp(F * B)
    meta = ref_mk.build_records(F, B, BLK, FR, lengths, n_pad=nrecp)
    words = np.zeros(nrecp * (BLK // 4), np.int32)
    flat = rows.reshape(-1).view(np.int32)
    words[: flat.size] = flat
    consts = ref_fk.make_consts()
    kern = ref_mk.get_match_kernel(BLK, SBd, nrecp, interpret=True)
    ref = tuple(np.asarray(a) for a in kern(consts, meta, words))
    return {"consts": consts, "meta": meta, "words": words, "F": F, "ref": ref}


def _port(case):
    return mk.match(
        torch.from_numpy(case["consts"]), torch.from_numpy(case["meta"]),
        torch.from_numpy(case["words"]), BLK=BLK, SBd=SBd, n_frames=case["F"],
    )


def test_layout_and_records_match_reference():
    assert (mk.META_COLS, mk.M_FBASE, mk.ST_LITHIST, mk.ST_TRASH, mk.HB) == (
        ref_mk.META_COLS, ref_mk.M_FBASE, ref_mk.ST_LITHIST, ref_mk.ST_TRASH, ref_mk.HB)
    lengths = np.array([70000, 5000, 0], np.int32)
    for n in (1, 7, 200, 1500):
        assert mk.bucket_nrecp(n) == ref_mk.bucket_nrecp(n)
    np.testing.assert_array_equal(
        mk.build_records(3, 4, BLK, 4 * BLK, lengths, n_pad=16),
        ref_mk.build_records(3, 4, BLK, 4 * BLK, lengths, n_pad=16),
    )
    np.testing.assert_array_equal(fk.make_consts(), ref_fk.make_consts())


def test_stat_rows_equal(case):
    _lm, _ofv, _litw, stat = _port(case)
    np.testing.assert_array_equal(stat.numpy(), case["ref"][3])
    # The three frames really parse: sequences in every frame.
    assert (stat.numpy()[: 6, mk.ST_NSEQ].reshape(3, 2).sum(axis=1) > 0).all()


def test_sequence_rows_equal_up_to_nseq(case):
    lm, ofv, _litw, stat = _port(case)
    ref_lm, ref_ofv = case["ref"][0], case["ref"][1]
    for r, n in enumerate(stat.numpy()[:, mk.ST_NSEQ]):
        np.testing.assert_array_equal(lm.numpy()[r, :n], ref_lm[r, :n])
        np.testing.assert_array_equal(ofv.numpy()[r, :n], ref_ofv[r, :n])


def test_literal_rows_equal_up_to_litcnt(case):
    _lm, _ofv, litw, stat = _port(case)
    got = litw.numpy().view(np.uint8)
    ref = case["ref"][2].view(np.uint8)
    for r, n in enumerate(stat.numpy()[:, mk.ST_LITCNT]):
        np.testing.assert_array_equal(got[r, :n], ref[r, :n])


def test_cpu_tensor_takes_plain_version_without_counting(case):
    from zeekstd_tpu_torch import ops

    before = ops.launches["match"]
    _port(case)
    assert ops.launches["match"] == before
