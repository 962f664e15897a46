"""PyTorch port: the wide contract on hostile records, against the JAX kernel.

The wide route's records, bitstream words, table pools and literal pools
for a 48 KiB archive in six 8 KiB frames are captured from the port's
CPU decode, mutated (one mutation per frame, seeded), and fed as the same
numpy arrays to the port's ``wide_decode`` (on the CPU: ``wide_plain``)
and to the JAX decode kernel in interpret mode. meta_out columns 0-2 and
the output bytes up to each frame's total must be equal. A hand-built
record whose first sequence is a match at position 0 is the fourth case.
"""

import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.ops import decode_kernel as ref_dk
from zeekstd_tpu_torch import archive, decode_routes
from zeekstd_tpu_torch.ops import decode_kernel as dk

from .torch_threads import two_torch_threads  # noqa: F401

FRAME = 8 << 10


def _data():
    rng = np.random.default_rng(44)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(150)]
    text = b" ".join(words[rng.integers(0, 150)] for _ in range(8000))
    return (text[:30000] + b"Q" * 4000 + bytes(rng.integers(0, 256, 6000, dtype=np.uint8))
            + b"abcabcab" * 1500 + text[30000:])[: 48 << 10]


@pytest.fixture(scope="module")
def wide_call():
    blob, _st = archive.compress_archive(_data(), frame_size=FRAME, level=1, checksum=True,
                                         device="cpu")
    calls = []
    orig = dk.wide_decode

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    dk.wide_decode = rec
    os.environ["ZEEKSTD_TPU_RING"] = "0"
    try:
        archive.decompress_archive(blob, device="cpu")
    finally:
        dk.wide_decode = orig
        os.environ.pop("ZEEKSTD_TPU_RING", None)
    (a, k), = calls
    return [t.numpy() for t in a], k


def _mutate(kind, meta, words, tables):
    """One seeded mutation of ``kind`` per frame's first KIND_SEQ record."""
    rng = np.random.default_rng(len(kind))
    m = meta.reshape(-1, dk.META_COLS).copy()
    w = words.copy()
    seq = np.nonzero(m[:, dk.M_KIND] == dk.KIND_SEQ)[0]
    assert len(seq) >= 4
    if kind == "counts":
        m[seq[0], dk.M_NSEQ] += 1
        m[seq[1], dk.M_NSEQ] -= 1
        m[seq[2], dk.M_NSEQ] *= 8
        m[seq[3], dk.M_LITN] += 37
        m[seq[4 % len(seq)], dk.M_LITN] -= 41
    elif kind == "bits":
        m[seq[0], dk.M_STARTBIT] += 1
        m[seq[1], dk.M_STARTBIT] -= 33
        # Each log +-1, staying within the 512-entry table rows.
        logs = m[seq[2], dk.M_LOGS]
        m[seq[2], dk.M_LOGS] = sum(min(((logs >> s) & 31) + 1, 9) << s for s in (0, 5, 10))
        r = int(m[seq[3], dk.M_WROW])
        for _ in range(3):
            j = int(rng.integers(0, max(int(m[seq[3], dk.M_STARTBIT]) // 32, 1)))
            w[r, j] ^= np.int32(1 << int(rng.integers(0, 31)))
    else:  # "rows": table and word rows outside their tables
        ntab, nw = tables.shape[0], words.shape[0]
        m[seq[0], dk.M_TLL] = -1
        m[seq[1], dk.M_TOF] = ntab
        m[seq[2], dk.M_TML] = ntab + 5
        m[seq[3], dk.M_WROW] = nw + 2
    return m.reshape(meta.shape), w


def _hand_built():
    """One frame whose first sequence is a match at position 0 (ll code 0,
    then ll 0 or 4 at random; offset code 3; match length 8), then an RLE
    run; a second frame of one literal run."""
    rng = np.random.default_rng(3)
    tabs = np.zeros((3, 512), np.int64)
    tabs[0, 0::2] = 0 | (1 << 8)
    tabs[0, 1::2] = 4 | (1 << 8)
    tabs[1, :] = 3
    tabs[2, :] = 5
    words = rng.integers(0, 1 << 32, (2, 16), dtype=np.uint64).astype(np.uint32).view(np.int32)
    nseq = 6
    meta, _n = dk.build_records([[("seq", 0, nseq, 200, 0, 1, 2, 0, 4 * nseq - 1),
                                  ("rle", 5, 7)], [("lit", 9)]])
    lits = np.zeros((2, 2048, 128), np.int32)
    lits[:, :2, :] = rng.integers(0, 256, (2, 2, 128))
    consts = dk.make_consts()
    return [consts, meta, words, tabs.astype(np.int32), lits], dict(OUTB=8192,
                                                                    LITB=decode_routes.LITB)


@pytest.mark.parametrize("case", ["counts", "bits", "rows", "match_at_0"])
def test_wide_contract_equals_decode_kernel_on_hostile_records(wide_call, case):
    if case == "match_at_0":
        (consts, meta, words, tables, lits), k = _hand_built()
    else:
        (consts, meta, words, tables, lits), k = wide_call
        meta, words = _mutate(case, meta, words, tables)
    kern = ref_dk.get_decode_kernel(words.shape[1], k["LITB"], k["OUTB"], meta.shape[0],
                                    lits.shape[0], lits.shape[1], interpret=True)
    ref_out, ref_meta = (np.asarray(x) for x in kern(consts, meta, words, tables, lits))
    out, meta_out = dk.wide_decode(*(torch.from_numpy(x) for x in
                                     (consts, meta, words, tables, lits)), **k)
    np.testing.assert_array_equal(meta_out.numpy()[:, :3], ref_meta[:, :3])
    assert ref_meta[:, 1].any(), "every case marks a frame bad"
    F = out.shape[0]
    ob, rb = out.numpy().reshape(F, -1), ref_out.reshape(F, -1)
    for f, tot in enumerate(ref_meta[:, 0]):
        np.testing.assert_array_equal(ob[f, :tot], rb[f, :tot])
