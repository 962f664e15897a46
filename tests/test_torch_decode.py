"""PyTorch port: the fused decoders against the JAX ring and decode kernels.

For each archive (the port's own, and libzstd frames at levels 1, 3 and 6
with 8 KiB blocks so repeat offsets cross block boundaries) the port's
decoder is run on the CPU on both routes; the records, bitstream words,
table pools and literal pools it hands to each kernel wrapper are then
fed, as the same numpy arrays, to the matching JAX kernel in interpret
mode. Output bytes up to each frame's total and meta_out columns 0-2
must be equal.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.ops import decode_kernel as ref_dk
from zeekstd_tpu.ops import ring_kernel as ref_rk
from zeekstd_tpu_torch import archive, decode_routes
from zeekstd_tpu_torch.ops import decode_kernel as dk
from zeekstd_tpu_torch.ops import ring_kernel as rk

from .oracle import zstd_compress
from .torch_threads import two_torch_threads  # noqa: F401

CASES = ("own", "zstd1", "zstd3", "zstd6")


def _data():
    rng = np.random.default_rng(44)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(150)]
    text = b" ".join(words[rng.integers(0, 150)] for _ in range(8000))
    return (text[:30000] + b"Q" * 4000 + bytes(rng.integers(0, 256, 6000, dtype=np.uint8))
            + b"abcabcab" * 1500 + text[30000:])[: 48 << 10]


def _blob(case):
    data = _data()
    if case == "own":
        blob, _st = archive.compress_archive(data, frame_size=32 << 10, level=1,
                                             checksum=True, device="cpu")
    else:
        blob = zstd_compress(data[: 32 << 10], int(case[4:]), window_log=13)
    return blob


def _capture(blob, ring):
    mod, attr = (rk, "ring_decode") if ring else (dk, "wide_decode")
    orig = getattr(mod, attr)
    calls = []

    def rec(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    setattr(mod, attr, rec)
    if not ring:
        os.environ["ZEEKSTD_TPU_RING"] = "0"
    try:
        archive.decompress_archive(blob, device="cpu")
    finally:
        setattr(mod, attr, orig)
        os.environ.pop("ZEEKSTD_TPU_RING", None)
    (a, k), = calls
    return a, k


@pytest.fixture(scope="module")
def cases():
    out = {}
    for case in CASES:
        blob = _blob(case)
        a, k = _capture(blob, ring=True)
        consts, meta, words, tables, litw = (t.numpy() for t in a)
        kern = ref_rk.get_ring_kernel(words.shape[1], decode_routes.LITB, k["OUTB"],
                                      meta.shape[0], litw.shape[0], litw.shape[1],
                                      interpret=True)
        ring_ref = tuple(np.asarray(x) for x in kern(consts, meta, words, tables, litw))
        aw, kw = _capture(blob, ring=False)
        consts, meta, words, tables, lits = (t.numpy() for t in aw)
        kern = ref_dk.get_decode_kernel(words.shape[1], kw["LITB"], kw["OUTB"],
                                        meta.shape[0], lits.shape[0], lits.shape[1],
                                        interpret=True)
        wide_ref = tuple(np.asarray(x) for x in kern(consts, meta, words, tables, lits))
        out[case] = SimpleNamespace(ring=(a, k, ring_ref), wide=(aw, kw, wide_ref))
    return out


def _check(out_bytes, meta_out, ref_bytes, ref_meta):
    np.testing.assert_array_equal(meta_out[:, :3], ref_meta[:, :3])
    assert (ref_meta[:, 1] == 0).all() and (ref_meta[:, 0] > 0).all()
    for f, tot in enumerate(ref_meta[:, 0]):
        np.testing.assert_array_equal(out_bytes[f, :tot], ref_bytes[f, :tot])


@pytest.mark.parametrize("case", CASES)
def test_ring_contract_equals_ring_kernel(cases, case):
    a, k, (ref_out, ref_meta) = cases[case].ring
    out, meta_out = rk.ring_decode(*a, **k)
    F = out.shape[0]
    _check(out.numpy().view(np.uint8).reshape(F, -1), meta_out.numpy(),
           ref_out.view(np.uint8).reshape(F, -1), ref_meta)


@pytest.mark.parametrize("case", CASES)
def test_wide_contract_equals_decode_kernel(cases, case):
    a, k, (ref_out, ref_meta) = cases[case].wide
    out, meta_out = dk.wide_decode(*a, **k)
    F = out.shape[0]
    _check(out.numpy().reshape(F, -1), meta_out.numpy(), ref_out.reshape(F, -1), ref_meta)


def test_records_and_consts_match_reference():
    np.testing.assert_array_equal(dk.make_consts(), ref_dk.make_consts())
    frames = [
        [("seq", 0, 5, 100, 1, 2, 3, 6 | 5 << 5 | 6 << 10, 77), ("lit", 9)],
        [],
        [("rle", 40, 7), ("seq", 1, 2, 3, 0, 0, 0, 0, 12)],
    ]
    got, n = dk.build_records(frames)
    ref, ref_n = ref_dk.build_records(frames)
    assert n == ref_n
    np.testing.assert_array_equal(got, ref)
    assert rk.RING == ref_rk.RING


def test_route_rule_follows_declared_windows(monkeypatch):
    small = (SimpleNamespace(window_size=1 << 19), None, None)
    wide = (SimpleNamespace(window_size=1 << 20), None, None)
    monkeypatch.delenv("ZEEKSTD_TPU_RING", raising=False)
    assert decode_routes.use_ring_route([small, small], 1 << 20)
    assert not decode_routes.use_ring_route([small, wide], 1 << 20)
    assert not decode_routes.use_ring_route([small], (1 << 27) + 1)
    monkeypatch.setenv("ZEEKSTD_TPU_RING", "0")
    assert not decode_routes.use_ring_route([small], 1 << 20)


def test_rle_and_literal_records_plain():
    """A hand-made frame of an RLE record and a literal record, on both
    routes' rules."""
    consts = torch.from_numpy(dk.make_consts())
    for ring in (True, False):
        meta, _ = dk.build_records([[("rle", 5, 65), ("lit", 3)]])
        pools = [b"xyz"]
        outs, mo = dk.decode_plain(consts, torch.from_numpy(meta),
                                   torch.zeros((2, 16), dtype=torch.int32),
                                   torch.zeros((1, 512), dtype=torch.int32), pools,
                                   4096, ring=ring, LITB=decode_routes.LITB, LROWS=2048)
        assert bytes(outs[0][:8]) == b"AAAAAxyz"
        assert mo[0, :3].tolist() == [8, 0, 3]
