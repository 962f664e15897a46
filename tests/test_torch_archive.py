"""PyTorch port: the archive path end to end against the JAX package.

Encode: ``compress_archive(level=1, device="cpu")`` must be byte-identical
to ``tpu_compress_archive(level=1)`` on its match-kernel route (JAX kernels
in interpret mode), with checksums on and off, with and without explicit
frame spans, and for empty input; libzstd must decode every frame.
Decode: ``decompress_archive`` on both routes, with and without the seek
table, must return the data (as the JAX decoder does), ``decode_frames``
the right byte ranges, and hostile archives must fail the same way in
both packages.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.errors import ZeekstdError as RefZeekstdError
from zeekstd_tpu.seek_table import Format as RefFormat
from zeekstd_tpu.tpu_archive import tpu_compress_archive, tpu_decompress_archive
from zeekstd_tpu_torch import archive
from zeekstd_tpu_torch.errors import ZeekstdError
from zeekstd_tpu_torch.seek_table import Format

from .oracle import zstd_decompress
from .torch_threads import two_torch_threads  # noqa: F401

FRAME = 32 << 10


def _data():
    rng = np.random.default_rng(55)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    text = b" ".join(words[rng.integers(0, 200)] for _ in range(16000))
    return (text[:40000] + b"R" * 3000 + bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
            + b"abcabcabc" * 1000 + text[40000:])[: 88 << 10]


# Spans of at most 32 KiB keep the row width (and the JAX kernels' compiled
# shapes) of the uniform configurations.
SPANS = [(0, 30000), (30000, 0), (30000, 20000), (50000, 32768), (82768, (88 << 10) - 82768)]
CONFIGS = {"plain": dict(checksum=False), "checksum": dict(checksum=True),
           "spans": dict(checksum=True, frame_spans=SPANS)}


@pytest.fixture(scope="module")
def ref(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ZEEKSTD_TPU_MATCH", "kernel")
    mp.setenv("ZEEKSTD_TPU_EXEC", "fused")
    mp.setenv("ZEEKSTD_TPU_RING", "1")
    request.addfinalizer(mp.undo)
    data = _data()
    out = {"data": data}
    for name, kw in CONFIGS.items():
        out[name] = tpu_compress_archive(data, frame_size=FRAME, level=1, **kw)
    blob, st = out["checksum"]
    out["dec_ring"] = tpu_decompress_archive(blob, st)
    mp.setenv("ZEEKSTD_TPU_RING", "0")
    out["dec_wide"] = tpu_decompress_archive(blob)
    mp.setenv("ZEEKSTD_TPU_RING", "1")
    return out


def _port(data, **kw):
    return archive.compress_archive(data, frame_size=FRAME, level=1, device="cpu", **kw)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_encode_byte_identical_to_reference(ref, config):
    blob, st = _port(ref["data"], **CONFIGS[config])
    ref_blob, ref_st = ref[config]
    assert blob == ref_blob
    assert st.to_bytes(Format.FOOT) == ref_st.to_bytes(RefFormat.FOOT)
    assert st.to_bytes(Format.HEAD) == ref_st.to_bytes(RefFormat.HEAD)


@pytest.mark.parametrize("checksum", [False, True])
def test_empty_input_matches_reference(checksum):
    blob, st = archive.compress_archive(b"", level=1, checksum=checksum, device="cpu")
    ref_blob, ref_st = tpu_compress_archive(b"", level=1, checksum=checksum)
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    assert archive.decompress_archive(blob, st, device="cpu") == b""


def test_libzstd_decodes_every_frame(ref):
    port_blob, st = _port(ref["data"], checksum=True)
    parts = [
        zstd_decompress(port_blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                        st.frame_size_decomp(i))
        for i in range(st.num_frames)
    ]
    assert b"".join(parts) == ref["data"]


@pytest.mark.parametrize("route", ["ring", "wide"])
@pytest.mark.parametrize("with_table", [True, False])
def test_decode_equals_data_and_reference(ref, monkeypatch, route, with_table):
    monkeypatch.setenv("ZEEKSTD_TPU_RING", "1" if route == "ring" else "0")
    blob, st = _port(ref["data"], checksum=True)
    out = archive.decompress_archive(blob, st if with_table else None, device="cpu")
    assert out == ref["data"] == ref[f"dec_{route}"]


def test_decode_with_appended_seek_table(ref):
    blob, st = _port(ref["data"], checksum=True)
    full = blob + st.to_bytes(Format.FOOT)
    parsed = archive.SeekTable.from_bytes(full)
    assert archive.decompress_archive(full, parsed, device="cpu") == ref["data"]
    assert archive.decompress_archive(full, device="cpu") == ref["data"]


def test_decode_frames_returns_byte_ranges(ref):
    data = ref["data"]
    blob, st = _port(data, checksum=True)
    idx = [2, 0, 1]
    spans = [(st.frame_start_comp(i), st.frame_end_comp(i)) for i in idx]
    parts = archive.decode_frames(blob, spans, device="cpu")
    assert parts == [data[st.frame_start_decomp(i) : st.frame_end_decomp(i)] for i in idx]


def _outcome(decode, blob, original):
    try:
        out = decode(blob)
    except (ZeekstdError, RefZeekstdError) as e:
        return ("error", getattr(e, "name", type(e).__name__))
    except OverflowError:
        return ("error", "OverflowError")
    return ("intact",) if out == original else ("silent",)


def _parity(ref_blob, ref_st, port_blob, port_st, cases, original):
    for mutated in cases:
        got = _outcome(lambda b: archive.decompress_archive(b, port_st, device="cpu"),
                       bytes(mutated), original)
        want = _outcome(lambda b: tpu_decompress_archive(b, ref_st), bytes(mutated), original)
        assert got != ("silent",)
        assert got == want


def test_archive_mutations_fail_like_reference(ref):
    data = ref["data"]
    ref_blob, ref_st = ref["checksum"]
    blob, st = _port(data, checksum=True)
    assert blob == ref_blob
    rng = random.Random(2)
    cases = []
    for _ in range(16):
        mutated = bytearray(blob)
        for _k in range(rng.randrange(1, 4)):
            mutated[rng.randrange(len(mutated))] ^= 1 << rng.randrange(8)
        cases.append(mutated)
    _parity(ref_blob, ref_st, blob, st, cases, data)


def test_archive_truncation_fails_like_reference(ref):
    data = ref["data"]
    ref_blob, ref_st = ref["checksum"]
    blob, st = _port(data, checksum=True)
    assert blob == ref_blob
    cases = [blob[: int(len(blob) * frac)] for frac in (0.1, 0.45, 0.8, 0.99)]
    _parity(ref_blob, ref_st, blob, st, cases, data)


@pytest.mark.parametrize("kw", [
    dict(level=3), dict(level=1, prefix=b"p" * 40000), dict(level=1, frame_size=48 << 10),
    dict(level=1, frame_size=16 << 20),
])
def test_formerly_refused_inputs_match_reference(monkeypatch, kw):
    """Level 3, a prefix, and frame sizes the match kernel does not take
    go through the parallel parse, byte-identical to the reference."""
    monkeypatch.setenv("ZEEKSTD_TPU_MATCH", "kernel")
    kw = {"frame_size": FRAME, **kw}
    data = b"x" * 5000
    blob, st = archive.compress_archive(data, device="cpu", **kw)
    ref_blob, ref_st = tpu_compress_archive(data, **kw)
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    if "prefix" in kw:
        assert archive.decompress_frame(blob, prefix=kw["prefix"], device="cpu") == (data, len(blob))
    else:
        assert archive.decompress_archive(blob, st, device="cpu") == data


def test_overflowing_frame_matches_reference(monkeypatch):
    """Sequences every 5 bytes overflow the 32 KiB frame's sequence bound:
    the frame is encoded on the host, as the reference does."""
    monkeypatch.setenv("ZEEKSTD_TPU_MATCH", "kernel")
    rng = np.random.default_rng(3)
    data = b"".join(b"abcd" + bytes([int(x)]) for x in rng.integers(0, 256, 6500))
    blob, st = archive.compress_archive(data, frame_size=FRAME, level=1, device="cpu")
    ref_blob, ref_st = tpu_compress_archive(data, frame_size=FRAME, level=1)
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    assert archive.decompress_archive(blob, st, device="cpu") == data


def test_default_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        archive.compress_archive(b"abc" * 100, level=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        archive.decompress_archive(b"")
