"""PyTorch port: patch-mode archives, odd frame sizes and overflowing
frames against the JAX package.

- With a 40 000-byte prefix (of which the last 32 KiB block is searched)
  at levels 1 and 3, ``compress_archive`` is byte-identical to
  ``tpu_compress_archive``, and every frame comes back through
  ``decompress_frame(prefix=...)`` on both fused routes with the bytes of
  the JAX package's ``tpu_decompress_frame`` on its fused route.
- Level 1 with frame sizes the match kernel does not take (48 KiB, 16 MiB)
  takes the parallel parse, as in the reference.
- A frame whose parse overflows the sequence bound is encoded on the
  host, as in the reference.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from zeekstd_tpu.seek_table import Format as RefFormat
from zeekstd_tpu.tpu_archive import tpu_compress_archive
from zeekstd_tpu.tpu_codec import tpu_decompress_frame
from zeekstd_tpu_torch import archive
from zeekstd_tpu_torch.codec.compress import compress_frame
from zeekstd_tpu_torch.seek_table import Format

from .oracle import zstd_decompress
from .torch_threads import two_torch_threads  # noqa: F401

FRAME = 32 << 10


def _new_and_old():
    """A 72 KiB file and the 40 000-byte "old" file it was edited from:
    the old bytes reappear in it with seeded overwrites."""
    rng = np.random.default_rng(21)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(300)]
    text = b" ".join(words[rng.integers(0, 300)] for _ in range(20000))
    old = text[:40000]
    new = bytearray(old[5000:] + text[60000:] + old[:20000])[: 72 << 10]
    for p in rng.integers(0, len(new) - 8, 120):
        new[p : p + 8] = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
    return bytes(new), old


def _overflowing():
    """Sequences every 5 bytes overflow the 32 KiB frame's sequence bound."""
    rng = np.random.default_rng(3)
    return b"".join(b"abcd" + bytes([int(x)]) for x in rng.integers(0, 256, 6500))


CONFIGS = {
    "prefix_L1": dict(frame_size=FRAME, level=1, checksum=True, patch=True),
    "prefix_L3": dict(frame_size=FRAME, level=3, checksum=True, patch=True),
    "prefix_L3_nock": dict(frame_size=FRAME, level=3, patch=True),
    "frame48k_L1": dict(frame_size=48 << 10, level=1, checksum=True),
    "frame16m_L1": dict(frame_size=16 << 20, level=1),
    "overflow_L1": dict(frame_size=FRAME, level=1, checksum=True, overflow=True),
    "overflow_L3": dict(frame_size=FRAME, level=3, overflow=True),
}


def _inputs(kw):
    kw = dict(kw)
    new, old = _new_and_old()
    data = _overflowing() if kw.pop("overflow", False) else new
    if kw.pop("patch", False):
        kw["prefix"] = old
    return data, kw


@pytest.fixture(scope="module")
def ref(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ZEEKSTD_TPU_MATCH", "kernel")
    mp.setenv("ZEEKSTD_TPU_EXEC", "fused")
    request.addfinalizer(mp.undo)
    out = {}
    for name, kw in CONFIGS.items():
        data, kw = _inputs(kw)
        out[name] = tpu_compress_archive(data, **kw)
    return out


@pytest.fixture(scope="module")
def port():
    out = {}
    for name, kw in CONFIGS.items():
        data, kw = _inputs(kw)
        out[name] = archive.compress_archive(data, device="cpu", **kw)
    return out


@pytest.mark.parametrize("config", list(CONFIGS))
def test_encode_byte_identical_to_reference(ref, port, config):
    blob, st = port[config]
    ref_blob, ref_st = ref[config]
    assert blob == ref_blob
    assert st.to_bytes(Format.FOOT) == ref_st.to_bytes(RefFormat.FOOT)


def test_overflowing_frame_is_encoded_on_the_host(port):
    """The overflowing frame is the host encoder's level-1 frame, which
    libzstd and the port decode."""
    data, _kw = _inputs(CONFIGS["overflow_L1"])
    blob, st = port["overflow_L1"]
    assert blob == compress_frame(data, level=1, checksum=True)
    assert zstd_decompress(blob, len(data)) == data
    assert archive.decompress_archive(blob, st, device="cpu") == data


@pytest.mark.parametrize("config", ["frame48k_L1", "frame16m_L1", "overflow_L3"])
def test_non_prefix_archives_round_trip(port, config):
    data, _kw = _inputs(CONFIGS[config])
    blob, st = port[config]
    parts = [zstd_decompress(blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                             st.frame_size_decomp(i))
             for i in range(st.num_frames)]
    assert b"".join(parts) == data
    assert archive.decompress_archive(blob, st, device="cpu") == data


@pytest.mark.parametrize("route", ["ring", "wide"])
@pytest.mark.parametrize("config", ["prefix_L1", "prefix_L3"])
def test_decompress_frame_with_prefix_equals_reference(ref, port, monkeypatch, route, config):
    monkeypatch.setenv("ZEEKSTD_TPU_RING", "1" if route == "ring" else "0")
    data, kw = _inputs(CONFIGS[config])
    blob, st = port[config]
    for i in range(st.num_frames):
        pos = st.frame_start_comp(i)
        got = archive.decompress_frame(blob, pos, prefix=kw["prefix"], device="cpu")
        assert got == (data[st.frame_start_decomp(i) : st.frame_end_decomp(i)],
                       st.frame_end_comp(i))
        if route == "wide":  # the reference's own CPU route
            assert got == tpu_decompress_frame(blob, pos, prefix=kw["prefix"])


def test_libzstd_decodes_prefix_frames(port):
    data, kw = _inputs(CONFIGS["prefix_L3"])
    blob, st = port["prefix_L3"]
    parts = [zstd_decompress(blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                             st.frame_size_decomp(i), prefix=kw["prefix"])
             for i in range(st.num_frames)]
    assert b"".join(parts) == data


@pytest.mark.parametrize("route", ["ring", "wide"])
def test_large_prefix_splits_into_literal_records(monkeypatch, route):
    """A prefix over the wide route's 128 KiB literal window still decodes:
    it rides as several literal records."""
    monkeypatch.setenv("ZEEKSTD_TPU_RING", "1" if route == "ring" else "0")
    new, old = _new_and_old()
    prefix = bytes(200 << 10) + old
    blob, st = archive.compress_archive(new[: 20 << 10], frame_size=FRAME, level=3,
                                        prefix=prefix, device="cpu")
    assert archive.decompress_frame(blob, 0, prefix=prefix, device="cpu")[0] == new[: 20 << 10]
