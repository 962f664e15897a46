"""PyTorch port: level 2-19 archives through the parallel parse.

``compress_archive(level=L, device="cpu")`` must be byte-identical to the
JAX package's ``tpu_compress_archive(level=L)`` at levels 2, 3, 9 and 19
(checksum on and off), with the default frame size, and with explicit
frame spans. libzstd must decode every frame; the port's decoder must
give the input back on both fused routes, and per frame the bytes of the
JAX package's ``tpu_decompress_frame`` on its fused route.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from zeekstd_tpu.seek_table import Format as RefFormat
from zeekstd_tpu.tpu_archive import tpu_compress_archive
from zeekstd_tpu.tpu_codec import tpu_decompress_frame
from zeekstd_tpu_torch import archive
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


SPANS = [(0, 30000), (30000, 0), (30000, 20000), (50000, 32768), (82768, (88 << 10) - 82768)]
CONFIGS = {f"L{lv}{'c' if ck else ''}": dict(frame_size=FRAME, level=lv, checksum=ck)
           for lv in (2, 3, 9, 19) for ck in (False, True)}
CONFIGS["default_frame"] = dict(checksum=True)
CONFIGS["spans"] = dict(frame_size=FRAME, level=3, checksum=True, frame_spans=SPANS)


@pytest.fixture(scope="module")
def ref(request):
    mp = pytest.MonkeyPatch()
    mp.setenv("ZEEKSTD_TPU_MATCH", "kernel")
    mp.setenv("ZEEKSTD_TPU_EXEC", "fused")
    request.addfinalizer(mp.undo)
    data = _data()
    out = {"data": data}
    for name, kw in CONFIGS.items():
        out[name] = tpu_compress_archive(data, **kw)
    return out


@pytest.fixture(scope="module")
def port(ref):
    return {name: archive.compress_archive(ref["data"], device="cpu", **kw)
            for name, kw in CONFIGS.items()}


@pytest.mark.parametrize("config", list(CONFIGS))
def test_encode_byte_identical_to_reference(ref, port, config):
    blob, st = port[config]
    ref_blob, ref_st = ref[config]
    assert blob == ref_blob
    assert st.to_bytes(Format.FOOT) == ref_st.to_bytes(RefFormat.FOOT)


@pytest.mark.parametrize("config", ["L2", "L9c", "L19", "default_frame", "spans"])
def test_libzstd_decodes_every_frame(ref, port, config):
    blob, st = port[config]
    parts = [zstd_decompress(blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                             st.frame_size_decomp(i))
             for i in range(st.num_frames)]
    assert b"".join(parts) == ref["data"]


@pytest.mark.parametrize("route", ["ring", "wide"])
@pytest.mark.parametrize("config", ["L3c", "L19c", "default_frame"])
def test_decode_routes_give_the_input_back(ref, port, monkeypatch, route, config):
    monkeypatch.setenv("ZEEKSTD_TPU_RING", "1" if route == "ring" else "0")
    blob, st = port[config]
    assert archive.decompress_archive(blob, st, device="cpu") == ref["data"]
    assert archive.decompress_archive(blob, device="cpu") == ref["data"]


def test_decompress_frame_equals_reference(ref, port):
    blob, st = port["L9c"]
    for i in range(st.num_frames):
        pos = st.frame_start_comp(i)
        got, end = archive.decompress_frame(blob, pos, device="cpu")
        want, ref_end = tpu_decompress_frame(blob, pos)
        assert (got, end) == (want, ref_end) == (
            ref["data"][st.frame_start_decomp(i) : st.frame_end_decomp(i)],
            st.frame_end_comp(i))


def test_staged_input_and_device_rows_on_the_parse_route(ref):
    staged = archive.StagedInput(ref["data"], FRAME, device="cpu")
    blob, st = archive.compress_archive(staged, frame_size=FRAME, level=3)
    assert blob == ref["L3"][0]
    rows, c_sizes, st2 = archive.compress_archive(staged, frame_size=FRAME, level=3,
                                                  return_device=True)
    assert b"".join(rows[f, : c_sizes[f]].numpy().tobytes() for f in range(len(c_sizes))) == blob
    assert st2.to_bytes() == st.to_bytes()
