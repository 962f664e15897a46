"""PyTorch port: the streaming Encoder and Decoder against the JAX package.

- The streaming ``Encoder`` on the ``tpu`` backend (``with_device("cpu")``:
  the kernels' plain versions) writes the JAX package's archive byte for
  byte: uncompressed policy at levels 1 and 3 with 4 KiB frames (a
  ``TPU_BATCH_FRAMES`` flush inside the input), 32 KiB frames at level 1
  (the match kernel's route), the compressed policy in one call and over
  several, and patch mode; the ``python`` backend likewise. The archive is
  ``compress_archive``'s plus its seek table.
- The ``Decoder`` on the ``python`` and ``tpu`` backends serves frame
  ranges, offset windows, ``seek``/``read``, the continue-vs-reset rule,
  a moving offset limit, per-call prefixes and streamed large frames, as
  ``tests/test_streaming.py`` checks them; hostile archives raise the
  JAX package's error names.
- Three faults of ``zeekstd_tpu.encode`` that the port does not copy: the
  compressed policy's frame cap, its re-probing, and input dropped or
  reordered when a prefix arrives mid-stream.
- ``native`` is accepted and writes the JAX package's archive; ``tpu`` with
  no card raises unless asked for the CPU.
"""

import io
import os
import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import zeekstd_tpu as zr
import zeekstd_tpu.encode as ref_enc_mod
import zeekstd_tpu_torch as zt
from zeekstd_tpu.errors import ZeekstdError as RefZeekstdError
from zeekstd_tpu_torch import archive
from zeekstd_tpu_torch import decode as dec_mod
from zeekstd_tpu_torch import encode as enc_mod
from zeekstd_tpu_torch.errors import ZeekstdError

from .oracle import zstd_decompress
from .torch_threads import two_torch_threads  # noqa: F401

# The reference's streaming tests take their own source as input.
with open(os.path.join(os.path.dirname(__file__), "..", "SURVEY.md"), "rb") as _fh:
    INPUT = _fh.read()


def _text(n: int, seed: int = 11) -> bytes:
    """Seeded word text: 400 words of 2-8 letters, drawn at random."""
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(400)]
    return b" ".join(words[rng.integers(0, 400)] for _ in range(n // 4))[:n]


def _repetitive(n: int) -> bytes:
    base = (b"It was the best of times, it was the worst of times, it was the age "
            b"of wisdom, it was the age of foolishness, it was the epoch of belief. ")
    return (base * (n // len(base) + 1))[:n]


TEXT = _text(96 << 10)


def _patch_pair():
    """(old, new): a 40 000-byte file and a 72 KiB edit of it."""
    rng = np.random.default_rng(21)
    old = _text(40000, seed=5)
    new = bytearray(old[5000:] + TEXT[:40000] + old[:20000])[: 72 << 10]
    for p in rng.integers(0, len(new) - 8, 60):
        new[p : p + 8] = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
    return old, bytes(new)


OLD, NEW = _patch_pair()

# name: policy (kind, size), level, checksum, write size (None: one call),
# TPU_BATCH_FRAMES, and patch mode.
CONFIGS = {
    "L1_4k": dict(policy=("uncompressed", 4096), level=1, checksum=True, write=20000),
    "L3_4k": dict(policy=("uncompressed", 4096), level=3, write=20000),
    "L1_32k_match": dict(policy=("uncompressed", 32768), level=1, checksum=True,
                         write=50000, batch=2),
    "compressed_L1": dict(policy=("compressed", 6000), level=1),
    "compressed_L1_writes": dict(policy=("compressed", 4000), level=1,
                                 write=len(TEXT) // 7 + 1),
    "patch_L3": dict(policy=("uncompressed", 32768), level=3, checksum=True, patch=True),
}
UNCOMPRESSED = [k for k, c in CONFIGS.items()
                if c["policy"][0] == "uncompressed" and not c.get("patch")]


def _options(mod, cfg, backend):
    kind, size = cfg["policy"]
    policy = getattr(mod.FrameSizePolicy, kind)(size)
    opts = (mod.EncodeOptions().with_backend(backend).with_frame_size_policy(policy)
            .with_compression_level(cfg["level"]).with_checksum_flag(cfg.get("checksum", False)))
    if mod is zt and backend == "tpu":
        opts = opts.with_device("cpu")
    return opts


def _encode(mod, cfg, backend="tpu"):
    """The archive (frames and Foot seek table) of ``cfg``'s input."""
    data = NEW if cfg.get("patch") else TEXT
    prefix = OLD if cfg.get("patch") else None
    out = io.BytesIO()
    enc = mod.Encoder(_options(mod, cfg, backend), out)
    step = cfg.get("write") or len(data)
    for i in range(0, len(data), step):
        enc.compress_with_prefix(data[i : i + step], prefix)
    enc.finish()
    return out.getvalue()


@pytest.fixture(scope="module", autouse=True)
def reference_routes():
    """The JAX package on the routes the port always takes: the match
    kernel at level 1 and the fused decode."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZEEKSTD_TPU_MATCH", "kernel")
        mp.setenv("ZEEKSTD_TPU_EXEC", "fused")
        yield


@pytest.fixture(scope="module")
def ref():
    """The JAX package's archives, each computed once."""
    out = {}
    for name, cfg in CONFIGS.items():
        with pytest.MonkeyPatch.context() as m:
            m.setattr(zr.RawEncoder, "TPU_BATCH_FRAMES", cfg.get("batch", 8))
            out[name] = _encode(zr, cfg)
    for name in ("L1_4k", "compressed_L1", "patch_L3"):
        out[name, "python"] = _encode(zr, CONFIGS[name], "python")
    return out


@pytest.fixture(scope="module")
def port():
    out = {}
    for name, cfg in CONFIGS.items():
        with pytest.MonkeyPatch.context() as m:
            m.setattr(zt.RawEncoder, "TPU_BATCH_FRAMES", cfg.get("batch", 8))
            out[name] = _encode(zt, cfg)
    for name in ("L1_4k", "compressed_L1", "patch_L3"):
        out[name, "python"] = _encode(zt, CONFIGS[name], "python")
    return out


@pytest.mark.parametrize("config", list(CONFIGS) + [
    ("L1_4k", "python"), ("compressed_L1", "python"), ("patch_L3", "python")])
def test_streaming_archive_equals_reference(ref, port, config):
    assert port[config] == ref[config]


@pytest.mark.parametrize("config", UNCOMPRESSED)
def test_streaming_archive_is_compress_archive_and_table(port, config):
    cfg = CONFIGS[config]
    blob, st = archive.compress_archive(TEXT, frame_size=cfg["policy"][1],
                                        checksum=cfg.get("checksum", False),
                                        level=cfg["level"], device="cpu")
    assert port[config] == blob + st.to_bytes(zt.Format.FOOT)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_streaming_archive_round_trips(port, config):
    """Every frame back through libzstd; the whole through the Decoder on
    both backends; compressed-policy frames near the threshold."""
    cfg = CONFIGS[config]
    data = NEW if cfg.get("patch") else TEXT
    prefix = OLD if cfg.get("patch") else b""
    blob = port[config]
    st = zt.SeekTable.from_seekable(zt.BytesWrapper(blob))
    parts = [zstd_decompress(blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                             st.frame_size_decomp(i), prefix=prefix or None)
             for i in range(st.num_frames)]
    assert b"".join(parts) == data
    for backend in ("python", "tpu"):
        opts = zt.DecodeOptions(zt.BytesWrapper(blob)).with_backend(backend).with_device("cpu")
        if prefix:
            opts = opts.with_prefix(prefix)
        assert opts.into_decoder().read(-1) == data, backend
    kind, size = cfg["policy"]
    if kind == "compressed":
        sizes = [st.frame_size_comp(i) for i in range(st.num_frames)]
        assert st.num_frames >= 3
        assert all(s >= size // 2 for s in sizes[:-1])
    else:
        assert st.num_frames == -(-len(data) // size)


@pytest.mark.parametrize("policy", ["uncompressed", "compressed"])
@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_empty_input_matches_reference(policy, backend):
    cfg = dict(policy=(policy, 4096), level=3)
    archives = []
    for mod in (zr, zt):
        out = io.BytesIO()
        mod.Encoder(_options(mod, cfg, backend), out).finish()
        archives.append(out.getvalue())
    assert archives[0] == archives[1]
    dec = zt.DecodeOptions(zt.BytesWrapper(archives[1])).with_backend(backend)
    assert dec.with_device("cpu").into_decoder().read(-1) == b""


# --- the Decoder, mirroring tests/test_streaming.py ------------------------


@pytest.fixture(scope="module")
def survey():
    """INPUT's archives at 4 KiB and 8 KiB frames (level 1, the tpu
    backend on the CPU), as the reference's ``seekable_archive`` makes
    them."""
    out = {}
    for fsize in (4096, 8192):
        cfg = dict(policy=("uncompressed", fsize), level=1)
        buf = io.BytesIO()
        enc = zt.Encoder(_options(zt, cfg, "tpu"), buf)
        enc.compress(INPUT)
        enc.finish()
        out[fsize] = buf.getvalue()
    return out


def _decoder(blob, backend, **kw):
    opts = zt.DecodeOptions(zt.BytesWrapper(blob)).with_backend(backend).with_device("cpu")
    for name, value in kw.items():
        opts = getattr(opts, "with_" + name)(value)
    return opts.into_decoder()


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_frame_range_decode(survey, backend):
    blob = survey[8192]
    st = zt.SeekTable.from_seekable(zt.BytesWrapper(blob))
    pieces = [_decoder(blob, backend, lower_frame=i, upper_frame=i).read(-1)
              for i in range(st.num_frames)]
    assert b"".join(pieces) == INPUT
    assert _decoder(blob, backend, lower_frame=1, upper_frame=2).read(-1) == INPUT[8192 : 3 * 8192]
    assert _decoder(blob, backend, lower_frame=3, upper_frame=1).read(-1) == b""


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_offset_window_decode(survey, backend):
    blob = survey[4096]
    assert _decoder(blob, backend, offset=5000, offset_limit=13_000).read(-1) == INPUT[5000:13_000]
    assert _decoder(blob, backend, offset=4097).read(100) == INPUT[4097:4197]


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_io_seek_semantics(survey, backend):
    dec = _decoder(survey[4096], backend)
    dec.seek(100, os.SEEK_SET)
    assert dec.read(50) == INPUT[100:150]
    assert dec.tell() == 150
    dec.seek(-50, os.SEEK_CUR)
    assert dec.read(10) == INPUT[100:110]
    dec.seek(-100, os.SEEK_END)
    assert dec.read(-1) == INPUT[-100:]
    with pytest.raises(zt.OffsetOutOfRangeError):
        dec.seek(-1, os.SEEK_SET)


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_set_offset_continue_vs_reset(survey, backend):
    dec = _decoder(survey[8192], backend)
    dec.read(100)
    before = dec.read_compressed
    dec.set_offset(4000)
    assert dec.read(100) == INPUT[4000:4100]
    assert dec.read_compressed == before
    dec.set_offset(20_000)
    assert dec.read(100) == INPUT[20_000:20_100]
    assert dec.read_compressed > before


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_set_offset_limit_mid_stream(survey, backend):
    dec = _decoder(survey[4096], backend)
    dec.set_offset_limit(6000)
    assert dec.read(-1) == INPUT[:6000]
    assert dec.read(100) == b""
    dec.set_offset_limit(7000)
    assert dec.read(-1) == INPUT[6000:7000]


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_decoder_set_prefix_per_call(backend):
    rng = random.Random(31)
    old = bytes(rng.randrange(256) for _ in range(30_000))
    new = old[:10_000] + b"EDIT" + old[10_000:]
    enc = zt.RawEncoder(zt.EncodeOptions().with_backend("python"))
    patch = enc.compress_with_prefix(new, old) + enc.end_frame()
    st = enc.seek_table()
    dec = _decoder(patch, backend, seek_table=st)
    dec.set_prefix(old)
    assert dec.read(-1) == new
    dec.reset()
    dec.set_prefix(None)
    with pytest.raises(ZeekstdError):
        dec.read(-1)


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_large_frame_streams_with_bounded_memory(monkeypatch, backend):
    """Frames above FRAME_CACHE_MAX stream block by block on the host on
    every backend, as in the reference."""
    n = 96 << 10
    data = (b"streaming bounded memory " * 4000)[:n]
    cfg = dict(policy=("uncompressed", n), level=1, checksum=True)
    buf = io.BytesIO()
    enc = zt.Encoder(_options(zt, cfg, "tpu"), buf)
    enc.write(data)
    enc.finish()
    monkeypatch.setattr(dec_mod, "FRAME_CACHE_MAX", 10_000)
    dec = _decoder(buf.getvalue(), backend)
    assert dec.read(-1) == data
    assert dec._cur_data is None
    for off in (70_000, 5_000, n - 10, 0):
        dec.set_offset(off)
        dec.set_offset_limit(min(off + 1234, n))
        assert dec.read(-1) == data[off : off + 1234]
        dec.set_offset_limit(n)
    dec.set_offset(60_000)
    got = bytearray()
    for _ in range(50):
        got += dec.read(7)
    assert bytes(got) == data[60_000 : 60_000 + 350]


def _outcome(decode, blob, original):
    try:
        out = decode(blob)
    except (ZeekstdError, RefZeekstdError) as e:
        return ("error", getattr(e, "name", type(e).__name__))
    return ("intact",) if out == original else ("silent",)


@pytest.mark.parametrize("backend", ["python", "tpu"])
def test_hostile_archives_fail_like_reference(ref, port, backend):
    """Truncated archives and flipped bits (frames with checksums): the
    port's Decoder gives the JAX package's outcome, never wrong bytes."""
    blob = port["L1_4k"]
    assert blob == ref["L1_4k"]
    rng = random.Random(2)
    cases = [blob[: int(len(blob) * frac)] for frac in (0.3, 0.9, 0.999)]
    for _ in range(8):
        bad = bytearray(blob)
        bad[rng.randrange(len(blob))] ^= 1 << rng.randrange(8)
        cases.append(bytes(bad))

    def port_read(b):
        return _decoder(b, backend).read(-1)

    def ref_read(b):
        return zr.DecodeOptions(zr.BytesWrapper(b)).with_backend(backend).into_decoder().read(-1)

    for case in cases:
        got = _outcome(port_read, case, TEXT)
        assert got != ("silent",)
        assert got == _outcome(ref_read, case, TEXT)


# --- faults of the reference that the port does not copy -------------------


def test_compressed_policy_cut_stops_at_the_frame_cap(monkeypatch):
    """With the cap at 16 KiB and a threshold the stream never reaches,
    every frame stays within the cap (the rest of a step is carried into
    the next frame); the JAX package cuts a whole probe step past it
    (``zeekstd_tpu/encode.py:320``)."""
    cap = 16 << 10
    data = _repetitive(64 << 10)
    opts = {mod: _options(mod, dict(policy=("compressed", 15000), level=1), "tpu")
            for mod in (zt, zr)}
    monkeypatch.setattr(enc_mod, "SEEKABLE_MAX_FRAME_SIZE", cap)
    monkeypatch.setattr(ref_enc_mod, "SEEKABLE_MAX_FRAME_SIZE", cap)
    sizes = {}
    for mod in (zt, zr):
        enc = mod.RawEncoder(opts[mod])
        blob = enc.compress(data) + enc.end_frame()
        st = enc.into_seek_table()
        sizes[mod] = [st.frame_size_decomp(i) for i in range(st.num_frames)]
        if mod is zt:
            dec = zt.DecodeOptions(zt.BytesWrapper(blob)).with_seek_table(st).into_decoder()
            assert dec.read(-1) == data
    assert sizes[zt] == [cap] * 4
    assert max(sizes[zr]) > cap  # the reference's overshoot


def _drive_compressed(mod, data, write, threshold=4000):
    """Compressed-policy encode on the tpu backend with a pass-1 flush
    after every write (what ``compress`` does past its 8 MiB floor)."""
    opts = _options(mod, dict(policy=("compressed", threshold), level=1), "tpu")
    enc = mod.RawEncoder(opts)
    enc._tpu_buf = bytearray()
    out = bytearray()
    for i in range(0, len(data), write):
        enc._tpu_buf += data[i : i + write]
        out += enc._tpu_flush_compressed(final=False)
    out += enc.end_frame()
    st = enc.into_seek_table()
    return bytes(out), st


def test_compressed_policy_flushes_equal_reference():
    """Pass 1 probes only new steps, and the cuts and the archive stay
    those of the JAX package, which probes its whole buffer each time."""
    data = TEXT[: 24 << 10]
    blob, st = _drive_compressed(zt, data, 7 << 10, threshold=2000)
    ref_blob, ref_st = _drive_compressed(zr, data, 7 << 10, threshold=2000)
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    assert st.num_frames >= 4


def test_compressed_policy_probes_grow_linearly(monkeypatch):
    """On a stream that never reaches its threshold, the bytes that pass 1
    probes grow with the input, not with its square
    (``zeekstd_tpu/encode.py:352`` probes the whole buffer on each call)."""
    probed = []
    real = archive.compress_archive

    def counting(data, *a, frame_spans=None, **kw):
        if frame_spans is None:
            probed.append(len(data))
        return real(data, *a, frame_spans=frame_spans, **kw)

    monkeypatch.setattr(archive, "compress_archive", counting)
    data = _repetitive(96 << 10)
    write, step = 4096, 1024
    blob, st = _drive_compressed(zt, data, write)
    n_calls = len(data) // write
    whole_buffer = sum(write * k for k in range(1, n_calls + 1))
    assert sum(probed) <= len(data) + len(probed) * step
    assert sum(probed) * 8 < whole_buffer
    dec = zt.DecodeOptions(zt.BytesWrapper(blob)).with_seek_table(st).into_decoder()
    assert dec.read(-1) == data


@pytest.mark.parametrize("order", ["prefix_arrives", "prefix_ends"])
def test_prefix_mid_stream_keeps_every_byte(order):
    """On the compressed policy, a prefix that arrives mid-stream moves the
    input onto the host frame encoder, and an empty one moves it back:
    ``compress(a)``, ``compress_with_prefix(b, p)``, ``end_frame()`` (and
    ``compress_with_prefix(a, p)``, ``compress_with_prefix(b, b"")``,
    ``end_frame()``). The port flushes or closes what the other path holds
    first, and decodes to ``a + b``; the JAX package
    (``zeekstd_tpu/encode.py:403-410``) returns the device flush from
    ``end_frame`` and drops the open host frame."""
    a, b, p = TEXT[:30000], TEXT[30000:60000], TEXT[60000:90000]
    prefixes = (None, p) if order == "prefix_arrives" else (p, b"")
    results = {}
    for mod in (zt, zr):
        opts = _options(mod, dict(policy=("compressed", 3000), level=1), "tpu")
        enc = mod.RawEncoder(opts)
        blob = (enc.compress_with_prefix(a, prefixes[0]) + enc.compress_with_prefix(b, prefixes[1])
                + enc.end_frame())
        st = enc.into_seek_table()
        dec = zt.DecodeOptions(zt.BytesWrapper(blob)).with_seek_table(st).with_prefix(p)
        try:
            results[mod] = dec.into_decoder().read(-1)
        except ZeekstdError as e:
            results[mod] = e
    assert results[zt] == a + b
    assert results[zr] != a + b


def test_native_backend_is_refused():
    """The backend names: ``native`` is accepted by both builders and
    round-trips through the Encoder and Decoder (its archive is the JAX
    package's), ``gpu`` is still an unknown backend, and ``auto`` is the
    default of both builders."""
    cfg = dict(policy=("uncompressed", 16384), level=1, checksum=True)
    blob = _encode(zt, cfg, backend="native")
    assert blob == _encode(zr, cfg, backend="native")
    dec = zt.DecodeOptions(zt.BytesWrapper(blob)).with_backend("native").into_decoder()
    assert dec._backend == "native"
    assert dec.read(-1) == TEXT
    with pytest.raises(ValueError, match="unknown backend"):
        zt.EncodeOptions().with_backend("gpu")
    with pytest.raises(ValueError, match="unknown backend"):
        zt.DecodeOptions(zt.BytesWrapper(b"")).with_backend("gpu")
    assert zt.EncodeOptions().backend == "auto"
    assert zt.DecodeOptions(zt.BytesWrapper(b"")).backend == "auto"


def test_tpu_backend_without_card_raises(survey):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.EncodeOptions().with_backend("tpu").into_raw_encoder()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        zt.DecodeOptions(zt.BytesWrapper(survey[4096])).with_backend("tpu").into_decoder()
    dec = zt.DecodeOptions(zt.BytesWrapper(survey[4096])).into_decoder()  # auto: native
    assert dec.read(-1) == INPUT
