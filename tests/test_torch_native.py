"""PyTorch port: the native runtime (``zeekstd_tpu_torch/native``) against
the JAX package's.

The cases of ``tests/test_native.py`` on the port's loader: XXH64, frame
interop with libzstd and the Python codec in both directions, patch mode,
checksums, truncations, the threaded stream helpers, the table builders,
sizes against libzstd. Beside them, byte equality with the JAX package's
library (built from the same source with the same flags): one-shot frames
at levels 1, 3 and 19 with and without a prefix, the streaming context's
blocks and the threaded stream blob. Through the streaming layer, the
default backend (``auto``: the native runtime) writes the JAX package's
archives under both frame-size policies and with a prefix, chunked writes
give one-shot bytes, and the compressed policy runs on the native
streaming context.
"""

import io
import os
import random
import struct
import time

import numpy as np
import pytest

pytest.importorskip("jax")

import zeekstd_tpu as zr
import zeekstd_tpu_torch as zt
from zeekstd_tpu.native import frame as ref_frame
from zeekstd_tpu.native import loader as ref_loader
from zeekstd_tpu_torch.codec import fse as pyfse
from zeekstd_tpu_torch.codec import huffman as pyhuf
from zeekstd_tpu_torch.codec.compress import compress_frame as py_compress_frame
from zeekstd_tpu_torch.codec.decompress import decompress_frame as py_decompress_frame
from zeekstd_tpu_torch.codec.sequences import LL_DEFAULT_NORM
from zeekstd_tpu_torch.errors import ZeekstdError
from zeekstd_tpu_torch.native import frame as native_frame
from zeekstd_tpu_torch.native import loader
from zeekstd_tpu_torch.xxhash64 import XXH64

from .frame_cases import structured_data as structured
from .oracle import zstd_compress, zstd_decompress
from .test_decompress import random_data, structured_data, text_data
from .torch_threads import two_torch_threads  # noqa: F401

CASES = [
    ("text", text_data(100_000)),
    ("struct", structured(100_000)),
    ("random", random_data(30_000)),
    ("zeros", b"\x00" * 80_000),
    ("periodic", (b"0123456789abcdef" * 5000)[:70_000]),
    ("tiny", b"x"),
    ("empty", b""),
    ("multiblock", structured(300_000)),
]
IDS = [c[0] for c in CASES]
PREFIX = random_data(20_000, seed=9)
TEXT = text_data(90_000)
# The reference's streaming tests take their own source as input.
with open(os.path.join(os.path.dirname(__file__), "..", "SURVEY.md"), "rb") as _fh:
    INPUT = _fh.read()


def test_structured_equals_reference_generator():
    """``frame_cases.structured_data`` is ``test_decompress``'s generator in
    linear time (that one sums the parts' lengths at every step: 40 s for
    300 kB)."""
    assert structured(20_000) == structured_data(20_000)


def test_xxh64_matches_python():
    for data in (b"", b"abc", bytes(range(256)) * 100):
        h = XXH64(7)
        h.update(data)
        assert loader.xxh64(data, 7) == h.digest() == ref_loader.xxh64(data, 7)


@pytest.mark.parametrize("name,data", CASES, ids=IDS)
def test_native_frames_interop(name, data):
    frame = loader.compress_frame(data, checksum=True)
    assert zstd_decompress(frame, len(data) + 64) == data
    out, consumed = loader.decompress_frame(frame, len(data) + 64)
    assert out == data and consumed == len(frame)
    assert py_decompress_frame(frame)[0] == data


@pytest.mark.parametrize("with_prefix", [False, True], ids=["plain", "prefix"])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_compress_frame_equals_reference_library(level, with_prefix):
    prefix = PREFIX if with_prefix else b""
    for name, data in CASES:
        got = loader.compress_frame(data, checksum=True, prefix=prefix, level=level)
        assert got == ref_loader.compress_frame(data, checksum=True, prefix=prefix,
                                                level=level), name
        assert zstd_decompress(got, len(data) + 64, prefix=prefix or None) == data, name


@pytest.mark.parametrize("name,data", CASES, ids=IDS)
@pytest.mark.parametrize("level", [1, 3, 19])
def test_native_decodes_libzstd(name, data, level):
    frame = zstd_compress(data, level=level, checksum=True)
    out, consumed = loader.decompress_frame(frame, len(data) + 64)
    assert out == data
    assert consumed == len(frame)


def test_native_decodes_python_frames():
    data = structured(150_000)
    for level in (1, 3, 9):
        frame = py_compress_frame(data, level=level, checksum=True)
        out, _ = loader.decompress_frame(frame, len(data) + 64)
        assert out == data


def test_patch_mode():
    old = random_data(40_000, seed=5)
    new = old[:15_000] + b"native patch" + old[15_000:]
    frame = loader.compress_frame(new, prefix=old)
    assert len(frame) < 200
    assert zstd_decompress(frame, len(new) + 64, prefix=old) == new
    out, _ = loader.decompress_frame(frame, len(new) + 64, prefix=old)
    assert out == new


def test_checksum_detection():
    data = text_data(5000)
    frame = bytearray(loader.compress_frame(data, checksum=True))
    frame[-1] ^= 0xFF
    with pytest.raises(RuntimeError, match="checksum"):
        loader.decompress_frame(bytes(frame), len(data) + 64)
    # The frame adapter maps it to the taxonomy, as the JAX package's does.
    with pytest.raises(ZeekstdError) as got:
        native_frame.native_decompress_frame(bytes(frame), len(data) + 64)
    with pytest.raises(zr.ZeekstdError) as want:
        ref_frame.native_decompress_frame(bytes(frame), len(data) + 64)
    assert str(got.value) == str(want.value)


def test_truncation_graceful():
    data = structured(20_000)
    frame = loader.compress_frame(data)
    for cut in (5, len(frame) // 3, len(frame) - 2):
        with pytest.raises(RuntimeError):
            loader.decompress_frame(frame[:cut], len(data) + 64)
        with pytest.raises(ZeekstdError) as got:
            native_frame.native_decompress_frame(frame[:cut], len(data) + 64)
        with pytest.raises(zr.ZeekstdError) as want:
            ref_frame.native_decompress_frame(frame[:cut], len(data) + 64)
        assert type(got.value).__name__ == type(want.value).__name__


@pytest.mark.parametrize("nthreads", [1, 4])
def test_mt_stream_roundtrip(nthreads):
    data = structured(300_000)
    blob, sizes = loader.compress_stream_mt(data, 65_536, checksum=True, nthreads=nthreads)
    assert (blob, sizes) == ref_loader.compress_stream_mt(data, 65_536, checksum=True,
                                                          nthreads=nthreads)
    assert sum(sizes) == len(blob)
    st = zt.SeekTable.from_frames(
        (c, min(65_536, len(data) - i * 65_536)) for i, c in enumerate(sizes)
    )
    assert zstd_decompress(blob, len(data) + 64) == data
    c_off, d_off = (list(map(int, o)) for o in st.cumulative_offsets())
    assert loader.decompress_stream_mt(blob, c_off, d_off, nthreads=nthreads) == data
    into = bytearray(len(data) + 10)
    assert loader.decompress_stream_mt(blob, c_off, d_off, nthreads=nthreads,
                                       into=into) == len(data)
    assert bytes(into[: len(data)]) == data
    with pytest.raises(ValueError):
        loader.decompress_stream_mt(blob, c_off, d_off, into=bytearray(10))


@pytest.mark.parametrize("level", [1, 3])
def test_stream_ctx_blocks_equal_reference_library(level):
    data = TEXT + structured(40_000)
    outs = []
    for mod in (loader, ref_loader):
        ctx = mod.StreamCtx(level, True)
        parts = [ctx.header()]
        parts += [ctx.block(data[i : i + 10_000]) for i in range(0, len(data), 10_000)]
        parts.append(ctx.end())
        ctx.close()
        outs.append(parts)
    assert outs[0] == outs[1]
    assert zstd_decompress(b"".join(outs[0]), len(data)) == data


def test_streaming_layer_backend_equivalence():
    data = structured(120_000)
    archives = {}
    for backend in ("python", "native"):
        out = io.BytesIO()
        opts = (zt.EncodeOptions().with_backend(backend)
                .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(32_768)))
        enc = zt.Encoder(opts, out)
        enc.compress(data)
        enc.finish()
        archives[backend] = out.getvalue()
    for backend, blob in archives.items():
        for dec_backend in ("python", "native"):
            dec = (zt.DecodeOptions(zt.BytesWrapper(blob)).with_backend(dec_backend)
                   .into_decoder())
            assert dec.read(-1) == data, (backend, dec_backend)


def test_native_random_access_through_decoder():
    data = text_data(100_000)
    out = io.BytesIO()
    opts = (zt.EncodeOptions().with_backend("native")
            .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(16_384)))
    enc = zt.Encoder(opts, out)
    enc.compress(data)
    enc.finish()
    dec = (zt.DecodeOptions(zt.BytesWrapper(out.getvalue())).with_backend("native")
           .with_offset(20_000).with_offset_limit(50_000).into_decoder())
    assert dec.read(-1) == data[20_000:50_000]


@pytest.mark.parametrize("level", [1, 3, 7, 9])
def test_size_beats_libzstd_per_level(level):
    data = text_data(150_000) + structured(100_000)
    frame = loader.compress_frame(data, level=level)
    assert len(frame) <= len(zstd_compress(data, level=level)) * 1.01
    out, _ = loader.decompress_frame(frame, len(data) + 64)
    assert out == data


def test_huge_declared_content_size_rejected_fast():
    frame = (
        b"\x28\xb5\x2f\xfd"  # magic
        + bytes([0xC0])       # fhd: 8-byte FCS, no checksum, windowed
        + bytes([0x00])       # window descriptor
        + struct.pack("<Q", 1 << 60)  # declared content size
        + b"\x01\x00\x00"     # bogus last-block header
    )
    t0 = time.time()
    with pytest.raises(Exception):
        loader.decompress_frame(frame, 1 << 20)
    assert time.time() - t0 < 2.0


def test_structured_data_ratio():
    data = "\n".join(str(i) for i in range(1, 20001)).encode() + b"\n"
    for lvl, bound in ((3, 0.32), (9, 0.32), (13, 0.32), (15, 0.32)):
        blob = loader.compress_frame(data, level=lvl)
        assert len(blob) / len(data) < bound, lvl
        out, _ = loader.decompress_frame(blob, len(data) + 64)
        assert out == data


def test_native_table_builders_match_python():
    rng = np.random.default_rng(3)
    norms = [list(LL_DEFAULT_NORM)]
    for _ in range(10):
        log = int(rng.integers(5, 10))
        n = int(rng.integers(2, 36))
        w = rng.random(n) + 0.01
        norm = np.maximum((w / w.sum() * (1 << log)).astype(np.int64), 1)
        norm[int(np.argmax(norm))] += (1 << log) - norm.sum()
        norms.append(list(norm))
    for norm in norms:
        log = int(np.log2(sum(x for x in norm if x > 0) + list(norm).count(-1)))
        nat = loader.fse_enc_table(np.asarray(norm, np.int16), log)
        ref = ref_loader.fse_enc_table(np.asarray(norm, np.int16), log)
        py = pyfse.build_encode_table(norm, log)
        n = len(norm)
        # Entries past the n symbols and the 1 << log states are not written.
        for a, b, k in zip(nat, ref, (n, n, 1 << log)):
            np.testing.assert_array_equal(a[:k], b[:k])
        assert np.array_equal(nat[0][:n], py.delta_nb_bits)
        assert np.array_equal(nat[1][:n], py.delta_find_state)
        assert np.array_equal(nat[2][: 1 << log], py.state_table)
    hist = np.zeros(256, np.uint32)
    hist[:64] = rng.integers(1, 1000, 64)
    tree, codes, nb = loader.huf_table(hist)
    lengths = pyhuf.package_merge_lengths({int(s): int(hist[s]) for s in np.nonzero(hist)[0]})
    assert int(np.dot(hist, nb.astype(np.int64))) == sum(
        int(hist[s]) * L for s, L in lengths.items())
    assert len(pyhuf.read_weights(tree)) > 0


# name: (policy kind, size), prefix; the default backend on both packages.
DEFAULTS = {
    "uncompressed_32k": (("uncompressed", 32768), None),
    "compressed_3000": (("compressed", 3000), None),
    "uncompressed_prefix": (("uncompressed", 32768), PREFIX),
    "compressed_prefix": (("compressed", 3000), PREFIX),
}


def _default_archive(mod, policy, prefix, data=TEXT):
    """(archive, whether the first frame went native) with no backend set."""
    out = io.BytesIO()
    opts = mod.EncodeOptions().with_frame_size_policy(getattr(mod.FrameSizePolicy, policy[0])(
        policy[1])).with_checksum_flag(True)
    enc = mod.Encoder(opts, out)
    enc.compress_with_prefix(data, prefix)
    native = enc.raw._use_native()
    enc.finish()
    return out.getvalue(), native


@pytest.mark.parametrize("name", list(DEFAULTS))
def test_default_backend_archive_equals_reference(name):
    policy, prefix = DEFAULTS[name]
    got, native = _default_archive(zt, policy, prefix)
    want, ref_native = _default_archive(zr, policy, prefix)
    assert native == ref_native == (name != "compressed_prefix")
    assert got == want
    dec = zt.DecodeOptions(zt.BytesWrapper(got))
    if prefix is not None:
        dec = dec.with_prefix(prefix)
    assert dec.into_decoder().read(-1) == TEXT


def test_default_archive_differs_from_python_backend():
    """What ``auto`` changes: the native runtime's frames, not the Python
    codec's (the two write different bytes for this input)."""
    got, _ = _default_archive(zt, ("uncompressed", 32768), None)
    out = io.BytesIO()
    enc = zt.Encoder(zt.EncodeOptions().with_backend("python").with_checksum_flag(True)
                     .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(32768)), out)
    enc.compress(TEXT)
    enc.finish()
    assert got != out.getvalue()


@pytest.mark.parametrize("kind", ["uncompressed", "compressed"])
def test_compress_into_byte_granular_contract(kind):
    """``tests/test_streaming.py::test_compress_into_byte_granular_contract``
    on the native backend: tiny input steps and a 97-byte output buffer
    give the one-shot archive and seek table."""
    data = (TEXT * 2)[:50_000]
    rng = random.Random(11)
    policy = (zt.FrameSizePolicy.uncompressed(7_000) if kind == "uncompressed"
              else zt.FrameSizePolicy.compressed(2_000))

    def opts():
        return zt.EncodeOptions().with_frame_size_policy(policy).with_backend("native")

    one = zt.RawEncoder(opts())
    oneshot = one.compress(data) + one.end_frame()
    st_one = one.into_seek_table()
    enc = zt.RawEncoder(opts())
    got, buf, pos = bytearray(), bytearray(97), 0
    while pos < len(data):
        step = min(rng.randrange(1, len(data) // 100), len(data) - pos)
        prog = enc.compress_into(data[pos : pos + step], buf)
        got += buf[: prog.out_progress]
        pos += prog.in_progress
    while True:
        ep = enc.end_frame_into(buf)
        got += buf[: ep.out_progress]
        if not ep.data_left:
            break
    assert bytes(got) == oneshot
    st = enc.into_seek_table()
    frames = [(st.frame_size_comp(i), st.frame_size_decomp(i)) for i in range(st.num_frames)]
    assert frames == [(st_one.frame_size_comp(i), st_one.frame_size_decomp(i))
                      for i in range(st_one.num_frames)]
    ref = zr.RawEncoder(zr.EncodeOptions().with_backend("native").with_frame_size_policy(
        getattr(zr.FrameSizePolicy, kind)(policy.size)))
    assert oneshot == ref.compress(data) + ref.end_frame()


def test_compressed_policy_native_stream():
    """The compressed policy runs on the native streaming context: every
    non-final frame reaches the threshold, frames carry no content size,
    libzstd decodes each frame, and the archive is the JAX package's."""
    data = INPUT * 3
    blobs = []
    for mod in (zt, zr):
        enc = mod.RawEncoder(mod.EncodeOptions().with_frame_size_policy(
            mod.FrameSizePolicy.compressed(3000)).with_compression_level(2))
        assert enc._use_native()
        blobs.append(enc.compress(data) + enc.end_frame())
        st = enc.into_seek_table()
    blob = blobs[0]
    assert blob == blobs[1]
    assert st.num_frames >= 3
    sizes = [st.frame_size_comp(i) for i in range(st.num_frames)]
    assert all(s >= 3000 for s in sizes[:-1])
    fhd = blob[st.frame_start_comp(0) + 4]
    assert fhd >> 6 == 0 and not (fhd & 0x20)
    parts = [zstd_decompress(blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                             st.frame_size_decomp(i)) for i in range(st.num_frames)]
    assert b"".join(parts) == data
    dec = zt.DecodeOptions(zt.BytesWrapper(blob)).with_seek_table(
        zt.SeekTable.from_frames((st.frame_size_comp(i), st.frame_size_decomp(i))
                                 for i in range(st.num_frames))).into_decoder()
    assert dec.read(-1) == data


def test_compressed_policy_native_frame_cuts_at_its_window(monkeypatch):
    """A native streaming frame declares a 16 MiB window, so the frame is
    cut once its input reaches it (``d_cap``), whatever the threshold;
    patched to 20 KiB here, as in both packages."""
    frames = []
    for mod, fr in ((zt, native_frame), (zr, ref_frame)):
        monkeypatch.setattr(fr.NativeStreamFrameEncoder, "d_cap", 20_000)
        enc = mod.RawEncoder(mod.EncodeOptions().with_frame_size_policy(
            mod.FrameSizePolicy.compressed(1 << 20)))
        blob = enc.compress(TEXT) + enc.end_frame()
        st = enc.into_seek_table()
        frames.append((blob, [st.frame_size_decomp(i) for i in range(st.num_frames)]))
    assert frames[0] == frames[1]
    assert frames[0][1] == [20_000] * 4 + [10_000]


def test_auto_prefix_mid_stream_round_trips():
    """A prefix that arrives mid-stream on the compressed policy moves the
    next frames from the native streaming context onto the Python frame
    encoder; the frame open on the native path is closed first, both
    packages write the same archive, and it decodes to every byte."""
    a, b, p = TEXT[:30000], TEXT[30000:60000], TEXT[60000:]
    blobs = []
    for mod in (zt, zr):
        enc = mod.RawEncoder(mod.EncodeOptions().with_frame_size_policy(
            mod.FrameSizePolicy.compressed(3000)))
        blob = enc.compress(a)
        assert enc._use_native()
        blob += enc.compress_with_prefix(b, p) + enc.end_frame()
        assert not enc._use_native()
        blobs.append((blob, enc.into_seek_table()))
    (blob, st), (ref_blob, _) = blobs
    assert blob == ref_blob
    dec = zt.DecodeOptions(zt.BytesWrapper(blob)).with_seek_table(st).with_prefix(p)
    assert dec.into_decoder().read(-1) == a + b
