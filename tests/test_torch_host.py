"""PyTorch port: package isolation and the host layer against the JAX package.

- The port imports neither JAX nor ``zeekstd_tpu`` (checked in a
  subprocess where both are blocked, and in the sources).
- The copied host modules and the native runtime's C++ source are
  verbatim copies of the reference's.
- The port's native runtime (XXH64, Huffman table construction, Huffman
  stream decoding) gives the reference library's results.
- The plain-torch stages (bit packer, Huffman stream encoder, stream
  finalizer, assembly map) equal their JAX counterparts exactly.
- The decode planner gives the reference's plans.
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import zeekstd_tpu_torch as zt
from zeekstd_tpu.native import loader as ref_loader
from zeekstd_tpu.ops import assemble as ref_asm
from zeekstd_tpu.ops import bitpack as ref_bitpack
from zeekstd_tpu.ops import entropy as ref_entropy
from zeekstd_tpu.tpu_codec import _plan_frame as ref_plan_frame
from zeekstd_tpu.xxhash64 import XXH64
from zeekstd_tpu_torch import archive, device
from zeekstd_tpu_torch.native import loader
from zeekstd_tpu_torch.ops import assemble, bitpack, entropy
from zeekstd_tpu_torch.plan import _plan_frame

from .oracle import zstd_compress
from .torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zeekstd_tpu_torch")


def test_isolated_import_and_cpu_round_trip():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['zeekstd_tpu'] = None\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import zeekstd_tpu_torch as zt\n"
        "data = bytes(range(256)) * 200 + b'hello world ' * 3000\n"
        "blob, st = zt.compress_archive(data, frame_size=32768, level=1, checksum=True, device='cpu')\n"
        "assert zt.decompress_archive(blob, st, device='cpu') == data\n"
        "bad = [m for m in sys.modules if (m == 'jax' or m.startswith(('jax.', 'zeekstd_tpu.')))\n"
        "       and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_sources_import_neither_jax_nor_the_jax_package():
    pat = re.compile(r"^\s*(import jax|from jax|import zeekstd_tpu[. ]|from zeekstd_tpu[. ])",
                     re.M)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_mh_worker.py")]
    for d, _sub, names in os.walk(PKG):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    for path in files:
        with open(path) as fh:
            hits = [m.group(0) for m in pat.finditer(fh.read())
                    if "zeekstd_tpu_torch" not in m.group(0)]
        assert not hits, (path, hits)


@pytest.mark.parametrize("mod", [
    "constants", "errors", "xxhash64", "seekable", "seek_table",
    "codec/bitstream", "codec/fse", "codec/huffman", "codec/literals",
    "codec/sequences", "codec/seq_encode", "codec/frame",
    "codec/compress", "codec/match", "codec/match_fast", "codec/block_compress",
    "codec/decompress", "native/frame", "native/zeekstd_native.cpp",
])
def test_host_modules_are_verbatim_copies(mod):
    name = mod if mod.endswith(".cpp") else mod + ".py"
    with open(os.path.join(ROOT, "zeekstd_tpu", name), "rb") as a, \
            open(os.path.join(PKG, name), "rb") as b:
        assert a.read() == b.read()


def test_xxh64_matches_reference():
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 31, 32, 33, 1000, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        h = XXH64(0)
        h.update(data)
        assert loader.xxh64(data) == h.digest()
    assert archive.empty_frame(True)[-4:] == (XXH64(0).digest() & 0xFFFFFFFF).to_bytes(4, "little")


def test_huffman_tables_match_reference_library():
    rng = np.random.default_rng(1)
    for trial in range(40):
        nsym = int(rng.integers(2, 256))
        hist = np.zeros(256, np.int64)
        syms = rng.choice(256, nsym, replace=False)
        hist[syms] = rng.integers(1, 5000, nsym) ** int(rng.integers(1, 3))
        got, ref = loader.huf_table(hist), ref_loader.huf_table(hist)
        assert (got is None) == (ref is None)
        if got is not None:
            assert got[0] == ref[0]
            np.testing.assert_array_equal(got[2], ref[2])
            used = ref[2] > 0  # codes of absent symbols are never read
            np.testing.assert_array_equal(got[1][used], ref[1][used])


def test_huffman_stream_decode_matches_reference_library():
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(400)]
    data = b" ".join(words[rng.integers(0, 400)] for _ in range(9000))
    blob, _st = archive.compress_archive(data, frame_size=32768, level=1, device="cpu")
    _hdr, plan, _ = _plan_frame(blob, 0)
    streams = [s for kind, *a in plan if kind == "cmp" for s in a[0].get("streams", [])]
    assert streams
    for sbytes, olen, table in streams:
        got = loader.huf_stream_decode(sbytes, table.symbol, table.nb_bits, table.max_bits, olen)
        ref = ref_loader.huf_stream_decode(sbytes, table.symbol, table.nb_bits, table.max_bits, olen)
        np.testing.assert_array_equal(got, ref)
    assert loader.huf_stream_decode(b"\x00", streams[0][2].symbol, streams[0][2].nb_bits,
                                    streams[0][2].max_bits, 4) is None


def test_pack_bits_matches_reference():
    rng = np.random.default_rng(2)
    vals = rng.integers(0, 1 << 32, (3, 500), dtype=np.uint64).astype(np.uint32)
    nbits = rng.integers(0, 33, (3, 500)).astype(np.int32)
    words, total = bitpack.pack_bits(torch.from_numpy(vals.astype(np.int64)),
                                     torch.from_numpy(nbits), 600)
    for j in range(3):
        rw, rt = ref_bitpack.pack_bits(jnp.asarray(vals[j]), jnp.asarray(nbits[j]), 600)
        np.testing.assert_array_equal(words[j].numpy().view(np.uint32), np.asarray(rw))
        assert int(total[j]) == int(rt)


def test_huffman_streams_match_vmapped_reference():
    rng = np.random.default_rng(3)
    segs = rng.integers(0, 40, (4, 256)).astype(np.uint8)
    n_valid = np.array([256, 100, 1, 0], np.int32)
    codes = rng.integers(0, 1 << 11, (4, 256)).astype(np.uint32)
    nbits = rng.integers(1, 12, (4, 256)).astype(np.int32)
    words, bits = entropy.huffman_encode_streams(
        torch.from_numpy(segs), torch.from_numpy(n_valid),
        torch.from_numpy(codes.astype(np.int64)), torch.from_numpy(nbits), 104)
    rw, rb = jax.vmap(lambda s, n, c, b: ref_entropy.huffman_encode_stream(s, n, c, b, 104))(
        jnp.asarray(segs), jnp.asarray(n_valid), jnp.asarray(codes), jnp.asarray(nbits))
    np.testing.assert_array_equal(words.numpy().view(np.uint32), np.asarray(rw))
    np.testing.assert_array_equal(bits.numpy(), np.asarray(rb))


def test_finalize_and_assembly_map_match_reference():
    rng = np.random.default_rng(4)
    words = rng.integers(0, 1 << 32, (5, 16), dtype=np.uint64).astype(np.uint32)
    bits = np.array([0, 1, 31, 200, 511], np.int32)
    got = assemble.finalize_streams(torch.from_numpy(words.view(np.int32)), torch.from_numpy(bits))
    ref = ref_asm.finalize_streams(jnp.asarray(words), jnp.asarray(bits))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    seg_dest = np.array([[0, 10, 25, 1 << 30], [0, 3, 1 << 30, 1 << 30]], np.int32)
    seg_base = np.array([[100, 7, 50, 0], [9, 900, 0, 0]], np.int32)
    nval = np.array([40, 20], np.int32)
    got = assemble.build_asm_map(torch.from_numpy(seg_dest), torch.from_numpy(seg_base),
                                 torch.from_numpy(nval), 64)
    ref = ref_asm.build_asm_map(jnp.asarray(seg_dest), jnp.asarray(seg_base),
                                jnp.asarray(nval), 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("level", [1, 6])
def test_plan_frame_matches_reference(level):
    data = (b"seekable frames decode independently; " * 900)[:30000]
    frame = zstd_compress(data, level, window_log=13)
    hdr, plan, end = _plan_frame(frame, 0)
    rhdr, rplan, rend = ref_plan_frame(frame, 0)
    assert end == rend and hdr.window_size == rhdr.window_size
    assert hdr.content_size == rhdr.content_size
    assert [k for k, *_ in plan] == [k for k, *_ in rplan]
    for (k, *a), (_rk, *ra) in zip(plan, rplan):
        if k == "cmp":
            assert a[0].get("nseq") == ra[0].get("nseq")
            assert a[0].get("payload") == ra[0].get("payload")
            assert [s[:2] for s in a[0].get("streams", [])] == \
                   [s[:2] for s in ra[0].get("streams", [])]


def test_device_resolution_and_phase_timer():
    assert device.resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        device.resolve_device("meta")
    device.set_timing(1)
    try:
        device.phase_records.clear()
        with device.phase_timer("enc.parse_dispatch") as pt:
            pt.fence(torch.zeros(1))
        assert set(device.phase_records) == {"enc.parse_dispatch"}
    finally:
        device.set_timing(0)
        device.phase_records.clear()


def test_from_reference_arrays_keeps_bits():
    words = np.array([[0xFFFFFFFF, 1]], np.uint32)
    meta = np.arange(16, dtype=np.int32).reshape(1, 16)
    got = zt.from_reference_arrays("cpu", words=words, meta=meta)
    assert got["words"].dtype == torch.int32
    np.testing.assert_array_equal(got["words"].numpy().view(np.uint32), words)
    np.testing.assert_array_equal(got["meta"].numpy(), meta)
