"""PyTorch port: the mesh pipeline (``zeekstd_tpu_torch.parallel``) against
the JAX package's ``zeekstd_tpu.parallel`` on the CPU.

Mirrors ``tests/test_parallel.py`` on the port's 8-device virtual mesh
(``make_mesh(["cpu"] * 8)``, the layout of the 8 virtual JAX devices of
``tests/conftest.py``) and on a one-device mesh: archives and seek tables
byte-equal to JAX ``parallel_compress`` at levels 1, 3 and 9 (and to
``tpu_compress_archive``), for the empty and one-byte inputs too; the seek
table against the frame headers; libzstd reading the blob; the same
frames and owners from ``route_queries``; random access and frame
subsets; libzstd archives on the fused route with no fallback and on the
doubling route; a flipped checksum flag raising ``corruption_detected``
in both packages; ``parallel_parse_step`` against the JAX step on a
one-device JAX mesh. Also ``ops/huffman_spec.decode_stream_spec`` and
``ops/histogram`` against the JAX functions.

Each JAX reference is computed once for the module.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from zeekstd_tpu import parallel as ref_par  # noqa: E402
from zeekstd_tpu.codec import huffman as ref_huf  # noqa: E402
from zeekstd_tpu.codec.bitstream import BackwardBitReader  # noqa: E402
from zeekstd_tpu.errors import ZstdError as RefZstdError  # noqa: E402
from zeekstd_tpu.ops import histogram as ref_hist  # noqa: E402
from zeekstd_tpu.ops import huffman_spec as ref_hs  # noqa: E402
from zeekstd_tpu.tpu_archive import tpu_compress_archive  # noqa: E402

import zeekstd_tpu_torch as zt  # noqa: E402
from zeekstd_tpu_torch import archive, decode_routes  # noqa: E402
from zeekstd_tpu_torch.codec.frame import parse_frame_header  # noqa: E402
from zeekstd_tpu_torch.errors import ZstdError  # noqa: E402
from zeekstd_tpu_torch.ops import histogram, huffman_spec  # noqa: E402
from zeekstd_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
    parallel_compress,
    parallel_decompress,
    parallel_parse_step,
    parallel_random_access,
    route_queries,
)
from zeekstd_tpu_torch.parallel.pipeline import DECODE_FALLBACKS  # noqa: E402

from .frame_cases import structured_data, text_data  # noqa: E402
from .oracle import zstd_compress, zstd_decompress  # noqa: E402
from .torch_threads import two_torch_threads  # noqa: F401

FRAME = 8 << 10  # 15 frames of the 120,000-byte input: two per shard, one on the last
LEVELS = (1, 3, 9)
DATA = text_data(60_000) + structured_data(60_000)
QUERIES = [0, 16_384, 40_000, 119_999]
RANGES = [(5000, 9000), (30_000, 70_000)]


@pytest.fixture(scope="module")
def ref():
    """The JAX package's archives of DATA on its 8-device mesh at each
    level, tpu_compress_archive's at level 3, the empty and one-byte
    inputs' archives, and its routing of QUERIES."""
    mesh = ref_par.make_mesh()
    out = {lv: ref_par.parallel_compress(DATA, mesh, frame_size=FRAME, level=lv)
           for lv in LEVELS}
    out["single"] = tpu_compress_archive(DATA, frame_size=FRAME, level=3)
    for d in (b"", b"x"):
        out[d] = ref_par.parallel_compress(d, mesh, frame_size=FRAME, checksum=True)
    blob, st = out[3]
    out["routes"] = ref_par.route_queries(st, QUERIES, mesh)
    return out


@pytest.fixture(scope="module", params=[8, 1], ids=["mesh8", "mesh1"])
def mesh(request):
    return make_mesh(["cpu"] * request.param)


@pytest.fixture(scope="module")
def mesh8():
    return make_mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def archives(mesh8):
    """The port's archives of DATA on the 8-device mesh at each level."""
    return {lv: parallel_compress(DATA, mesh8, frame_size=FRAME, level=lv) for lv in LEVELS}


def _libzstd_archive(level):
    data = text_data(60_000) + structured_data(40_000)
    fsize = 24_000
    frames = [zstd_compress(data[i : i + fsize], level=level)
              for i in range(0, len(data), fsize)]
    st = zt.SeekTable.from_frames(
        (len(f), min(fsize, len(data) - i * fsize)) for i, f in enumerate(frames))
    return data, b"".join(frames), st


def test_mesh_has_8_devices(mesh8, monkeypatch):
    assert mesh8.size == 8 and list(mesh8.shards()) == list(range(8))
    assert mesh8.group is None and mesh8.axis_names == ("data",)
    # With no argument the mesh is the card's, and there is none.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


@pytest.mark.parametrize("level", LEVELS)
def test_parallel_honors_level(ref, archives, level):
    blob, st = archives[level]
    ref_blob, ref_st = ref[level]
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    assert zstd_decompress(blob) == DATA


def test_parallel_equals_serial_frames(ref, mesh):
    blob, st = parallel_compress(DATA, mesh, frame_size=FRAME)
    ref_blob, ref_st = ref["single"]
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    single = archive.compress_archive(DATA, frame_size=FRAME, device="cpu")
    assert (blob, st.to_bytes()) == (single[0], single[1].to_bytes())


@pytest.mark.parametrize("data", [b"", b"x"], ids=["empty", "one_byte"])
def test_tiny_inputs_equal_reference(ref, mesh, data):
    blob, st = parallel_compress(data, mesh, frame_size=FRAME, checksum=True)
    ref_blob, ref_st = ref[data]
    assert blob == ref_blob
    assert st.to_bytes() == ref_st.to_bytes()
    assert st.num_frames == 1
    assert parallel_decompress(blob, st, mesh) == data


def test_parallel_compress_roundtrip(archives):
    blob, st = archives[3]
    assert st.num_frames == -(-len(DATA) // FRAME)
    assert st.size_decomp == len(DATA)
    assert st.size_comp == len(blob)
    archive_bytes = blob + st.to_bytes()
    assert zt.DecodeOptions(zt.BytesWrapper(archive_bytes)).into_decoder().read(-1) == DATA


def test_seek_table_built_from_gathered_entries(archives):
    blob, st = archives[1]
    pos = 0
    for i in range(st.num_frames):
        assert st.frame_start_comp(i) == pos, f"frame {i} start"
        assert parse_frame_header(blob[pos:]).content_size == st.frame_size_decomp(i)
        pos = st.frame_end_comp(i)
    assert pos == len(blob)


def test_parallel_decompress_matches(mesh):
    blob, st = parallel_compress(DATA, mesh, frame_size=FRAME, checksum=True)
    before = dict(DECODE_FALLBACKS), decode_routes.serial_fallback_count()
    assert parallel_decompress(blob, st, mesh) == DATA
    assert (dict(DECODE_FALLBACKS), decode_routes.serial_fallback_count()) == before


@pytest.mark.parametrize("huf", ["bitreach", "spec"])
def test_doubling_route_roundtrip(mesh8, archives, monkeypatch, huf):
    monkeypatch.setenv("ZEEKSTD_TPU_MESH_EXEC", "doubling")
    if huf == "spec":
        monkeypatch.setenv("ZEEKSTD_TPU_HUF", "spec")
    blob, st = archives[3]
    assert parallel_decompress(blob, st, mesh8) == DATA


def test_query_routing(ref, mesh8, archives):
    blob, st = archives[3]
    frames, owners = route_queries(st, QUERIES, mesh8)
    ref_frames, ref_owners = ref["routes"]
    assert list(frames) == list(np.asarray(ref_frames)) == [0, 2, 4, 14]
    assert list(owners) == list(np.asarray(ref_owners))
    assert all(0 <= o < 8 for o in owners)
    got = parallel_random_access(blob, st, RANGES, mesh8)
    assert got == [DATA[lo:hi] for lo, hi in RANGES]


def test_frame_ids_subset(mesh):
    blob, st = parallel_compress(DATA, mesh, frame_size=FRAME, checksum=True)
    got = parallel_decompress(blob, st, mesh, frame_ids=[1, 4, 14])
    assert set(got) == {1, 4, 14}
    for i in (1, 4, 14):
        assert got[i] == DATA[st.frame_start_decomp(i) : st.frame_end_decomp(i)]


@pytest.mark.parametrize("level", LEVELS)
def test_mesh_foreign_archives(mesh8, monkeypatch, level):
    """libzstd archives decode on the fused route with no fallback of any
    kind, and on the doubling route to the same bytes."""
    data, blob, st = _libzstd_archive(level)
    before = dict(DECODE_FALLBACKS), decode_routes.serial_fallback_count()
    assert parallel_decompress(blob, st, mesh8) == data
    assert (dict(DECODE_FALLBACKS), decode_routes.serial_fallback_count()) == before
    monkeypatch.setenv("ZEEKSTD_TPU_MESH_EXEC", "doubling")
    assert parallel_decompress(blob, st, mesh8) == data
    assert dict(DECODE_FALLBACKS) == before[0]


def test_flipped_checksum_flag_is_corruption(mesh8):
    """A frame whose checksum-flag bit is flipped no longer consumes its
    seek-table extent: both packages raise corruption_detected."""
    blob, st = parallel_compress(DATA, mesh8, frame_size=FRAME, checksum=True)
    bad = bytearray(blob)
    fhd = st.frame_start_comp(3) + 4  # frame header descriptor of frame 3
    bad[fhd] ^= 0x04  # Content_Checksum_flag
    with pytest.raises(ZstdError, match="consumed"):
        parallel_decompress(bytes(bad), st, mesh8)
    from zeekstd_tpu.seek_table import SeekTable as RefSeekTable

    ref_st = RefSeekTable.from_bytes(st.to_bytes())
    with pytest.raises(RefZstdError, match="consumed"):
        ref_par.parallel_decompress(bytes(bad), ref_st, ref_par.make_mesh())


def test_mesh_kernel_encode_cycle(mesh8):
    """Level 1 at 32 KiB-multiple frames takes the match kernel per shard
    (its plain version here): the archive equals compress_archive's,
    libzstd reads it, and it decodes on the mesh with checksums on."""
    data = DATA + text_data(8_000)
    blob, st = parallel_compress(data, mesh8, frame_size=32 << 10, level=1, checksum=True)
    single, single_st = archive.compress_archive(data, frame_size=32 << 10, level=1,
                                                 checksum=True, device="cpu")
    assert blob == single and st.to_bytes() == single_st.to_bytes()
    assert zstd_decompress(blob) == data
    assert parallel_decompress(blob, st, mesh8) == data


def test_parse_step_equals_reference():
    """The port's parse step on a one-device mesh against the JAX step on a
    one-device JAX mesh: every output over its valid region."""
    seq_bound = 2048
    rows = [DATA[:FRAME], DATA[60_000 : 60_000 + 5000]]
    frames = np.zeros((2, FRAME), np.uint8)
    for i, r in enumerate(rows):
        frames[i, : len(r)] = np.frombuffer(r, np.uint8)
    lengths = np.asarray([len(r) for r in rows], np.int32)
    ref_step = ref_par.parallel_parse_step(ref_par.make_mesh(jax.devices()[:1]), FRAME,
                                           seq_bound, 3)
    want = [np.asarray(o) for o in ref_step(jnp.asarray(frames), jnp.asarray(lengths))]
    got = [o.numpy() for o in parallel_parse_step(make_mesh(["cpu"]), FRAME, seq_bound, 3)(
        frames, lengths)]
    assert len(got) == len(want) == 18
    n_seq, n_lit = want[7], want[8]
    for j, (g, w) in enumerate(zip(got, want)):
        # The reference pads the six sequence rows with seq_bound zeros.
        assert g.shape == (w.shape if j >= 6 else (2, seq_bound)), j
        for f in range(2):
            valid = slice(n_seq[f]) if j < 6 else slice(n_lit[f]) if j == 6 else ()
            assert np.array_equal(g[f][valid].astype(np.int64), w[f][valid].astype(np.int64)), j


def _huffman_stream(data):
    freqs = {}
    for b in data:
        freqs[b] = freqs.get(b, 0) + 1
    lengths = ref_huf.package_merge_lengths(freqs)
    weights = ref_huf.lengths_to_weights(lengths, max(freqs))
    codes, nb, _mb = ref_huf.build_encode_table(weights)
    stream = ref_huf.encode_stream(data, codes, nb)
    dt = ref_huf.build_decode_table(list(weights[:-1]))
    start = BackwardBitReader(stream).remaining
    words = np.frombuffer(stream.ljust((len(stream) + 3) // 4 * 4, b"\0"), "<u4")
    sym = np.zeros(2048, np.int32)
    sym[: dt.symbol.shape[0]] = dt.symbol
    nbt = np.zeros(2048, np.int32)
    nbt[: dt.nb_bits.shape[0]] = dt.nb_bits
    return words, start, sym, nbt, dt.max_bits


def _spec_cases():
    rng = np.random.default_rng(0)
    pick = np.frombuffer(text_data(400), np.uint8)
    return {
        "struct": structured_data(30_000),
        "text": text_data(20_000),
        "tiny": text_data(64),
        "skewed": (b"aaaaaaaaab" * 3000)[:25_000],
        "random_text": rng.choice(pick, 12_000).tobytes(),
    }


@pytest.mark.parametrize("case", list(_spec_cases()))
def test_decode_stream_spec_equals_reference(case):
    """Chunk speculation against the JAX decode_stream_spec (the whole
    output) and the port's decode_stream_bitreach, on
    test_ops_entropy.py's streams."""
    data = _spec_cases()[case]
    words, start, sym, nbt, mb = _huffman_stream(data)
    out_bound = 1 << max((len(data) - 1).bit_length(), 4)
    ref_out, ref_n = ref_hs.decode_stream_spec_jit(
        jnp.asarray(words), jnp.int32(start), out_bound, jnp.asarray(sym), jnp.asarray(nbt),
        jnp.int32(mb))
    args = (torch.from_numpy(words.view(np.int32).copy())[None], torch.tensor([start]),
            out_bound, torch.from_numpy(sym)[None], torch.from_numpy(nbt)[None],
            torch.tensor([mb]))
    out, n = huffman_spec.decode_stream_spec(*args)
    out_b, n_b = huffman_spec.decode_stream_bitreach(*args)
    assert int(n[0]) == int(ref_n) == int(n_b[0]) == len(data)
    assert bytes(out[0, : len(data)].numpy()) == data
    assert np.array_equal(out[0].numpy(), np.asarray(ref_out))
    assert torch.equal(out[:, : len(data)], out_b[:, : len(data)])


def test_histograms_equal_reference():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 256, 5000, dtype=np.uint8)
    codes = [rng.integers(-3, 60, 700).astype(np.int32) for _ in range(3)]
    for n_valid in (None, 0, 1234):
        want = np.asarray(ref_hist.byte_histogram(jnp.asarray(data), n_valid))
        assert np.array_equal(histogram.byte_histogram(torch.from_numpy(data), n_valid).numpy(),
                              want)
    for n_valid in (0, 333, 700):
        want = ref_hist.code_histograms(*(jnp.asarray(c) for c in codes), n_valid)
        got = histogram.code_histograms(*(torch.from_numpy(c) for c in codes), n_valid)
        for g, w in zip(got, want):
            assert g.dtype == torch.int32 and np.array_equal(g.numpy(), np.asarray(w))
