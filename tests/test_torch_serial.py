"""PyTorch port: the serial and pointer-doubling decode routes
(``ZEEKSTD_TPU_EXEC=serial|doubling``) against the JAX package.

- Both routes decode the port's own level-1 and level-3 archives, the
  raw/RLE mix of ``test_tpu_codec.py`` (a native multi-threaded archive),
  and libzstd level-6 frames (several blocks, cross-block repeat
  offsets; one without a content size), with and without a seek table,
  and with ``return_device``; no archive leaves the serial executor.
- Mutated and truncated archives fail with the same error names as the
  JAX package's routes: all cases on the doubling route, four on the
  serial route (the JAX serial route runs its kernel in interpret mode).
- Copy chains deeper than the reference's deepest doubling program
  (2^12 segments) resolve on both routes and through ``decompress_frame``:
  the doubling depth follows the frame size. The serial route's
  literal-window guard hands the archive to the doubling route and
  counts it.
- ``decompress_frame`` with a prefix on the classic path equals
  ``tpu_decompress_frame`` on its classic path.
- The pointer-doubling executor equals the JAX one (layout, bytes,
  convergence), on well-formed and on hostile sequences.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.errors import ZeekstdError as RefZeekstdError
from zeekstd_tpu.native.loader import compress_stream_mt
from zeekstd_tpu.tpu_archive import tpu_decompress_archive
from zeekstd_tpu.tpu_codec import tpu_decompress_frame
from zeekstd_tpu_torch import archive, decode_routes
from zeekstd_tpu_torch.errors import ZeekstdError
from zeekstd_tpu_torch.seek_table import SeekTable

from .oracle import zstd_compress
from .torch_threads import two_torch_threads  # noqa: F401

ROUTES = ["serial", "doubling"]


def _text(n, seed):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    return b" ".join(words[rng.integers(0, 200)] for _ in range(n // 5))[:n]


def _data():
    rng = np.random.default_rng(55)
    text = _text(80000, 55)
    return (text[:20000] + b"R" * 3000 + bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
            + b"abcabcabc" * 1000 + text[20000:])[: 48 << 10]


def _mix():
    """The raw/RLE mix of test_tpu_codec.py: text, random bytes, zeros."""
    rng = random.Random(3)
    base = b"seekable zstandard frames decode independently " * 800
    return (base[:30000] + bytes(rng.randrange(256) for _ in range(8000)) + b"\x00" * 5000
            + base[:20000])


def _table(sizes, decomp):
    st = SeekTable()
    for c, d in zip(sizes, decomp):
        st.log_frame(c, d)
    return st


@pytest.fixture(scope="module")
def inputs():
    """name -> (blob, seek table or None, data)."""
    data = _data()
    out = {}
    for level, frame in ((1, 16 << 10), (3, 32 << 10)):
        blob, st = archive.compress_archive(data, frame_size=frame, level=level, checksum=True,
                                            device="cpu")
        out[f"L{level}"] = (blob, st, data)
    mix = _mix()
    blob, sizes = compress_stream_mt(mix, 1 << 15, checksum=True, nthreads=2, level=3)
    out["mix"] = (blob, _table(sizes, [min(1 << 15, len(mix) - i * (1 << 15))
                                       for i in range(len(sizes))]), mix)
    big = _text(150 << 10, 9)
    frame = zstd_compress(big, 6)
    out["libzstd6"] = (frame, _table([len(frame)], [len(big)]), big)
    small = _text(20000, 4)
    frame = zstd_compress(small, 6, content_size_flag=False)
    out["libzstd6-nosize"] = (frame, _table([len(frame)], [len(small)]), small)
    return out


@pytest.fixture
def route(request, monkeypatch):
    monkeypatch.setenv("ZEEKSTD_TPU_EXEC", request.param)
    return request.param


@pytest.mark.parametrize("route", ROUTES, indirect=True)
@pytest.mark.parametrize("name", ["L1", "L3", "mix", "libzstd6", "libzstd6-nosize"])
@pytest.mark.parametrize("with_table", [True, False])
def test_routes_decode_own_and_foreign_archives(inputs, route, name, with_table):
    blob, st, data = inputs[name]
    fallbacks = decode_routes.serial_fallback_count()
    out = archive.decompress_archive(blob, st if with_table else None, device="cpu")
    assert out == data
    assert decode_routes.serial_fallback_count() == fallbacks


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_routes_return_device(inputs, route):
    blob, st, data = inputs["L3"]
    out, sizes = archive.decompress_archive(blob, st, return_device=True, device="cpu")
    assert isinstance(out, torch.Tensor) and out.dtype == torch.uint8
    assert sizes == [st.frame_size_decomp(i) for i in range(st.num_frames)]
    got = b"".join(out[i, :n].numpy().tobytes() for i, n in enumerate(sizes))
    assert got == data


def _outcome(decode, blob, original):
    try:
        out = decode(blob)
    except (ZeekstdError, RefZeekstdError) as e:
        return ("error", getattr(e, "name", type(e).__name__))
    except OverflowError:
        return ("error", "OverflowError")
    return ("intact",) if out == original else ("silent",)


def _cases(blob):
    rng = random.Random(2)
    cases = []
    for _ in range(16):
        mutated = bytearray(blob)
        for _k in range(rng.randrange(1, 4)):
            mutated[rng.randrange(len(mutated))] ^= 1 << rng.randrange(8)
        cases.append(bytes(mutated))
    return cases + [blob[: int(len(blob) * frac)] for frac in (0.1, 0.45, 0.8, 0.99)]


@pytest.fixture(scope="module")
def reference_outcomes(inputs):
    """The JAX package's outcomes: every case on the doubling route, the
    first four on the serial route (one kernel compile, shared)."""
    blob, st, data = inputs["L1"]
    ref_st = _reference_table(st)
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for mode, cases in (("doubling", _cases(blob)), ("serial", _cases(blob)[:4])):
            mp.setenv("ZEEKSTD_TPU_EXEC", mode)
            out[mode] = [_outcome(lambda b: tpu_decompress_archive(b, ref_st), c, data)
                         for c in cases]
    finally:
        mp.undo()
    return out


def _reference_table(st):
    from zeekstd_tpu.seek_table import SeekTable as RefSeekTable

    return RefSeekTable.from_bytes(st.to_bytes())


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_mutations_fail_like_reference(inputs, reference_outcomes, route):
    blob, st, data = inputs["L1"]
    want = reference_outcomes[route]
    cases = _cases(blob)[: len(want)]
    got = [_outcome(lambda b: archive.decompress_archive(b, st, device="cpu"), c, data)
           for c in cases]
    assert ("silent",) not in got
    assert got == want


def _deep_chain_frame():
    """A libzstd frame (1 KiB window) of 16-byte periods that differ only
    in their first byte: its 9,600 matches each copy the previous period,
    so copy chains cross about 9,600 segments."""
    rng = np.random.default_rng(8)
    n, period = 150 << 10, 16
    data = np.tile(rng.integers(0, 256, period, dtype=np.uint8), n // period)
    data[::period] = np.arange(n // period) % 251
    data = data.tobytes()
    return zstd_compress(data, 6, window_log=10), data


@pytest.mark.parametrize("route", ROUTES, indirect=True)
def test_deep_copy_chains_resolve(route, monkeypatch):
    from zeekstd_tpu_torch.ops import seq_exec

    frame, data = _deep_chain_frame()
    calls = []
    orig = seq_exec.execute_sequences_batch

    def record(*a, **k):
        calls.append((a, k))
        return orig(*a, **k)

    monkeypatch.setattr(seq_exec, "execute_sequences_batch", record)
    assert archive.decompress_archive(frame, None, device="cpu") == data
    out, sizes = archive.decompress_archive(frame, None, return_device=True, device="cpu")
    assert out[0, : sizes[0]].numpy().tobytes() == data
    assert archive.decompress_frame(frame, 0, device="cpu") == (data, len(frame))
    # One doubling pass per bit of the 256 KiB output bound; the
    # reference's 12 passes leave this frame unresolved.
    a, k = calls[-1]
    assert k["n_doublings"] == 18
    assert not bool(orig(*a[:5], n_doublings=12)[1][0])


def test_serial_guard_hands_over_to_doubling(inputs, monkeypatch):
    monkeypatch.setenv("ZEEKSTD_TPU_EXEC", "serial")
    monkeypatch.setattr(decode_routes, "SERIAL_LITB", 1024)
    blob, st, data = inputs["L3"]
    before = decode_routes.serial_fallback_count()
    assert archive.decompress_archive(blob, st, device="cpu") == data
    assert decode_routes.serial_fallback_count() == before + 1


def test_exec_mode_values(monkeypatch):
    for value, mode in (("", "fused"), ("fused", "fused"), ("serial", "serial"),
                        ("doubling", "doubling"), ("other", "fused")):
        monkeypatch.setenv("ZEEKSTD_TPU_EXEC", value)
        assert decode_routes.exec_mode() == mode


@pytest.mark.parametrize("route", ["doubling"], indirect=True)
def test_decompress_frame_with_prefix_equals_reference(route):
    rng = np.random.default_rng(21)
    old = _text(30000, 21)
    new = bytearray(old[4000:] + _text(20000, 22) + old[:9000])
    for p in rng.integers(0, len(new) - 8, 60):
        new[p : p + 8] = bytes(rng.integers(0, 256, 8, dtype=np.uint8))
    new = bytes(new)
    blob, st = archive.compress_archive(new, frame_size=64 << 10, level=3, checksum=True,
                                        prefix=old, device="cpu")
    for i in range(st.num_frames):
        pos = st.frame_start_comp(i)
        got = archive.decompress_frame(blob, pos, prefix=old, device="cpu")
        want = tpu_decompress_frame(blob, pos, prefix=old)
        assert got == want
        assert got[0] == new[st.frame_start_decomp(i) : st.frame_end_decomp(i)]
        assert got[1] == st.frame_end_comp(i)


def _seq_rows(rng, F, S, hostile):
    lls = rng.integers(0, 20, (F, S)).astype(np.int32)
    mls = rng.integers(0, 40, (F, S)).astype(np.int32)
    pos = np.cumsum(lls + mls, axis=1) - mls
    offs = (rng.integers(0, 1 << 30, (F, S)) % np.maximum(pos, 1) + 1).astype(np.int32)
    offs[:, ::7] = rng.integers(1, 4, offs[:, ::7].shape)  # short, overlapping copies
    lls[:, -3:] = mls[:, -3:] = 0  # padding sequences
    if hostile:
        offs[:, 5] = pos[:, 5] + 9
        offs[:, 9] = 0
        lls[:, 2] = -7
    return lls, mls, offs


@pytest.mark.parametrize("hostile", [False, True])
@pytest.mark.parametrize("n_doublings", [1, 12])
def test_seq_exec_equals_reference(hostile, n_doublings):
    """The pointer-doubling executor (plain torch) equals the JAX one:
    layout, bytes and convergence flags, batched over frames."""
    from zeekstd_tpu.ops import seq_exec as ref_se
    from zeekstd_tpu_torch.ops import seq_exec

    rng = np.random.default_rng(31 + hostile)
    F, S, OUT = 3, 64, 4096
    lls, mls, offs = _seq_rows(rng, F, S, hostile)
    lits = rng.integers(0, 256, (F, 1024)).astype(np.uint8)
    got = seq_exec.build_sequence_layout(*(torch.from_numpy(a) for a in (lls, mls, offs)), OUT)
    out, conv = seq_exec.execute_sequences_batch(
        torch.from_numpy(lits), *(torch.from_numpy(a) for a in (lls, mls, offs)), OUT,
        n_doublings)
    ref_out, ref_conv = ref_se.execute_sequences_batch(
        jax.numpy.asarray(lits), jax.numpy.asarray(lls), jax.numpy.asarray(mls),
        jax.numpy.asarray(offs), OUT, n_doublings)
    for f in range(F):
        ref = ref_se.build_sequence_layout(lls[f], mls[f], offs[f], OUT)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g[f].numpy(), np.asarray(r))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref_out))
    np.testing.assert_array_equal(conv.numpy(), np.asarray(ref_conv))
