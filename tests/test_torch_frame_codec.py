"""PyTorch port: the per-frame device encoder (``frame_codec``) against the
JAX package's ``tpu_codec.tpu_compress_frame``.

On the CPU (``device="cpu"``: the kernels' plain versions), on the cases
of ``tests/frame_cases.py`` (those of ``tests/test_tpu_codec.py`` plus a
literal run and a match past 16 bits in one 128 KiB block):

- every frame equals the JAX package's byte for byte, checksums on and
  off, and libzstd, the port's device decoder and the host codec read it;
- ``parse_and_code`` gives the JAX package's arrays over their valid
  regions;
- inputs under 64 bytes and a parse past the sequence bound (patched
  small in both packages) take the host frame encoder, as in the
  reference;
- the archive pipeline gives the JAX package's archive on the long
  literal run too;
- the mutations and truncations of ``tests/test_tpu_fuzz.py``, decoded by
  the port, end in an error or the exact bytes.
"""

import random

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
jnp = jax.numpy

import zeekstd_tpu.tpu_codec as ref_codec
import zeekstd_tpu_torch as zt
from zeekstd_tpu.tpu_archive import tpu_compress_archive
from zeekstd_tpu_torch import archive, frame_codec
from zeekstd_tpu_torch.codec.compress import compress_frame as host_compress_frame
from zeekstd_tpu_torch.codec.decompress import decompress_frame as host_decompress_frame
from zeekstd_tpu_torch.errors import ZeekstdError

from .frame_cases import CASES, structured_data, text_data
from .oracle import zstd_decompress
from .torch_threads import two_torch_threads  # noqa: F401


@pytest.fixture(scope="module")
def frames():
    """{(case, checksum): (port frame, JAX package's frame)}."""
    out = {}
    for name, data in CASES.items():
        for checksum in (False, True):
            out[name, checksum] = (
                frame_codec.compress_frame(data, checksum=checksum, device="cpu"),
                ref_codec.tpu_compress_frame(data, checksum=checksum),
            )
    return out


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "checksum"])
@pytest.mark.parametrize("name", list(CASES))
def test_frame_equals_reference(frames, name, checksum):
    got, want = frames[name, checksum]
    assert got == want


@pytest.mark.parametrize("name", list(CASES))
def test_every_decoder_reads_the_frame(frames, name):
    data = CASES[name]
    frame = frames[name, True][0]
    assert zstd_decompress(frame, len(data) + 64) == data
    assert archive.decompress_frame(frame, device="cpu") == (data, len(frame))
    assert host_decompress_frame(frame) == (data, len(frame))


def _parse_both(data):
    n = len(data)
    n_pad = 1 << max((n - 1).bit_length(), 10)
    seq_bound = min(frame_codec.SEQ_BOUND, max(2048, n_pad // 8))
    padded = np.zeros(n_pad, np.uint8)
    padded[:n] = np.frombuffer(data, np.uint8)
    got = frame_codec.parse_and_code(torch.from_numpy(padded), n, seq_bound)
    want = ref_codec._get_parse_fn(n_pad, seq_bound)(jnp.asarray(padded), n)
    return [t.numpy() for t in got], [np.asarray(t) for t in want]


@pytest.mark.parametrize("name", ["text", "struct", "multiblock", "long_literals", "long_match"])
def test_parse_and_code_equals_reference(name):
    got, want = _parse_both(CASES[name])
    n_seq, n_lit = int(got[3]), int(got[5])
    assert (n_seq, n_lit, int(got[9])) == (int(want[3]), int(want[5]), int(want[9]))
    for k in (0, 1, 2, 6, 7, 8):  # lls, mls, ov and the three codes
        np.testing.assert_array_equal(got[k][:n_seq], want[k][:n_seq], err_msg=str(k))
    np.testing.assert_array_equal(got[4][:n_lit], want[4][:n_lit])


@pytest.mark.parametrize("name,field", [("long_literals", 0), ("long_match", 1)])
def test_lengths_past_16_bits_reach_the_fse_stage(name, field):
    """A block's literal run (clamped to the block) or match passes 65,535,
    so the FSE stage takes the wide layout; the frame still equals the
    JAX package's (``test_frame_equals_reference``)."""
    got, _ = _parse_both(CASES[name])
    lls, mls, n_seq = got[0], got[1], int(got[3])
    starts = np.concatenate([[0], np.cumsum(lls[:n_seq].astype(np.int64) + mls[:n_seq])])
    mstart = starts[:-1] + lls[:n_seq]
    block = mstart // frame_codec.BLOCK_SIZE
    clamped = mstart - np.maximum(mstart - lls[:n_seq], block * frame_codec.BLOCK_SIZE)
    assert (clamped, mls[:n_seq])[field].max() > 0xFFFF


@pytest.mark.parametrize("checksum", [False, True])
def test_empty_and_short_inputs_equal_reference(checksum):
    data = text_data(200)
    for n in (0, 1, 5, 63, 64, 65):
        assert frame_codec.compress_frame(data[:n], checksum=checksum, device="cpu") == \
            ref_codec.tpu_compress_frame(data[:n], checksum=checksum), n


def test_sequence_bound_overflow_takes_host_encoder(monkeypatch):
    """With the per-frame bound patched to 16 sequences in both packages,
    a frame of more goes to the host encoder at level 1 in both."""
    monkeypatch.setattr(frame_codec, "SEQ_BOUND", 16)
    monkeypatch.setattr(ref_codec, "SEQ_BOUND", 16)
    data = structured_data(6000)
    got = frame_codec.compress_frame(data, checksum=True, device="cpu")
    assert got == ref_codec.tpu_compress_frame(data, checksum=True)
    assert got == host_compress_frame(data, level=1, checksum=True)
    assert zstd_decompress(got, len(data) + 64) == data


def test_compress_archive_on_long_literal_run_equals_reference():
    """The archive pipeline's 32 KiB blocks keep every length in 16 bits;
    the long literal run gives the JAX package's archive at level 3."""
    data = CASES["long_literals"]
    blob, st = zt.compress_archive(data, frame_size=len(data), level=3, device="cpu")
    ref_blob, ref_st = tpu_compress_archive(data, frame_size=len(data), level=3)
    assert blob == ref_blob
    assert zt.decompress_archive(blob, st, device="cpu") == data


def test_no_card_raises_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        frame_codec.compress_frame(text_data(1000))


def _outcome(frame, original):
    try:
        out = archive.decompress_frame(bytes(frame), device="cpu")[0]
    except (ZeekstdError, OverflowError):
        return "error"
    return "intact" if out == original else "silent"


def test_frame_mutations_graceful():
    data = text_data(30_000)
    frame = frame_codec.compress_frame(data, checksum=True, device="cpu")
    rng = random.Random(1)
    for _ in range(60):
        mutated = bytearray(frame)
        for _k in range(rng.randrange(1, 4)):
            mutated[rng.randrange(len(mutated))] ^= 1 << rng.randrange(8)
        # With checksums on, a mutation never gives silently wrong bytes.
        assert _outcome(mutated, data) != "silent"


def test_frame_truncations_graceful():
    data = structured_data(20_000)
    frame = frame_codec.compress_frame(data, checksum=True, device="cpu")
    for cut in range(1, len(frame), max(len(frame) // 37, 1)):
        assert _outcome(frame[:cut], data) in ("error", "intact"), cut


def test_giant_declared_size_rejected():
    frame = bytearray(frame_codec.compress_frame(text_data(5_000), device="cpu"))
    rest = frame[6 if not (frame[4] & 0x20) else 5 :]
    forged = frame[:4] + bytes([0xC0]) + (1 << 40).to_bytes(8, "little")
    with pytest.raises(ZeekstdError):
        archive.decompress_frame(bytes(forged + rest), device="cpu")


def test_offset_beyond_window_rejected():
    data = structured_data(40_000)
    frame = frame_codec.compress_frame(data, device="cpu")  # no checksum
    rng = random.Random(3)
    outcomes = set()
    for _ in range(80):
        mutated = bytearray(frame)
        mutated[rng.randrange(len(frame) // 2, len(frame))] ^= 0xFF
        outcomes.add(_outcome(mutated, data))
    # Without checksums some payload flips decode to other valid bytes; the
    # validation must still catch structural breakage.
    assert "error" in outcomes
