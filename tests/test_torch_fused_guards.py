"""PyTorch port: the fused decode route's five guards against the JAX package.

The reference's ``_fused_exec_dispatch`` hands a frame set to its next
route, counted with a reason, when a prefix is over 128 KiB, a frame
bound is over 4 MiB off the ring route, a block's sequence bitstream is
over 16384 words, or a raw block or a block's literals are over 128 KiB
(``tpu_archive.py:2273-2362``). Each case below is a small frame built by
hand that trips one guard. It goes through the JAX package with
``ZEEKSTD_TPU_EXEC=fused`` (the guard, as the JAX tests force it on the
CPU) and ``=serial`` (the reference's next route on its device, with its
own guard), and through the port on its default route, which takes the
serial route past a fused guard (``decompress_frame``: the classic path,
as ``tpu_codec.tpu_decompress_frame`` does). Both give the same bytes or
the same error name, and libzstd's bytes where it takes the frame; the
port counts the fused fallback with the reference's reason, then the
serial route's own, as the reference does on its device. The one
difference by design: the port's serial route has no 4 MiB output cap,
so a frame bound over 4 MiB falls back once, not twice.
"""

import numpy as np
import pytest

pytest.importorskip("jax")

from zeekstd_tpu import tpu_archive as ref_archive
from zeekstd_tpu.tpu_codec import tpu_decompress_frame
from zeekstd_tpu_torch import archive, decode_routes
from zeekstd_tpu_torch.codec.literals import LIT_RAW, write_literals_header
from zeekstd_tpu_torch.codec.match import Sequence
from zeekstd_tpu_torch.codec.seq_encode import encode_sequences_section

from .oracle import zstd_compress, zstd_decompress
from .torch_threads import two_torch_threads  # noqa: F401

MAGIC = (0xFD2FB528).to_bytes(4, "little")
REASONS = {
    "prefix": "prefix over literal budget",
    "frame_bound": "frame bound 4198400 over cap",
    "bitstream": "bitstream over SMEM cap",
    "raw_block": "oversize raw block",
    "literal_budget": "oversize literal budget",
}


def _header(content_size: int) -> bytes:
    """Single-segment frame header with a 4-byte content size (the window
    is the content size)."""
    return MAGIC + bytes([0xA0]) + content_size.to_bytes(4, "little")


def _block(btype: int, payload: bytes, last: bool, size: int | None = None) -> bytes:
    size = len(payload) if size is None else size
    return ((size << 3) | (btype << 1) | int(last)).to_bytes(3, "little") + payload


def _case(name: str):
    """(frame, expected bytes, prefix or None)."""
    rng = np.random.default_rng(list(REASONS).index(name))
    if name == "prefix":
        old = rng.integers(0, 256, 140 << 10, dtype=np.uint8).tobytes()
        new = old[1000:9000] + old[100000:108000]
        return zstd_compress(new, 3, prefix=old), new, old
    if name == "frame_bound":
        # 33 RLE blocks: 4 MiB + 4 KiB of output from 141 bytes.
        n = (4 << 20) + 4096
        out, left = bytearray(_header(n)), n
        while left:
            k = min(left, 128 << 10)
            left -= k
            out += _block(1, b"\x5a", left == 0, size=k)
        return bytes(out), b"\x5a" * n, None
    if name == "bitstream":
        # A raw 128 KiB block of history, then a block of 40 000 3-byte
        # matches at random offsets: an 89 437-byte sequence bitstream.
        hist = rng.integers(0, 256, 128 << 10, dtype=np.uint8).tobytes()
        out, seqs = bytearray(hist), []
        for _ in range(40000):
            off = int(rng.integers(8, len(out) - 8))
            for _ in range(3):
                out.append(out[-off])
            seqs.append(Sequence(0, 3, off + 3))
        body = write_literals_header(LIT_RAW, 0, 0, False) + encode_sequences_section(seqs)
        frame = _header(len(out)) + _block(0, hist, False) + _block(2, body, True)
        return frame, bytes(out), None
    if name == "raw_block":
        # A raw block whose 21-bit size is 200 KiB.
        data = rng.integers(0, 256, 200 << 10, dtype=np.uint8).tobytes()
        return _header(len(data)) + _block(0, data, True), data, None
    # A compressed block with 130 KiB of raw literals and no sequences.
    lits = rng.integers(0, 256, 130 << 10, dtype=np.uint8).tobytes()
    body = write_literals_header(LIT_RAW, len(lits), 0, False) + lits + b"\x00"
    return _header(len(lits)) + _block(2, body, True), lits, None


def _outcome(fn):
    """The decoded bytes, or the error's class name."""
    try:
        return fn()
    except Exception as e:  # compared by name with the other package's
        return type(e).__name__


def _reference(monkeypatch, frame, prefix, mode):
    """(outcome, fallbacks counted, last reason) of the JAX package."""
    monkeypatch.setenv("ZEEKSTD_TPU_EXEC", mode)
    before = ref_archive.serial_fallback_count()
    monkeypatch.setitem(ref_archive._serial_fallbacks, "reason", "")
    if prefix is None:
        got = _outcome(lambda: ref_archive.tpu_decompress_archive(frame))
    else:
        got = _outcome(lambda: tpu_decompress_frame(frame, 0, prefix=prefix)[0])
    return got, ref_archive.serial_fallback_count() - before, ref_archive._serial_fallbacks["reason"]


def _port(monkeypatch, decode):
    """(outcome, fallbacks counted, last reason) of the port's default route."""
    monkeypatch.delenv("ZEEKSTD_TPU_EXEC", raising=False)
    before = decode_routes.serial_fallback_count()
    monkeypatch.setitem(decode_routes._serial_fallbacks, "reason", "")
    got = _outcome(decode)
    return got, decode_routes.serial_fallback_count() - before, decode_routes._serial_fallbacks["reason"]


@pytest.mark.parametrize("name", list(REASONS))
def test_guard_takes_the_reference_route(monkeypatch, name):
    frame, want, prefix = _case(name)
    if prefix is None:
        got, n, why = _port(monkeypatch, lambda: archive.decompress_archive(frame, device="cpu"))
    else:
        got, n, why = _port(monkeypatch, lambda: archive.decompress_frame(
            frame, 0, prefix=prefix, device="cpu")[0])
    ref_f, n_f, why_f = _reference(monkeypatch, frame, prefix, "fused")
    ref_s, n_s, why_s = _reference(monkeypatch, frame, prefix, "serial")
    assert (n_f, why_f) == (1, REASONS[name])
    assert got == ref_f == ref_s
    if name == "literal_budget":
        # Literals over the format's 128 KiB block cap: libzstd refuses
        # the frame; both packages decode the bytes it declares.
        with pytest.raises(RuntimeError):
            zstd_decompress(frame, 1 << 23)
        assert got == want
    else:
        assert got == want == zstd_decompress(frame, 1 << 23, prefix=prefix)
    serial_own = 0 if name == "frame_bound" else n_s
    assert n == 1 + serial_own
    assert why == (why_s if serial_own else why_f)


def test_guard_fallback_on_every_entry_point(monkeypatch):
    """Two raw-block frames through decode_frames (fused guard, then the
    serial route's own), decompress_frame (the classic path, as the
    reference's) and decompress_archive with the output left on the
    device."""
    frame, want, _ = _case("raw_block")
    blob = frame + frame
    spans = [(0, len(frame)), (len(frame), len(blob))]
    got, n, why = _port(monkeypatch, lambda: archive.decode_frames(blob, spans, device="cpu"))
    assert (got, n, why) == ([want, want], 2, "oversize block literal budget")
    got, n, why = _port(monkeypatch, lambda: archive.decompress_frame(
        blob, len(frame), device="cpu"))
    assert (got, n, why) == ((want, len(blob)), 1, "oversize raw block")
    monkeypatch.setenv("ZEEKSTD_TPU_EXEC", "fused")
    before = ref_archive.serial_fallback_count()
    assert tpu_decompress_frame(blob, len(frame)) == (want, len(blob))
    assert ref_archive.serial_fallback_count() == before + 1
    (out, sizes), n, _why = _port(monkeypatch, lambda: archive.decompress_archive(
        frame, return_device=True, device="cpu"))
    assert sizes == [len(want)] and n == 2
    assert out[0, : sizes[0]].numpy().tobytes() == want
