"""Frame decompression: block loop, per-frame entropy state, checksum verify.

Host-path replacement for libzstd's ``ZSTD_decompress_stream`` surface that
the reference drives (reference: lib/src/decode.rs:242-256, SURVEY §2.3).
``DCtx`` mirrors the context object semantics: parameters survive
``reset()``, ``ref_prefix`` applies to the next frame only.
"""

from __future__ import annotations

from ..constants import ZSTD_WINDOWLOG_MAX
from ..errors import checksum_wrong, corruption_detected, src_size_wrong
from ..xxhash64 import XXH64
from . import frame as frame_mod
from . import literals as lit_mod
from . import sequences as seq_mod


class DCtx:
    """Decompression context with libzstd-like parameter semantics
    (reference exercises WindowLogMax, ref_prefix, reset:
    cli/src/decompress.rs:56-62, lib/src/decode.rs:212-214, 249-255)."""

    def __init__(self):
        self.window_log_max = ZSTD_WINDOWLOG_MAX
        self._prefix: bytes | None = None

    def set_parameter_window_log_max(self, wlog: int) -> None:
        self.window_log_max = wlog

    def ref_prefix(self, prefix: bytes) -> None:
        """Reference a prefix (dictionary-lite) for the next frame only."""
        self._prefix = prefix

    def reset_session(self) -> None:
        self._prefix = None

    def take_prefix(self) -> bytes:
        p = self._prefix
        self._prefix = None
        return p if p is not None else b""

    def decompress_frame(self, data: bytes, pos: int = 0):
        """Decompress one complete frame starting at ``data[pos]``.

        Returns ``(output_bytes, end_pos)``. Skippable frames yield empty
        output. The referenced prefix (if any) is consumed.
        """
        prefix = self.take_prefix()
        return decompress_frame(
            data, pos, prefix=prefix, window_log_max=self.window_log_max
        )


def decompress_frame(data: bytes, pos: int = 0, prefix: bytes = b"", window_log_max: int = ZSTD_WINDOWLOG_MAX):
    """Decode one frame (zstd or skippable) at ``data[pos]``; returns
    ``(output, end_pos)``."""
    if len(data) - pos < 4:
        raise src_size_wrong("input too short for frame magic")
    magic = int.from_bytes(data[pos : pos + 4], "little")
    if (magic & 0xFFFF_FFF0) == frame_mod.ZSTD_MAGIC_SKIPPABLE_START:
        if len(data) - pos < 8:
            raise src_size_wrong("truncated skippable frame header")
        size = int.from_bytes(data[pos + 4 : pos + 8], "little")
        end = pos + 8 + size
        if end > len(data):
            raise src_size_wrong("truncated skippable frame")
        return b"", end

    hdr = frame_mod.parse_frame_header(data[pos:])
    if hdr.window_size is not None and hdr.window_size > (1 << window_log_max):
        raise corruption_detected(
            f"frame window {hdr.window_size} exceeds windowLogMax {window_log_max}"
        )
    fpos = pos + hdr.header_size

    state = FrameDecodeState(prefix)
    block_max = frame_mod.block_size_max(hdr.window_size or (1 << window_log_max))

    while True:
        last, btype, bsize, consumed = frame_mod.parse_block_header(data[fpos:])
        fpos += consumed
        if btype == frame_mod.BLOCK_RAW:
            end = fpos + bsize
            if end > len(data):
                raise src_size_wrong("truncated raw block")
            state.append_raw(data[fpos:end])
            fpos = end
        elif btype == frame_mod.BLOCK_RLE:
            if fpos >= len(data):
                raise src_size_wrong("truncated RLE block")
            state.append_raw(bytes([data[fpos]]) * bsize)
            fpos += 1
        else:
            if bsize > block_max:
                raise corruption_detected("compressed block exceeds maximum size")
            end = fpos + bsize
            if end > len(data):
                raise src_size_wrong("truncated compressed block")
            decode_block(data[fpos:end], state)
            fpos = end
        if last:
            break

    out = state.output()
    if hdr.content_size is not None and len(out) != hdr.content_size:
        raise corruption_detected(
            f"frame content size {hdr.content_size} != decoded {len(out)}"
        )
    if hdr.has_checksum:
        if len(data) - fpos < 4:
            raise src_size_wrong("truncated content checksum")
        stored = int.from_bytes(data[fpos : fpos + 4], "little")
        fpos += 4
        h = XXH64(0)
        h.update(out)
        if (h.digest() & 0xFFFF_FFFF) != stored:
            raise checksum_wrong("content checksum mismatch")
    return out, fpos


class FrameDecodeState:
    """Per-frame mutable decode state: window (prefix + history), repeat
    offsets, and the carried Huffman/FSE tables for repeat modes."""

    def __init__(self, prefix: bytes = b""):
        self.window = bytearray(prefix)
        self.window_start = 0  # matches may reach into the prefix
        self.prefix_len = len(prefix)
        self.rep_offsets = (1, 4, 8)
        self.huf_table = None
        self.ll_table = None
        self.of_table = None
        self.ml_table = None

    def append_raw(self, chunk: bytes) -> None:
        self.window += chunk

    def output(self) -> bytes:
        return bytes(self.window[self.prefix_len :])


def decode_block(block: bytes, state: FrameDecodeState) -> int:
    """Decode one compressed block into the frame state; returns bytes
    produced (RFC 8878 §3.1.1.3)."""
    lits, consumed, state.huf_table = lit_mod.decode_literals(block, state.huf_table)
    rest = block[consumed:]

    nseq, nconsumed = seq_mod.parse_num_sequences(rest)
    rest = rest[nconsumed:]

    if nseq == 0:
        if rest:
            raise corruption_detected("trailing bytes after empty sequences section")
        state.window += lits
        return len(lits)

    if not rest:
        raise corruption_detected("missing symbol compression modes")
    modes = rest[0]
    if modes & 0x03:
        raise corruption_detected("reserved symbol-compression-mode bits set")
    rest = rest[1:]

    ll_mode = (modes >> 6) & 3
    of_mode = (modes >> 4) & 3
    ml_mode = (modes >> 2) & 3

    ll_table, c = seq_mod.read_symbol_table(rest, ll_mode, "ll", state.ll_table)
    rest = rest[c:]
    of_table, c = seq_mod.read_symbol_table(rest, of_mode, "of", state.of_table)
    rest = rest[c:]
    ml_table, c = seq_mod.read_symbol_table(rest, ml_mode, "ml", state.ml_table)
    rest = rest[c:]
    state.ll_table, state.of_table, state.ml_table = ll_table, of_table, ml_table

    seqs = seq_mod.decode_sequences(
        rest, nseq, ll_table, of_table, ml_table, state.rep_offsets
    )
    state.rep_offsets = seqs.rep_offsets
    return seq_mod.execute_sequences(seqs, lits, state.window, state.window_start)


class StreamingFrameDecoder:
    """Block-by-block frame decode with O(window) memory — the analog of
    the reference's dummy-decode to mid-frame offsets (lib/src/decode.rs:
    228-232), whose memory bound is its out-buffer rather than the frame.

    ``next_block()`` returns one block's decompressed bytes (b'' only for
    an empty block, None when the frame is done). History older than the
    frame's declared window (plus one block of slack) is discarded as
    decoding advances, so a 1 GiB frame with a 2 MiB window decodes in
    ~2 MiB of state.
    """

    def __init__(self, data, pos: int = 0, prefix: bytes = b"",
                 window_log_max: int = ZSTD_WINDOWLOG_MAX):
        # ``data`` may be bytes or any object with __len__ and bounded
        # slice __getitem__ (e.g. a lazy source-backed window), so the
        # compressed side is bounded too; all accesses below are bounded
        # slices.
        self._data = data
        hdr = frame_mod.parse_frame_header(bytes(data[pos : pos + 32]))
        if hdr.window_size is not None and hdr.window_size > (1 << window_log_max):
            raise corruption_detected(
                f"frame window {hdr.window_size} exceeds windowLogMax {window_log_max}"
            )
        self.header = hdr
        self._fpos = pos + hdr.header_size
        self._state = FrameDecodeState(prefix)
        self._window_size = hdr.window_size or (1 << window_log_max)
        self._block_max = frame_mod.block_size_max(self._window_size)
        self._hasher = XXH64(0) if hdr.has_checksum else None
        self._produced = 0
        self._done = False
        self.end_pos: int | None = None

    def next_block(self):
        if self._done:
            return None
        data, fpos, state = self._data, self._fpos, self._state
        before = len(state.window)
        last, btype, bsize, consumed = frame_mod.parse_block_header(
            bytes(data[fpos : fpos + 8])
        )
        fpos += consumed
        if btype == frame_mod.BLOCK_RAW:
            end = fpos + bsize
            if end > len(data):
                raise src_size_wrong("truncated raw block")
            state.append_raw(bytes(data[fpos:end]))
            fpos = end
        elif btype == frame_mod.BLOCK_RLE:
            if fpos >= len(data):
                raise src_size_wrong("truncated RLE block")
            state.append_raw(bytes(data[fpos : fpos + 1]) * bsize)
            fpos += 1
        else:
            if bsize > self._block_max:
                raise corruption_detected("compressed block exceeds maximum size")
            end = fpos + bsize
            if end > len(data):
                raise src_size_wrong("truncated compressed block")
            decode_block(bytes(data[fpos:end]), state)
            fpos = end
        self._fpos = fpos
        out = bytes(state.window[before:])
        self._produced += len(out)
        if self._hasher is not None:
            self._hasher.update(out)
        # Trim history beyond the declared window (+ slack): valid frames
        # never reference further back; indices stay relative to the end.
        keep = self._window_size + self._block_max
        drop = len(state.window) - keep
        if drop > self._block_max:
            del state.window[:drop]
        if last:
            self._done = True
            hdr = self.header
            if hdr.content_size is not None and self._produced != hdr.content_size:
                raise corruption_detected(
                    f"frame content size {hdr.content_size} != decoded {self._produced}"
                )
            if hdr.has_checksum:
                if len(data) - fpos < 4:
                    raise src_size_wrong("truncated content checksum")
                stored = int.from_bytes(bytes(data[fpos : fpos + 4]), "little")
                fpos += 4
                if (self._hasher.digest() & 0xFFFF_FFFF) != stored:
                    raise checksum_wrong("content checksum mismatch")
            self.end_pos = fpos
        return out


def decompress(data: bytes, prefix: bytes = b"") -> bytes:
    """Decompress a concatenation of frames (skippable frames skipped)."""
    out = []
    pos = 0
    while pos < len(data):
        chunk, pos = decompress_frame(data, pos, prefix=prefix)
        out.append(chunk)
    return b"".join(out)
