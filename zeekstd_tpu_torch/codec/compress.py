"""Frame compression: block splitting, literals/sequences encoding, checksum.

Host-path replacement for libzstd's ``ZSTD_compressStream2`` surface the
reference drives (reference: lib/src/encode.rs:341-345, SURVEY §2.3).
``CCtx`` mirrors the context semantics: parameters persist across
``reset_session``; ``ref_prefix`` applies to the next frame only.
"""

from __future__ import annotations

from ..constants import DEFAULT_COMPRESSION_LEVEL
from ..xxhash64 import XXH64
from . import frame as frame_mod
from .block_compress import compress_block


class CCtx:
    """Compression context (parameters + per-frame state)."""

    def __init__(self):
        self.level = DEFAULT_COMPRESSION_LEVEL
        self.checksum = False
        self.window_log = 0  # 0 = derive from level/content
        self.ldm = False
        self._prefix: bytes | None = None

    def set_compression_level(self, level: int) -> None:
        self.level = level

    def set_checksum_flag(self, flag: bool) -> None:
        self.checksum = flag

    def set_window_log(self, wlog: int) -> None:
        self.window_log = wlog

    def set_enable_ldm(self, flag: bool) -> None:
        self.ldm = flag

    def ref_prefix(self, prefix: bytes) -> None:
        self._prefix = prefix

    def reset_session(self) -> None:
        self._prefix = None

    def take_prefix(self) -> bytes:
        p = self._prefix
        self._prefix = None
        return p if p is not None else b""

    def compress_frame(self, data: bytes) -> bytes:
        prefix = self.take_prefix()
        return compress_frame(
            data,
            level=self.level,
            checksum=self.checksum,
            prefix=prefix,
            window_log=self.window_log,
            enable_ldm=self.ldm,
        )


def compress_frame(
    data: bytes,
    level: int = DEFAULT_COMPRESSION_LEVEL,
    checksum: bool = False,
    prefix: bytes = b"",
    window_log: int = 0,
    enable_ldm: bool = False,
) -> bytes:
    """Compress ``data`` into a single complete zstd frame."""
    if level <= 4 and not prefix and window_log == 0 and not enable_ldm and len(data) >= 4096:
        # Vectorized whole-frame fast path (numpy port of the TPU parse).
        return compress_frame_fast(data, checksum=checksum)
    enc = FrameEncoder(
        level=level,
        checksum=checksum,
        prefix=prefix,
        window_log=window_log,
        content_size=len(data),
        enable_ldm=enable_ldm,
    )
    return enc.compress(data) + enc.finish()


def compress_frame_fast(data: bytes, checksum: bool = False) -> bytes:
    """One-shot frame compression with the vectorized numpy parse
    (codec/match_fast.py) and the standard section writers."""
    from ..constants import ZSTD_BLOCK_SIZE_MAX
    from ..xxhash64 import XXH64 as _X
    from .block_compress import encode_literals_section
    from .match import Sequence, encode_offset
    from .match_fast import parse_frame_numpy
    from .seq_encode import encode_sequences_section

    n = len(data)
    out = bytearray(frame_mod.write_frame_header(n, max(n, 1024), checksum))
    blocks = parse_frame_numpy(data, ZSTD_BLOCK_SIZE_MAX)
    reps = (1, 4, 8)
    huf_state = type("S", (), {"huf_table": None})()
    seq_tables: dict = {}
    for b, (triples, lits_b) in enumerate(blocks):
        last = b == len(blocks) - 1
        b_start = b * ZSTD_BLOCK_SIZE_MAX
        b_len = min(ZSTD_BLOCK_SIZE_MAX, n - b_start)
        raw_block = data[b_start : b_start + b_len]
        if b_len and raw_block.count(raw_block[0]) == b_len:
            out += frame_mod.write_block_header(last, frame_mod.BLOCK_RLE, b_len)
            out += raw_block[:1]
            continue
        reps_in = reps
        huf_before = huf_state.huf_table
        tables_before = dict(seq_tables)
        seqs = []
        for ll, ml, off in triples:
            ov, reps = encode_offset(off, ll, reps)
            seqs.append(Sequence(ll, ml, ov))
        body = encode_literals_section(lits_b, huf_state) + encode_sequences_section(
            seqs, seq_tables
        )
        if len(body) >= b_len:
            reps = reps_in
            huf_state.huf_table = huf_before
            seq_tables.clear()
            seq_tables.update(tables_before)
            out += frame_mod.write_block_header(last, frame_mod.BLOCK_RAW, b_len)
            out += raw_block
        else:
            out += frame_mod.write_block_header(
                last, frame_mod.BLOCK_COMPRESSED, len(body)
            )
            out += body
    if checksum:
        h = _X(0)
        h.update(data)
        out += (h.digest() & 0xFFFF_FFFF).to_bytes(4, "little")
    return bytes(out)


class FrameEncoder:
    """Incremental single-frame encoder: feed chunks, blocks are emitted as
    they fill; ``finish()`` closes the frame (last block + checksum).

    This is the building block for the streaming seekable encoder's
    frame-cutting state machine (reference drives libzstd's
    compress_stream2 the same way: lib/src/encode.rs:341-345, 438-472).
    """

    def __init__(
        self,
        level: int = DEFAULT_COMPRESSION_LEVEL,
        checksum: bool = False,
        prefix: bytes = b"",
        window_log: int = 0,
        content_size: int | None = None,
        block_size: int | None = None,
        enable_ldm: bool = False,
    ):
        if window_log == 0:
            if content_size is not None:
                need = max(content_size + len(prefix), 1 << 10)
                window_log = min(
                    need.bit_length() - (0 if need & (need - 1) else 1), 27
                )
            else:
                window_log = 24  # streaming default when size unknown
        self.window_size = 1 << window_log
        if content_size is not None:
            self.window_size = min(
                self.window_size, max(content_size + len(prefix), 1024)
            )
        self.checksum = checksum
        self.block_max = frame_mod.block_size_max(self.window_size)
        if block_size is not None:
            self.block_max = max(1024, min(self.block_max, block_size))
        self.state = CompressState(
            prefix, level, max_offset=self.window_size, enable_ldm=enable_ldm
        )
        self._header = frame_mod.write_frame_header(
            content_size, self.window_size, checksum
        )
        self._hasher = XXH64(0) if checksum else None
        self._pending = bytearray()
        self._frame_pos = 0  # uncompressed bytes already emitted as blocks
        self._emitted_any = False
        self._finished = False

    def compress(self, chunk: bytes) -> bytes:
        """Feed input; returns any compressed bytes produced."""
        assert not self._finished
        if self._hasher is not None:
            self._hasher.update(chunk)
        self._pending += chunk
        out = bytearray()
        if self._header is not None:
            out += self._header
            self._header = None
        while len(self._pending) > self.block_max:
            out += self._emit_block(self.block_max, last=False)
        return bytes(out)

    def _emit_block(self, size: int, last: bool) -> bytes:
        data = bytes(self._pending[:size])
        del self._pending[:size]
        self.state.extend(data)
        blk = compress_block(self.state, self._frame_pos, size, last)
        self._frame_pos += size
        self._emitted_any = True
        return blk

    def finish(self) -> bytes:
        """Close the frame: final block (possibly empty) + checksum."""
        assert not self._finished
        self._finished = True
        out = bytearray()
        if self._header is not None:
            out += self._header
            self._header = None
        while len(self._pending) > self.block_max:
            out += self._emit_block(self.block_max, last=False)
        out += self._emit_block(len(self._pending), last=True)
        if self._hasher is not None:
            out += (self._hasher.digest() & 0xFFFF_FFFF).to_bytes(4, "little")
        return bytes(out)

    @property
    def uncompressed_size(self) -> int:
        return self._frame_pos + len(self._pending)


class CompressState:
    """Per-frame encoder state shared across blocks: the growing
    prefix+data window, repeat-offset history, and carried entropy tables."""

    def __init__(self, prefix: bytes, level: int, max_offset: int = 1 << 31, enable_ldm: bool = False):
        from .match import LdmState, params_for_level

        self.prefix_len = len(prefix)
        self.window = bytearray(prefix)  # match search space, grows per block
        self.level = level
        self.params = params_for_level(level)
        self.max_offset = max_offset
        self.rep_offsets = (1, 4, 8)
        self.huf_table = None  # carried (codes, nbits) for treeless reuse
        self.seq_tables = {}  # carried FSE tables for repeat mode
        self.match_state = None  # carried hash tables across blocks
        self.ldm_state = LdmState() if enable_ldm else None

    def extend(self, data: bytes) -> None:
        self.window += data
        if self.match_state is not None:
            self.match_state.ensure_capacity(len(self.window))
