"""Streaming seekable decoder: random access by offset or frame index.

The streaming Decoder of ``zeekstd_tpu.decode`` with its ``tpu`` backend
on the CUDA card: each frame goes through ``archive.decompress_frame``
(one device decode per frame), on the card unless ``with_device("cpu")``
asks for the kernels' plain versions. ``auto`` means ``native`` when the
native runtime builds, and ``python`` otherwise, as in the JAX package.

Mirrors the reference's decode layer (reference: lib/src/decode.rs):
``DecodeOptions`` builder (decode.rs:12-114) and ``Decoder``
(decode.rs:116-466) with ``set_offset`` / ``set_offset_limit`` /
``set_lower_frame`` / ``set_upper_frame`` random access, ``reset``, and the
file-object ``read``/``seek`` protocol (the reference's io::Read/io::Seek
impls, decode.rs:508-579).

Small frames (the policy default is 2 MiB) are decoded whole and served
from a cache — also the unit the TPU parallel path decodes per chip.
Frames larger than ``ZEEKSTD_FRAME_CACHE_MAX`` (default 64 MiB) stream
block-by-block with O(window) memory on both the compressed and
decompressed side — the reference's dummy-decode to mid-frame offsets
(decode.rs:228-232) with its out-buffer-bounded footprint, so a seek into
a 1 GiB frame no longer allocates 1 GiB. ``set_offset`` keeps the current
frame buffer/stream when the target lies at or ahead of it (the
continue-vs-reset rule, decode.rs:402-414).
"""

from __future__ import annotations

import io
import os

from . import archive
from .codec.decompress import DCtx, StreamingFrameDecoder
from .device import counters, resolve_device, trace_range
from .errors import OffsetOutOfRangeError, ZeekstdError, corruption_detected
from .native import loader
from .native.frame import native_decompress_frame
from .seek_table import SeekTable
from .seekable import Seekable, Start, as_seekable

FRAME_CACHE_MAX = int(os.environ.get("ZEEKSTD_FRAME_CACHE_MAX", 64 << 20))


class _LazySrcBytes:
    """Bounded sliceable view over a Seekable region: holds only a rolling
    window of the compressed bytes (forward decoding discards consumed
    prefix), so giant frames never fully materialize."""

    def __init__(self, src: Seekable, base: int, size: int, on_read=None):
        self._src = src
        self._base = base
        self._size = size
        self._lo = 0
        self._buf = bytearray()
        self._src_pos = None  # next absolute source offset to read
        self._on_read = on_read

    def __len__(self) -> int:
        return self._size

    def _ensure(self, lo: int, hi: int) -> None:
        hi = min(hi, self._size)
        if lo < self._lo:
            # Rewind (only happens on stream restart).
            self._lo = lo
            self._buf = bytearray()
            self._src_pos = None
        while self._lo + len(self._buf) < hi:
            pos = self._lo + len(self._buf)
            if self._src_pos != pos:
                self._src.set_offset(Start(self._base + pos))
                self._src_pos = pos
            want = max(hi - pos, 1 << 20)
            chunk = self._src.read(min(want, self._size - pos))
            if not chunk:
                raise ZeekstdError("unexpected EOF reading frame")
            self._buf += chunk
            self._src_pos = pos + len(chunk)
            if self._on_read is not None:
                self._on_read(len(chunk))
        # Trim consumed prefix (keep a small rewind margin).
        margin = 1 << 16
        drop = lo - margin - self._lo
        if drop > (1 << 20):
            del self._buf[:drop]
            self._lo += drop

    def __getitem__(self, sl):
        if isinstance(sl, slice):
            lo = 0 if sl.start is None else sl.start
            hi = self._size if sl.stop is None else min(sl.stop, self._size)
            if hi <= lo:
                return b""
            self._ensure(lo, hi)
            off = lo - self._lo
            return bytes(self._buf[off : off + (hi - lo)])
        self._ensure(sl, sl + 1)
        return self._buf[sl - self._lo]


class DecodeOptions:
    """Builder (reference: lib/src/decode.rs:12-114). Frame indices override
    byte offsets (decode.rs:70-84, 157-172)."""

    def __init__(self, src, dctx: DCtx | None = None):
        self.src = src
        self.dctx = dctx if dctx is not None else DCtx()
        self.seek_table: SeekTable | None = None
        self._lower_frame: int | None = None
        self._upper_frame: int | None = None
        self._offset: int | None = None
        self._offset_limit: int | None = None
        self._prefix: bytes | None = None
        self.backend = "auto"
        self.device = None

    def with_backend(self, backend: str) -> "DecodeOptions":
        """"auto" (native when available), "python", "native", or "tpu" -
        frames decode through the device pipeline on the CUDA card,
        including prefix/patch mode."""
        if backend not in ("auto", "python", "native", "tpu"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        return self

    def with_device(self, device) -> "DecodeOptions":
        """The ``tpu`` backend's device: ``None`` (the default) is the CUDA
        card, ``"cpu"`` runs the kernels' plain versions."""
        self.device = device
        return self

    def with_dctx(self, dctx: DCtx) -> "DecodeOptions":
        self.dctx = dctx
        return self

    def with_seek_table(self, st: SeekTable) -> "DecodeOptions":
        """Skip parsing the table from the source (reference: decode.rs:61-68)."""
        self.seek_table = st
        return self

    def with_lower_frame(self, index: int) -> "DecodeOptions":
        self._lower_frame = index
        return self

    def with_upper_frame(self, index: int) -> "DecodeOptions":
        self._upper_frame = index
        return self

    def with_offset(self, offset: int) -> "DecodeOptions":
        self._offset = offset
        return self

    def with_offset_limit(self, limit: int) -> "DecodeOptions":
        self._offset_limit = limit
        return self

    def with_prefix(self, prefix: bytes) -> "DecodeOptions":
        self._prefix = prefix
        return self

    def into_decoder(self) -> "Decoder":
        return Decoder(self)


class Decoder:
    """Seekable decoder over any byte source (reference: lib/src/decode.rs:116-466)."""

    def __init__(self, options: DecodeOptions):
        self.dctx = options.dctx
        self.src: Seekable = as_seekable(options.src)
        if options.seek_table is not None:
            self._st = options.seek_table
        else:
            self._st = SeekTable.from_seekable(self.src)
        self._prefix = options._prefix

        offset = options._offset
        limit = options._offset_limit
        if options._lower_frame is not None:
            offset = self._st.frame_start_decomp(options._lower_frame)
        if options._upper_frame is not None:
            limit = self._st.frame_end_decomp(options._upper_frame)
        if offset is None:
            offset = 0
        if limit is None:
            limit = self._st.size_decomp
        self._validate_offset(offset)
        self._validate_offset(limit)

        self._initial_offset = offset
        self._initial_limit = limit
        self.offset = offset
        self.offset_limit = limit
        self._read_compressed = 0
        self._backend = options.backend
        if self._backend == "auto":
            self._backend = "native" if loader.available() else "python"
        # A missing card raises here, not in the middle of a read.
        self._device = resolve_device(options.device) if self._backend == "tpu" else None
        # In-memory decoded frame cache: (frame_index, bytes) or None.
        self._cur_frame: int | None = None
        self._cur_data: bytes | None = None
        # Streaming state for frames larger than FRAME_CACHE_MAX.
        self._stream: StreamingFrameDecoder | None = None
        self._stream_frame: int | None = None
        self._stream_tail = bytearray()  # produced, unserved bytes
        self._stream_tail_pos = 0  # frame-relative position of tail[0]

    # -- helpers -----------------------------------------------------------

    def _validate_offset(self, offset: int) -> None:
        """(reference: lib/src/decode.rs:439-445)"""
        if offset < 0 or offset > self._st.size_decomp:
            raise OffsetOutOfRangeError(
                f"offset {offset} out of range (0..{self._st.size_decomp})"
            )

    def _load_frame(self, index: int) -> None:
        """Read + decode one frame from the source into the cache."""
        with trace_range("dec.frame_load"):
            start = self._st.frame_start_comp(index)
            size = self._st.frame_size_comp(index)
            self.src.set_offset(Start(start))
            buf = b""
            while len(buf) < size:
                chunk = self.src.read(size - len(buf))
                if not chunk:
                    raise ZeekstdError(f"unexpected EOF reading frame {index}")
                buf += chunk
            self._read_compressed += len(buf)
            if self._backend == "tpu":
                out, fend = archive.decompress_frame(
                    buf, prefix=self._prefix or b"", device=self._device
                )
            elif self._backend == "native":
                out, fend = native_decompress_frame(
                    buf, self._st.frame_size_decomp(index) + 64, prefix=self._prefix or b""
                )
            else:
                if self._prefix is not None:
                    self.dctx.ref_prefix(self._prefix)
                out, fend = self.dctx.decompress_frame(buf)
            if fend not in (None, len(buf)):
                # A corrupted header (e.g. a cleared checksum flag) makes the
                # frame consume fewer bytes than the seek table records — the
                # canonical silent-corruption vector.
                raise corruption_detected(
                    f"frame {index} consumed {fend} of {len(buf)} bytes"
                )
            expected = self._st.frame_size_decomp(index)
            if len(out) != expected:
                raise ZeekstdError(
                    f"frame {index} decoded to {len(out)} bytes, seek table says {expected}"
                )
            counters["dec.frame_load_bytes"] += len(out)
            self._cur_frame = index
            self._cur_data = out

        # -- core decode -------------------------------------------------------

    def decompress(self, size: int = -1) -> bytes:
        """Decode up to ``size`` bytes from the current offset, bounded by
        the offset limit (reference loop: lib/src/decode.rs:201-270). Each
        call is the profiler range ``zk.dec.read`` and adds to the
        ``dec.*`` counters of ``device.counters``."""
        with trace_range("dec.read"):
            out = self._decompress(size)
        counters["dec.read_bytes"] += len(out)
        return out

    def _decompress(self, size: int) -> bytes:
        if size is None or size < 0:
            size = self.offset_limit - self.offset
        out = []
        remaining = min(size, self.offset_limit - self.offset)
        visited = None  # a large frame may serve one read in several pieces
        while remaining > 0:
            if self._st.num_frames == 0:
                break
            index = self._st.frame_index_decomp(self.offset)
            f_start = self._st.frame_start_decomp(index)
            f_end = self._st.frame_end_decomp(index)
            if self.offset >= f_end:
                break  # at archive end
            first = index != visited
            if first:
                visited = index
                counters["dec.frame_visits"] += 1
            if self._st.frame_size_decomp(index) > FRAME_CACHE_MAX:
                chunk = self._stream_read(index, f_start, f_end, remaining, first)
                if not chunk:
                    break
                out.append(chunk)
                self.offset += len(chunk)
                remaining -= len(chunk)
                continue
            if self._cur_frame != index:
                self._load_frame(index)
            else:
                counters["dec.frame_hits"] += 1
            lo = self.offset - f_start
            take = min(remaining, f_end - self.offset)
            out.append(self._cur_data[lo : lo + take])
            self.offset += take
            remaining -= take
        return b"".join(out)

    def _stream_read(self, index: int, f_start: int, f_end: int, remaining: int,
                     first: bool) -> bytes:
        """Serve bytes from a large frame with O(window) memory: decode
        block-by-block, discarding output before the requested offset (the
        reference's dummy-decode, lib/src/decode.rs:228-232). ``first``: this
        is the read's first piece of the frame, a hit if the stream is kept."""
        rel = self.offset - f_start
        if self._stream_frame != index or rel < self._stream_tail_pos:
            comp_start = self._st.frame_start_comp(index)
            comp_size = self._st.frame_size_comp(index)

            def on_read(n):
                self._read_compressed += n

            lazy = _LazySrcBytes(self.src, comp_start, comp_size, on_read)
            self._stream = StreamingFrameDecoder(
                lazy, 0, prefix=self._prefix or b"",
                window_log_max=self.dctx.window_log_max,
            )
            self._stream_frame = index
            self._stream_tail = bytearray()
            self._stream_tail_pos = 0
        elif first:
            counters["dec.frame_hits"] += 1
        tail = self._stream_tail
        while self._stream_tail_pos + len(tail) <= rel:
            blk = self._stream.next_block()
            if blk is None:
                raise corruption_detected(
                    f"frame {index} exhausted before offset; decoded size "
                    "disagrees with the seek table"
                )
            counters["dec.frame_load_bytes"] += len(blk)
            # Dummy-decode: drop everything before the target offset.
            self._stream_tail_pos += len(tail)
            tail = self._stream_tail = bytearray(blk)
            drop = min(rel - self._stream_tail_pos, len(tail))
            if drop > 0:
                del tail[:drop]
                self._stream_tail_pos += drop
        lo = rel - self._stream_tail_pos
        take = min(remaining, f_end - self.offset, len(tail) - lo)
        if take <= 0:
            blk = self._stream.next_block()
            if blk is None:
                return b""
            counters["dec.frame_load_bytes"] += len(blk)
            tail += blk
            take = min(remaining, f_end - self.offset, len(tail) - lo)
        chunk = bytes(tail[lo : lo + take])
        # Consume served bytes.
        del tail[: lo + take]
        self._stream_tail_pos += lo + take
        return chunk

    def decompress_into(self, buf) -> int:
        """Fill a caller buffer; returns bytes written (0 at end)."""
        view = memoryview(buf)
        chunk = self.decompress(len(view))
        view[: len(chunk)] = chunk
        return len(chunk)

    # -- random access (reference: lib/src/decode.rs:346-437) --------------

    def set_offset(self, offset: int) -> None:
        """Continue within the current frame when possible, else retarget
        (reference continue-vs-reset rule: lib/src/decode.rs:402-414)."""
        self._validate_offset(offset)
        if self._cur_frame is not None:
            f_start = self._st.frame_start_decomp(self._cur_frame)
            f_end = self._st.frame_end_decomp(self._cur_frame)
            if not (f_start <= offset < f_end):
                self._cur_frame = None
                self._cur_data = None
        self.offset = offset

    def set_offset_limit(self, limit: int) -> None:
        """Changeable mid-stream; may stop before frame end
        (reference: lib/src/decode.rs:432-437)."""
        self._validate_offset(limit)
        self.offset_limit = limit

    def set_prefix(self, prefix) -> None:
        """Change the referenced prefix for subsequently decoded frames
        (the per-call prefix of the reference's decompress_with_prefix,
        lib/src/decode.rs:201-270); drops the cached frame."""
        self._prefix = bytes(prefix) if prefix is not None else None
        self._cur_frame = None
        self._cur_data = None

    def set_lower_frame(self, index: int) -> None:
        self.set_offset(self._st.frame_start_decomp(index))

    def set_upper_frame(self, index: int) -> None:
        self.set_offset_limit(self._st.frame_end_decomp(index))

    def reset(self) -> None:
        """Back to the initially-configured window (reference: decode.rs:346-350)."""
        self.offset = self._initial_offset
        self.offset_limit = self._initial_limit
        self._cur_frame = None
        self._cur_data = None
        self._stream = None
        self._stream_frame = None
        self._stream_tail = bytearray()
        self._stream_tail_pos = 0
        self.dctx.reset_session()

    # -- accessors ---------------------------------------------------------

    def seek_table(self) -> SeekTable:
        return self._st

    @property
    def read_compressed(self) -> int:
        """Total compressed bytes read from the source
        (reference: lib/src/decode.rs:447-450)."""
        return self._read_compressed

    # -- file-object protocol ---------------------------------------------

    def read(self, size: int = -1) -> bytes:
        return self.decompress(size)

    def readinto(self, buf) -> int:
        return self.decompress_into(buf)

    def seek(self, offset: int, whence: int = os.SEEK_SET) -> int:
        """io.Seek semantics over the decompressed stream
        (reference: lib/src/decode.rs:545-579)."""
        if whence == os.SEEK_SET:
            target = offset
        elif whence == os.SEEK_CUR:
            target = self.offset + offset
        elif whence == os.SEEK_END:
            target = self._st.size_decomp + offset
        else:
            raise ValueError(f"bad whence {whence}")
        if target < 0:
            raise OffsetOutOfRangeError("seek before start of stream")
        self.set_offset(target)
        return target

    def tell(self) -> int:
        return self.offset

    def seekable(self) -> bool:
        return True
