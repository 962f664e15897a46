"""Python-facing adapters for the native runtime's frame codec."""

from __future__ import annotations

from ..errors import checksum_wrong
from . import loader


class NativeFrameEncoder:
    """FrameEncoder-compatible wrapper over zn_compress_frame.

    The native encoder is one-shot per frame, so input buffers until
    ``finish()``; the streaming layer's frame-size policy bounds the
    buffered amount (2 MiB by default).
    """

    def __init__(self, checksum: bool = False, prefix: bytes = b"", level: int = 1, ldm: bool = False):
        self.checksum = checksum
        self.prefix = prefix
        self.level = level
        self.ldm = ldm
        self._buf = bytearray()
        self.block_max = 1 << 17

    def compress(self, chunk: bytes) -> bytes:
        self._buf += chunk
        return b""

    def finish(self) -> bytes:
        return loader.compress_frame(
            bytes(self._buf), checksum=self.checksum, prefix=self.prefix,
            level=self.level, ldm=self.ldm,
        )

    @property
    def uncompressed_size(self) -> int:
        return len(self._buf)


class NativeStreamFrameEncoder:
    """FrameEncoder-compatible streaming encoder: one native compressed
    BLOCK per ``compress`` step, so the caller's frame-size policy can
    watch the compressed size grow and cut mid-frame (the reference's
    FrameSizePolicy::Compressed, lib/src/encode.rs:15-39). The frame
    declares a 16 MiB window and no content size; callers must cut at
    ``d_cap`` bytes of input."""

    d_cap = loader.StreamCtx.STREAM_DCAP

    def __init__(self, checksum: bool = False, level: int = 1,
                 block_size: int | None = None):
        self.checksum = checksum
        self.level = level
        self.block_max = min(max(block_size or (1 << 17), 1024), 1 << 17)
        self._ctx = loader.StreamCtx(level, checksum)
        self._hdr_pending = True
        self._buf = bytearray()
        self._d = 0

    def compress(self, chunk: bytes) -> bytes:
        out = bytearray()
        if self._hdr_pending:
            out += self._ctx.header()
            self._hdr_pending = False
        self._buf += chunk
        while len(self._buf) >= self.block_max:
            out += self._ctx.block(bytes(self._buf[: self.block_max]))
            del self._buf[: self.block_max]
            self._d += self.block_max
        return bytes(out)

    def finish(self) -> bytes:
        out = bytearray()
        if self._hdr_pending:
            out += self._ctx.header()
            self._hdr_pending = False
        if self._buf:
            out += self._ctx.block(bytes(self._buf))
            self._d += len(self._buf)
            self._buf.clear()
        out += self._ctx.end()
        self._ctx.close()
        return bytes(out)

    @property
    def uncompressed_size(self) -> int:
        return self._d + len(self._buf)


def native_decompress_frame(data: bytes, max_size: int, prefix: bytes = b""):
    """Decode one frame natively, translating failures to the error
    taxonomy (falling back to the Python decoder for precise errors)."""
    try:
        return loader.decompress_frame(data, max_size, prefix=prefix)
    except RuntimeError as e:
        if "checksum" in str(e):
            raise checksum_wrong("content checksum mismatch") from None
        # Re-run the Python decoder to surface the precise taxonomy error.
        from ..codec.decompress import decompress_frame as py_decode

        out, end = py_decode(data, 0, prefix=prefix)
        return out, end
