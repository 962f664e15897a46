"""ctypes bindings of the native runtime (``zeekstd_native.cpp``).

The runtime is the host execution backend: a zstd frame codec, the
threaded whole-stream helpers, the streaming frame context of the
compressed frame-size policy, XXH64, and the entropy-table builders and
Huffman stream decoder the archive pipeline uses. The source is a
verbatim copy of the JAX package's; it is built with the same g++ flags on
first use (``_build.load``) into the gitignored ``build/``.

A failed build raises from ``get_lib()``: the archive encoder must not
fall back to the Python Huffman table code, which may pick other optimal
code lengths and so other bytes than the reference. ``available()`` is
``False`` only when the build fails; the streaming layer's ``auto``
backend then means ``python``, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "zeekstd_native.cpp")
# -O2 measures ~10% faster than -O3 for this codec (its branchy loops lose
# from aggressive auto-vectorization).
_GXX = ["g++", "-O2", "-march=native", "-shared", "-fPIC", "-pthread"]

_scratch = bytearray(0)  # reused output buffer (per-call allocs cost ~30%)


def _get_scratch(cap: int):
    global _scratch
    if len(_scratch) < cap:
        _scratch = bytearray(cap + cap // 2)
    return _scratch


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    sigs = {
        "zn_xxh64": (c.c_uint64, [c.c_void_p, c.c_size_t, c.c_uint64]),
        "zn_compress_frame": (c.c_size_t, [
            c.c_char_p, c.c_size_t, c.c_void_p, c.c_size_t,
            c.c_int, c.c_int, c.c_char_p, c.c_size_t,
        ]),
        "zn_decompress_frame": (c.c_int64, [
            c.c_char_p, c.c_size_t, c.c_void_p, c.c_size_t,
            c.c_char_p, c.c_size_t, c.POINTER(c.c_size_t),
        ]),
        "zn_set_mt_level": (None, [c.c_int]),
        "zn_set_ldm": (None, [c.c_int]),
        "zn_compress_stream_mt": (c.c_int64, [
            c.c_char_p, c.c_size_t, c.c_void_p, c.c_size_t,
            c.c_size_t, c.c_int, c.c_int, c.POINTER(c.c_uint32),
        ]),
        "zn_decompress_stream_mt": (c.c_int64, [
            c.c_char_p, c.c_size_t, c.c_void_p, c.c_size_t,
            c.POINTER(c.c_uint64), c.POINTER(c.c_uint64), c.c_size_t, c.c_int,
        ]),
        "zn_stream_new": (c.c_void_p, [c.c_int, c.c_int]),
        "zn_stream_free": (None, [c.c_void_p]),
        "zn_stream_header": (c.c_int64, [c.c_void_p, c.c_void_p, c.c_size_t]),
        "zn_stream_block": (c.c_int64, [
            c.c_void_p, c.c_char_p, c.c_size_t, c.c_void_p, c.c_size_t,
        ]),
        "zn_stream_end": (c.c_int64, [c.c_void_p, c.c_void_p, c.c_size_t]),
        "zn_huf_table": (c.c_int64, [
            c.c_void_p, c.c_void_p, c.c_size_t, c.c_void_p, c.c_void_p,
        ]),
        "zn_fse_enc_table": (c.c_int, [
            c.c_void_p, c.c_int, c.c_int, c.c_void_p, c.c_void_p, c.c_void_p,
        ]),
        "zn_huf_stream_decode": (c.c_int, [
            c.c_void_p, c.c_size_t, c.c_void_p, c.c_void_p, c.c_int,
            c.c_void_p, c.c_size_t,
        ]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


_build_error: Exception | None = None


def get_lib() -> ctypes.CDLL:
    """The runtime, built on first use. Raises when the build fails (and
    again on every later call, without another build)."""
    global _build_error
    if _build_error is not None:
        raise _build_error
    try:
        lib = _build.load("native", _GXX, [_SRC])
    except Exception as e:
        _build_error = e
        raise
    if lib.zn_xxh64.argtypes is None:
        _bind(lib)
    return lib


def available() -> bool:
    try:
        get_lib()
    except Exception:
        return False
    return True


def xxh64(data, seed: int = 0) -> int:
    buf = np.frombuffer(data, np.uint8) if len(data) else np.zeros(1, np.uint8)
    return get_lib().zn_xxh64(buf.ctypes.data, len(data), seed)


def huf_table(hist):
    """(tree_bytes, codes uint32[256], nbits uint8[256]) for a 256-bin
    literal histogram, or None when it is not encodable."""
    h = np.ascontiguousarray(hist, np.uint32)
    tree = ctypes.create_string_buffer(512)
    codes = np.zeros(256, np.uint32)
    nb = np.zeros(256, np.uint8)
    r = get_lib().zn_huf_table(
        h.ctypes.data, tree, 512, codes.ctypes.data, nb.ctypes.data
    )
    if r < 0:
        return None
    return tree.raw[:r], codes, nb


def huf_stream_decode(stream: bytes, sym, nbt, max_bits: int, out_len: int):
    """Decode one Huffman literal stream with a direct table (symbol/nbits
    uint8 arrays of size 1 << max_bits); the bytes as a numpy uint8
    array, or None for a malformed stream."""
    s = np.frombuffer(stream, np.uint8)
    sy = np.ascontiguousarray(sym, np.uint8)
    nb = np.ascontiguousarray(nbt, np.uint8)
    out = np.empty(out_len, np.uint8)
    r = get_lib().zn_huf_stream_decode(
        s.ctypes.data if len(s) else 0, len(s),
        sy.ctypes.data, nb.ctypes.data, int(max_bits),
        out.ctypes.data, out_len,
    )
    return out if r == 0 else None


def fse_enc_table(norm, accuracy_log: int):
    """(delta_nb int32[64], delta_fs int32[64], state_table uint16[512])
    or None."""
    n = np.ascontiguousarray(norm, np.int16)
    dnb = np.zeros(64, np.int32)
    dfs = np.zeros(64, np.int32)
    stt = np.zeros(512, np.uint16)
    r = get_lib().zn_fse_enc_table(
        n.ctypes.data, len(n), accuracy_log,
        dnb.ctypes.data, dfs.ctypes.data, stt.ctypes.data,
    )
    if r != 0:
        return None
    return dnb, dfs, stt


class StreamCtx:
    """Handle for the native streaming frame context (one compressed
    block per call — the FrameSizePolicy::Compressed engine)."""

    STREAM_DCAP = 1 << 24  # declared window; frames must cut here

    def __init__(self, level: int, checksum: bool):
        self._lib = get_lib()
        self._h = self._lib.zn_stream_new(level, 1 if checksum else 0)

    def header(self) -> bytes:
        buf = ctypes.create_string_buffer(16)
        r = self._lib.zn_stream_header(self._h, buf, 16)
        if r < 0:
            raise RuntimeError("zn_stream_header failed")
        return buf.raw[:r]

    def block(self, data: bytes) -> bytes:
        cap = len(data) + len(data) // 2 + 1024
        buf = ctypes.create_string_buffer(cap)
        r = self._lib.zn_stream_block(self._h, bytes(data), len(data), buf, cap)
        if r < 0:
            raise RuntimeError("zn_stream_block failed")
        return buf.raw[:r]

    def end(self) -> bytes:
        buf = ctypes.create_string_buffer(16)
        r = self._lib.zn_stream_end(self._h, buf, 16)
        if r < 0:
            raise RuntimeError("zn_stream_end failed")
        return buf.raw[:r]

    def close(self) -> None:
        if self._h:
            self._lib.zn_stream_free(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def compress_frame(data: bytes, checksum: bool = False, prefix: bytes = b"",
                   level: int = 1, ldm: bool = False) -> bytes:
    lib = get_lib()
    cap = len(data) + len(data) // 2 + 1024
    dst = ctypes.create_string_buffer(cap)
    lib.zn_set_ldm(int(ldm))
    try:
        r = lib.zn_compress_frame(
            bytes(data), len(data), dst, cap, level, int(checksum),
            bytes(prefix) if prefix else None, len(prefix),
        )
    finally:
        if ldm:
            lib.zn_set_ldm(0)
    if r == ctypes.c_size_t(-1).value:
        raise RuntimeError("native compress failed")
    return dst.raw[:r]


def decompress_frame(data: bytes, max_size: int, prefix: bytes = b""):
    """Returns (output, consumed). Raises on error; checksum mismatch raises
    with 'checksum' in the message."""
    lib = get_lib()
    dst = ctypes.create_string_buffer(max_size)
    consumed = ctypes.c_size_t(0)
    r = lib.zn_decompress_frame(
        bytes(data), len(data), dst, max_size,
        bytes(prefix) if prefix else None, len(prefix),
        ctypes.byref(consumed),
    )
    if r == -2:
        raise RuntimeError("native decompress: checksum mismatch")
    if r < 0:
        raise RuntimeError("native decompress failed")
    return dst.raw[:r], consumed.value


def compress_stream_mt(data: bytes, frame_size: int, checksum: bool = False,
                       nthreads: int = 0, level: int = 1):
    """Compress all frames in parallel; returns (blob, [frame_sizes])."""
    lib = get_lib()
    lib.zn_set_mt_level(level)
    n = len(data)
    nframes = -(-n // frame_size) if n else 0
    cap = n + n // 2 + 4096 + 16 * max(nframes, 1)
    dst = _get_scratch(cap)
    dst_p = (ctypes.c_char * len(dst)).from_buffer(dst)
    sizes = (ctypes.c_uint32 * max(nframes, 1))()
    r = lib.zn_compress_stream_mt(
        bytes(data), n, dst_p, cap, frame_size, int(checksum), nthreads, sizes
    )
    del dst_p
    if r < 0:
        raise RuntimeError("native stream compress failed")
    return bytes(memoryview(dst)[:r]), [sizes[i] for i in range(nframes)]


def decompress_stream_mt(blob: bytes, frame_offsets, frame_dst_offsets,
                         nthreads: int = 0, into=None):
    """Decompress frames in parallel given compressed/decompressed offsets
    (from the seek table).

    With ``into`` (a writable bytearray of at least the decompressed size)
    output lands directly in the caller's buffer and the byte count is
    returned, with no extra copy. Without it, a fresh ``bytes`` is
    returned.
    """
    lib = get_lib()
    nframes = len(frame_offsets) - 1
    total = frame_dst_offsets[-1]
    if into is not None and len(into) < total:
        raise ValueError("into buffer smaller than decompressed size")
    dst = into if into is not None else _get_scratch(max(total, 1))
    dst_p = (ctypes.c_char * len(dst)).from_buffer(dst)
    fo = (ctypes.c_uint64 * len(frame_offsets))(*frame_offsets)
    do = (ctypes.c_uint64 * len(frame_dst_offsets))(*frame_dst_offsets)
    r = lib.zn_decompress_stream_mt(
        bytes(blob), len(blob), dst_p, max(total, 1), fo, do, nframes, nthreads
    )
    del dst_p
    if r < 0:
        raise RuntimeError("native stream decompress failed")
    if into is not None:
        return r
    return bytes(memoryview(dst)[:r])
