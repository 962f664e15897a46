"""ctypes binding of ``seq_header.cpp``: a compressed block's sequences-section
header (the number of sequences, the modes byte and the three table
descriptions) read in one call, for the decode planner.

``reader()`` gives a function ``read(block, off)`` that returns, for the
section at ``block[off]``, ``(nseq, tables, payload_off)``: ``tables`` holds
per category (ll, of, ml) ``(mode, consumed, arg, norm)``: the bytes its
description takes, the RLE symbol or the FSE accuracy log, and the FSE
normalized counts (int16, the values of the list ``codec/fse.read_ncount``
returns; else None); ``payload_off`` is where the FSE bitstream starts. It
returns None where the Python functions raise on the block, and ``reader()``
is None when the library cannot be built. The library is built with the
native runtime's g++ flags on first use (``_build.load``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build
from .loader import _GXX

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "seq_header.cpp")

SYM = 64  # the C++ file's kSym

_lib = None
_build_failed = False


def _get_lib():
    """The library, or None when it cannot be built or loaded (tried once)."""
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        try:
            lib = _build.load("seq_header", _GXX, [_SRC])
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        lib.zk_seq_header.restype = ctypes.c_int
        lib.zk_seq_header.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_void_p]
        _lib = lib
    return _lib


def reader():
    """``read(block, off)`` with output buffers of its own, or None."""
    lib = _get_lib()
    if lib is None:
        return None
    fn = lib.zk_seq_header
    out = np.zeros(15, np.int64)
    norms = np.zeros((3, SYM), np.int16)
    out_p, norms_p = out.ctypes.data, norms.ctypes.data

    def read(block, off: int):
        if not isinstance(block, bytes):
            block = bytes(block)
        if fn(block, len(block), off, out_p, norms_p):
            return None
        h = out.tolist()
        tables = []
        for c in range(3):
            mode, consumed, arg, nsym = h[2 + 4 * c : 6 + 4 * c]
            tables.append((mode, consumed, arg, norms[c, :nsym].copy() if nsym else None))
        return h[0], tables, h[14]

    return read
