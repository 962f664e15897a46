"""ctypes binding of ``fse_choice.cpp``: the archive encoder's sequence-table
choices for a batch of blocks in one call.

``choose_tables`` returns, for each block, the three ``(mode, enc_table,
desc_bytes, cost_bits)`` choices that ``codec/seq_encode._choose_table``
returns for its literal-length, offset and match-length histograms, the
Repeat chain run frame by frame as the caller runs it. A Repeat choice
carries ``None`` for its table: it is the previous block's table object,
which only the caller holds. A block whose frame the library leaves to the
Python function (a near tie of two prices, or a histogram the function
raises on) reads ``None``, and so does every block when the library cannot
be built. The library is built with the native runtime's g++ flags on
first use (``_build.load``).
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from .. import _build
from ..codec import sequences as seq
from ..codec.fse import FseEncodeTable
from ..codec.seq_encode import _default_enc_table
from .loader import _GXX

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fse_choice.cpp")

SYM, STATES, DESC = 64, 512, 128  # the C++ file's kSym, kStates, kDesc
# (category, predefined counts, predefined log, max code, max log), in the
# order of the C++ call's category index.
CATS = (
    ("ll", seq.LL_DEFAULT_NORM, seq.LL_DEFAULT_LOG, seq.MAX_LL_CODE, seq.LL_MAX_LOG),
    ("of", seq.OF_DEFAULT_NORM, seq.OF_DEFAULT_LOG, seq.MAX_OFFSET_CODE, seq.OF_MAX_LOG),
    ("ml", seq.ML_DEFAULT_NORM, seq.ML_DEFAULT_LOG, seq.MAX_ML_CODE, seq.ML_MAX_LOG),
)

_lib = None
_build_failed = False
_consts = None


def _get_lib():
    """The library, or None when it cannot be built or loaded (tried once)."""
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        try:
            lib = _build.load("fse_choice", _GXX, [_SRC])
        except (OSError, RuntimeError):
            _build_failed = True
            return None
        p = ctypes.c_void_p
        lib.zk_fse_choose.restype = ctypes.c_int64
        lib.zk_fse_choose.argtypes = [ctypes.c_int64] + [p] * 17
        lib.zk_fse_normalize.restype = ctypes.c_int
        lib.zk_fse_normalize.argtypes = [p, ctypes.c_int, ctypes.c_int, ctypes.c_int64, p]
        _lib = lib
    return _lib


def available() -> bool:
    return _get_lib() is not None


def _constants():
    """The category parameters, predefined counts and prices' log2 table
    (numpy's own log2, so a price is the one numpy computes)."""
    global _consts
    if _consts is None:
        params = np.array([[len(n), lg, mc, ml] for _, n, lg, mc, ml in CATS], np.int32)
        norms = np.zeros((3, SYM), np.int16)
        for c, (_, n, *_r) in enumerate(CATS):
            norms[c, : len(n)] = n
        log2tab = np.log2(np.concatenate([[0.5], np.arange(1, STATES + 1)]).astype(np.float64))
        _consts = params, norms, log2tab
    return _consts


def _ptr(a: np.ndarray) -> int:
    return a.ctypes.data


def choose_tables(frames, ll_hist, of_hist, ml_hist):
    """Per block (``frames[j]`` its frame; the histograms ``[J, width]`` in
    the caller's block order), None or the list of its three choices."""
    J = len(frames)
    lib = _get_lib()
    params, norms, log2tab = _constants()
    hists = (ll_hist, of_hist, ml_hist)
    widths_ok = all(h.shape[1] == mc + 1 for h, (*_r, mc, _ml) in zip(hists, CATS))
    if lib is None or J == 0 or not widths_ok:
        return [None] * J
    hist = np.zeros((J, 3, SYM), np.int64)
    for c, h in enumerate(hists):
        hist[:, c, : h.shape[1]] = h
    frame = np.ascontiguousarray(frames, np.int32)
    mode = np.empty((J, 3), np.int32)
    tab = np.empty((J, 3), np.int32)
    cost = np.empty((J, 3), np.float64)
    deferred = np.empty(J, np.int32)
    cap = 3 * J
    t_log = np.empty(cap, np.int32)
    t_nsym = np.empty(cap, np.int32)
    t_norm = np.empty((cap, SYM), np.int16)
    t_dnb = np.empty((cap, SYM), np.int64)
    t_dfs = np.empty((cap, SYM), np.int64)
    t_stt = np.empty((cap, STATES), np.uint16)
    t_desc = np.empty((cap, DESC), np.uint8)
    t_desc_len = np.empty(cap, np.int32)
    n = lib.zk_fse_choose(
        J, _ptr(frame), _ptr(hist), _ptr(params), _ptr(norms), _ptr(log2tab),
        _ptr(mode), _ptr(tab), _ptr(cost), _ptr(deferred),
        _ptr(t_log), _ptr(t_nsym), _ptr(t_norm), _ptr(t_dnb), _ptr(t_dfs),
        _ptr(t_stt), _ptr(t_desc), _ptr(t_desc_len),
    )
    if n < 0:
        return [None] * J
    dnb, dfs, stt, norm, desc = t_dnb[:n], t_dfs[:n], t_stt[:n], t_norm[:n], t_desc[:n]
    tables = [
        (FseEncodeTable(lg, dnb[k, :ns], dfs[k, :ns], stt[k, : 1 << lg], norm[k, :ns].tolist()),
         desc[k, :dl].tobytes())
        for k, (lg, ns, dl) in enumerate(zip(t_log[:n].tolist(), t_nsym[:n].tolist(),
                                             t_desc_len[:n].tolist()))
    ]
    defaults = [_default_enc_table(cat) for cat, *_r in CATS]
    out = []
    for d, ms, ts, cs in zip(deferred.tolist(), mode.tolist(), tab.tolist(), cost.tolist()):
        if d:
            out.append(None)
            continue
        row = []
        for c in range(3):
            m = ms[c]
            if m == seq.MODE_PREDEFINED:
                row.append((m, defaults[c], b"", cs[c]))
            elif m == seq.MODE_REPEAT:
                row.append((m, None, b"", cs[c]))
            else:
                row.append((m, *tables[ts[c]], cs[c]))
        out.append(row)
    return out


def normalize(counts, table_log: int, total: int, max_symbol: int):
    """``codec/fse.normalize_counts`` in the library, or None where that
    function raises."""
    lib = _get_lib()
    c = np.zeros(SYM, np.int64)
    c[: max_symbol + 1] = np.asarray(counts, np.int64)[: max_symbol + 1]
    norm = np.zeros(SYM, np.int16)
    if lib.zk_fse_normalize(_ptr(c), max_symbol, table_log, total, _ptr(norm)) != 0:
        return None
    return norm[: max_symbol + 1].tolist()
