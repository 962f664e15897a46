"""FSE sequence-bitstream encoder: job layout, plain version, CUDA wrapper.

Port of ``zeekstd_tpu/ops/fse_kernel.py``. One job per sequence-bearing
block: walk the block's match-kernel rows (``lm`` = ll << 16 | ml, ``ofv``
= repeat-coded offset value) backward, derive the LL/ML/OF codes, keep
the three interleaved FSE states and pack the bitstream LSB-first into
32-bit words.

Stream item order (as ``codec/seq_encode.py`` writes it): head = last
sequence's ll/ml/of extras; per sequence i = n-2..0 the fused of/ml/ll
state bits then the ll/ml/of extras; tail = final ml/of/ll states at
their accuracy logs. ``ops/assemble.finalize_streams`` adds the sentinel.

The wide layout (``ml`` given) carries lengths that do not fit 16 bits,
as the per-frame encoder's 128 KiB blocks need: ``lm`` holds the full ll
and ``ml`` the full match length, row for row.

Encode-table rows (one int32[1024] row per table, deduped across
Repeat_Mode blocks): [0:64] delta_nb_bits, [64:128] delta_find_state,
[128:640] state_table. A row index outside the pool reads the nearest
row; a state-table index is taken modulo 1024. Words at index >= WBo are
never written, but the bit count still counts them.

The CUDA kernel walks each job in chunks of ``CHUNK`` sequences (one of
``CHUNKS``, the sizes the kernel is compiled for).
"""

from __future__ import annotations

import numpy as np
import torch

from . import launches
from ._launch import I, P, check_cuda, check_rc, kernel_fn, ptr, stream

# flat meta columns per job
J_REC = 0     # match-kernel record index (frame*B + block)
J_NSEQ = 1
J_TLL = 2     # packed-table row indices
J_TOF = 3
J_TML = 4
J_LOGS = 5    # ll_log | of_log << 5 | ml_log << 10
JMETA_COLS = 8

# packed const layout (flat int32)
C_LLBASE = 0     # 36
C_LLBITS = 64    # 36
C_MLBASE = 128   # 53
C_MLBITS = 192   # 53
C_LLLUT = 256    # 64: ll -> code for ll < 64
C_MLLUT = 320    # 128: (ml-3) -> code for ml-3 < 128
CONSTS_LEN = 512

_MASK32 = 0xFFFFFFFF

CHUNKS = (512, 32)
CHUNK = 512  # sequences per chunk of the kernel's walk


def make_consts():
    from ..codec.sequences import LL_BASE, LL_BITS, ML_BASE, ML_BITS

    c = np.zeros(CONSTS_LEN, np.int32)
    c[C_LLBASE : C_LLBASE + 36] = LL_BASE
    c[C_LLBITS : C_LLBITS + 36] = LL_BITS
    c[C_MLBASE : C_MLBASE + 53] = ML_BASE
    c[C_MLBITS : C_MLBITS + 53] = ML_BITS
    for v in range(64):
        c[C_LLLUT + v] = int(np.searchsorted(LL_BASE, v, side="right")) - 1
    for mb in range(128):
        c[C_MLLUT + mb] = (
            int(np.searchsorted(ML_BASE, mb + 3, side="right")) - 1
        )
    return c


def pack_enc_table(dnb, dfs, stt):
    """One (1024,) int32 row: [0:64] dnb, [64:128] dfs, [128:640] stt."""
    row = np.zeros(1024, np.int32)
    row[0:64] = dnb
    row[64:128] = dfs
    row[128 : 128 + len(stt)] = stt
    return row


def bucket_nrecj(n: int) -> int:
    for b in (8, 16, 32, 64, 128, 256, 512, 1024):
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def word_bound(SBd: int) -> int:
    """Power-of-two words per job: >= SBd * 88 bits / 32 (the most a block
    of SBd sequences can write)."""
    return 1 << (((SBd * 88) // 32 + 16) - 1).bit_length()


def _highbit(x: int) -> int:
    return max(x, 1).bit_length() - 1


def _encode_job(c, lm, ofv, tll, tof, tml, logs, words, mlw=None):
    """One job over Python ints; writes ``words`` (a list; words past its
    length are dropped) and returns the stream's bit count. With ``mlw``
    (the wide layout) ``lm`` holds the full ll and ``mlw`` the ml."""
    nseq = len(lm)
    cap = len(words)

    def seq_at(j):
        if mlw is None:
            ll, ml = (lm[j] >> 16) & 0xFFFF, lm[j] & 0xFFFF
        else:
            ll, ml = lm[j], mlw[j]
        ov = ofv[j]
        llc = c[C_LLLUT + ll] if ll < 64 else 19 + _highbit(ll)
        mlb = ml - 3
        mlc = c[C_MLLUT + mlb] if mlb < 128 else 36 + _highbit(mlb)
        ofc = _highbit(ov)
        return (llc, mlc, ofc, ll - c[C_LLBASE + llc], c[C_LLBITS + llc],
                ml - c[C_MLBASE + mlc], c[C_MLBITS + mlc], ov - (1 << ofc))

    def init_state(t, sym):
        dnb = t[sym]
        nb = (dnb + (1 << 15)) >> 16
        value = (nb << 16) - dnb
        return t[(128 + (value >> nb) + t[64 + sym]) & 1023]

    def enc(t, state, sym):
        nb = (state + t[sym]) >> 16
        return (t[(128 + (state >> nb) + t[64 + sym]) & 1023], state & ((1 << nb) - 1),
                nb)

    acc = n = w = 0

    def wadd(val, nb):
        nonlocal acc, n, w
        v = val & ((1 << nb) - 1)
        acc2 = (acc | (v << n)) & _MASK32
        if n + nb >= 32:
            if w < cap:
                words[w] = acc2
            acc = v >> (32 - n)
            n = n + nb - 32
            w += 1
        else:
            acc = acc2
            n += nb

    llc, mlc, ofc, lle, llb, mle, mlbi, ofe = seq_at(nseq - 1)
    ml_s = init_state(tml, mlc)
    of_s = init_state(tof, ofc)
    ll_s = init_state(tll, llc)
    wadd(lle, llb)
    wadd(mle, mlbi)
    wadd(ofe, ofc)
    for i in range(nseq - 2, -1, -1):
        llc, mlc, ofc, lle, llb, mle, mlbi, ofe = seq_at(i)
        of_s, of_v, of_nb = enc(tof, of_s, ofc)
        ml_s, ml_v, ml_nb = enc(tml, ml_s, mlc)
        ll_s, ll_v, ll_nb = enc(tll, ll_s, llc)
        wadd(of_v | (ml_v << of_nb) | (ll_v << (of_nb + ml_nb)),
             of_nb + ml_nb + ll_nb)
        wadd(lle, llb)
        wadd(mle, mlbi)
        wadd(ofe, ofc)
    wadd(ml_s, (logs >> 10) & 31)
    wadd(of_s, (logs >> 5) & 31)
    wadd(ll_s, logs & 31)
    if w < cap:
        words[w] = acc
    return w * 32 + n


def fse_plain(consts, meta, lm, ofv, tables, SBd: int, WBo: int, ml=None):
    """Plain version over Python ints, job by job."""
    njobs = meta.numel() // JMETA_COLS
    c = consts.reshape(-1).tolist()
    mrows = meta.reshape(njobs, JMETA_COLS).tolist()
    lm2 = lm.reshape(-1, SBd)
    ofv2 = ofv.reshape(-1, SBd)
    ml2 = None if ml is None else ml.reshape(-1, SBd)
    tab = tables.reshape(-1, 1024)
    words = np.zeros((njobs, WBo), np.uint32)
    bits = np.zeros(njobs, np.int32)
    rows = {}

    def row(k):
        k = min(max(k, 0), tab.shape[0] - 1)
        if k not in rows:
            rows[k] = tab[k].tolist()
        return rows[k]

    for j, m in enumerate(mrows):
        nseq = m[J_NSEQ]
        if nseq <= 0:
            continue
        rec = m[J_REC]
        wl = [0] * WBo
        bits[j] = _encode_job(
            c, lm2[rec, :nseq].tolist(), ofv2[rec, :nseq].tolist(),
            row(m[J_TLL]), row(m[J_TOF]), row(m[J_TML]), m[J_LOGS], wl,
            None if ml2 is None else ml2[rec, :nseq].tolist(),
        )
        words[j] = wl
    dev = lm.device
    return (torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(bits).to(dev))


def fse_encode(consts, meta, lm, ofv, tables, *, SBd: int, WBo: int, ml=None):
    """Encode every job. consts int32[512], meta int32[NRECJ, JMETA_COLS],
    lm/ofv int32[NRECP, SBd] (match-kernel rows), tables int32[Tp, 1024];
    ``ml`` int32[NRECP, SBd] selects the wide layout (``lm`` = ll).
    Returns (words int32[NRECJ, WBo] - the uint32 stream words, exact up
    to and including word ``bits // 32`` - and bits int32[NRECJ]).

    On the card ``words`` is not zero-filled: the kernel writes every
    word up to ``bits // 32`` (word 0 of a job without sequences), and
    ``assemble.finalize_streams`` zeroes each image past its sentinel
    byte, so nothing reads the words beyond."""
    if lm.device.type == "cpu":
        return fse_plain(consts, meta, lm, ofv, tables, SBd, WBo, ml)
    for name, t in (("consts", consts), ("meta", meta), ("lm", lm),
                    ("ofv", ofv), ("tables", tables)) + ((("ml", ml),) if ml is not None else ()):
        check_cuda(name, t)
    if CHUNK not in CHUNKS:
        raise ValueError(f"CHUNK must be one of {CHUNKS}, got {CHUNK}")
    if tables.numel() < 1024:
        raise ValueError("tables must hold at least one 1024-entry row")
    njobs = meta.numel() // JMETA_COLS
    dev = lm.device
    words = torch.empty((njobs, WBo), dtype=torch.int32, device=dev)
    bits = torch.empty(njobs, dtype=torch.int32, device=dev)
    if ml is None:
        fn = kernel_fn("zk_fse_launch", [P, P, P, P, P, I, I, I, I, I, P, P, P])
        rows = (ptr(lm), ptr(ofv))
    else:
        fn = kernel_fn("zk_fse_wide_launch", [P, P, P, P, P, P, I, I, I, I, I, P, P, P])
        rows = (ptr(lm), ptr(ml), ptr(ofv))
    rc = fn(ptr(consts), ptr(meta), *rows, ptr(tables),
            tables.numel() // 1024, njobs, SBd, WBo, CHUNK, ptr(words), ptr(bits),
            stream())
    launches["fse"] += 1
    check_rc("fse", rc)
    return words, bits
