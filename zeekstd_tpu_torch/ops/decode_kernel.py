"""Fused FSE decode + sequence execution: record layout, plain versions,
and the wide-window CUDA wrapper.

Port of ``zeekstd_tpu/ops/decode_kernel.py`` (and, through
``decode_plain``, of the shared loop of ``ops/ring_kernel.py``). Each
KIND_SEQ record reads its block's backward FSE bitstream, keeps the three
FSE states (initial states read ll, of, ml; per sequence the extra bits
read of, ml, ll; state updates ll, ml, of, skipped after the block's last
sequence), resolves repeat offsets with libzstd's rules (history threaded
across the blocks of a frame) and executes the literal and match copies.
KIND_LIT copies a literal run, KIND_RLE fills a byte run. A stream that
does not end on exactly zero remaining bits, or any clamped copy, marks
the frame bad.

Inputs per KIND_SEQ record: a row of the (nw, WB) bitstream word table,
three rows of the deduped (Tp, 512) decode-table pool (symbol |
nb_bits << 8 | baseline << 16), and the ll/ml code base+bits constants
(4, 64). A row index outside its table reads the table's last row, as
the reference kernels' index maps do.

The wide contract (this module): literals one int32 per byte
(F, LROWS, 128), output bytes (F, OUTB/128, 128). Its literal clamp is
the reference's staging window (LITB + 128 bytes from the 128-byte row
holding the record's first literal). On the card it runs in three stages
(``csrc/wide_decode.cu``): an FSE pass per record, a scan per frame that
writes one descriptor per output byte, and pointer jumping over the
descriptors. ``staged_decode`` allocates their scratch and launches them
for either contract; the ring contract's wrapper (``ring_kernel``) uses it
too, and the serial executor (``exec_kernel``) the scratch and the
resolve.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launches
from ._launch import (ALLOC_SLACK, I, P, check_cuda, check_rc, kernel_fn, padded_records,
                      ptr, stream)

KIND_SEQ = 0
KIND_LIT = 1
KIND_RLE = 2
KIND_NOP = 3

F_FRAME_START = 1
F_FRAME_END = 2

M_FRAME = 0
M_KIND = 1
M_WROW = 2
M_NSEQ = 3
M_LITN = 4  # KIND_LIT/KIND_RLE: length; KIND_SEQ: block literal budget
M_FLAGS = 5
M_RLEBYTE = 6
M_TLL = 7
M_TOF = 8
M_TML = 9
M_LOGS = 10  # ll_log | of_log << 5 | ml_log << 10
M_STARTBIT = 11
META_COLS = 16

RING = 1 << 19   # the ring route's window limit (512 KiB)

_MASK32 = 0xFFFFFFFF


def make_consts():
    """(4, 64) int32: LL_BASE, LL_BITS, ML_BASE, ML_BITS padded."""
    from ..codec import sequences as seq_mod

    consts = np.zeros((4, 64), np.int32)
    consts[0, : len(seq_mod.LL_BASE)] = seq_mod.LL_BASE
    consts[1, : len(seq_mod.LL_BITS)] = seq_mod.LL_BITS
    consts[2, : len(seq_mod.ML_BASE)] = seq_mod.ML_BASE
    consts[3, : len(seq_mod.ML_BITS)] = seq_mod.ML_BITS
    return consts


def build_records(frames):
    """``frames``: per output frame, a list of block entries:
      ("seq", wrow, nseq, lit_budget, tll, tof, tml, logs, startbit)
      ("lit", litlen)
      ("rle", count, byte)
    Returns (int32[NRECP, META_COLS], record count)."""
    recs = []
    for f, blocks in enumerate(frames):
        if not blocks:
            blocks = [("lit", 0)]
        n_blocks = len(blocks)
        for bi, b in enumerate(blocks):
            flags = (F_FRAME_START if bi == 0 else 0) | (
                F_FRAME_END if bi == n_blocks - 1 else 0
            )
            row = [f, 0, 0, 0, 0, flags, 0] + [0] * (META_COLS - 7)
            if b[0] == "seq":
                (_, wrow, nseq, budget, tll, tof, tml, logs, startbit) = b
                row[M_KIND] = KIND_SEQ
                row[M_WROW] = wrow
                row[M_NSEQ] = nseq
                row[M_LITN] = budget
                row[M_TLL] = tll
                row[M_TOF] = tof
                row[M_TML] = tml
                row[M_LOGS] = logs
                row[M_STARTBIT] = startbit
            elif b[0] == "lit":
                row[M_KIND] = KIND_LIT
                row[M_LITN] = b[1]
            else:
                row[M_KIND] = KIND_RLE
                row[M_LITN] = b[1]
                row[M_RLEBYTE] = b[2]
            recs.append(row)
    n = len(recs)
    nrecp = padded_records(n)
    out = np.zeros((nrecp, META_COLS), np.int32)
    if recs:
        out[:n] = np.asarray(recs, np.int32)
    out[n:, M_KIND] = KIND_NOP
    return out, n


def _i32(x: int) -> int:
    return ((x + (1 << 31)) & _MASK32) - (1 << 31)


def _read_bits(wrow, WB, rem, n):
    """n bits ending at bit ``rem`` of the backward stream (n in [0, 31])."""
    if n <= 0:
        return 0
    lo = rem - n
    w = min(max(lo >> 5, 0), WB - 2)
    sh = lo & 31
    hi = 0 if sh == 0 else (wrow[w + 1] << (32 - sh)) & _MASK32
    return ((wrow[w] >> sh) | hi) & ((1 << min(n, 31)) - 1)


def _window_read(ws4, wbase, rem, n):
    """The ring kernel's read: n bits ending at ``rem`` from the four words
    loaded at ``wbase`` for this sequence."""
    if n <= 0:
        return 0
    lo = max(rem - n - wbase, 0)
    ws, sh = lo >> 5, lo & 31
    a = ws4[min(ws, 3)]
    b = ws4[ws + 1] if ws < 3 else 0
    v = a if sh == 0 else ((a >> sh) | (b << (32 - sh))) & _MASK32
    return v & ((1 << min(n, 31)) - 1)


def _row(i: int, n: int) -> int:
    """A meta row index outside [0, n) reads row n - 1, as the kernels
    (and the reference kernels' index maps) take it."""
    return i if 0 <= i < n else n - 1


def _padded(buf, start, n):
    piece = bytes(buf[start:start + n])
    return piece + bytes(n - len(piece))


def decode_plain(consts, meta, words, tables, lit_pools, OUTB: int, ring: bool,
                 LITB: int = 0, LROWS: int = 0):
    """The fused decode over Python ints, record by record, for either
    contract: ``ring`` picks the ring kernel's literal clamp, window check
    and bitstream reads, else the wide kernel's (which need LITB and
    LROWS). ``lit_pools``: per frame, its literal pool as bytes.
    Returns (per-frame output bytearrays of OUTB bytes, meta_out int32[F, 128])."""
    c = consts.reshape(4, 64).tolist()
    m_rows = meta.reshape(-1, META_COLS).tolist()
    wtab = words.reshape(words.shape[0], -1)
    WB = wtab.shape[1]
    wtab_np = wtab.detach().cpu().numpy().view(np.uint32)
    tab = tables.reshape(-1, 512).detach().cpu().numpy()
    F = len(lit_pools)
    outs = [bytearray(OUTB) for _ in range(F)]
    meta_out = np.zeros((F, 128), np.int32)
    LRWS = LITB // 128 + 1
    states = {}
    for m in m_rows:
        kind, f, flags = m[M_KIND], m[M_FRAME], m[M_FLAGS]
        if kind == KIND_NOP:
            continue
        if flags & F_FRAME_START or f not in states:
            states[f] = [0, 1, 4, 8, 0, 0]  # pos, r1, r2, r3, bad, litcur
        st = states[f]
        out, pool = outs[f], lit_pools[f]
        pos, r1, r2, r3, bad, litcur0 = st
        litn = m[M_LITN]
        if ring:
            lit_lim = litcur0 + litn
        else:
            lit_row0 = min(litcur0 // 128, LROWS - LRWS)
            lit_lim = lit_row0 * 128 + LITB + 128
        if kind == KIND_SEQ:
            wrow = wtab_np[_row(m[M_WROW], len(wtab_np))].tolist()
            tll, tof, tml = (tab[_row(m[k], len(tab))].tolist()
                             for k in (M_TLL, M_TOF, M_TML))
            logs = m[M_LOGS]
            rem = m[M_STARTBIT]
            ll_s = _read_bits(wrow, WB, rem, logs & 31)
            rem -= logs & 31
            of_s = _read_bits(wrow, WB, rem, (logs >> 5) & 31)
            rem -= (logs >> 5) & 31
            ml_s = _read_bits(wrow, WB, rem, (logs >> 10) & 31)
            rem -= (logs >> 10) & 31
            litcur = litcur0
            nseq = m[M_NSEQ]
            for j in range(nseq):
                of_e, ml_e, ll_e = tof[of_s & 511], tml[ml_s & 511], tll[ll_s & 511]
                if ring:
                    bw = min(max(((rem & _MASK32) >> 5) - 3, 0), WB - 4)
                    ws4, wbase = wrow[bw:bw + 4], bw * 32

                    def rd(r, n):
                        return _window_read(ws4, wbase, r, n)
                else:
                    def rd(r, n):
                        return _read_bits(wrow, WB, r, n)
                of_code = of_e & 0xFF
                ofv = _i32((1 << min(of_code, 31)) + rd(rem, of_code))
                rem -= of_code
                ml_code = ml_e & 0xFF
                mlb = c[3][ml_code & 63]
                ml = c[2][ml_code & 63] + rd(rem, mlb)
                rem -= mlb
                ll_code = ll_e & 0xFF
                llb = c[1][ll_code & 63]
                ll = c[0][ll_code & 63] + rd(rem, llb)
                rem -= llb
                # Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1).
                ridx = 0 if ofv > 3 else ofv + (1 if ll == 0 else 0)
                off = (ofv - 3 if ofv > 3 else r1 if ridx == 1 else r2 if ridx == 2
                       else r3 if ridx == 3 else r1 - 1)
                moved = ofv > 3 or ridx != 1
                r1, r2, r3 = (off if moved else r1, r1 if moved else r2,
                              r3 if ridx == 2 else (r2 if moved else r3))
                upd = j + 1 < nseq
                for which in range(3):
                    e = (ll_e, ml_e, of_e)[which]
                    nb = (e >> 8) & 0xFF
                    s2 = (e >> 16) + rd(rem, nb)
                    if upd:
                        rem -= nb
                        if which == 0:
                            ll_s = s2
                        elif which == 1:
                            ml_s = s2
                        else:
                            of_s = s2
                ll_w = min(ll, OUTB - pos, max(lit_lim - litcur, 0))
                bad |= ll_w != ll
                if ll_w > 0:
                    out[pos:pos + ll_w] = _padded(pool, litcur, ll_w)
                mpos = pos + ll_w
                ml_w = min(ml, OUTB - mpos)
                if ring:
                    bad |= (ml > 0 and (off <= 0 or off > mpos or off > RING)) or ml_w != ml
                    safe_off = min(max(off, 1), max(min(mpos, RING), 1))
                else:
                    bad |= (ml > 0 and (off <= 0 or off > mpos)) or ml_w != ml
                    safe_off = min(max(off, 1), max(mpos, 1))
                if ml_w > 0:
                    src = mpos - safe_off
                    if src < 0:  # mpos == 0: bytes before the row read 0
                        out[mpos:mpos + ml_w] = bytes(ml_w)
                    elif safe_off >= ml_w:
                        out[mpos:mpos + ml_w] = out[src:src + ml_w]
                    else:
                        period = bytes(out[src:mpos])
                        reps = -(-ml_w // safe_off)
                        out[mpos:mpos + ml_w] = (period * reps)[:ml_w]
                pos = mpos + ml_w
                litcur += ll_w
            bad |= rem != 0
            trail = litn - (litcur - litcur0)
            bad |= trail < 0
            trail_c = min(max(trail, 0), OUTB - pos)
            if not ring:
                trail_c = min(trail_c, max(lit_lim - litcur, 0))
            bad |= trail_c != max(trail, 0)
            if trail_c > 0:
                out[pos:pos + trail_c] = _padded(pool, litcur, trail_c)
            st[:] = [pos + trail_c, r1, r2, r3, int(bad), litcur + trail_c]
        elif kind == KIND_LIT:
            litn_w = min(litn, OUTB - pos)
            if not ring:
                litn_w = min(litn_w, max(lit_lim - litcur0, 0))
            bad |= litn_w != litn
            if litn_w > 0:
                out[pos:pos + litn_w] = _padded(pool, litcur0, litn_w)
            st[:] = [pos + litn_w, r1, r2, r3, int(bad), litcur0 + litn_w]
        elif kind == KIND_RLE:
            litn_w = min(litn, OUTB - pos)
            bad |= litn_w != litn
            if litn_w > 0:
                out[pos:pos + litn_w] = bytes([m[M_RLEBYTE] & 0xFF]) * litn_w
            st[:] = [pos + litn_w, r1, r2, r3, int(bad), litcur0]
        if flags & F_FRAME_END:
            meta_out[f, 0], meta_out[f, 1], meta_out[f, 2] = st[0], st[4], st[5]
    return outs, meta_out


def wide_plain(consts, meta, words, tables, lits, OUTB: int, LITB: int):
    F, LROWS = lits.shape[0], lits.shape[1]
    pools = [
        bytes(lits[f].reshape(-1).to(torch.uint8).cpu().numpy()) for f in range(F)
    ]
    outs, meta_out = decode_plain(consts, meta, words, tables, pools, OUTB,
                                  ring=False, LITB=LITB, LROWS=LROWS)
    out = np.frombuffer(b"".join(outs), np.uint8).reshape(F, OUTB // 128, 128)
    dev = lits.device
    return torch.from_numpy(out.copy()).to(dev), torch.from_numpy(meta_out).to(dev)


def stage_bytes(F: int, OUTB: int, n_rec: int, n_seq: int) -> int:
    """Device bytes of ``staged_decode`` for F frames of OUTB bytes, n_rec
    records and n_seq sequences: two descriptor buffers, 8 B per byte of
    F x OUTB; lls/mls/ofvs, 12 B per sequence; per padded record its meta
    row (64 B, built per launch) and 32 B of sequence offsets and remaining
    bits with their temporaries; meta_out; ``ALLOC_SLACK``."""
    return (F * (OUTB * 8 + 512) + n_seq * 12 + padded_records(n_rec) * (META_COLS * 4 + 32)
            + ALLOC_SLACK)


def launch_bytes(F: int, OUTB: int, LROWS: int, n_rec: int, n_seq: int) -> int:
    """Device bytes of a ``wide_decode`` launch: the literal pools, 4 B per
    slot of F x LROWS x 128 and 1 B for the bytes they are staged as
    before they are widened on the card; the output, 1 B per byte of F x
    OUTB; ``stage_bytes``."""
    return F * (LROWS * 128 * 5 + OUTB) + stage_bytes(F, OUTB, n_rec, n_seq)


def descriptor_scratch(F: int, OUTB: int, dev):
    """The scan's and the resolve's buffers: two of F x OUTB int32
    descriptors, the first with every byte the terminal 0 (-1), the second
    written whole by the first jump round; and meta_out (F, 128)."""
    desc_a = torch.full((F * OUTB,), -1, dtype=torch.int32, device=dev)
    desc_b = torch.empty(F * OUTB, dtype=torch.int32, device=dev)
    return desc_a, desc_b, torch.zeros((F, 128), dtype=torch.int32, device=dev)


def resolve_stage(label: str, contract: str, desc_a, desc_b, pool, pool_width: int,
                  OUTB: int, out):
    """The resolve launch of ``contract``'s instance ("wide" or "ring"):
    pointer jumping from ``desc_a`` and the gather from the pools ``pool``
    (F rows of ``pool_width`` elements) into ``out``; raises if the
    launcher reports an error."""

    def resolve():
        fn = kernel_fn(f"zk_{contract}_resolve_launch", [P, P, P, I, I, I, P, P])
        check_rc(f"{label} (resolve)", fn(
            ptr(desc_a), ptr(desc_b), ptr(pool), pool.shape[0], pool_width, OUTB, ptr(out),
            stream()))

    return resolve


def staged_decode(contract, consts, meta, words, tables, pool, out, *, OUTB: int,
                  scan_ints, pool_width: int, min_wb: int):
    """Scratch and launches of the three stages of ``csrc/wide_decode.cu``
    for ``contract`` ("wide" or "ring"), writing ``out`` (F x OUTB bytes)
    from the literal pools ``pool`` (F rows of ``pool_width`` elements).
    ``scan_ints`` are the scan launcher's contract arguments after OUTB.
    Returns (meta_out, stages): ``stages`` are ("fse", "scan", "resolve")
    launch functions, to run in that order on the current stream; each
    raises if its launcher reports an error. Reads the total sequence count
    back from the card once."""
    for name, t in (("consts", consts), ("meta", meta), ("words", words),
                    ("tables", tables), ("pool", pool)):
        check_cuda(name, t)
    F = pool.shape[0]
    nrecp = meta.numel() // META_COLS
    nw, WB = words.shape[0], words.numel() // max(words.shape[0], 1)
    if nw < 1 or WB < min_wb or tables.numel() < 512 or nrecp < 1:
        raise ValueError(f"words needs a row of >= {min_wb} words, tables and meta a row each")
    dev = pool.device
    m = meta.reshape(nrecp, META_COLS)
    nseq = torch.where(m[:, M_KIND] == KIND_SEQ, m[:, M_NSEQ].clamp(min=0), 0).to(torch.int64)
    ends = torch.cumsum(nseq, 0)
    total = int(ends[-1])
    if total >= 1 << 31:
        raise ValueError(f"{total} sequences: too many for int32 offsets")
    seq_off = (ends - nseq).to(torch.int32)
    lls, mls, ofvs = (torch.empty(max(total, 1), dtype=torch.int32, device=dev)
                      for _ in range(3))
    rems = torch.empty(nrecp, dtype=torch.int32, device=dev)
    desc_a, desc_b, meta_out = descriptor_scratch(F, OUTB, dev)
    label = f"{contract}_decode"

    def fse():
        fn = kernel_fn(f"zk_{contract}_fse_launch", [P, P, I, P, I, I, P, I, P, P, P, P, P, P])
        check_rc(f"{label} (fse)", fn(
            ptr(consts), ptr(meta), nrecp, ptr(words), nw, WB, ptr(tables),
            tables.numel() // 512, ptr(seq_off), ptr(lls), ptr(mls), ptr(ofvs), ptr(rems),
            stream()))

    def scan():
        fn = kernel_fn(f"zk_{contract}_scan_launch",
                       [P, I, P, P, P, P, P, I, I] + [I] * len(scan_ints) + [P, P, P])
        check_rc(f"{label} (scan)", fn(
            ptr(meta), nrecp, ptr(seq_off), ptr(rems), ptr(lls), ptr(mls), ptr(ofvs),
            F, OUTB, *scan_ints, ptr(desc_a), ptr(meta_out), stream()))

    resolve = resolve_stage(label, contract, desc_a, desc_b, pool, pool_width, OUTB, out)
    return meta_out, (("fse", fse), ("scan", scan), ("resolve", resolve))


def wide_stages(consts, meta, words, tables, lits, *, OUTB: int, LITB: int):
    """Allocate the outputs and scratch of the CUDA wide decoder for these
    CUDA inputs (see ``wide_decode``). Returns (out, meta_out, stages), as
    ``staged_decode``."""
    check_cuda("lits", lits)
    F, LROWS = lits.shape[0], lits.shape[1]
    if OUTB <= 0 or OUTB % 128 or LITB < 0 or LITB % 128:
        raise ValueError("OUTB must be a positive multiple of 128, LITB a multiple of 128")
    if LROWS * 128 + LITB + 256 >= 1 << 31:
        raise ValueError("literal pool too large for int32 descriptors")
    out = torch.empty((F, OUTB // 128, 128), dtype=torch.uint8, device=lits.device)
    meta_out, stages = staged_decode("wide", consts, meta, words, tables, lits, out,
                                     OUTB=OUTB, scan_ints=(LITB, LROWS), pool_width=LROWS,
                                     min_wb=2)
    return out, meta_out, stages


def wide_decode(consts, meta, words, tables, lits, *, OUTB: int, LITB: int):
    """Decode every frame (any declared window). consts int32[4, 64], meta
    int32[NRECP, META_COLS], words int32[nw, WB], tables int32[Tp, 512],
    lits int32[F, LROWS, 128] (one literal byte per int). Returns (out
    uint8[F, OUTB/128, 128], meta_out int32[F, 128] = total, bad flag,
    literals used); output bytes are exact up to the total. Records are
    frame-major with a frame's F_FRAME_START on its first record
    (``build_records``)."""
    if lits.device.type == "cpu":
        return wide_plain(consts, meta, words, tables, lits, OUTB, LITB)
    out, meta_out, stages = wide_stages(consts, meta, words, tables, lits,
                                        OUTB=OUTB, LITB=LITB)
    for _name, launch in stages:
        launch()
    launches["wide_decode"] += 1
    return out, meta_out
