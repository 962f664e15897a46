"""Serial sequence executor: record layout, plain version and CUDA wrapper.

Port of ``zeekstd_tpu/ops/exec_kernel.py``. The serial decode route
decodes every block's FSE stream first (``entropy.fse_decode_sequences``)
and hands the pre-decoded (ll, ml, raw offset value) rows to this
executor, which walks each frame's records in order:

- KIND_SEQ: a slice of at most SBd sequences of one block; repeat offsets
  resolve with libzstd's rules, the history threaded across the blocks of
  a frame; after the block's last slice (F_BLOCK_END) come the trailing
  literals its literal budget leaves, counted from the literal cursor at
  the block's first slice (F_BLOCK_START);
- KIND_LIT: a literal run (raw blocks, sequence-less blocks);
- KIND_RLE: one byte repeated;
- KIND_NOP: padding.

The literal window of a record is fixed where the record starts: LITB +
128 bytes from the 128-byte row holding its first literal (that row
clamped to LROWS - LITB/128 - 1). A literal run past it, a write past
OUTB, a match offset outside (0, position] or a negative trailing run
marks the frame bad; per frame, meta_out holds (total, bad flag, literals
consumed) in lanes 0-2. Output bytes past a frame's total are not defined
(the reference never clears its scratch between frames; the CUDA kernel
writes 0 there), so comparisons cover [0, total).

On the card the executor runs two of the wide decoder's stages
(``csrc/wide_decode.cu``) in their exec instance: a scan per frame that
writes one descriptor per output byte, and the wide instance's pointer
jumping over the descriptors (``exec_stages``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import corruption_detected
from . import launches
from ._launch import (ALLOC_SLACK, I, P, check_cuda, check_rc, kernel_fn, padded_records,
                      ptr, stream)
from .decode_kernel import descriptor_scratch, resolve_stage

# Record kinds
KIND_SEQ = 0  # sequences slice of a compressed block (+ trail at block end)
KIND_LIT = 1  # pure literal run (raw block / sequence-less block)
KIND_RLE = 2  # RLE block: one byte repeated
KIND_NOP = 3  # padding

# Flags
F_FRAME_START = 1
F_FRAME_END = 2
F_BLOCK_START = 4
F_BLOCK_END = 8

# meta columns
M_FRAME = 0
M_KIND = 1
M_ROW = 2
M_NSEQ = 3
M_LITN = 4  # KIND_LIT/KIND_RLE: length; KIND_SEQ: block literal budget
M_FLAGS = 5
M_RLEBYTE = 6
META_COLS = 8


def build_records(frames, sbd: int):
    """Host-side record table builder.

    ``frames`` is a list (one per output frame) of per-block entries:
      ("seq", row, nseq, lit_budget)  — row indexes the (NROWS, sbd)
        sequence arrays; blocks wider than sbd span consecutive rows
      ("lit", litlen)
      ("rle", count, byte)
    Returns int32[NRECP, META_COLS] (padded) and the record count.
    """
    recs = []
    for f, blocks in enumerate(frames):
        if not blocks:
            blocks = [("lit", 0)]
        n_blocks = len(blocks)
        for bi, b in enumerate(blocks):
            fflags = (F_FRAME_START if bi == 0 else 0) | (
                F_FRAME_END if bi == n_blocks - 1 else 0
            )
            if b[0] == "seq":
                _, row, nseq, budget = b
                n_slices = max(1, -(-nseq // sbd))
                for s in range(n_slices):
                    ns = min(sbd, nseq - s * sbd)
                    flags = F_BLOCK_START if s == 0 else 0
                    if s == n_slices - 1:
                        flags |= F_BLOCK_END
                    rec_flags = flags
                    if s == 0:
                        rec_flags |= fflags & F_FRAME_START
                    if s == n_slices - 1:
                        rec_flags |= fflags & F_FRAME_END
                    recs.append([f, KIND_SEQ, row + s, ns, budget,
                                 rec_flags, 0, 0])
            elif b[0] == "lit":
                _, litlen = b
                recs.append([f, KIND_LIT, 0, 0, litlen,
                             fflags | F_BLOCK_START | F_BLOCK_END, 0, 0])
            else:
                _, count, byte = b
                recs.append([f, KIND_RLE, 0, 0, count,
                             fflags | F_BLOCK_START | F_BLOCK_END, byte, 0])
    n = len(recs)
    nrecp = padded_records(n)
    out = np.zeros((nrecp, META_COLS), np.int32)
    if recs:
        out[:n] = np.asarray(recs, np.int32)
    out[n:, M_KIND] = KIND_NOP
    return out, n


def _check_shapes(lls, lits, OUTB: int, LITB: int, SBd: int) -> None:
    if OUTB % 4096 != 0:
        raise ValueError("OUTB must be a multiple of 4096")
    if LITB % 128 != 0:
        raise ValueError("LITB must be a multiple of 128")
    if SBd % 8 != 0:
        raise ValueError("SBd must be a multiple of 8")
    if lls.dim() != 2 or lls.shape[1] != SBd or lls.shape[0] < 1:
        raise ValueError(f"sequence rows must be (NROWS >= 1, {SBd}), got {tuple(lls.shape)}")
    if lits.dim() != 3 or lits.shape[2] != 128 or lits.shape[1] < LITB // 128 + 1:
        raise ValueError("lits must be (F, LROWS >= LITB/128 + 1, 128)")


def _copy_match(out: bytearray, mpos: int, off: int, n: int) -> None:
    """out[mpos + k] = out[mpos - off + (k mod off)]; a source before the
    row's start reads 0."""
    src = mpos - off
    if src < 0:  # only off == 1 at mpos == 0 (the frame is marked bad)
        out[mpos:mpos + n] = bytes(n)
    elif off >= n:
        out[mpos:mpos + n] = out[src:src + n]
    else:
        period = bytes(out[src:mpos])
        out[mpos:mpos + n] = (period * -(-n // off))[:n]


def exec_plain(meta, lls, mls, ofvs, lits, OUTB: int, LITB: int, SBd: int):
    """The executor over Python ints, record by record. Returns (out
    uint8[F, OUTB/128, 128], meta_out int32[F, 128])."""
    m_rows = meta.reshape(-1, META_COLS).tolist()
    rows = [t.reshape(-1, SBd).cpu().numpy() for t in (lls, mls, ofvs)]
    nrows = rows[0].shape[0]
    F, LROWS = lits.shape[0], lits.shape[1]
    LRWS = LITB // 128 + 1
    pools = [bytes(lits[f].reshape(-1).to(torch.uint8).cpu().numpy()) for f in range(F)]
    outs = [bytearray(OUTB) for _ in range(F)]
    meta_out = np.zeros((F, 128), np.int32)
    st = {}
    for m in m_rows:
        kind, f, flags = m[M_KIND], m[M_FRAME], m[M_FLAGS]
        if kind == KIND_NOP:
            continue
        if flags & F_FRAME_START or f not in st:
            # pos, r1, r2, r3, bad, literal cursor, cursor at block start
            st[f] = [0, 1, 4, 8, 0, 0, 0]
        s = st[f]
        if flags & F_BLOCK_START:
            s[6] = s[5]
        out, pool = outs[f], pools[f]
        pos, r1, r2, r3, bad, litcur0, blit = s
        litn = m[M_LITN]
        lit_lim = min(litcur0 // 128, LROWS - LRWS) * 128 + LITB + 128
        if kind == KIND_SEQ:
            row = min(max(m[M_ROW], 0), nrows - 1)
            nseq = min(max(m[M_NSEQ], 0), SBd)
            lls_r, mls_r, ofv_r = (r[row, :nseq].tolist() for r in rows)
            litcur = litcur0
            for ll, ml, ofv in zip(lls_r, mls_r, ofv_r):
                # Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1).
                ridx = 0 if ofv > 3 else ofv + (1 if ll == 0 else 0)
                off = (ofv - 3 if ofv > 3 else r1 if ridx == 1 else r2 if ridx == 2
                       else r3 if ridx == 3 else r1 - 1)
                moved = ofv > 3 or ridx != 1
                r1, r2, r3 = (off if moved else r1, r1 if moved else r2,
                              r3 if ridx == 2 else (r2 if moved else r3))
                ll_w = min(ll, OUTB - pos, max(lit_lim - litcur, 0))
                bad |= ll_w != ll
                if ll_w > 0:
                    out[pos:pos + ll_w] = pool[litcur:litcur + ll_w]
                mpos = pos + ll_w
                ml_w = min(ml, OUTB - mpos)
                bad |= (ml > 0 and (off <= 0 or off > mpos)) or ml_w != ml
                safe_off = min(max(off, 1), max(mpos, 1))
                if ml_w > 0:
                    _copy_match(out, mpos, safe_off, ml_w)
                pos = mpos + ml_w
                litcur += ll_w
            trail = litn - (litcur - blit) if flags & F_BLOCK_END else 0
            bad |= trail < 0
            trail_c = min(max(trail, 0), OUTB - pos, max(lit_lim - litcur, 0))
            bad |= trail_c != max(trail, 0)
            if trail_c > 0:
                out[pos:pos + trail_c] = pool[litcur:litcur + trail_c]
            s[:6] = [pos + trail_c, r1, r2, r3, int(bad), litcur + trail_c]
        elif kind == KIND_LIT:
            litn_w = min(litn, OUTB - pos, max(lit_lim - litcur0, 0))
            bad |= litn_w != litn
            if litn_w > 0:
                out[pos:pos + litn_w] = pool[litcur0:litcur0 + litn_w]
            s[0], s[4], s[5] = pos + litn_w, int(bad), litcur0 + litn_w
        elif kind == KIND_RLE:
            litn_w = min(litn, OUTB - pos)
            bad |= litn_w != litn
            if litn_w > 0:
                out[pos:pos + litn_w] = bytes([m[M_RLEBYTE] & 0xFF]) * litn_w
            s[0], s[4] = pos + litn_w, int(bad)
        if flags & F_FRAME_END:
            meta_out[f, 0], meta_out[f, 1], meta_out[f, 2] = s[0], s[4], s[5]
    out = np.frombuffer(b"".join(outs), np.uint8).reshape(F, OUTB // 128, 128)
    dev = lits.device
    return torch.from_numpy(out.copy()).to(dev), torch.from_numpy(meta_out).to(dev)


def launch_bytes(F: int, OUTB: int, LROWS: int, n_rec: int) -> int:
    """Device bytes of a ``serial_exec`` launch: the literal pools, 4 B per
    slot of F x LROWS x 128; the meta rows of n_rec records, padded; per
    byte of F x OUTB the output (1 B) and two int32 descriptor buffers
    (8 B); meta_out; ``ALLOC_SLACK``."""
    return (F * (LROWS * 128 * 4 + OUTB * 9 + 512) + padded_records(n_rec) * META_COLS * 4
            + ALLOC_SLACK)


def exec_stages(meta, lls, mls, ofvs, lits, *, OUTB: int, LITB: int, SBd: int):
    """Allocate the output and scratch of the CUDA executor for these CUDA
    inputs (see ``serial_exec``). Returns (out, meta_out, stages):
    ``stages`` are the ("scan", "resolve") launch functions, to run in that
    order on the current stream; each raises if its launcher reports an
    error."""
    _check_shapes(lls, lits, OUTB, LITB, SBd)
    for name, t in (("meta", meta), ("lls", lls), ("mls", mls), ("ofvs", ofvs),
                    ("lits", lits)):
        check_cuda(name, t)
    if OUTB >= (1 << 31) - 256:
        # A descriptor is a position below OUTB or -257 - i for a literal
        # index i below OUTB, in int32.
        raise corruption_detected("frame output too large for int32 descriptors")
    F, LROWS = lits.shape[0], lits.shape[1]
    nrecp, nrows = meta.numel() // META_COLS, lls.shape[0]
    dev = lits.device
    out = torch.empty((F, OUTB // 128, 128), dtype=torch.uint8, device=dev)
    desc_a, desc_b, meta_out = descriptor_scratch(F, OUTB, dev)

    def scan():
        fn = kernel_fn("zk_exec_scan_launch", [P, I, P, P, P, I, I, I, I, I, I, P, P, P])
        check_rc("exec (scan)", fn(
            ptr(meta), nrecp, ptr(lls), ptr(mls), ptr(ofvs), nrows, SBd, F, OUTB, LITB, LROWS,
            ptr(desc_a), ptr(meta_out), stream()))

    resolve = resolve_stage("exec", "wide", desc_a, desc_b, lits, LROWS, OUTB, out)
    return out, meta_out, (("scan", scan), ("resolve", resolve))


def serial_exec(meta, lls, mls, ofvs, lits, *, OUTB: int, LITB: int, SBd: int):
    """Execute every frame's records. meta int32[NRECP, META_COLS];
    lls/mls/ofvs int32[NROWS, SBd]; lits int32[F, LROWS, 128] (one literal
    byte per int). Returns (out uint8[F, OUTB/128, 128], meta_out
    int32[F, 128] = total, bad flag, literals consumed). Records are
    frame-major with a frame's F_FRAME_START on its first record
    (``build_records``)."""
    if lits.device.type == "cpu":
        _check_shapes(lls, lits, OUTB, LITB, SBd)
        return exec_plain(meta, lls, mls, ofvs, lits, OUTB, LITB, SBd)
    out, meta_out, stages = exec_stages(meta, lls, mls, ofvs, lits, OUTB=OUTB, LITB=LITB,
                                        SBd=SBd)
    for _name, launch in stages:
        launch()
    launches["exec"] += 1
    return out, meta_out
