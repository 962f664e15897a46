"""Level-1 LZ77 match finder: record layout, plain version, CUDA wrapper.

Port of ``zeekstd_tpu/ops/match_kernel.py`` (the serial Pallas parse).
One record per (frame, block), frame-major; each record parses one
block and emits, in rows of its own:

  lm   (SBd,)   (ll_written << 16) | ml per sequence
  ofv  (SBd,)   repeat-coded offset values
  litw (BLK/4,) the block's literal bytes packed LE into words
  stat (512,)   counters and histograms (see the ST_* layout)

Blocks above 32 KiB (``wide_rows``) may hold a literal run or a match of
2^16 bytes or more, which the packed ``lm`` cannot carry: there ``lm``
holds ll_written and a fifth row, ``ml``, the match lengths (the FSE
kernel's wide layout). Up to 32 KiB the packed record stays.

Per visited position: hash 6 bytes into a single-entry table of
(tagged position, word), probe rep1 first (taken unconditionally), gate
hash matches by 6*ml >= 14 + bitlen(offset), run a 1-step lazy race,
extend backward over the pending literals, insert stride-2 interior
positions up to INS_CAP. Literal-run anchor and repeat history thread
across the blocks of a frame.

The TPU kernel walks every record in order on one core with one hash
table. Here each frame owns its table (the CUDA kernel runs one thread
block per frame, one warp carrying its serial parse): the two agree
because a hash hit is only accepted when its tag is at least
``frame_base + window_low``, which no entry from an earlier frame can be.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launches
from ._launch import I, L, P, check_cuda, check_rc, kernel_fn, ptr, stream

# meta columns
M_FRAME = 0
M_BS = 1      # block start within frame (bytes)
M_BLEN = 2    # valid bytes in block
M_FLAGS = 3
M_WOFF = 4    # word offset of the block in the flat words array, /1024
M_SLOT = 5    # window slot index for this block (TPU staging only)
M_FBASE = 6   # frame base offset for hash tags (frame * frame_size)
META_COLS = 8

F_FRAME_START = 1
F_FRAME_END = 2

# stat row layout
ST_NSEQ = 0
ST_MLSUM = 1
ST_LITCNT = 2
ST_EXTREP = 3      # block reads rep history inherited from earlier blocks
ST_OVERFLOW = 4
ST_LLHIST = 5      # 36 bins
ST_MLHIST = 41     # 53 bins
ST_OFHIST = 94     # 32 bins
ST_LITHIST = 128   # 256 bins
ST_TRASH = 508     # the reference's disabled histogram increments land here

HB = 14            # hash bits: 2^HB entries x (pos, word)
WIN_LOG = 19       # sliding window: 512 KiB (libzstd level-1 window)
INS_CAP = 16       # interior insertion reach (positions 1..INS_CAP, step 2)
LAZY_ML_MAX = 32   # no lazy race once the first match is this long

PACKED_BLK = 32 << 10  # the largest block whose ll and ml fit 16 bits each

_M1 = 2654435761   # Knuth multiplier (wraps mod 2^32)
_M2 = 0x85EBCA77
_MASK32 = 0xFFFFFFFF


def wide_rows(BLK: int) -> bool:
    """Whether blocks of ``BLK`` bytes carry ll and ml in rows of their own
    (above 32 KiB) rather than the packed ``ll << 16 | ml``."""
    return BLK > PACKED_BLK


def bucket_nrecp(n: int) -> int:
    """Round the record count up to a canonical size (padding records have
    blen=0 and do nothing)."""
    for b in (8, 16, 32, 64, 128, 192, 256, 384, 512, 768, 1024):
        if n <= b:
            return b
    return -(-n // 1024) * 1024


def build_records(F: int, B: int, BLK: int, FR: int, lengths,
                  n_pad: int | None = None):
    """meta int32[n_pad or F*B, META_COLS]: one record per (frame, block),
    in frame-major order. Padding records have blen=0."""
    assert F * FR < (1 << 31), "hash tags need frame*FR + pos < 2^31"
    WIN = 1 << WIN_LOG
    NSLOT = max(WIN // BLK, 1)
    nrec = F * B
    meta = np.zeros((n_pad if n_pad else nrec, META_COLS), np.int32)
    r = 0
    for f in range(F):
        n_valid = int(lengths[f])
        for b in range(B):
            bs = b * BLK
            meta[r, M_FRAME] = f
            meta[r, M_BS] = bs
            meta[r, M_BLEN] = max(0, min(BLK, n_valid - bs))
            meta[r, M_FLAGS] = (F_FRAME_START if b == 0 else 0) | (
                F_FRAME_END if b == B - 1 else 0
            )
            meta[r, M_WOFF] = (f * FR + bs) // 4096  # 1024-word units
            meta[r, M_SLOT] = b % NSLOT
            meta[r, M_FBASE] = f * FR
            r += 1
    return meta


def _highbit(x: int) -> int:
    return max(x, 1).bit_length() - 1


def _code_of(consts, ll: int, ml: int, ofv: int):
    llc = consts[256 + ll] if ll < 64 else 19 + _highbit(ll)
    mlb = ml - 3
    mlc = consts[320 + mlb] if mlb < 128 else 36 + _highbit(mlb)
    return llc, mlc, _highbit(ofv)


def _parse_block(data, base, m, st, ht_pos, ht_word, SBd, consts):
    """One record of the serial parse over Python ints. ``data`` holds
    the words array as bytes (zero-padded), ``base`` the frame's byte
    offset in it. Returns (lm, ofv, literal bytes, stat row) and updates
    the cross-block state ``st`` = [anchor, r1, r2, r3] in place. ``lm``
    holds (ll_written, ml) pairs."""
    bs, blen, fbase = m[M_BS], m[M_BLEN], m[M_FBASE]
    bend = bs + blen
    lo_win = max(bend - (1 << WIN_LOG), 0)
    shift = 32 - HB

    def w32(q):
        i = base + q
        return int.from_bytes(data[i:i + 4], "little")

    def extend(a, b, maxl):
        ia, ib, k = base + a, base + b, 0
        while k + 16 <= maxl and data[ia + k:ia + k + 16] == data[ib + k:ib + k + 16]:
            k += 16
        while k < maxl and data[ia + k] == data[ib + k]:
            k += 1
        return k

    def insert(q):
        q0 = w32(q)
        h = (((q0 * _M1) ^ ((w32(q + 4) & 0xFFFF) * _M2)) & _MASK32) >> shift
        ht_pos[h] = fbase + q
        ht_word[h] = q0

    def probe(abs_p, r1):
        w = w32(abs_p)
        h = (((w * _M1) ^ ((w32(abs_p + 4) & 0xFFFF) * _M2)) & _MASK32) >> shift
        cand_gp, cand_w = ht_pos[h], ht_word[h]
        ht_pos[h] = fbase + abs_p
        ht_word[h] = w
        rsrc = abs_p - r1
        rep_hit = rsrc >= lo_win and w32(rsrc) == w
        hash_ok = cand_gp >= fbase + lo_win and cand_w == w
        if not (rep_hit or hash_ok):
            return False, False, abs_p, 4, 0
        src = rsrc if rep_hit else cand_gp - fbase
        ml = 4 + extend(abs_p + 4, src + 4, bend - (abs_p + 4))
        off = abs_p - src
        hit = rep_hit or 6 * ml >= 14 + _highbit(off) + 1
        return hit, rep_hit, src, ml, off

    anchor, r1, r2, r3 = st
    lm, ofvs, lits = [], [], bytearray()
    nseq = mlsum = repm = ext_rep = trash = 0
    limit = blen - 12
    p = 0
    while p < limit:
        abs_p = bs + p
        hit, rep_hit, src, ml, off = probe(abs_p, r1)
        m_pos = abs_p
        if hit and not rep_hit and ml < LAZY_ML_MAX and p + 1 < limit:
            hit2, rep2, src2, ml2, off2 = probe(abs_p + 1, r1)
            sc1 = 4 * ml - _highbit(off)
            sc2 = 4 * ml2 + 2 if rep2 else 4 * ml2 - _highbit(max(off2, 1))
            if hit2 and sc2 > sc1 + 1:
                m_pos, src, ml, off = abs_p + 1, src2, ml2, off2
        lstart = max(anchor, bs)
        if hit:
            max_back = min(m_pos - lstart, src - lo_win)
            back = 0
            while back < max_back and (
                data[base + m_pos - back - 1] == data[base + src - back - 1]
            ):
                back += 1
            m_pos, src, ml = m_pos - back, src - back, ml + back
        ll = m_pos - anchor
        ll_w = min(ll, m_pos - bs)
        if not (hit and nseq < SBd):
            p = p + 1 + (ll >> 8)
            continue
        # Repeat-offset value (RFC 8878 3.1.1.3.2.1.1, encoder side).
        isz = 1 if ll_w == 0 else 0
        o1, o2, o3 = (r2, r3, r1 - 1) if isz else (r1, r2, r3)
        ofv = 1 if off == o1 else 2 if off == o2 else 3 if off == o3 else off + 3
        ridx = ofv + isz
        b1, b2, b3 = repm & 1, (repm >> 1) & 1, (repm >> 2) & 1
        rbit = b2 if ridx == 2 else b3 if ridx == 3 else b1
        if ofv <= 3 and rbit == 0:
            ext_rep = 1
        moved = ofv > 3 or ridx != 1
        nr3 = r3 if ridx == 2 else (r2 if moved else r3)
        nr2 = r1 if moved else r2
        nr1 = off if moved else r1
        nb3 = b3 if ridx == 2 else (b2 if moved else b3)
        nb2 = b1 if moved else b2
        repm = 1 | (nb2 << 1) | (nb3 << 2)
        r1, r2, r3 = nr1, nr2, nr3
        lits += data[base + lstart:base + lstart + ll_w]
        trash += -ll_w & 3
        lm.append((ll_w, ml))
        ofvs.append(ofv)
        stop = min(m_pos + ml, bs + limit, m_pos + 1 + INS_CAP)
        for q in range(m_pos + 1, stop, 2):
            insert(q)
        p = m_pos + ml - bs
        anchor = m_pos + ml
        nseq += 1
        mlsum += ml

    lstart = max(anchor, bs)
    trail = max(bend - lstart, 0)
    lits += data[base + lstart:base + lstart + trail]
    trash += -trail & 3
    st[:] = [anchor, r1, r2, r3]

    stat = np.zeros(512, np.int64)
    for (ll_w, ml), ov in zip(lm, ofvs):
        llc, mlc, ofc = _code_of(consts, ll_w, ml, ov)
        stat[ST_LLHIST + llc] += 1
        stat[ST_MLHIST + mlc] += 1
        stat[ST_OFHIST + ofc] += 1
    stat[ST_LITHIST:ST_LITHIST + 256] += np.bincount(
        np.frombuffer(bytes(lits), np.uint8), minlength=256
    )
    stat[ST_TRASH] += trash
    stat[ST_NSEQ] = nseq
    stat[ST_MLSUM] = mlsum
    stat[ST_LITCNT] = len(lits)
    stat[ST_EXTREP] = ext_rep
    stat[ST_OVERFLOW] = 1 if nseq >= SBd else 0
    return lm, ofvs, lits, stat


def match_plain(consts, meta, words, BLK: int, SBd: int):
    """Plain version of the parse over Python ints, record by record.
    ``words`` is the flat LE word array of all frames (int32). Returns
    what ``match`` returns."""
    nrecp = meta.numel() // META_COLS
    mrows = meta.reshape(nrecp, META_COLS).tolist()
    consts_l = consts.reshape(-1).tolist()
    data = words.detach().cpu().contiguous().numpy().astype("<i4").tobytes()
    data += bytes(16)
    wide = wide_rows(BLK)
    lm = np.zeros((nrecp, SBd), np.int32)
    mlr = np.zeros((nrecp, SBd), np.int32)
    ofv = np.zeros((nrecp, SBd), np.int32)
    litw = np.zeros((nrecp, BLK), np.uint8)
    stat = np.zeros((nrecp, 512), np.int32)
    st = [0, 1, 4, 8]
    ht_pos = ht_word = None
    for r, m in enumerate(mrows):
        if m[M_FLAGS] & F_FRAME_START or ht_pos is None:
            st[:] = [0, 1, 4, 8]
            ht_pos = [-(1 << 30)] * (1 << HB)
            ht_word = [0] * (1 << HB)
        base = m[M_WOFF] * 4096 - m[M_BS]
        rl, ro, rlits, rstat = _parse_block(
            data, base, m, st, ht_pos, ht_word, SBd, consts_l
        )
        if rl:
            ll_w, ml = np.asarray(rl, np.int64).T
            lm[r, : len(rl)] = ll_w if wide else (ll_w << 16) | ml
            mlr[r, : len(rl)] = ml
        ofv[r, : len(ro)] = ro
        litw[r, : len(rlits)] = np.frombuffer(bytes(rlits), np.uint8)
        stat[r] = rstat
    dev = words.device
    out = (
        torch.from_numpy(lm).to(dev), torch.from_numpy(ofv).to(dev),
        torch.from_numpy(litw.view(np.int32).copy()).to(dev),
        torch.from_numpy(stat).to(dev),
    )
    return out + (torch.from_numpy(mlr).to(dev),) if wide else out


def smem_bytes(BLK: int) -> int:
    """Dynamic shared memory the CUDA kernel asks for per frame at block
    size ``BLK`` (the card's limit is 232,448 bytes): 197,056 at 32 KiB,
    and the same for every larger block, whose staging is windowed."""
    return kernel_fn("zk_match_smem_bytes", [I])(BLK)


def match(consts, meta, words, *, BLK: int, SBd: int, n_frames: int):
    """Parse every record. consts int32[512] (``fse_kernel.make_consts``),
    meta int32[NRECP, META_COLS], words int32[>= NRECP*BLK/4] (frame rows
    as LE words). Returns lm, ofv int32[NRECP, SBd], litw
    int32[NRECP, BLK/4] and stat int32[NRECP, 512], and for blocks above
    32 KiB (``wide_rows``) also ml int32[NRECP, SBd], with ll_written in
    ``lm``; rows are exact up to the counts in ``stat`` and zero past
    them. ``BLK`` is a multiple of 4 KiB, as the reference's kernel
    asserts."""
    assert BLK % 4096 == 0 and SBd % 8 == 0
    if words.device.type == "cpu":
        return match_plain(consts, meta, words, BLK, SBd)
    for name, t in (("consts", consts), ("meta", meta), ("words", words)):
        check_cuda(name, t)
    if words.data_ptr() % 16:
        raise ValueError("words must be 16-byte aligned (the kernel stages it with cp.async)")
    nrecp = meta.numel() // META_COLS
    dev = words.device
    lm = torch.zeros((nrecp, SBd), dtype=torch.int32, device=dev)
    ofv = torch.zeros((nrecp, SBd), dtype=torch.int32, device=dev)
    litw = torch.zeros((nrecp, BLK // 4), dtype=torch.int32, device=dev)
    stat = torch.zeros((nrecp, 512), dtype=torch.int32, device=dev)
    ml = torch.zeros((nrecp, SBd), dtype=torch.int32, device=dev) if wide_rows(BLK) else None
    fn = kernel_fn("zk_match_launch", [P, P, P, L, I, I, I, I, P, P, P, P, P, P])
    rc = fn(ptr(consts), ptr(meta), ptr(words), words.numel(), nrecp, n_frames,
            BLK, SBd, ptr(lm), None if ml is None else ptr(ml), ptr(ofv), ptr(litw),
            ptr(stat), stream())
    launches["match"] += 1
    check_rc("match", rc)
    return (lm, ofv, litw, stat) + ((ml,) if ml is not None else ())
