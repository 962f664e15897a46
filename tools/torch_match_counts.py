#!/usr/bin/env python3
"""Count what the level-1 parse does per frame, on the plain version's rules.

    python3 tools/torch_match_counts.py [--mib 10] [--frames 10]

Parses chip_smoke.py's 10 MiB dickens-like text (bench.py's corpus, seed
1898) in 1 MiB frames of 32 KiB blocks with a counting copy of
``zeekstd_tpu_torch/ops/match_kernel.py::_parse_block`` (same decisions;
the table keeps positions only, whose words are read back from the bytes)
and prints the mean per frame of: sequences, probes (primary and lazy),
misses, lazy switches, interior inserts, forward-extension bytes past the
first 4 and backward-extension bytes, how many matches and lazy
candidates run past 32 bytes (the CUDA kernel's one-round window), how
many sequences need a backward round, the slot collisions the warp
kernel resolves (a lazy probe in the primary's slot, interior inserts
sharing a slot), and the miss runs before each sequence. The sequence
count of every record is checked against ``match_plain``'s stat rows.
Imports no JAX.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (build_corpus)
from zeekstd_tpu_torch.ops import fse_kernel as fk  # noqa: E402
from zeekstd_tpu_torch.ops import match_kernel as mk  # noqa: E402

MIB = 1 << 20
BLK = 32 << 10


def _highbit(x):
    return max(x, 1).bit_length() - 1


def count_frame(data: bytes, c: dict, nseq_out: list):
    """The plain parse of one frame (records of BLK bytes), counting."""
    n = len(data)
    buf = data + bytes(64)
    shift = 32 - mk.HB
    pos_t = [-(1 << 30)] * (1 << mk.HB)

    def w32(q):
        return int.from_bytes(buf[q:q + 4], "little") if q >= 0 else 0

    def slot(q):
        return ((((w32(q) * mk._M1) ^ ((w32(q + 4) & 0xFFFF) * mk._M2)) & mk._MASK32) >> shift)

    def extend(a, b, maxl):
        k = 0
        while k < maxl and buf[a + k] == buf[b + k]:
            k += 1
        return k

    anchor, r1, r2, r3 = 0, 1, 4, 8
    for bs in range(0, n, BLK):
        blen = min(BLK, n - bs)
        bend = bs + blen
        lo_win = max(bend - (1 << mk.WIN_LOG), 0)
        limit = blen - 12
        nseq, p, run = 0, 0, 0

        def probe(abs_p, r1):
            c["probes"] += 1
            w = w32(abs_p)
            h = slot(abs_p)
            cand = pos_t[h]
            pos_t[h] = abs_p
            rsrc = abs_p - r1
            rep = rsrc >= lo_win and w32(rsrc) == w
            hok = cand >= lo_win and w32(cand) == w
            if not (rep or hok):
                return False, False, abs_p, 4, 0, h
            src = rsrc if rep else cand
            ext = extend(abs_p + 4, src + 4, bend - (abs_p + 4))
            c["fwd_bytes"] += ext
            ml = 4 + ext
            off = abs_p - src
            return rep or 6 * ml >= 15 + _highbit(off), rep, src, ml, off, h

        while p < limit:
            abs_p = bs + p
            c["primary"] += 1
            hit, rep, src, ml, off, h = probe(abs_p, r1)
            m_pos = abs_p
            if hit and ml >= 32:
                c["long_primary"] += 1
            if hit and not rep and ml < mk.LAZY_ML_MAX and p + 1 < limit:
                c["lazy"] += 1
                hit2, rep2, src2, ml2, off2, h2 = probe(abs_p + 1, r1)
                c["lazy_same_slot"] += h2 == h
                c["long_lazy"] += hit2 and ml2 >= 32
                sc1 = 4 * ml - _highbit(off)
                sc2 = 4 * ml2 + 2 if rep2 else 4 * ml2 - _highbit(max(off2, 1))
                if hit2 and sc2 > sc1 + 1:
                    c["lazy_switch"] += 1
                    m_pos, src, ml, off = abs_p + 1, src2, ml2, off2
            lstart = max(anchor, bs)
            if hit:
                max_back = min(m_pos - lstart, src - lo_win)
                c["back_rounds"] += max_back > 0
                back = 0
                while back < max_back and buf[m_pos - back - 1] == buf[src - back - 1]:
                    back += 1
                c["back_bytes"] += back
                m_pos, src, ml = m_pos - back, src - back, ml + back
            ll = m_pos - anchor
            ll_w = min(ll, m_pos - bs)
            if not (hit and nseq < BLK // 4):
                c["misses"] += 1
                run += 1
                p = p + 1 + (ll >> 8)
                continue
            isz = 1 if ll_w == 0 else 0
            o1, o2, o3 = (r2, r3, r1 - 1) if isz else (r1, r2, r3)
            ofv = 1 if off == o1 else 2 if off == o2 else 3 if off == o3 else off + 3
            if ofv > 3 or ofv + isz != 1:
                r1, r2, r3 = off, r1, (r3 if ofv + isz == 2 else r2)
            stop = min(m_pos + ml, bs + limit, m_pos + 1 + mk.INS_CAP)
            slots = [slot(q) for q in range(m_pos + 1, stop, 2)]
            for q, hq in zip(range(m_pos + 1, stop, 2), slots):
                pos_t[hq] = q
            c["inserts"] += len(slots)
            c["insert_collisions"] += len(set(slots)) < len(slots)
            c["runs"].append(run)
            run = 0
            p = m_pos + ml - bs
            anchor = m_pos + ml
            nseq += 1
        nseq_out.append(nseq)
        c["sequences"] += nseq
    return c


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mib", type=int, default=10)
    ap.add_argument("--frames", type=int, default=10, help="frames to count")
    args = ap.parse_args()
    data = chip_smoke.build_corpus(args.mib * MIB)
    frames = [data[i:i + MIB] for i in range(0, len(data), MIB)][: args.frames]
    keys = ("sequences", "probes", "primary", "lazy", "misses", "lazy_switch", "inserts",
            "fwd_bytes", "back_bytes", "long_primary", "long_lazy", "back_rounds",
            "lazy_same_slot", "insert_collisions")
    c = {k: 0 for k in keys}
    c["runs"] = []
    nseq = []
    for f in frames:
        count_frame(f, c, nseq)
    # The counting copy must parse as the plain version does.
    F = len(frames)
    rows = np.zeros((F, MIB), np.uint8)
    lengths = np.zeros(F, np.int32)
    for i, f in enumerate(frames):
        rows[i, : len(f)] = np.frombuffer(f, np.uint8)
        lengths[i] = len(f)
    B = MIB // BLK
    meta = mk.build_records(F, B, BLK, MIB, lengths, n_pad=mk.bucket_nrecp(F * B))
    words = np.zeros(meta.shape[0] * BLK // 4, np.int32)
    words[: rows.size // 4] = rows.reshape(-1).view(np.int32)
    stat = mk.match_plain(torch.from_numpy(fk.make_consts()), torch.from_numpy(meta),
                          torch.from_numpy(words), BLK, BLK // 4)[3]
    assert stat[: F * B, mk.ST_NSEQ].tolist() == nseq, "counting copy diverged"
    runs = np.asarray(c.pop("runs"))
    out = {k: v / F for k, v in c.items()}
    out.update(frames=F, mean_miss_run=float(runs.mean()),
               share_no_miss=float((runs == 0).mean()), share_run_le_8=float((runs <= 8).mean()))
    for k, v in out.items():
        print(f"{k:18s} {v:.4f}" if isinstance(v, float) else f"{k:18s} {v}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
