"""Vectorized (numpy) frame parse: the CPU port of the TPU match kernel.

The per-position Python loop in ``match.py`` is the bit-exact reference but
runs at well under 1 MiB/s. This module ports the parallel formulation from
``ops/match_tpu.py`` to numpy — hash-bucket candidates via argsort,
vectorized match lengths, pointer-jumping greedy reachability, and
same-offset chain merging — giving the pure-Python backend fast-level
throughput without JAX or the native runtime.

Used by ``compress_frame`` for levels <= 4; deeper levels keep the
chain/lazy reference matcher.
"""

from __future__ import annotations

import numpy as np

from .match import Sequence, encode_offset

MIN_MATCH = 4
MATCH_CAP = 64
HASH_LOG = 16


def _words_at(a64: np.ndarray, n: int) -> np.ndarray:
    """int64 array of 4-byte little-endian words at every byte offset."""
    w = a64[:n].copy()
    for k in range(1, 4):
        w[: n - k] += a64[k : n] << (8 * k)
    return w


def _hash6(a64: np.ndarray, n: int) -> np.ndarray:
    v = a64[:n].copy()
    for k in range(1, 6):
        v[: n - k] += a64[k : n] << (8 * k)
    # 64-bit multiplicative hash on the low 48 bits.
    v = (v * np.int64(0x9E3779B1)) ^ ((v >> np.int64(13)) * np.int64(0x85EBCA77))
    return (v & np.int64((1 << HASH_LOG) - 1)).astype(np.int64)


def _hash16(a64: np.ndarray, n: int) -> np.ndarray:
    w = _words_at(a64, n)
    v = w.copy()
    for k in (4, 8, 12):
        vv = np.zeros(n, np.int64)
        vv[: max(n - k, 0)] = w[k:n]
        v = (v ^ (vv * np.int64(0x9E3779B1 + k))) * np.int64(0x2545F491)
    return (v & np.int64((1 << HASH_LOG) - 1)).astype(np.int64)


def _nearest_earlier(h: np.ndarray, k: int):
    """k nearest earlier positions with the same hash (-1 if none)."""
    n = len(h)
    order = np.argsort(h, kind="stable")
    h_sorted = h[order]
    outs = []
    for j in range(1, k + 1):
        prev = np.full(n, -1, np.int64)
        prev[j:] = order[:-j]
        same = np.zeros(n, bool)
        same[j:] = h_sorted[j:] == h_sorted[:-j]
        cand_sorted = np.where(same, prev, -1)
        cand = np.empty(n, np.int64)
        cand[order] = cand_sorted
        outs.append(cand)
    return outs


def _match_lengths(words: np.ndarray, cand: np.ndarray, limit: np.ndarray, n: int):
    """Vectorized match length (cap MATCH_CAP) + continuation score.

    After the first word compare the alive set shrinks sharply, so later
    rounds operate on a compacted index subset."""
    mlen = np.zeros(n, np.int64)
    valid = cand >= 0
    idx = np.nonzero(valid)[0]
    if not len(idx):
        return mlen, np.zeros(n, np.int64)
    nm1 = n - 1
    pk = idx
    ck = cand[idx]
    diff = words[np.minimum(pk, nm1)] ^ words[np.minimum(ck, nm1)]
    full = diff == 0
    partial = (
        ((diff & 0xFF) == 0).astype(np.int64)
        + ((diff & 0xFFFF) == 0).astype(np.int64)
        + ((diff & 0xFFFFFF) == 0).astype(np.int64)
    )
    mlen[idx] = np.where(full, 4, partial)
    sub = np.nonzero(full)[0]
    idx = idx[sub]
    for k in range(4, MATCH_CAP, 4):
        if not len(idx):
            break
        pk = np.minimum(idx + k, nm1)
        ck = np.minimum(cand[idx] + k, nm1)
        diff = words[pk] ^ words[ck]
        full = diff == 0
        partial = (
            ((diff & 0xFF) == 0).astype(np.int64)
            + ((diff & 0xFFFF) == 0).astype(np.int64)
            + ((diff & 0xFFFFFF) == 0).astype(np.int64)
        )
        mlen[idx] += np.where(full, 4, partial)
        idx = idx[np.nonzero(full)[0]]
    # Continuation score only matters for capped matches (the tiebreak).
    cont = np.zeros(n, np.int64)
    if len(idx):
        for k in (MATCH_CAP, MATCH_CAP + 4, MATCH_CAP + 8, MATCH_CAP + 12):
            w1 = words[np.minimum(idx + k, nm1)]
            w2 = words[np.minimum(cand[idx] + k, nm1)]
            cont[idx] += (w1 == w2).astype(np.int64)
    return np.where(valid, np.minimum(mlen, limit), 0), cont


def parse_frame_numpy(data: bytes, block_size: int):
    """Parse a whole frame; returns (per-block list of (seqs, literals),
    final_reps). Sequences are block-contained; merging mirrors the TPU
    kernel."""
    n = len(data)
    a = np.frombuffer(data, np.uint8).astype(np.int64)
    words = _words_at(a, n)
    p = np.arange(n, dtype=np.int64)
    block_end = np.minimum((p // block_size + 1) * block_size, n)
    limit = np.minimum(block_end - p, MATCH_CAP)

    cands_s = _nearest_earlier(_hash6(a, n), 2)
    cands_l = _nearest_earlier(_hash16(a, n), 3)

    cand = cands_s[0]
    mlen, cont = _match_lengths(words, cand, limit, n)
    for extra in (cands_s[1], *cands_l):
        m2, c2 = _match_lengths(words, extra, limit, n)
        better = (m2 > mlen) | ((m2 == mlen) & (c2 > cont))
        cand = np.where(better, extra, cand)
        mlen = np.where(better, m2, mlen)
        cont = np.where(better, c2, cont)

    off = p - np.maximum(cand, 0)
    offbits = np.floor(np.log2(np.maximum(off, 1))).astype(np.int64) + 1
    good = (mlen >= MIN_MATCH) & (6 * mlen >= 14 + offbits) & (p < n - MIN_MATCH)

    # Pointer-jumping greedy reachability with a sink at n.
    step = np.where(good, np.maximum(mlen, 1), 1)
    f = np.empty(n + 1, np.int64)
    f[:n] = np.minimum(p + step, n)
    f[n] = n
    reach = np.zeros(n + 1, bool)
    reach[0] = True
    doublings = max((n - 1).bit_length(), 1)
    for _ in range(doublings):
        reach[f[reach.nonzero()[0]]] = True
        f = f[f]
    reach = reach[:n]

    is_seq = reach & good
    is_lit = reach & ~good

    seq_pos = np.nonzero(is_seq)[0]
    lit_pos = np.nonzero(is_lit)[0]
    lit_count_before = np.cumsum(is_lit) - is_lit  # exclusive

    mls = mlen[seq_pos]
    offs = off[seq_pos]
    lc_at = lit_count_before[seq_pos]
    lls = np.diff(np.concatenate([[0], lc_at + 0]))  # placeholder; fixed below
    lls = np.empty(len(seq_pos), np.int64)
    if len(seq_pos):
        lls[0] = lc_at[0]
        lls[1:] = lc_at[1:] - lc_at[:-1]

    # Merge same-offset contiguous continuations (not across block bounds).
    if len(seq_pos):
        prev_end = np.concatenate([[-1], seq_pos[:-1] + mls[:-1]])
        prev_off = np.concatenate([[-1], offs[:-1]])
        cont_m = (
            (lls == 0)
            & (offs == prev_off)
            & (seq_pos == prev_end)
            & (seq_pos % block_size != 0)
        )
        seg = np.cumsum(~cont_m) - 1
        nseg = seg[-1] + 1
        mls_m = np.zeros(nseg, np.int64)
        np.add.at(mls_m, seg, mls)
        first = np.zeros(nseg, bool)
        first_idx = np.searchsorted(seg, np.arange(nseg))
        lls_m = lls[first_idx]
        offs_m = offs[first_idx]
        pos_m = seq_pos[first_idx]
    else:
        mls_m = lls_m = offs_m = pos_m = np.zeros(0, np.int64)

    literals = bytes(np.frombuffer(data, np.uint8)[lit_pos]) if len(lit_pos) else b""

    # Split into per-block groups of raw (ll, ml, offset) + literal slices.
    # Repeat-offset encoding happens in the caller, which owns the
    # raw-block-fallback semantics.
    blocks = []
    n_blocks = -(-n // block_size) if n else 1
    lit_cursor = 0
    si = 0
    for b in range(n_blocks):
        b_start = b * block_size
        b_len = min(block_size, n - b_start)
        idx = []
        while si < len(pos_m) and pos_m[si] < b_start + b_len:
            idx.append(si)
            si += 1
        ml_sum = int(mls_m[idx].sum()) if idx else 0
        nlit_b = b_len - ml_sum
        lits_b = literals[lit_cursor : lit_cursor + nlit_b]
        lit_cursor += nlit_b
        triples = []
        for k, j in enumerate(idx):
            ll = int(lls_m[j])
            if k == 0:
                # First sequence's literal run may have started earlier.
                ll = int(pos_m[j]) - max(int(pos_m[j]) - ll, b_start)
            triples.append((ll, int(mls_m[j]), int(offs_m[j])))
        blocks.append((triples, lits_b))
    return blocks
