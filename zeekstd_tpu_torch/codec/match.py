"""LZ77 match finding: greedy/lazy hash-chain search with repeat-offset
awareness.

Replaces libzstd's match finders for the level range the reference exposes
(1..19, reference: cli/src/args.rs:191-193). Strategy is level-scaled chain
depth + lazy evaluation, tuned so that compressed size at a given level is
at or below libzstd's at the same level (BASELINE.md target) — the format,
not the search heuristics, is what fixes compatibility.

The TPU-parallel counterpart of this module lives in
``zeekstd_tpu.ops.match_tpu`` (hash-bucket candidate gathering on device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MIN_MATCH = 4
HASH_LOG = 17


@dataclass
class Sequence:
    ll: int
    ml: int
    offset_value: int  # >3: offset+3; 1..3: repeat codes


@dataclass
class MatchParams:
    depth: int  # hash-chain search depth
    lazy: int  # 0 = greedy, 1 = one-step lazy, 2 = two-step
    hash_bytes: int = 4  # bytes hashed per table entry (longer = fewer, longer matches)


def params_for_level(level: int) -> MatchParams:
    if level <= 1:
        return MatchParams(depth=2, lazy=0, hash_bytes=6)
    if level <= 2:
        return MatchParams(depth=4, lazy=0, hash_bytes=6)
    if level <= 3:
        return MatchParams(depth=8, lazy=0, hash_bytes=6)
    if level <= 4:
        return MatchParams(depth=16, lazy=0, hash_bytes=5)
    if level <= 6:
        return MatchParams(depth=32, lazy=1, hash_bytes=5)
    if level <= 9:
        return MatchParams(depth=64, lazy=1, hash_bytes=5)
    if level <= 12:
        return MatchParams(depth=128, lazy=2, hash_bytes=4)
    if level <= 16:
        return MatchParams(depth=256, lazy=2, hash_bytes=4)
    return MatchParams(depth=512, lazy=2, hash_bytes=4)


class MatchState:
    """Hash-chain state persisting across blocks of one frame."""

    def __init__(self, window_len: int):
        self.head = np.full(1 << HASH_LOG, -1, dtype=np.int64)
        # Most-recent position per 4-byte hash: a single near probe that
        # finds the 4-5 byte matches a 5/6-byte chain hash never buckets
        # together (numeric/structured data; the price gate filters far
        # short matches). Only maintained when hash_bytes > 4.
        self.head4 = np.full(1 << HASH_LOG, -1, dtype=np.int64)
        self.chain = np.full(max(window_len, 1024), -1, dtype=np.int64)
        self.chain4 = np.full(max(window_len, 1024), -1, dtype=np.int64)
        self.filled_to = 0

    def ensure_capacity(self, window_len: int) -> None:
        if window_len > len(self.chain):
            new = np.full(max(window_len, 2 * len(self.chain)), -1, dtype=np.int64)
            new[: len(self.chain)] = self.chain
            self.chain = new
            new4 = np.full(len(self.chain), -1, dtype=np.int64)
            new4[: len(self.chain4)] = self.chain4
            self.chain4 = new4


def _hash4(v: int) -> int:
    return ((v * 2654435761) & 0xFFFFFFFF) >> (32 - HASH_LOG)


_HASH_PRIME64 = 0xCF1BBCDCB7A56463


def _hash_n(data, p: int, nbytes: int) -> int:
    v = int.from_bytes(data[p : p + nbytes], "little")
    return ((v * _HASH_PRIME64) & 0xFFFFFFFFFFFFFFFF) >> (64 - HASH_LOG)


def hash_positions(data: bytes, start: int, end: int, nbytes: int) -> np.ndarray:
    """Vectorized hash of every position in [start, end): the host-side twin
    of the TPU hashing kernel in ``zeekstd_tpu.ops``."""
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.uint64)
    v = np.zeros(end - start, dtype=np.uint64)
    for k in range(nbytes):
        v |= arr[start + k : end + k] << np.uint64(8 * k)
    return ((v * np.uint64(_HASH_PRIME64)) >> np.uint64(64 - HASH_LOG)).astype(np.int64)


def bulk_insert(state: "MatchState", data: bytes, start: int, end: int, nbytes: int) -> None:
    """Insert positions [start, end) into the hash chains in order, as if
    ``insert`` had been called per position (vectorized grouping by hash)."""
    end = min(end, len(data) - nbytes + 1)
    if end <= start:
        return
    hs = hash_positions(data, start, end, nbytes)
    pos = np.arange(start, end, dtype=np.int64)
    order = np.argsort(hs, kind="stable")
    hs_sorted = hs[order]
    pos_sorted = pos[order]
    same_h = np.empty(len(order), dtype=bool)
    same_h[0] = False
    same_h[1:] = hs_sorted[1:] == hs_sorted[:-1]
    prev = np.where(same_h, np.concatenate(([0], pos_sorted[:-1])), -1)
    # Chain to the previous same-hash position; group heads link to the
    # pre-existing chain head for that hash.
    group_start = ~same_h
    prev[group_start] = state.head[hs_sorted[group_start]]
    state.chain[pos_sorted] = prev
    # Heads become the last (largest) position of each group.
    last_of_group = np.empty(len(order), dtype=bool)
    last_of_group[:-1] = hs_sorted[1:] != hs_sorted[:-1]
    last_of_group[-1] = True
    state.head[hs_sorted[last_of_group]] = pos_sorted[last_of_group]
    if nbytes > 4:
        h4 = hash_positions(data, start, end, 4)
        pos4 = np.arange(start, end, dtype=np.int64)
        order4 = np.argsort(h4, kind="stable")
        h4s = h4[order4]
        p4s = pos4[order4]
        same4 = np.empty(len(order4), dtype=bool)
        same4[0] = False
        same4[1:] = h4s[1:] == h4s[:-1]
        prev4 = np.where(same4, np.concatenate(([0], p4s[:-1])), -1)
        group_start4 = ~same4
        prev4[group_start4] = state.head4[h4s[group_start4]]
        state.chain4[p4s] = prev4
        last4 = np.empty(len(order4), dtype=bool)
        last4[:-1] = h4s[1:] != h4s[:-1]
        last4[-1] = True
        state.head4[h4s[last4]] = p4s[last4]
    state.filled_to = end


LDM_LOG = 20
LDM_MIN = 32
_LDM_PRIMES = (
    0x9E3779B185EBCA87,
    0xC2B2AE3D27D4EB4F,
    0x165667B19E3779F9,
    0x27D4EB2F165667C5,
)
_LDM_MIX = 0x2545F4914F6CDD1D
_M64 = 0xFFFFFFFFFFFFFFFF


class LdmState:
    """Long-distance matcher: a 32-byte-window hash table over the whole
    window (prefix + data). Keeps the first AND the most recent position
    per bucket — the first reaches across an arbitrarily large patch
    prefix even after nearer data has flooded the ordinary chains
    (reference behavior: libzstd's EnableLongDistanceMatching, driven by
    the CLI patch mode, cli/src/compress.rs:31-37)."""

    def __init__(self):
        self.first = np.full(1 << LDM_LOG, -1, dtype=np.int64)
        self.last = np.full(1 << LDM_LOG, -1, dtype=np.int64)
        self.filled_to = 0


def ldm_hash_positions(data, start: int, end: int) -> np.ndarray:
    """Vectorized 32-byte-window hash for every position in [start, end)."""
    arr = np.frombuffer(data, dtype=np.uint8).astype(np.uint64)
    h = np.zeros(end - start, dtype=np.uint64)
    for j in range(4):
        v = np.zeros(end - start, dtype=np.uint64)
        for k in range(8):
            v |= arr[start + 8 * j + k : end + 8 * j + k] << np.uint64(8 * k)
        h = (h ^ (v * np.uint64(_LDM_PRIMES[j]))) * np.uint64(_LDM_MIX)
    return (h >> np.uint64(64 - LDM_LOG)).astype(np.int64)


def _ldm_hash_one(data, p: int) -> int:
    h = 0
    for j in range(4):
        v = int.from_bytes(data[p + 8 * j : p + 8 * j + 8], "little")
        h = ((h ^ (v * _LDM_PRIMES[j])) * _LDM_MIX) & _M64
    return h >> (64 - LDM_LOG)


def ldm_bulk_insert(ldm: LdmState, data, start: int, end: int) -> None:
    """Insert positions [start, end) into the LDM tables (vectorized)."""
    end = min(end, len(data) - 32 + 1)
    if end <= start:
        return
    hs = ldm_hash_positions(data, start, end)
    pos = np.arange(start, end, dtype=np.int64)
    # Most recent occurrence: duplicate fancy indices keep the last write.
    ldm.last[hs] = pos
    # First occurrence: only fill still-empty buckets, earliest in batch.
    uniq, first_idx = np.unique(hs, return_index=True)
    cand = pos[first_idx]
    unset = ldm.first[uniq] < 0
    ldm.first[uniq[unset]] = cand[unset]
    ldm.filled_to = max(ldm.filled_to, end)


def encode_offset(offset: int, ll: int, reps):
    """Map an actual offset to its offset_value given the repeat history,
    mirroring the decoder's rules (RFC 8878 §3.1.1.3.2.1.1); returns
    (offset_value, new_reps)."""
    r1, r2, r3 = reps
    if ll != 0:
        if offset == r1:
            return 1, (r1, r2, r3)
        if offset == r2:
            return 2, (r2, r1, r3)
        if offset == r3:
            return 3, (r3, r1, r2)
    else:
        if offset == r2:
            return 1, (r2, r1, r3)  # ll==0 shifts the repeat index by one
        if offset == r3:
            return 2, (r3, r1, r2)
        if offset == r1 - 1 and offset != 0:
            return 3, (offset, r1, r2)
    return offset + 3, (offset, r1, r2)


def find_sequences(window: bytes, start: int, end: int, params: MatchParams, state: MatchState, reps, max_dist: int = 1 << 31, ldm: LdmState | None = None):
    """Greedy/lazy parse of window[start:end] (history = window[:start]).

    Returns (sequences, literals, new_reps). ``reps`` mirrors the decoder's
    repeat-offset state entering the block. With ``ldm``, long-distance
    candidates from the 32-byte-window table compete with the chain hits.
    """
    seqs: list[Sequence] = []
    literals = bytearray()
    head = state.head
    chain = state.chain
    depth = params.depth
    lazy = params.lazy

    data = window
    n = end
    anchor = start
    pos = start
    cur_reps = reps
    hb = params.hash_bytes

    def match_len_at(a: int, b: int, limit: int) -> int:
        # Length of common prefix of data[a:], data[b:], capped at limit.
        l = 0
        while l + 8 <= limit and data[a + l : a + l + 8] == data[b + l : b + l + 8]:
            l += 8
        while l < limit and data[a + l] == data[b + l]:
            l += 1
        return l

    head4 = state.head4
    chain4 = state.chain4
    probe4 = hb > 4

    def insert(p: int) -> None:
        h = _hash_n(data, p, hb)
        chain[p] = head[h]
        head[h] = p
        if probe4:
            h4 = _hash_n(data, p, 4)
            chain4[p] = head4[h4]
            head4[h4] = p

    def best_match(p: int):
        """Best (length, offset) at p, or (0, 0)."""
        limit = n - p
        if limit < MIN_MATCH:
            return 0, 0
        best_len, best_off = 0, 0
        best_score = -1000
        # Repeat-offset probe first: scored with no offset cost (mirrors
        # the native matcher) so profitable repeat chains survive slightly
        # longer far candidates on structured data.
        r1 = cur_reps[0]
        if p - r1 >= 0 and data[p : p + 4] == data[p - r1 : p - r1 + 4]:
            l = match_len_at(p, p - r1, limit)
            best_len, best_off = l, r1
            best_score = 4 * l + 2
        h = _hash_n(data, p, hb)
        cand = head[h]
        tries = depth
        lo = p - max_dist
        while cand >= 0 and tries > 0:
            c = int(cand)
            if c >= p:  # self or future position (already inserted)
                cand = chain[c]
                continue
            if c < lo:  # beyond the window: the chain only gets older
                break
            if data[p : p + 4] == data[c : c + 4]:
                l = match_len_at(p, c, limit)
                sc = 4 * l - (p - c).bit_length()
                if sc > best_score:
                    best_len, best_off, best_score = l, p - c, sc
            cand = chain[c]
            tries -= 1
        if probe4:
            c4 = int(chain4[p])  # previous same-4-byte-hash position
            if 0 <= c4 < p and p - c4 <= max_dist and data[p : p + 4] == data[c4 : c4 + 4]:
                l = match_len_at(p, c4, limit)
                sc = 4 * l - (p - c4).bit_length()
                if sc > best_score:
                    best_len, best_off, best_score = l, p - c4, sc
        if ldm is not None and best_len < 64 and limit >= LDM_MIN:
            hl = _ldm_hash_one(data, p)
            for c in (int(ldm.first[hl]), int(ldm.last[hl])):
                if 0 <= c < p and p - c <= max_dist and data[p : p + 8] == data[c : c + 8]:
                    l = match_len_at(p, c, limit)
                    if l >= LDM_MIN and l > best_len:
                        best_len, best_off = l, p - c
                        best_score = 4 * l - (p - c).bit_length()
        if best_len < MIN_MATCH:
            return 0, 0
        # Cost gate: a short far match can cost more than its literals
        # (~6 bits/literal vs ~12 bits + offset bits per sequence).
        if best_off != cur_reps[0] and 6 * best_len < 14 + best_off.bit_length():
            return 0, 0
        return best_len, best_off

    insert_limit = n - hb + 1
    while pos < n - MIN_MATCH + 1:
        if pos >= insert_limit:
            pos += 1
            continue
        insert(pos)
        mlen, moff = best_match(pos)
        if mlen == 0:
            pos += 1
            continue

        # Lazy evaluation: the later match wins only on a cost-aware gain
        # comparison (rep matches keep the no-offset-cost bonus) — a pure
        # longer-wins rule breaks repeat-offset chains on digit-periodic
        # data (the seq-20000 regression).
        steps = lazy
        while steps > 0 and pos + 1 < insert_limit:
            insert(pos + 1)
            nlen, noff = best_match(pos + 1)
            sc1 = (4 * mlen + 2 if moff == cur_reps[0]
                   else 4 * mlen - moff.bit_length())
            sc2 = (4 * nlen + 2 if noff == cur_reps[0]
                   else 4 * nlen - noff.bit_length())
            if nlen >= 4 and sc2 > sc1 + 1:
                pos += 1
                mlen, moff = nlen, noff
                steps -= 1
            else:
                break

        # Extend backwards into pending literals.
        while pos > anchor and pos - moff > 0 and data[pos - 1] == data[pos - moff - 1]:
            pos -= 1
            mlen += 1

        ll = pos - anchor
        literals += data[anchor:pos]
        offset_value, cur_reps = encode_offset(moff, ll, cur_reps)
        seqs.append(Sequence(ll, mlen, offset_value))

        # Index interior positions sparsely to bound cost.
        stride = 1 if mlen < 64 else 2
        p = pos + 1
        stop = min(pos + mlen, insert_limit)
        while p < stop:
            insert(p)
            p += stride
        pos += mlen
        anchor = pos

    literals += data[anchor:n]
    return seqs, bytes(literals), cur_reps
