"""LZ77 parse for levels 2-19 and prefix mode, fully parallel.

Port of ``zeekstd_tpu/ops/match_tpu.py`` in plain PyTorch, with the frame
axis as a batch dimension (the reference ``vmap``s one frame):

1. candidates: a stable argsort of each row by hash makes the j-th
   previous element of a hash bucket the j-th nearest earlier occurrence;
2. match lengths: word strips gathered once in sorted order, compared
   with themselves shifted by j rows;
3. greedy commit: the positions the serial greedy parse would visit, by
   the chunked reachability kernels (``reach_kernel.py``) where the
   reference's chunked route applies, else by pointer doubling;
4. stream compaction of literals and sequences by cumulative sums;
5. merging of capped matches that continue at the next anchor.

The reference's 32-bit wrapping multiplies are computed on int64 values
in [0, 2^32) and masked; scatters with ``mode="drop"`` write to one sink
slot past the end, which is sliced off.
"""

from __future__ import annotations

import torch

from .reach_kernel import CHUNK, SMAX, reachability_chunked

HASH_LOG = 16
MIN_MATCH = 4
MATCH_CAP = 32
CONT_WORDS = 2  # words compared past the cap for the merge tie-break

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2^32 for int64 x in [0, 2^32) and a constant c < 2^32,
    without leaving int64."""
    lo = x * (c & 0xFFFF)
    hi = (x * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & _M32


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2^32) -> int32 with the same bits."""
    return ((x ^ (1 << 31)) - (1 << 31)).to(torch.int32)


def bit_length(x: torch.Tensor) -> torch.Tensor:
    """Exact bit length of non-negative int64 values below 2^32 (the
    reference's ``32 - clz``)."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        n = n + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return n + (x > 0).to(x.dtype)


def _shift_left(a: torch.Tensor, k: int, fill=0) -> torch.Tensor:
    """Row i takes a[i + k]; the last k entries take ``fill``."""
    if k == 0:
        return a
    pad = torch.full((a.shape[0], k), fill, dtype=a.dtype, device=a.device)
    return torch.cat([a[:, k:], pad], dim=1)


def _words_u32(data_u8: torch.Tensor) -> torch.Tensor:
    """LE 32-bit word at every byte offset, as int64 in [0, 2^32)."""
    a = data_u8.to(torch.int64)
    return (a | (_shift_left(a, 1) << 8) | (_shift_left(a, 2) << 16)
            | (_shift_left(a, 3) << 24))


def precompute_words(data_u8: torch.Tensor) -> torch.Tensor:
    """int32 word at every byte offset (zero-padded at the tail)."""
    return _to_i32(_words_u32(data_u8))


def hash_positions_tpu(data_u8: torch.Tensor) -> torch.Tensor:
    """Per-position hash of 6 bytes."""
    w = _words_u32(data_u8)
    a = data_u8.to(torch.int64)
    hi = _shift_left(a, 4) | (_shift_left(a, 5) << 8)
    h = _mul32(w, 0x9E3779B1) ^ _mul32(hi, 0x85EBCA77)
    return (h >> (32 - HASH_LOG)).to(torch.int32)


def hash_positions_4(data_u8: torch.Tensor) -> torch.Tensor:
    """Per-position hash of exactly 4 bytes."""
    h = _mul32(_words_u32(data_u8), 2654435761)
    return (h >> (32 - HASH_LOG)).to(torch.int32)


def hash_positions_long(data_u8: torch.Tensor, span: int = 16) -> torch.Tensor:
    """Per-position hash of ``span`` bytes (the long table)."""
    words = _words_u32(data_u8)
    h = torch.zeros_like(words)
    primes = (0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F)
    for k in range(0, span, 4):
        wk = _shift_left(words, min(k, words.shape[1]))
        h = _mul32(h ^ _mul32(wk, primes[(k // 4) % 4]), 0x2545F491)
    return (h >> (32 - HASH_LOG)).to(torch.int32)


def _shift_down(a: torch.Tensor, j: int, fill) -> torch.Tensor:
    """Row i takes a[i - j]; the first j entries take ``fill``."""
    pad = torch.full((a.shape[0], j), fill, dtype=a.dtype, device=a.device)
    return torch.cat([pad, a[:, :-j]], dim=1)


def sorted_hash_matches(data_u8, h, depths: int, block_size: int, n_valid,
                        cap: int = MATCH_CAP, cont_words: int = CONT_WORDS):
    """Best candidate among the ``depths`` nearest earlier same-hash
    positions, with match lengths measured up to ``cap`` (plus extension
    words). ``data_u8`` uint8[F, n], ``h`` int32[F, n], ``n_valid``
    int64[F]. Returns (cand, mlen, cont), int32[F, n] in position space."""
    F, n = data_u8.shape
    dev = data_u8.device
    words = precompute_words(data_u8)
    order = torch.argsort(h, dim=1, stable=True)
    order32 = order.to(torch.int32)

    if cont_words == 1:
        ext_ks = [cap // 4, cap // 4 + 1]
        far_ks = [cap // 4 + 7]
    else:
        ext_ks = []
        far_ks = [cap // 4 + i for i in range(cont_words)]
    strip_ks = list(range(cap // 4)) + ext_ks + far_ks

    # One row gather for all strips and the sorted hashes.
    cols = []
    for k in strip_ks:
        if k == 0:
            cols.append(words)
        else:
            kk = min(4 * k, n)
            fill = words[:, n - 1 : n].expand(F, kk)
            cols.append(torch.cat([words[:, kk:], fill], dim=1))
    cols.append(h)
    K1 = len(cols)
    sm = torch.gather(torch.stack(cols, dim=2), 1, order[:, :, None].expand(F, n, K1))
    strips = [sm[:, :, i] for i in range(len(strip_ks))]
    h_s = sm[:, :, len(strip_ks)]

    # Per-row (sorted order) match-length limit at the owning position.
    block_end = (order32 // block_size + 1) * block_size
    mlen_max = cap + 4 * len(ext_ks)
    limit = torch.clamp(torch.minimum(block_end, n_valid[:, None].to(torch.int32)) - order32,
                        max=mlen_max)

    best_cand = torch.full((F, n), -1, dtype=torch.int32, device=dev)
    best_mlen = torch.zeros((F, n), dtype=torch.int32, device=dev)
    best_cont = torch.zeros((F, n), dtype=torch.int32, device=dev)
    for j in range(1, depths + 1):
        same = torch.cat([torch.zeros((F, j), dtype=torch.bool, device=dev),
                          h_s[:, j:] == h_s[:, :-j]], dim=1)
        cand = torch.where(same, _shift_down(order32, j, 0), -1)
        mlen = torch.zeros((F, n), dtype=torch.int32, device=dev)
        alive = same
        for k in range(cap // 4):
            diff = strips[k] ^ _shift_down(strips[k], j, -1)
            full = alive & (diff == 0)
            partial = (((diff & 0xFF) == 0).to(torch.int32)
                       + ((diff & 0xFFFF) == 0).to(torch.int32)
                       + ((diff & 0xFFFFFF) == 0).to(torch.int32))
            mlen = mlen + torch.where(full, 4, torch.where(alive, partial, 0))
            alive = full
        # Word-granular extension past the cap, then the far-probe
        # continuation tie-break.
        run = alive.to(torch.int32)
        si = cap // 4
        for _ in ext_ks:
            run = run * (strips[si] == _shift_down(strips[si], j, -1)).to(torch.int32)
            mlen = mlen + 4 * run
            si += 1
        cont = torch.zeros((F, n), dtype=torch.int32, device=dev)
        for _ in far_ks:
            run = run * (strips[si] == _shift_down(strips[si], j, -1)).to(torch.int32)
            cont = cont + run
            si += 1
        mlen = torch.where(same, torch.minimum(mlen, limit), 0)
        cont = torch.where(same, cont, 0)
        better = (mlen > best_mlen) | ((mlen == best_mlen) & (cont > best_cont))
        best_cand = torch.where(better, cand, best_cand)
        best_mlen = torch.where(better, mlen, best_mlen)
        best_cont = torch.where(better, cont, best_cont)

    # Back to position space: one packed scatter when the fields fit.
    if n <= (1 << 22) and mlen_max <= 63 and len(far_ks) <= 3:
        packed = ((best_cand + 1) << 8) | (best_mlen << 2) | torch.clamp(best_cont, max=3)
        out = torch.zeros((F, n), dtype=torch.int32, device=dev).scatter(1, order, packed)
        return (out >> 8) - 1, (out >> 2) & 63, out & 3
    out_c = torch.full((F, n), -1, dtype=torch.int32, device=dev).scatter(1, order, best_cand)
    out_m = torch.zeros((F, n), dtype=torch.int32, device=dev).scatter(1, order, best_mlen)
    out_k = torch.zeros((F, n), dtype=torch.int32, device=dev).scatter(1, order, best_cont)
    return out_c, out_m, out_k


def greedy_reachability(step, n: int, block_size: int | None = None,
                        step_max: int | None = None):
    """Anchor mask bool[F, n]: the positions the serial greedy parse
    visits. Steps never cross a multiple of ``block_size``, so every block
    start is an anchor and blocks are independent.

    The reference's route rule, less its backend term and its
    ``ZEEKSTD_TPU_REACH`` term (that variable changes no byte, so the port
    ignores it): the chunked kernels when ``step_max`` <= SMAX and the
    shapes tile, else pointer doubling with an explicit sink node (a match
    ending exactly at the end does not mark the final byte)."""
    F = step.shape[0]
    dev = step.device
    eff_block = min(block_size, n) if block_size else n
    if (
        step_max is not None
        and step_max <= SMAX
        and n % CHUNK == 0
        and eff_block % CHUNK == 0
        and n % eff_block == 0
        and (eff_block // CHUNK) & (eff_block // CHUNK - 1) == 0
        and (n // CHUNK) % 8 == 0
    ):
        return reachability_chunked(step, n, eff_block)
    if block_size is None or block_size >= n:
        rows, width, s = F, n, step.long()
    else:
        nb = -(-n // block_size)
        pad = nb * block_size - n
        if pad:
            step = torch.cat([step, torch.ones((F, pad), dtype=step.dtype, device=dev)], dim=1)
        rows, width, s = F * nb, block_size, step.long().reshape(F * nb, block_size)
    p = torch.arange(width, dtype=torch.int64, device=dev)
    f = torch.cat([torch.clamp(p + s, max=width),
                   torch.full((rows, 1), width, dtype=torch.int64, device=dev)], dim=1)
    reach = torch.zeros_like(f)
    reach[:, 0] = 1
    for _ in range(max((width - 1).bit_length(), 1)):
        reach = reach.scatter_reduce(1, f, reach, "amax", include_self=True)
        f = torch.gather(f, 1, f)
    return reach[:, :width].reshape(F, -1)[:, :n].bool()


def level_depths(level: int):
    """(short-chain depth, long-chain depth) per level."""
    if level <= 1:
        return 1, 0
    if level <= 4:
        return 2, 3
    return 4, 6


def level_cap(level: int):
    """(match-length cap, continuation words) per level."""
    if level <= 4:
        return 16, 1
    return MATCH_CAP, CONT_WORDS


def _pick(better, a, b):
    return tuple(torch.where(better, x, y) for x, y in zip(a, b))


def parse_frame(data_u8, block_size: int, seq_bound: int, n_valid=None, level: int = 3,
                start: int = 0):
    """Parallel parse of every frame row of ``data_u8`` (uint8[F, n]).

    Returns (lls, mls, offs int32[F, seq_bound]; n_seq int32[F]; literals
    uint8[F, n]; n_lit int32[F]; n_seq_raw int32[F]), as the reference's
    ``parse_frame`` returns them per frame: offsets are actual distances,
    capped continuations are merged, and n_seq_raw > seq_bound means
    sequences were dropped (the caller re-encodes such a frame).
    ``n_valid``: int64[F] valid bytes per row (default n). ``start`` (a
    multiple of block_size) marks a prefix region data_u8[:, :start]
    whose positions may source matches but emit nothing."""
    F, n = data_u8.shape
    dev = data_u8.device
    if n_valid is None:
        n_valid = torch.full((F,), n, dtype=torch.int64, device=dev)
    n_valid = n_valid.to(torch.int64)
    assert start % block_size == 0, "prefix must be block-aligned"
    p = torch.arange(n, dtype=torch.int64, device=dev)[None, :]
    nv = n_valid[:, None]

    ds, dl = level_depths(level)
    cap, cw = level_cap(level)
    best = sorted_hash_matches(data_u8, hash_positions_tpu(data_u8), ds, block_size,
                               n_valid, cap=cap, cont_words=cw)
    if dl > 0:
        other = sorted_hash_matches(data_u8, hash_positions_long(data_u8), dl, block_size,
                                    n_valid, cap=cap, cont_words=cw)
        better = (other[1] > best[1]) | ((other[1] == best[1]) & (other[2] > best[2]))
        best = _pick(better, other, best)
    if level >= 2:
        other = sorted_hash_matches(data_u8, hash_positions_4(data_u8), 1, block_size,
                                    n_valid, cap=cap, cont_words=cw)
        better = (other[1] > best[1]) | ((other[1] == best[1]) & (other[2] > best[2]))
        best = _pick(better, other, best)
    cand, mlen = best[0].long(), best[1].long()
    off = p - torch.clamp(cand, min=0)

    # Cost gate mirroring the host heuristic (match.py best_match).
    offbits = bit_length(torch.clamp(off, min=1))
    good = (mlen >= MIN_MATCH) & (6 * mlen >= 14 + offbits)
    good = good & (p < nv - MIN_MATCH)
    if start:
        good = good & (p >= start)

    step = torch.where(good, torch.clamp(mlen, min=1), 1)
    mlen_max = cap + (8 if cw == 1 else 0)
    reach = greedy_reachability(step, n, block_size, step_max=mlen_max)

    is_seq = reach & good
    in_frame = (p < nv) & (p >= start) if start else p < nv
    is_lit = reach & ~good & in_frame

    # Literal stream compaction (non-literal rows write the sink slot n).
    lit_i = is_lit.long()
    lit_idx = torch.cumsum(lit_i, dim=1) - lit_i
    n_lit = lit_i.sum(dim=1)
    literals = torch.zeros((F, n + 1), dtype=torch.uint8, device=dev).scatter(
        1, torch.where(is_lit, lit_idx, n), data_u8)[:, :n]

    # Sequence stream compaction (raw, pre-merge); rows past seq_bound
    # are dropped into the sink slot.
    seq_i = is_seq.long()
    seq_idx = torch.cumsum(seq_i, dim=1) - seq_i
    n_seq_raw = seq_i.sum(dim=1)
    LC = torch.cumsum(lit_i, dim=1)
    tgt = torch.clamp(torch.where(is_seq, seq_idx, seq_bound), max=seq_bound)

    def scatter_seq(vals, fill):
        out = torch.full((F, seq_bound + 1), fill, dtype=torch.int64, device=dev)
        return out.scatter(1, tgt, vals.expand(F, n))[:, :seq_bound]

    lc_at = scatter_seq(LC - lit_i, 0)
    mls_raw = scatter_seq(torch.where(is_seq, mlen, 0), 0)
    offs_raw = scatter_seq(torch.where(is_seq, off, 1), 1)
    pos_raw = scatter_seq(p, 0)

    sidx = torch.arange(seq_bound, dtype=torch.int64, device=dev)[None, :]
    valid = sidx < n_seq_raw[:, None]
    prev_lc = torch.where(sidx > 0, torch.roll(lc_at, 1, dims=1), 0)
    lls_raw = torch.where(valid, lc_at - prev_lc, 0)

    # Merge capped continuations: ll == 0, same offset, contiguous, and
    # never across a block boundary.
    prev_off = torch.roll(offs_raw, 1, dims=1)
    prev_end = torch.roll(pos_raw + mls_raw, 1, dims=1)
    cont = ((lls_raw == 0) & (offs_raw == prev_off) & (pos_raw == prev_end) & (sidx > 0)
            & (pos_raw % block_size != 0) & valid)
    seg_start = valid & ~cont
    seg_id = torch.cumsum(seg_start.long(), dim=1) - 1
    n_seq = seg_start.long().sum(dim=1)

    seg_tgt = torch.where(valid, seg_id, seq_bound)
    zeros = torch.zeros((F, seq_bound + 1), dtype=torch.int64, device=dev)
    mls = zeros.scatter_add(1, seg_tgt, torch.where(valid, mls_raw, 0))[:, :seq_bound]
    lls = zeros.scatter_reduce(1, seg_tgt, torch.where(seg_start, lls_raw, 0), "amax",
                               include_self=True)[:, :seq_bound]
    offs = torch.ones_like(zeros).scatter_reduce(
        1, seg_tgt, torch.where(seg_start, offs_raw, 1), "amax", include_self=True
    )[:, :seq_bound]
    i32 = torch.int32
    return (lls.to(i32), mls.to(i32), offs.to(i32), n_seq.to(i32), literals,
            n_lit.to(i32), n_seq_raw.to(i32))


def rep1_offset_values(lls_pos, lls_written, mls, offs, n_seq, block_size: int,
                       seq_bound: int):
    """Offset values with repeat-offset coding, per row: rep code 1 when a
    sequence repeats the previous offset, writes a nonzero literal length,
    and starts its match in the same block as the previous one; otherwise
    offset + 3 (RFC 8878 3.1.1.3.2.1.1)."""
    sidx = torch.arange(seq_bound, dtype=torch.int64, device=mls.device)[None, :]
    out_len = lls_pos + mls
    starts = torch.cumsum(out_len, dim=1) - out_len
    mstart = starts + lls_pos
    prev_off = torch.roll(offs, 1, dims=1)
    prev_m = torch.roll(mstart, 1, dims=1)
    same_block = (mstart // block_size) == (prev_m // block_size)
    is_rep = ((sidx > 0) & (sidx < n_seq[:, None]) & (offs == prev_off)
              & (lls_written > 0) & same_block)
    return torch.where(is_rep, 1, offs + 3)
