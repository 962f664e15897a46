"""Sequence execution as pointer-doubling gathers (plain torch).

Port of ``zeekstd_tpu/ops/seq_exec.py``, batched over frames (the
reference vmaps it). Every output byte is either a literal or a copy of
an earlier output byte at a known distance:

    src(p) = p            if p is inside a literal run
    src(p) = p - off_i    if p is inside match i

``src`` is idempotent on literals, so iterating ``S <- S[S]`` converges to
the literal position that supplies each byte. A match segment [M, M + ml)
at offset o is left in one step (``(p - M) mod o + M - o``), so each pass
squares the number of segments a chain can cross. The reference computes
this in XLA, outside any Pallas kernel; here it is torch gathers.
"""

from __future__ import annotations

import torch

from ._launch import ALLOC_SLACK


def _scatter_count(idx: torch.Tensor, size: int) -> torch.Tensor:
    """Per row, ``zeros(size).at[idx].add(1, mode="drop")``: a negative
    index counts from the end first, then indices outside [0, size) drop
    (into a sink slot that is sliced off)."""
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx >= 0) & (idx < size), idx, size)
    counts = torch.zeros(idx.shape[:-1] + (size + 1,), dtype=torch.int64, device=idx.device)
    counts.scatter_add_(-1, idx, torch.ones_like(idx))
    return counts[..., :size]


def build_sequence_layout(lls, mls, offs, out_bound: int):
    """Per-output-position layout from per-sequence (ll, ml, offset) rows
    [F, nseq]. Padding sequences have ll = ml = 0. Returns (src, lit_idx,
    is_lit), each [F, out_bound]:
      src[p]     - collapsed source position (p itself for literals)
      lit_idx[p] - index into the literal stream when is_lit[p]
      is_lit[p]  - whether p takes a literal byte
    Intermediates are freed or updated in place as soon as they are spent
    (``launch_bytes`` counts what stays alive)."""
    lls = lls.to(torch.int64)
    mls = mls.to(torch.int64)
    offs = offs.to(torch.int64)
    nseq = lls.shape[-1]
    seq_out = lls + mls
    starts = torch.cumsum(seq_out, dim=-1).sub_(seq_out)
    del seq_out
    lit_starts = torch.cumsum(lls, dim=-1).sub_(lls)

    # Rightmost segment whose start <= p: one count per segment start,
    # prefix count minus one (ties resolve to the largest index).
    p = torch.arange(out_bound, dtype=torch.int64, device=lls.device).expand(lls.shape[0], -1)
    counts = _scatter_count(starts, out_bound)
    i = torch.cumsum(counts, dim=-1).sub_(1).clamp_(0, nseq - 1)
    del counts

    start_i = torch.gather(starts, 1, i)
    ll_i = torch.gather(lls, 1, i)
    off_i = torch.gather(offs, 1, i)
    lit_start_i = torch.gather(lit_starts, 1, i)
    del i

    within = p - start_i
    is_lit = within < ll_i
    m = start_i.add_(ll_i)  # match start
    o = off_i.clamp_(min=1)
    src = torch.remainder(p - m, o).add_(m).sub_(o)
    del m, o, start_i, off_i
    src = torch.where(is_lit, p, src).clamp_(0, out_bound - 1)
    lit_idx = lit_start_i.add_(torch.minimum(within, ll_i.sub_(1).clamp_(min=0)))
    return src, lit_idx, is_lit


def resolve_copy_chains(src, n_doublings: int):
    """Pointer-double ``src`` (per row) ``n_doublings`` times: chains up to
    2^n_doublings segments deep map to their literal."""
    for _ in range(n_doublings):
        src = torch.gather(src, 1, src)
    return src


def execute_sequences_batch(literals, lls, mls, offs, out_bound: int, n_doublings: int):
    """Decode frames' sequences. literals: uint8[F, lit_bound]; lls, mls,
    offs: int[F, seq_bound] (padded with zeros; trailing literals as a
    final sequence with ml = 0). Returns (out uint8[F, out_bound],
    converged bool[F]); chains deeper than 2^n_doublings segments leave
    non-literal sources and clear the frame's flag."""
    src, lit_idx, is_lit = build_sequence_layout(lls, mls, offs, out_bound)
    final = resolve_copy_chains(src, n_doublings)
    del src
    total = (lls.to(torch.int64) + mls.to(torch.int64)).sum(dim=-1)
    in_range = torch.arange(out_bound, device=lls.device)[None, :] < total[:, None]
    packed = lit_idx.mul_(2).add_(is_lit)  # (lit_idx << 1) | is_lit
    del is_lit
    pf = torch.gather(packed, 1, final)
    del packed, final
    converged = ((pf & 1).bool() | ~in_range).all(dim=-1)
    take = pf.bitwise_right_shift_(1).clamp_(0, literals.shape[-1] - 1)
    return torch.gather(literals, 1, take), converged


def launch_bytes(F: int, out_bound: int, S: int) -> int:
    """Device bytes of an ``execute_sequences_batch`` call on F frames of S
    sequence slots laid out at ``out_bound`` bytes, beside the inputs it is
    given: per byte of F x out_bound, the int64 tensors that
    ``build_sequence_layout``, ``resolve_copy_chains`` and the final gathers
    keep alive at once (at most seven, 56 B), the masks and the byte output
    (4 B); per column, the position index (8 B); per slot, 64 B of int64
    sums and starts and the scatter's indices; ``ALLOC_SLACK``."""
    return F * (out_bound * 60 + S * 64) + out_bound * 8 + ALLOC_SLACK
