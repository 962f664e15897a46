"""Chunked greedy reachability: plain versions, CUDA wrappers and glue.

Port of ``zeekstd_tpu/ops/pallas_kernels.py`` (``chunk_pointer_tables``,
``chunk_mark``, ``reachability_chunked``). The greedy parse jumps from
position p to p + step[p]; the positions it visits from each block start
are the anchors. Steps are at most ``SMAX`` and never cross a block, so
chains are local:

- ``chunk_pointer_tables``: per 128-position chunk, the tables f^(2^k),
  k < 8, of the step map ``lane + step``. A value v >= 128 means the chain
  left the chunk and entered the next one at phase v - 128 (< SMAX);
  such values stay put under further doubling.
- the glue composes the chunk transfer maps (f^128's first SMAX lanes)
  across each block, so every chunk learns the phase its chain enters
  with (an integer gather; the reference's one-hot einsum computes the
  same map);
- ``chunk_mark``: from its entry phase, each lane walks the tables by
  binary lifting without passing its own position; it is an anchor iff
  the walk lands on it.

Both wrappers run their plain version for CPU tensors and launch their
CUDA kernel (``csrc/reach_kernel.cu``) for CUDA tensors.
"""

from __future__ import annotations

import torch

from . import launches
from ._launch import I, P, check_cuda, check_rc, kernel_fn, ptr, stream

CHUNK = 128   # positions per chunk
SMAX = 32     # largest greedy step; exit phases are < SMAX
N_TABLES = 8  # f^1, f^2, ..., f^128


def tables_plain(step2: torch.Tensor) -> torch.Tensor:
    """int32[rows, 128] steps -> int32[rows, 8*128] pointer tables."""
    lane = torch.arange(CHUNK, dtype=torch.int32, device=step2.device)
    v = lane + step2
    out = [v]
    for _ in range(1, N_TABLES):
        nxt = torch.gather(v, 1, v.clamp(0, CHUNK - 1).long())
        v = torch.where(v < CHUNK, nxt, v)
        out.append(v)
    return torch.cat(out, dim=1)


def mark_plain(tables: torch.Tensor, entry2: torch.Tensor) -> torch.Tensor:
    """int32[rows, 8*128] tables, int32[rows, 128] entry phases ->
    int32[rows, 128] chain mask."""
    lane = torch.arange(CHUNK, dtype=torch.int32, device=tables.device)
    cur = entry2
    for k in range(N_TABLES - 1, -1, -1):
        tab = tables[:, k * CHUNK : (k + 1) * CHUNK]
        cand = torch.gather(tab, 1, cur.clamp(0, CHUNK - 1).long())
        cur = torch.where(cand <= lane, cand, cur)
    return (cur == lane).to(torch.int32)


def chunk_pointer_tables(step2: torch.Tensor) -> torch.Tensor:
    """step2: int32[rows, 128] (row = chunk) -> int32[rows, 8*128]."""
    if step2.device.type == "cpu":
        return tables_plain(step2)
    check_cuda("step2", step2)
    rows = step2.shape[0]
    out = torch.empty((rows, N_TABLES * CHUNK), dtype=torch.int32, device=step2.device)
    fn = kernel_fn("zk_reach_tables_launch", [P, I, P, P])
    rc = fn(ptr(step2), rows, ptr(out), stream())
    launches["reach_tables"] += 1
    check_rc("reach_tables", rc)
    return out


def chunk_mark(tables: torch.Tensor, entry2: torch.Tensor) -> torch.Tensor:
    """tables: int32[rows, 8*128]; entry2: int32[rows, 128] (the chunk's
    entry phase in every lane) -> int32[rows, 128] chain mask."""
    if tables.device.type == "cpu":
        return mark_plain(tables, entry2)
    check_cuda("tables", tables)
    check_cuda("entry2", entry2)
    rows = tables.shape[0]
    out = torch.empty((rows, CHUNK), dtype=torch.int32, device=tables.device)
    fn = kernel_fn("zk_reach_mark_launch", [P, P, I, P, P])
    rc = fn(ptr(tables), ptr(entry2), rows, ptr(out), stream())
    launches["reach_mark"] += 1
    check_rc("reach_mark", rc)
    return out


def reachability_chunked(step: torch.Tensor, n: int, block_size: int) -> torch.Tensor:
    """Anchor mask bool[..., n] of the greedy chains over ``step`` (any
    leading shape, last axis n). Requirements (the caller checks): every
    step in [1, SMAX]; n a multiple of CHUNK; min(block_size, n) a
    multiple of CHUNK dividing n, with a power-of-two chunk count."""
    shape = step.shape
    rows = step.numel() // CHUNK
    cb = min(block_size, n) // CHUNK  # chunks per block
    nb = rows // cb
    tables = chunk_pointer_tables(step.to(torch.int32).reshape(rows, CHUNK).contiguous())

    # Chunk transfer maps: f^128 is saturated (every chain leaves a chunk
    # within 128 steps), so its first SMAX lanes map entry to exit phase.
    m = tables[:, (N_TABLES - 1) * CHUNK : (N_TABLES - 1) * CHUNK + SMAX] - CHUNK
    m = m.reshape(nb, cb, SMAX).long()

    # Prefix-compose per block (Hillis-Steele): q[:, c] maps the block's
    # entry phase (0) to chunk c's entry phase. Composition is
    # q_new[b, c, e] = q[b, c, qs[b, c, e]], the reference's one-hot
    # product (an index outside [0, SMAX) selects 0 there, and here).
    ident = torch.arange(SMAX, dtype=torch.int64, device=step.device).expand(nb, 1, SMAX)
    q = torch.cat([ident, m[:, :-1]], dim=1)
    sh = 1
    while sh < cb:
        qs = torch.cat([ident.expand(nb, sh, SMAX), q[:, :-sh]], dim=1)
        inside = (qs >= 0) & (qs < SMAX)
        q = torch.where(inside, torch.gather(q, 2, qs.clamp(0, SMAX - 1)), 0)
        sh *= 2
    entry = q[:, :, 0].reshape(rows, 1).to(torch.int32)
    mask = chunk_mark(tables, entry.expand(rows, CHUNK).contiguous())
    return mask.reshape(shape).bool()
