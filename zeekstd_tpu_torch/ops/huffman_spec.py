"""Loop-free Huffman stream decoding by bit reachability.

Port of ``decode_stream_bitreach`` of ``zeekstd_tpu/ops/huffman_spec.py``,
batched over streams (the reference vmaps it over the streams of the
device Huffman dispatch). Per stream:

1. The peek window ending at every bit position comes from 32 static
   shifts of the word array (one zero word below bit 0 reproduces the
   zero fill of codes that read past the stream's bottom), flipped and
   rotated into "distance from the stream top" coordinates.
2. One packed table lookup per position gives (symbol, bit count); the
   bit count is the step of a forward chain over positions whose visited
   set is exactly the decoded symbol sequence.
3. Steps are at most 31, so the chain is local: the chunked reachability
   kernels (``reach_kernel.reachability_chunked``, one block per stream)
   mark it.
4. The marked symbols are compacted to the output by a prefix sum and a
   scatter.

The shifts, flip, rotation, lookup and compaction are plain torch; the
two reachability kernels run on the card. The reference's other decoder,
``decode_stream_spec`` (chunk speculation, its CPU default), is not
ported: the port decodes device Huffman streams with this one on every
device.
"""

from __future__ import annotations

import torch

from . import reach_kernel

_M32 = 0xFFFFFFFF


def decode_stream_bitreach(words, start_bits, out_bound: int, table_symbol, table_nbits,
                           max_bits):
    """Decode a batch of backward Huffman streams.

    words: int32[S, W] (each stream's LE uint32 words); start_bits,
    max_bits: int[S]; table_symbol, table_nbits: int[S, 2048] dense decode
    tables. Returns (symbols uint8[S, out_bound], n_symbols int32[S]);
    symbols past a stream's count are 0."""
    S, W = words.shape
    dev = words.device
    n_reach = max(-(-W * 32 // 1024) * 1024, 1024)  # the kernels' tile granularity
    mb = max_bits.to(torch.int64)

    # allv[t] = ext bits [t, t + 11) with ext bit t == stream bit t - 32.
    ext = torch.cat([torch.zeros((S, 1), dtype=torch.int64, device=dev),
                     words.to(torch.int64) & _M32], dim=1)
    w1 = torch.cat([ext[:, 1:], torch.zeros((S, 1), dtype=torch.int64, device=dev)], dim=1)
    win = [(ext & 0x7FF).to(torch.int32)]
    for sh in range(1, 32):
        win.append((((ext >> sh) | (w1 << (32 - sh))) & 0x7FF).to(torch.int32))
    allv = torch.stack(win, dim=2).reshape(S, -1)
    L = allv.shape[1]

    # Chain position p peeks stream bits [start - p - max_bits, start - p)
    # = allv[base - p], base = start + 32 - max_bits: a flip and a per-row
    # rotation by -(L - 1 - base) (the reference's jnp.roll).
    flipped = allv.flip(1)
    N = max(L, n_reach)
    if L < n_reach:
        flipped = torch.cat(
            [flipped, torch.zeros((S, n_reach - L), dtype=torch.int32, device=dev)], dim=1)
    base = start_bits.to(torch.int64) + 32 - mb
    src = torch.remainder(torch.arange(n_reach, device=dev)[None, :] + (L - 1 - base)[:, None], N)
    peek = torch.gather(flipped, 1, src).to(torch.int64)
    mask = torch.where(mb >= 32, _M32, (1 << mb.clamp(0, 31)) - 1)
    peek = peek & mask[:, None]

    packed_tab = (table_symbol.to(torch.int64) & 0xFF) | (
        table_nbits.to(torch.int64).clamp(1, 31) << 8)
    packed = torch.gather(packed_tab, 1, peek.clamp(0, 2047))
    sym = (packed & 0xFF).to(torch.uint8)
    step = (packed >> 8).to(torch.int32)  # in [1, 31]

    reach = reach_kernel.reachability_chunked(step, n_reach, n_reach)
    p = torch.arange(n_reach, device=dev)[None, :]
    emit = reach & (p < start_bits.to(torch.int64)[:, None])
    e = emit.to(torch.int64)
    n_sym = e.sum(dim=1).to(torch.int32)
    idx = torch.cumsum(e, dim=1) - e
    tgt = torch.where(emit & (idx < out_bound), idx, out_bound)  # out_bound: a sink slot
    out = torch.zeros((S, out_bound + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, tgt, sym)
    return out[:, :out_bound], n_sym
