"""Huffman stream decoding on the device, two ways.

Ports of ``zeekstd_tpu/ops/huffman_spec.py``, batched over streams (the
reference vmaps each over the streams of the device Huffman dispatch).
``decode_routes._huf_batch_dev`` takes ``decode_stream_bitreach`` unless
``ZEEKSTD_TPU_HUF=spec`` asks for ``decode_stream_spec``; the reference
takes the first on a TPU and the second elsewhere
(``tpu_codec.py:398-404``, ``parallel/pipeline.py:751-756``). Both give
the same symbols.

``decode_stream_bitreach``, per stream:

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
two reachability kernels run on the card.

``decode_stream_spec`` (chunk speculation), plain torch:

1. The stream is cut into chunks of ``chunk_bits`` from its top. A code
   is at most 11 bits, so the decode enters each chunk 0-10 bits below
   its top (the spill of the code that straddled the edge).
2. Every chunk is decoded from all 11 entry spills at once, one step per
   symbol for at most ``chunk_bits`` steps over (chunks x 11) lanes,
   keeping each lane's symbols, count and exit spill.
3. Each chunk's exit spills form a map over the 11 entry spills; a
   log-depth scan composes the maps, which gives every chunk's true entry
   spill.
4. Each chunk's true lane is selected, and its symbols scattered to the
   offsets of a prefix sum of the counts.
"""

from __future__ import annotations

import torch

from . import reach_kernel

_M32 = 0xFFFFFFFF
SPILLS = 11  # a Huffman code is at most 11 bits: the entry spill of a chunk


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


def decode_stream_spec(words, start_bits, out_bound: int, table_symbol, table_nbits, max_bits,
                       chunk_bits: int = 264):
    """Decode a batch of backward Huffman streams by chunk speculation;
    same arguments and results as ``decode_stream_bitreach``."""
    S, W = words.shape
    dev = words.device
    C = chunk_bits
    K = (W * 32 + C - 1) // C
    # ext word j + 1 is stream word j: ext bit q is stream bit q - 32, and
    # the zero word below makes bits under the stream's bottom read 0.
    ext = torch.cat([torch.zeros((S, 1), dtype=torch.int64, device=dev),
                     words.to(torch.int64) & _M32,
                     torch.zeros((S, 1), dtype=torch.int64, device=dev)], dim=1)
    mb = max_bits.to(torch.int64)[:, None]
    mask = (1 << mb) - 1
    start = start_bits.to(torch.int64)[:, None]
    sym_tab = table_symbol.to(torch.int64) & 0xFF
    nb_tab = table_nbits.to(torch.int64)

    def peek(pos):
        """The max_bits bits of each stream below ``pos`` (int64[S, L])."""
        lo = pos - mb
        q = lo.clamp(min=-32) + 32
        wi = (q >> 5).clamp(max=W)
        both = torch.gather(ext, 1, wi) | (torch.gather(ext, 1, wi + 1) << 32)
        val = (both >> (q & 31)) & mask
        return torch.where(lo <= -mb, 0, val).clamp(0, 2047)

    # Lane (k, s): chunk k, counted from the stream's top, entered s bits
    # below its top; it decodes while its code starts above the chunk's
    # bottom (and above bit 0).
    k = torch.arange(K, dtype=torch.int64, device=dev).repeat_interleave(SPILLS)[None, :]
    s = torch.arange(SPILLS, dtype=torch.int64, device=dev).repeat(K)[None, :]
    pos = start - k * C - s
    floor = (start - (k + 1) * C).clamp(min=0)
    count = torch.zeros_like(pos)
    syms = torch.zeros((S, K * SPILLS, C), dtype=torch.uint8, device=dev)
    for t in range(C):
        active = pos > floor
        if not bool(active.any()):
            break
        p = peek(pos)
        syms[:, :, t] = torch.gather(sym_tab, 1, p).to(torch.uint8)
        pos = torch.where(active, pos - torch.gather(nb_tab, 1, p), pos)
        count += active
    bottom = start - (k + 1) * C
    spill = (bottom - pos).clamp(0, SPILLS - 1).reshape(S, K, SPILLS)
    count = count.reshape(S, K, SPILLS)

    # Inclusive scan of the maps, composed in chunk order: after it,
    # comp[k][s] is the exit spill of chunk k when chunk 0 is entered at s.
    comp = spill
    d = 1
    while d < K:
        comp = torch.cat([comp[:, :d], torch.gather(comp[:, d:], 2, comp[:, :-d])], dim=1)
        d *= 2
    entry = torch.cat([torch.zeros((S, 1), dtype=torch.int64, device=dev), comp[:, :-1, 0]],
                      dim=1)

    true_counts = torch.gather(count, 2, entry[:, :, None])[:, :, 0]
    lane = torch.arange(K, dtype=torch.int64, device=dev)[None, :] * SPILLS + entry
    true_syms = torch.gather(syms, 1, lane[:, :, None].expand(S, K, C))
    offsets = torch.cumsum(true_counts, dim=1) - true_counts
    j = torch.arange(C, dtype=torch.int64, device=dev)[None, None, :]
    tgt = torch.where((j < true_counts[:, :, None]) & (offsets[:, :, None] + j < out_bound),
                      offsets[:, :, None] + j, out_bound)  # out_bound: a sink slot
    out = torch.zeros((S, out_bound + 1), dtype=torch.uint8, device=dev)
    out.scatter_(1, tgt.reshape(S, -1), true_syms.reshape(S, -1))
    return out[:, :out_bound], true_counts.sum(dim=1).to(torch.int32)
