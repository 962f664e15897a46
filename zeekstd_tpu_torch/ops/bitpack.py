"""Parallel bitstream assembly: prefix-sum offsets + scatter-add into words.

Port of ``zeekstd_tpu/ops/bitpack.py``. Every value's absolute bit
offset is the exclusive prefix sum of the bit lengths, and each value
contributes to at most two 32-bit words. Bit positions are written
exactly once, so a scatter-add equals a scatter-or. Batched over a
leading axis (the JAX package's ``vmap``). uint32 words are carried as
int64 and returned as int32 bit patterns.
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> the same 32 bits as int32."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def pack_bits(values, nbits, word_bound: int):
    """Pack ``values[..., i]`` (low ``nbits[..., i]`` bits, LSB-first stream
    order) into words. values/nbits: [J, N] integer tensors. Returns
    (words int32[J, word_bound], total_bits int32[J])."""
    values = values.to(torch.int64) & _M32
    nbits = nbits.to(torch.int64)
    mask = torch.where(nbits >= 32, torch.full_like(nbits, _M32),
                       (torch.ones_like(nbits) << nbits.clamp(0, 31)) - 1)
    values = values & mask
    offsets = torch.cumsum(nbits, dim=-1) - nbits
    total_bits = nbits.sum(dim=-1)
    w = offsets >> 5
    sh = offsets & 31
    lo = (values << sh) & _M32
    hi = torch.where(sh == 0, torch.zeros_like(values), values >> (32 - sh))
    words = torch.zeros(values.shape[:-1] + (word_bound,), dtype=torch.int64,
                        device=values.device)
    words.scatter_add_(-1, w.clamp(0, word_bound - 1), lo)
    words.scatter_add_(-1, (w + 1).clamp(0, word_bound - 1), hi)
    return to_i32(words & _M32), total_bits.to(torch.int32)


def words_to_stream(words, total_bits) -> bytes:
    """Host-side: finalize a backward-readable stream — append the sentinel
    bit and byte-align (mirrors BitWriter.finish())."""
    import numpy as np

    words = np.asarray(words, dtype="<u4")
    total_bits = int(total_bits)
    raw = words.tobytes()
    nbytes = (total_bits + 7) // 8
    buf = bytearray(raw[: nbytes + 1])
    while len(buf) < nbytes + 1:
        buf.append(0)
    # Sentinel: one 1-bit at position total_bits.
    buf[total_bits // 8] |= 1 << (total_bits % 8)
    return bytes(buf[: total_bits // 8 + 1])
