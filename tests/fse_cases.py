"""Cases of the FSE-decode tests, shared by the CPU tests and the card's.

Each case is the inputs of ``entropy.fse_decode_sequences`` as numpy
arrays: words uint32[B, WB], start_bits and n_seq int32[B], tidx
int32[B, 3], tables int32[T, 512], logs int32[T], consts int32[4, 64],
and seq_bound (a multiple of 8). All are made from seeds:

- ``planned``: the blocks of a 96 KiB level-3 archive of the port (16 KiB
  frames) as ``plan.fse_stage`` stages them, with its padding rows;
- mutations of ``planned``: ``start_bits`` a few bits below or above its
  value and past the row's end; ``n_seq`` at -1, 0, one more, eight times
  and over ``seq_bound``; table indices out of range and negative; bit
  flips in the streams; and twice as many padding rows;
- ``wide_rows``: rows of 65,536 words, past the kernel's staging budget
  (``entropy.STAGE_WORDS``): a planned stream at the bottom of its row,
  random streams walked from the row's top, a start past the row's end;
- ``long_chain``: one row of 12,000 sequences of a random stream under
  the planned tables, from the top of a 65,536-word row.

Imports no JAX.
"""

import functools

import numpy as np

from zeekstd_tpu_torch import archive, plan
from zeekstd_tpu_torch.ops import decode_kernel as dk

MUTATIONS = ("start_minus", "start_plus", "start_past_end", "nseq_edges", "tidx_out_of_range",
             "bit_flips", "more_padding")
CASES = ("planned",) + MUTATIONS + ("wide_rows", "long_chain")
WIDE_WB = 1 << 16


def _text(n, seed=21):
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(150)]
    text = b" ".join(words[rng.integers(0, 150)] for _ in range(n // 5))
    return (text[: n // 2] + bytes(rng.integers(0, 256, n // 8, dtype=np.uint8)) + text)[:n]


def _pow2(n, lo):
    return 1 << max((n - 1).bit_length(), lo)


@functools.lru_cache(maxsize=1)
def _planned():
    blob, _st = archive.compress_archive(_text(96 << 10), frame_size=16 << 10, level=3,
                                         device="cpu")
    seq_blocks = plan.collect(plan.plan_archive(blob, None)).seq_blocks
    words, starts, tidx, packed, logs_t, _wb = plan.fse_stage(seq_blocks)
    nseqs = np.zeros(words.shape[0], np.int32)
    nseqs[: len(seq_blocks)] = [d["nseq"] for d in seq_blocks]
    return words, starts, nseqs, tidx, packed, logs_t, len(seq_blocks)


def case(name):
    """(words, start_bits, n_seq, tidx, tables, logs, consts, seq_bound) of
    case ``name``."""
    words, starts, nseqs, tidx, tables, logs, nb = (
        x.copy() if isinstance(x, np.ndarray) else x for x in _planned())
    seq_bound = _pow2(int(nseqs.max()), 5)
    B, WB = words.shape
    rng = np.random.default_rng(CASES.index(name) + 40)
    if name == "start_minus":
        starts[:nb] -= rng.integers(1, 6, nb).astype(np.int32)
    elif name == "start_plus":
        starts[:nb] += rng.integers(1, 6, nb).astype(np.int32)
    elif name == "start_past_end":
        starts[:nb] = WB * 32 + rng.integers(1, 200, nb).astype(np.int32)
        starts[0] = 1 << 28
    elif name == "nseq_edges":
        for i in range(B):
            n = int(nseqs[i])
            nseqs[i] = (-1, 0, n + 1, 8 * n, seq_bound + 3)[i % 5]
    elif name == "tidx_out_of_range":
        T = tables.shape[0]
        for i in range(B):
            tidx[i, i % 3] = (T, T + 5, -1, -T - 4)[i % 4]
    elif name == "bit_flips":
        for i in range(nb):
            used = max((int(starts[i]) + 31) // 32, 1)
            for _ in range(3):
                words[i, rng.integers(0, used)] ^= np.uint32(1 << int(rng.integers(0, 32)))
    elif name == "more_padding":
        pad = B
        words = np.concatenate([words, np.zeros((pad, WB), np.uint32)])
        starts, nseqs = (np.concatenate([x, np.zeros(pad, np.int32)]) for x in (starts, nseqs))
        tidx = np.concatenate([tidx, np.zeros((pad, 3), np.int32)])
    elif name in ("wide_rows", "long_chain"):
        return _wide(name, words, starts, nseqs, tidx, tables, logs, rng)
    return words, starts, nseqs, tidx, tables, logs, dk.make_consts(), seq_bound


def _wide(name, words, starts, nseqs, tidx, tables, logs, rng):
    """Rows of ``WIDE_WB`` words under the planned tables."""
    top = WIDE_WB * 32
    if name == "long_chain":
        w = rng.integers(0, 1 << 32, (1, WIDE_WB), dtype=np.uint64).astype(np.uint32)
        return (w, np.array([top - 9], np.int32), np.array([12000], np.int32), tidx[:1].copy(),
                tables, logs, dk.make_consts(), 1 << 14)
    w = rng.integers(0, 1 << 32, (4, WIDE_WB), dtype=np.uint64).astype(np.uint32)
    w[0] = 0
    w[0, : words.shape[1]] = words[0]
    st = np.array([starts[0], top - 3, top + 4000, top - 77], np.int32)
    ns = np.array([nseqs[0], 3000, 500, 0], np.int32)
    return (w, st, ns, tidx[:4].copy(), tables, logs, dk.make_consts(),
            _pow2(int(ns.max()), 5))
