"""Hand-built records for the ring contract of the fused decoder, shared by
the CPU test (against the JAX ring kernel, ``test_torch_ring_hostile.py``)
and the card test (``test_torch_gpu.py``). Imports no JAX.

Each case is the ring decoder's inputs, made from a seed with numpy: the
ll/ml code constants, build_records rows, bitstream words, decode-table
rows (symbol | nb_bits << 8 | baseline << 16) and the literal pools as LE
words, with the output bound. Each reaches one place where the ring
contract differs from the wide one:

- ``offset_over_ring``: matches whose offsets exceed 512 KiB in a frame
  longer than 512 KiB (a literal run, then RLE records of one block each
  up to just past 512 KiB): the frame is bad and each copy reads from
  512 KiB back;
- ``literal_over_budget``: literal runs past their block's literal budget
  (clamped there), trailing literals clamped by the output only, and a
  literal record;
- ``fields_below_window``: offset codes of 100 bits, so that a sequence
  reads more bits than the four words below its start hold;
- ``match_at_0``: a first sequence that is a match at position 0 (its
  bytes read 0), then an RLE run, and a frame of one literal run.
"""

from __future__ import annotations

import numpy as np

from zeekstd_tpu_torch.ops import decode_kernel as dk

RING = 1 << 19
NAMES = ("offset_over_ring", "literal_over_budget", "fields_below_window", "match_at_0")
WB = 64  # words per bitstream row (the three small cases share one shape)


def _entry(sym, nb=0, base=0):
    return np.asarray(sym, np.int64) | np.asarray(nb, np.int64) << 8 | (
        np.asarray(base, np.int64) << 16)


def _lit_words(pools, LW: int):
    lw = np.zeros((len(pools), LW * 4), np.uint8)
    for f, p in enumerate(pools):
        lw[f, : len(p)] = np.frombuffer(p, np.uint8)
    return lw.view(np.int32)


def _words(rng, n=2):
    return rng.integers(0, 1 << 32, (n, WB), dtype=np.uint64).astype(np.uint32).view(np.int32)


def ring_case(name: str):
    """([consts, meta, words, tables, lit_words], OUTB) of case ``name``:
    numpy int32 arrays in the ring decoder's layouts."""
    rng = np.random.default_rng(NAMES.index(name) + 21)
    tabs = np.zeros((4, 512), np.int64)
    words = _words(rng)
    LW, OUTB = 1024, 8192
    if name == "offset_over_ring":
        # ll 0, offset code 19 (offset value 2^19 + 19 bits: offsets from
        # 2^19 - 3 up), ml 34; 6 sequences of 19 bits.
        tabs[0], tabs[1], tabs[2] = _entry(0), _entry(19), _entry(31)
        nseq = 6
        # RLE records of at most one block (128 KiB) each, as the format
        # has them, up to 500 bytes past 512 KiB.
        runs = [1 << 17] * 3 + [RING - 500 - 3 * (1 << 17)]
        frames = [[("lit", 1000)] + [("rle", n, 0x41 + i) for i, n in enumerate(runs)]
                  + [("seq", 0, nseq, 0, 0, 1, 2, 0, 19 * nseq)], [("lit", 9)]]
        pools = [rng.integers(0, 256, 1000, dtype=np.uint8).tobytes(), b"ring case"]
        words = words[:, :16].copy()
        OUTB = 1 << 20
    elif name == "literal_over_budget":
        # ll 4, offset code 3 (offsets 5-12), ml 8: six sequences against a
        # budget of 10 literals, then a literal record; a second block of
        # two sequences with a budget of 300 (292 trailing literals).
        tabs[0], tabs[1], tabs[2] = _entry(4), _entry(3), _entry(5)
        frames = [[("seq", 0, 6, 10, 0, 1, 2, 0, 18), ("lit", 20),
                   ("seq", 1, 2, 300, 0, 1, 2, 0, 6)],
                  [("lit", 40), ("seq", 1, 3, 5, 0, 1, 2, 0, 9)]]
        pools = [rng.integers(0, 256, 400, dtype=np.uint8).tobytes(),
                 rng.integers(0, 256, 60, dtype=np.uint8).tobytes()]
    elif name == "fields_below_window":
        # Random symbols without extra bits but offsets (ll 0-15, ml 3-34,
        # offset codes 1-12), 8-bit state updates (states stay below 512);
        # a quarter of the offset codes are 100, so that sequence reads
        # 124 bits, more than the 96-128 bits the window holds below its
        # start, and the state updates after it read the window's floor.
        of_codes = rng.integers(1, 13, 512)
        of_codes[rng.random(512) < 0.25] = 100
        for t, syms in enumerate((rng.integers(0, 16, 512), of_codes,
                                  rng.integers(0, 32, 512))):
            tabs[t] = _entry(syms, 8, 256 * rng.integers(0, 2, 512))
        logs = 9 | 9 << 5 | 9 << 10
        frames = [[("seq", 0, 18, 400, 0, 1, 2, logs, WB * 32 - 5)],
                  [("lit", 7), ("seq", 1, 12, 300, 0, 1, 2, logs, WB * 32 - 40)]]
        pools = [rng.integers(0, 256, 400, dtype=np.uint8).tobytes(),
                 rng.integers(0, 256, 307, dtype=np.uint8).tobytes()]
    else:  # match_at_0
        # ll code 0 or 4 by the state's low bit (one update bit), offset
        # code 3, ml 8: the first sequence (state 0) is a match at 0.
        tabs[0, 0::2] = _entry(0, 1)
        tabs[0, 1::2] = _entry(4, 1)
        tabs[1], tabs[2] = _entry(3), _entry(5)
        nseq = 40
        frames = [[("seq", 0, nseq, 200, 0, 1, 2, 0, 4 * nseq - 1), ("rle", 5, 7)],
                  [("lit", 9)]]
        pools = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes(), b"literal!!"]
    meta, _n = dk.build_records(frames)
    return [dk.make_consts(), meta, words, tabs.astype(np.int32),
            _lit_words(pools, LW)], OUTB
