"""Edge inputs of the level-1 match finder, shared by the CPU test (against
the JAX kernel, ``test_torch_match_edges.py``), the card test
(``test_torch_gpu.py``) and ``chip_smoke.py``. Imports no JAX.

Each case is a set of frame rows with their valid lengths, the block size
and the sequence bound, made from a seed with numpy at a size the caller
picks. Together they reach every branch of the parse: long rep1 matches
capped at the block end (zeros, period-1 and period-3 text), long miss
runs on the ``1 + (ll >> 8)`` schedule (random bytes), a lazy probe whose
slot is the primary probe's and interior inserts that share a slot (the
``collide`` text, whose seed was picked for both), last blocks shorter
than 12 bytes and of odd length, the sequence bound (a small SBd),
several frames that repeat each other's bytes (the per-frame table), and
matches at offsets on both sides of the 2^19 window in a frame row of
8 MiB, the largest frame the match kernel takes (``window``).
"""

from __future__ import annotations

import numpy as np

BLK = 32 << 10
NAMES = ("zeros", "random", "period1", "period3", "collide", "short_tail", "overflow",
         "frames", "window")


def _text(rng, n: int, nwords: int = 300) -> bytes:
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(nwords)]
    out = b" ".join(words[i] for i in rng.integers(0, nwords, n // 3 + 16))
    return out[:n]


def _frames(datas, FR: int):
    rows = np.zeros((len(datas), FR), np.uint8)
    lengths = np.zeros(len(datas), np.int32)
    for i, d in enumerate(datas):
        rows[i, : len(d)] = np.frombuffer(d, np.uint8)
        lengths[i] = len(d)
    return rows, lengths


def _row(n: int) -> int:
    return max(-(-n // BLK), 1) * BLK


def edge_case(name: str, n: int, seed: int = 0):
    """(rows uint8[F, FR], lengths int32[F], BLK, SBd) of case ``name`` with
    about ``n`` bytes of data (``window`` takes n >= 704 KiB)."""
    rng = np.random.default_rng(seed + NAMES.index(name))
    SBd = BLK // 4
    if name == "zeros":
        datas = [bytes(n)]
    elif name == "random":
        datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes()]
    elif name in ("period1", "period3"):
        unit = b"e" if name == "period1" else b"abc"
        parts, total = [], 0
        while total < n:
            run = unit * int(rng.integers(200, 3000))
            parts += [run, _text(rng, int(rng.integers(1, 40)))]
            total += len(run) + len(parts[-1])
        datas = [b"".join(parts)[:n]]
    elif name == "collide":
        datas = [_text(np.random.default_rng(COLLIDE_SEED), n, nwords=60)]
    elif name == "short_tail":
        k = max(n // (2 * BLK), 1)
        datas = [_text(rng, k * BLK + 7), _text(rng, k * BLK + 12345)]
    elif name == "overflow":
        SBd = 64
        datas = [_text(rng, n)]
    elif name == "frames":
        base = _text(rng, n // 3)
        datas = [base, base[: n // 6] + _text(rng, n // 6), base[n // 9:]]
    elif name == "window":
        # 4 KiB random chunks repeated across a block boundary at offsets
        # 2^19 - 8, 2^19 - 20000 and 2^19 + 8. The window ends 2^19 bytes
        # before the block's end, so the first two are found only in
        # their block's last 8 and 20000 bytes, the third never.
        assert n >= 704 << 10
        d = bytearray(_text(rng, n))
        w = 1 << 19
        for dst, off in ((18 * BLK - 2000, w - 8), (20 * BLK - 1000, w - 20000),
                         (19 * BLK - 1500, w + 8)):
            d[dst - off : dst - off + 4096] = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
            d[dst : dst + 4096] = d[dst - off : dst - off + 4096]
        return (*_frames([bytes(d)], 8 << 20), BLK, SBd)
    else:
        raise ValueError(name)
    FR = _row(max(len(d) for d in datas))
    return (*_frames(datas, FR), BLK, SBd)


# Picked by parsing seeds 0-119 of the 60-word text with a counting copy
# of the plain parse: at 64 KiB this one has 18 lazy probes whose slot is
# the primary probe's and 9 sequences whose interior inserts share a slot.
COLLIDE_SEED = 118


def match_inputs(rows, lengths, BLK: int):
    """The match wrapper's (meta, words) for frame rows, as the archive
    pipeline builds them: records bucketed, words padded to the bucket."""
    from zeekstd_tpu_torch.ops import match_kernel as mk

    F, FR = rows.shape
    nrecp = mk.bucket_nrecp(F * (FR // BLK))
    meta = mk.build_records(F, FR // BLK, BLK, FR, lengths, n_pad=nrecp)
    words = np.zeros(nrecp * (BLK // 4), np.int32)
    flat = np.ascontiguousarray(rows).reshape(-1).view(np.int32)
    words[: flat.size] = flat
    return meta, words
