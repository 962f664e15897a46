"""Fused decode for windows of at most 512 KiB: plain version and CUDA
wrapper of the ring contract.

Port of ``zeekstd_tpu/ops/ring_kernel.py``. The computation is
``decode_kernel``'s (same meta layout, table rows and repeat-offset
rules); the contract differs: the literal pool arrives as packed LE words
(F, LW) and the output leaves as LE words (F, OUTB/4). The TPU kernel
kept the last 512 KiB of output in a scalar-memory ring; on the card no
ring is needed, but the route keeps the reference's rules: a literal run
may not exceed its block's literal budget, an offset over 512 KiB marks
the frame bad, and a sequence reads its bits from the four words below
its start.

On the card it runs the wide decoder's three stages
(``csrc/wide_decode.cu``, ``decode_kernel.staged_decode``) in their ring
instances: an FSE pass per record, a scan per frame that writes one
descriptor per output byte, and pointer jumping over the descriptors.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launches
from ._launch import check_cuda
from .decode_kernel import RING, decode_plain, stage_bytes, staged_decode

RING_LOG = 19
assert RING == 1 << RING_LOG


def ring_plain(consts, meta, words, tables, lit_words, OUTB: int):
    lw = lit_words.detach().cpu().contiguous().numpy()
    pools = [lw[f].tobytes() for f in range(lw.shape[0])]
    outs, meta_out = decode_plain(consts, meta, words, tables, pools, OUTB,
                                  ring=True)
    out = np.frombuffer(b"".join(outs), np.uint8).reshape(len(outs), OUTB)
    dev = lit_words.device
    return (torch.from_numpy(out.view(np.int32).copy()).to(dev),
            torch.from_numpy(meta_out).to(dev))


def launch_bytes(F: int, OUTB: int, LW: int, n_rec: int, n_seq: int) -> int:
    """Device bytes of a ``ring_decode`` launch: the literal words, 4 B per
    word of F x LW; the output, 1 B per byte of F x OUTB;
    ``decode_kernel.stage_bytes``."""
    return F * (LW * 4 + OUTB) + stage_bytes(F, OUTB, n_rec, n_seq)


def ring_stages(consts, meta, words, tables, lit_words, *, OUTB: int):
    """Allocate the outputs and scratch of the CUDA ring decoder for these
    CUDA inputs (see ``ring_decode``). Returns (out, meta_out, stages), as
    ``decode_kernel.staged_decode``."""
    check_cuda("lit_words", lit_words)
    F, LW = lit_words.shape
    if OUTB <= 0 or OUTB % 4:
        raise ValueError("OUTB must be a positive multiple of 4")
    if LW * 4 + 256 >= 1 << 31:
        raise ValueError("literal pool too large for int32 descriptors")
    out = torch.empty((F, OUTB // 4), dtype=torch.int32, device=lit_words.device)
    meta_out, stages = staged_decode("ring", consts, meta, words, tables, lit_words, out,
                                     OUTB=OUTB, scan_ints=(LW,), pool_width=LW, min_wb=4)
    return out, meta_out, stages


def ring_decode(consts, meta, words, tables, lit_words, *, OUTB: int):
    """Decode every frame. consts int32[4, 64], meta int32[NRECP,
    META_COLS], words int32[nw, WB] (WB >= 4), tables int32[Tp, 512],
    lit_words int32[F, LW] (each frame's literal pool as LE words).
    Returns (out int32[F, OUTB/4] LE words, meta_out int32[F, 128] =
    total, bad flag, literals used); output bytes are exact up to the
    total. Records are frame-major with a frame's F_FRAME_START on its
    first record (``decode_kernel.build_records``)."""
    if lit_words.device.type == "cpu":
        return ring_plain(consts, meta, words, tables, lit_words, OUTB)
    out, meta_out, stages = ring_stages(consts, meta, words, tables, lit_words, OUTB=OUTB)
    for _name, launch in stages:
        launch()
    launches["ring_decode"] += 1
    return out, meta_out
