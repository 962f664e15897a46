"""Entropy stages: Huffman literal-stream encoding and FSE sequence decode.

``huffman_encode_streams`` ports ``zeekstd_tpu/ops/entropy.huffman_encode_stream``
(batched over streams). Huffman coding has no inter-symbol state: each
stream is a gather of (code, bit count) per literal in backward-stream
order (reversed literal order) followed by the parallel bit packer.

``fse_decode_sequences`` ports ``zeekstd_tpu/ops/entropy.fse_decode_sequences``
as the reference's device FSE dispatch calls it
(``tpu_codec._get_fse_decode_packed_fn``: batched over blocks, packed
deduped tables, the ``hasrep`` flag). The reference runs it as an XLA
scan; here it is a CUDA kernel (``csrc/fse_decode.cu``), because a
plain-torch loop over the sequence index would be one small launch per
sequence step. The kernel runs one warp per block: it stages the block's
three table rows and a window of its bitstream (``stage_words`` words,
``STAGE_WORDS`` at most) in shared memory, walks the FSE states 64
sequences at a time, and decodes those sequences' values, repeat offsets
and stores across the lanes, two per lane. Its plain version
(``fse_decode_plain``) decodes one block at a time over Python ints.
"""

from __future__ import annotations

import numpy as np
import torch

from . import launches
from ._launch import I, P, check_cuda, check_rc, kernel_fn, ptr, stream
from .bitpack import pack_bits

_M32 = 0xFFFFFFFF
LL_CODES = 36  # len(LL_BASE): ll code lookups clamp to it, as JAX's gather
ML_CODES = 53  # len(ML_BASE)
# Bitstream words the FSE-decode kernel stages per block in shared memory:
# 32 KiB, a whole 32 KiB block's stream (the tables take 21 KiB more).
STAGE_WORDS = 8192


def huffman_encode_streams(segs, n_valid, codes, nbits, word_bound: int):
    """Encode a batch of literal runs into packed words (the sentinel is
    added by ``assemble.finalize_streams``).

    segs: uint8[J, N] with the valid prefix [0, n_valid[j]) per row;
    codes: int64[J, 256]; nbits: int32[J, 256]. Returns (words
    int32[J, word_bound], bits int32[J])."""
    n = segs.shape[1]
    idx = n_valid.to(torch.int64)[:, None] - 1 - torch.arange(
        n, dtype=torch.int64, device=segs.device)[None, :]
    valid = idx >= 0
    lit = torch.gather(segs.to(torch.int64), 1, idx.clamp(0, n - 1))
    vals = torch.where(valid, torch.gather(codes.to(torch.int64), 1, lit), 0)
    bits = torch.where(valid, torch.gather(nbits.to(torch.int64), 1, lit), 0)
    return pack_bits(vals, bits, word_bound)


def _wrap32(x: int) -> int:
    """The int32 value with the same low 32 bits as ``x``."""
    return ((x + (1 << 31)) & _M32) - (1 << 31)


def _take(tab, i: int) -> int:
    """``tab[i]`` with JAX's gather rule: a negative index counts from the
    end, then the index is clamped."""
    size = len(tab)
    if i < 0:
        i += size
    return tab[min(max(i, 0), size - 1)]


def _decode_block(w, start: int, n: int, tll, tof, tml, logs, c, seq_bound: int):
    """One block's sequences over Python ints (one thread block of the
    kernel)."""
    W = len(w)

    def read_at(rem, nb):
        # nb bits of the backward stream ending at bit rem, as int32: word
        # indices clipped, nb <= 0 reads 0, nb >= 32 keeps all 32 bits.
        if nb <= 0:
            return 0
        lo = rem - nb
        wi, sh = lo >> 5, lo & 31
        w0 = w[min(max(wi, 0), W - 1)]
        w1 = w[min(max(wi + 1, 0), W - 1)]
        both = (w0 >> sh) | (0 if sh == 0 else (w1 << (32 - sh)) & _M32)
        return _wrap32(both & (_M32 if nb >= 32 else (1 << nb) - 1))

    ll_cb, ll_bb = c[0][:LL_CODES], c[1][:LL_CODES]
    ml_cb, ml_bb = c[2][:ML_CODES], c[3][:ML_CODES]
    rem = start
    ll_s = read_at(rem, logs[0])
    rem -= logs[0]
    of_s = read_at(rem, logs[1])
    rem -= logs[1]
    ml_s = read_at(rem, logs[2])
    rem -= logs[2]
    r1, r2, r3 = 1, 4, 8
    lls, mls = [0] * seq_bound, [0] * seq_bound
    offs, ofvs = [1] * seq_bound, [4] * seq_bound
    hasrep = False
    for i in range(min(max(n, 0), seq_bound)):
        of_e, ml_e, ll_e = _take(tof, of_s), _take(tml, ml_s), _take(tll, ll_s)
        of_code = of_e & 0xFF
        ofv = _wrap32((0 if of_code >= 32 else 1 << of_code) + read_at(rem, of_code))
        rem -= of_code
        mc = ml_e & 0xFF
        mlb = _take(ml_bb, mc)
        ml = _wrap32(_take(ml_cb, mc) + read_at(rem, mlb))
        rem -= mlb
        lc = ll_e & 0xFF
        llb = _take(ll_bb, lc)
        ll = _wrap32(_take(ll_cb, lc) + read_at(rem, llb))
        rem -= llb
        # Repeat-offset resolution (RFC 8878 3.1.1.3.2.1.1): an index
        # outside 1..4 resolves to 0 and moves nothing (the reference's
        # jnp.select default).
        idx = ofv + (1 if ll == 0 else 0)
        off_rep = (r1 if idx == 1 else r2 if idx == 2 else r3 if idx == 3
                   else _wrap32(r1 - 1) if idx == 4 else 0)
        off = _wrap32(ofv - 3) if ofv > 3 else off_rep
        mv12 = ofv > 3 or idx >= 2
        mv3 = ofv > 3 or idx in (3, 4)
        r1, r2, r3 = (off if mv12 else r1, r1 if mv12 else r2, r2 if mv3 else r3)
        # State updates (skipped for the final sequence).
        if i + 1 < n:
            for e, which in ((ll_e, 0), (ml_e, 1), (of_e, 2)):
                nb = (e >> 8) & 0xFF
                s2 = _wrap32((e >> 16) + read_at(rem, nb))
                rem -= nb
                if which == 0:
                    ll_s = s2
                elif which == 1:
                    ml_s = s2
                else:
                    of_s = s2
        lls[i], mls[i], offs[i], ofvs[i] = ll, ml, off, ofv
        hasrep |= ofv <= 3 and not (ofv == 1 and ll > 0 and i >= 1)
    return lls, mls, offs, ofvs, (r1, r2, r3), hasrep


def fse_decode_plain(words, start_bits, n_seq, tidx, tables, logs, consts, seq_bound: int):
    """The FSE sequence decode (see ``fse_decode_sequences``) over Python
    ints, one block at a time."""
    wnp = words.cpu().numpy().view(np.uint32)
    tab = tables.cpu().numpy().tolist()
    lg = logs.cpu().tolist()
    c = consts.reshape(4, 64).cpu().tolist()
    T = len(tab)
    cols = [[] for _ in range(6)]
    for b, (start, n, t3) in enumerate(zip(start_bits.tolist(), n_seq.tolist(),
                                           tidx.tolist())):
        tl, to, tm = (min(max(t + T if t < 0 else t, 0), T - 1) for t in t3)
        res = _decode_block(wnp[b].tolist(), start, n, tab[tl], tab[to][:256], tab[tm],
                            (lg[tl], lg[to], lg[tm]), c, seq_bound)
        for col, v in zip(cols, res):
            col.append(v)
    dev = words.device
    out = [torch.tensor(col, dtype=torch.int32, device=dev).reshape(-1, seq_bound)
           for col in cols[:4]]
    reps = torch.tensor(cols[4], dtype=torch.int32, device=dev).reshape(-1, 3)
    hasrep = torch.tensor(cols[5], dtype=torch.bool, device=dev)
    return (*out, reps, hasrep)


def stage_words(WB: int) -> int:
    """Bitstream words the kernel stages per block for rows of ``WB``
    words: the whole row, up to ``STAGE_WORDS`` rounded down to a multiple
    of 4 (at least 4)."""
    return min(WB, max(4, STAGE_WORDS // 4 * 4))


def staged_whole(start_bits, WB: int):
    """bool[B]: rows whose valid walk reads only the words staged at the
    start. A walk reads no word above ``(start_bits >> 5) + 1`` (its
    position never rises); other rows slide the window down as they go."""
    top = ((start_bits.to(torch.int64) >> 5) + 2).clamp(1, WB)
    return top <= stage_words(WB)


def fse_decode_sequences(words, start_bits, n_seq, tidx, tables, logs, consts, *,
                         seq_bound: int):
    """Decode every block's FSE sequence stream.

    words int32[B, WB] (the stream's LE uint32 words); start_bits, n_seq
    int32[B]; tidx int32[B, 3] (ll, of, ml rows of ``tables``); tables
    int32[T, 512] (symbol | nb_bits << 8 | baseline << 16); logs int32[T]
    (accuracy logs); consts int32[4, 64] (LL_BASE, LL_BITS, ML_BASE,
    ML_BITS). Returns (lls, mls, offs, ofvs) int32[B, seq_bound] (valid
    prefix n_seq, padded with (0, 0, 1, 4); offs resolved against a fresh
    (1, 4, 8) repeat history), reps int32[B, 3] (the final history) and
    hasrep bool[B] (a repeat form that may depend on an earlier block)."""
    if words.device.type == "cpu":
        return fse_decode_plain(words, start_bits, n_seq, tidx, tables, logs, consts,
                                seq_bound)
    for name, t in (("words", words), ("start_bits", start_bits), ("n_seq", n_seq),
                    ("tidx", tidx), ("tables", tables), ("logs", logs), ("consts", consts)):
        check_cuda(name, t)
    if tables.shape[-1] != 512 or consts.numel() != 256:
        raise ValueError("tables must be (T, 512) and consts (4, 64)")
    B, WB = words.shape
    if WB < 1 or tables.shape[0] < 1:
        raise ValueError("words and tables must have at least one row entry")
    dev = words.device
    lls, mls, offs, ofvs = (torch.empty((B, seq_bound), dtype=torch.int32, device=dev)
                            for _ in range(4))
    reps = torch.empty((B, 3), dtype=torch.int32, device=dev)
    hasrep = torch.empty(B, dtype=torch.int32, device=dev)
    fn = kernel_fn("zk_fse_seq_decode_launch",
                   [P, I, P, P, P, P, I, P, P, I, I, I, P, P, P, P, P, P, P])
    rc = fn(ptr(words), WB, ptr(start_bits), ptr(n_seq), ptr(tidx), ptr(tables),
            tables.shape[0], ptr(logs), ptr(consts), B, seq_bound, stage_words(WB), ptr(lls),
            ptr(mls), ptr(offs), ptr(ofvs), ptr(reps), ptr(hasrep), stream())
    launches["fse_decode"] += 1
    check_rc("fse_decode", rc)
    return lls, mls, offs, ofvs, reps, hasrep.bool()
