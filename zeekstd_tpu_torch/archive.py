"""Seekable archive encode (levels 1-19, patch mode) on the CUDA card, and
the decode entry points.

Port of the archive routes of ``zeekstd_tpu/tpu_archive.py``.

Encode (``compress_archive``):
  device  parse + per-block statistics, all frames: the match kernel
          (level 1, unless ``ZEEKSTD_TPU_MATCH=xla``) or the parallel
          parse with the chunked reachability kernels (every other level,
          prefix mode, and level 1 under ``=xla``)
  host    literal / sequence table decisions from the pulled statistics;
          frames whose parse overflowed are encoded on the host
  device  FSE kernel (sequence bitstreams) + Huffman literal streams
  host    byte-exact layout of every frame (run segments)
  device  assembly of the compressed frame rows

Decode (``decompress_archive``, ``decode_frames``, ``decompress_frame``):
  host    plan every frame (``plan.py``)
  then    ``decode_routes.decode_planned``: the fused route (the ring or
          wide decoder) by default, the serial or doubling route under
          ``ZEEKSTD_TPU_EXEC`` or past a fused-route guard
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import decode_routes
from . import plan as plan_mod
from .codec import frame as frame_mod
from .codec import huffman as huf
from .codec import literals as lit_mod
from .codec import sequences as seq_mod
from .codec.compress import compress_frame
from .codec.seq_encode import _choose_table, write_num_sequences
from .constants import ZSTD_BLOCK_SIZE_MAX
from .device import phase_timer, resolve_device, trace_range
from .native import fse_choice, loader
from .ops import assemble, entropy
from .ops import fse_kernel as fk
from .ops import match_kernel as mk
from .ops import match_tpu as mt
from .plan import _plan_frame
from .plan import checksum as content_checksum
from .seek_table import SeekTable

# The archive encoder cuts 32 KiB blocks unless ZEEKSTD_TPU_BLOCK names
# another size (read once, at import, as the reference reads it), up to
# the format's 128 KiB: each block is an independent FSE stream (and 4
# Huffman streams), so smaller blocks widen the batch. Above 32 KiB a
# sequence's ll and ml may pass 16 bits, so the FSE job rows carry them
# in rows of their own (``mk.wide_rows``).
BLOCK_SIZE = int(os.environ.get("ZEEKSTD_TPU_BLOCK", 32 << 10))
assert BLOCK_SIZE <= ZSTD_BLOCK_SIZE_MAX

MAX_FRAME_SIZE = 8 << 20   # the match kernel's largest frame row
WINDOW_CAP = 1 << 19       # match-kernel offsets stay inside 512 KiB


def empty_frame(checksum: bool) -> bytes:
    """The frame of an empty input: header, one empty last raw block, and
    XXH64("") when checksummed."""
    return compress_frame(b"", level=1, checksum=checksum)


# --------------------------------------------------------------- encode ---


class StagedInput:
    """Archive input staged on the device once, reusable across repeated
    compressions (input upload is then kept out of the timed runs)."""

    def __init__(self, data: bytes, frame_size: int, device=None):
        self.device = resolve_device(device)
        self.data = data
        self.frame_size = frame_size
        n = len(data)
        F = -(-n // frame_size)
        with trace_range("enc.input_rows"):
            frames = np.zeros((F, frame_size), np.uint8)
            lengths = np.zeros(F, np.int32)
            for i in range(F):
                chunk = data[i * frame_size : (i + 1) * frame_size]
                frames[i, : len(chunk)] = np.frombuffer(chunk, np.uint8)
                lengths[i] = len(chunk)
        self.lengths = lengths
        with phase_timer("enc.input_stage") as _pt:
            self.frames_dev = torch.from_numpy(frames).to(self.device)
            _pt.fence(self.frames_dev)


def _match_stats_packed_fn(frames_dev, meta, seq_bound: int, B: int, F: int):
    """Parse every frame with the match kernel; returns (literal rows
    uint8[F, frame_size] block-strided, stats int32[F, cols], lm, ofv,
    ml): the FSE job rows, packed (``ml`` None) or wide (``lm`` the ll).

    Same contract as the reference: the per-frame literal array is
    BLOCK-STRIDED (block b's literals at [b*BLOCK_SIZE, +litcnt_b)) and
    the stats row carries B ``extrep`` columns after the histograms."""
    dev = frames_dev.device
    frame_size = frames_dev.shape[1]
    SBd = BLOCK_SIZE // 4
    BLKW = BLOCK_SIZE // 4
    NRECP = meta.shape[0]
    # Little-endian words: reinterpret the byte rows, then pad to the
    # record bucket.
    words = frames_dev.contiguous().view(torch.int32).reshape(-1)
    words = torch.nn.functional.pad(words, (0, NRECP * BLKW - words.shape[0]))
    consts = torch.from_numpy(fk.make_consts()).to(dev)
    lm, ofv, litw, stat, *ml = mk.match(consts, meta, words, BLK=BLOCK_SIZE, SBd=SBd,
                                        n_frames=F)

    statf = stat[: F * B].reshape(F, B, 512)
    nseq_b = statf[:, :, mk.ST_NSEQ]
    mlsum_b = statf[:, :, mk.ST_MLSUM]
    litcnt_b = statf[:, :, mk.ST_LITCNT]
    extrep_b = statf[:, :, mk.ST_EXTREP]
    ovf_b = statf[:, :, mk.ST_OVERFLOW]
    n_seq = nseq_b.sum(dim=1, dtype=torch.int32)
    first = torch.cumsum(nseq_b, dim=1, dtype=torch.int32) - nseq_b
    n_lit = litcnt_b.sum(dim=1, dtype=torch.int32)
    over = (n_seq > seq_bound) | (ovf_b.sum(dim=1) > 0)
    n_raw = torch.where(over, seq_bound + 1, n_seq)
    lits = litw[: F * B].reshape(F, B * BLKW).view(torch.uint8).reshape(F, frame_size)
    first_idx = torch.where(nseq_b > 0, first, seq_bound)
    stats = torch.cat([
        torch.stack([n_seq, n_lit, n_raw], dim=1),
        nseq_b, first_idx, mlsum_b, litcnt_b,
        statf[:, :, mk.ST_LLHIST : mk.ST_LLHIST + 36].reshape(F, -1),
        statf[:, :, mk.ST_MLHIST : mk.ST_MLHIST + 53].reshape(F, -1),
        statf[:, :, mk.ST_OFHIST : mk.ST_OFHIST + 32].reshape(F, -1),
        statf[:, :, mk.ST_LITHIST : mk.ST_LITHIST + 256].reshape(F, -1),
        extrep_b,
    ], dim=1)
    return lits, stats, lm, ofv, (ml[0] if ml else None)


def _seq_codes(adj_ll, mls, ovs):
    """The literal-length, match-length and offset codes (int64) of the
    parse's (block-clamped) literal lengths, match lengths and offset
    values."""
    dev = adj_ll.device
    ll_base = torch.from_numpy(seq_mod.LL_BASE.astype(np.int64)).to(dev)
    ml_base = torch.from_numpy(seq_mod.ML_BASE.astype(np.int64)).to(dev)
    ll_codes = torch.where(
        adj_ll < 16, adj_ll,
        torch.searchsorted(ll_base, adj_ll.contiguous(), right=True) - 1)
    ml_codes = torch.where(
        mls < 35, torch.clamp(mls - 3, min=0),
        torch.searchsorted(ml_base, mls.contiguous(), right=True) - 1)
    of_codes = mt.bit_length(torch.clamp(ovs, min=1)) - 1
    return ll_codes, ml_codes, of_codes


def _stats_tail(lls, mls, offs, n_seq, lits, n_lit, n_raw, n_valid, seq_bound: int, B: int):
    """Per-frame code derivation and per-block statistics from the
    parallel parse's triples (rows = frames). Takes true (cross-block)
    literal runs and clamps the first ll of each block itself (adj_ll).
    Returns (adj_ll, mls, ovs int64[F, seq_bound], packed stats int32[F, cols])."""
    dev = lls.device
    F = lls.shape[0]
    lls, mls, offs = lls.long(), mls.long(), offs.long()
    n_seq = n_seq.long()
    sidx = torch.arange(seq_bound, dtype=torch.int64, device=dev)[None, :]
    valid = sidx < n_seq[:, None]
    out_len = lls + mls
    starts = torch.cumsum(out_len, dim=1) - out_len
    mstarts = starts + lls
    blk = torch.clamp(mstarts // BLOCK_SIZE, 0, B - 1)
    adj_ll = mstarts - torch.maximum(starts, blk * BLOCK_SIZE)
    # Same-block rep1 coding over the WRITTEN (block-clamped) lls.
    ovs = mt.rep1_offset_values(lls, adj_ll, mls, offs, n_seq, BLOCK_SIZE, seq_bound)
    ll_codes, ml_codes, of_codes = _seq_codes(adj_ll, mls, ovs)

    def block_sum(idx, vals, size, fill=0, reduce=None):
        """Scatter into ``size`` bins plus one sink bin (dropped)."""
        out = torch.full((F, size + 1), fill, dtype=torch.int64, device=dev)
        if reduce is None:
            out = out.scatter_add(1, idx, vals)
        else:
            out = out.scatter_reduce(1, idx, vals, reduce, include_self=True)
        return out[:, :size]

    one = valid.long()
    tgt = torch.where(valid, blk, B)
    seq_cnt = block_sum(tgt, one, B)
    first_idx = block_sum(tgt, torch.where(valid, sidx, seq_bound).expand(F, -1), B,
                          fill=seq_bound, reduce="amin")
    ml_sum = block_sum(tgt, torch.where(valid, mls, 0), B)
    ll_hist = block_sum(torch.where(valid, blk * 36 + ll_codes, B * 36), one, B * 36)
    ml_hist = block_sum(torch.where(valid, blk * 53 + ml_codes, B * 53), one, B * 53)
    of_hist = block_sum(torch.where(valid, blk * 32 + of_codes, B * 32), one, B * 32)

    # Literal-to-block assignment: block b holds litcnt_b = block_len_b -
    # ml_sum_b literal bytes, in stream order.
    bi = torch.arange(B, dtype=torch.int64, device=dev)[None, :]
    block_len = torch.clamp(n_valid.long()[:, None] - bi * BLOCK_SIZE, 0, BLOCK_SIZE)
    litcnt = block_len - ml_sum
    litcum = torch.cumsum(litcnt, dim=1)
    lidx = torch.arange(lits.shape[1], dtype=torch.int64, device=dev)[None, :]
    lit_blk = torch.searchsorted(litcum, lidx.expand(F, -1).contiguous(), right=True)
    lit_valid = lidx < n_lit.long()[:, None]
    lit_hist = block_sum(
        torch.where(lit_valid, torch.clamp(lit_blk, 0, B - 1) * 256 + lits.long(), B * 256),
        lit_valid.long().expand(F, -1), B * 256)

    stats = torch.cat([
        torch.stack([n_seq, n_lit.long(), n_raw.long()], dim=1),
        seq_cnt, first_idx, ml_sum, litcnt, ll_hist, ml_hist, of_hist, lit_hist,
    ], dim=1).to(torch.int32)
    return adj_ll, mls, ovs, stats


def _parse_stats_packed_fn(frames_dev, lengths, seq_bound: int, B: int, level: int,
                           prefix_len: int = 0):
    """Parse every frame row with the parallel parse and derive its
    statistics. Rows are prefix‖frame when ``prefix_len`` > 0 (patch
    mode: sequences may reference the prefix). Returns (literal rows
    uint8[F, n] compacted per frame, stats int32[F, cols], adj_ll, mls,
    ovs int64[F, seq_bound])."""
    dev = frames_dev.device
    n_valid = torch.from_numpy(np.asarray(lengths, np.int64)).to(dev)
    lls, mls, offs, n_seq, lits, n_lit, n_raw = mt.parse_frame(
        frames_dev, BLOCK_SIZE, seq_bound, n_valid=prefix_len + n_valid, level=level,
        start=prefix_len,
    )
    adj_ll, mls, ovs, stats = _stats_tail(lls, mls, offs, n_seq, lits, n_lit, n_raw,
                                          n_valid, seq_bound, B)
    return lits, stats, adj_ll, mls, ovs


def _parse_job_rows(adj_ll, mls, ovs, seq_cnt, first_idx, B: int):
    """The FSE kernel's per-record rows from the parallel parse: record
    f*B + b holds block b's sequences of frame f, zero past the block's
    count. Returns (lm, ofv, ml). Up to 32 KiB blocks both lengths fit 16
    bits (a literal run ends before its block does, and a match is at
    most the block), so lm = adj_ll << 16 | ml and ``ml`` is None; above
    (``mk.wide_rows``) lm holds adj_ll and ml the match lengths, the FSE
    kernel's wide layout."""
    dev = adj_ll.device
    F, seq_bound = adj_ll.shape
    SBd = BLOCK_SIZE // 4
    k = torch.arange(SBd, dtype=torch.int64, device=dev)
    first = torch.from_numpy(np.asarray(first_idx, np.int64)).to(dev)
    cnt = torch.from_numpy(np.asarray(seq_cnt, np.int64)).to(dev)
    idx = torch.clamp(first[:, :, None] + k, max=seq_bound - 1).reshape(F, B * SBd)
    live = (k < cnt[:, :, None]).reshape(F, B * SBd)

    def rows(v):
        v = torch.where(live, torch.gather(v, 1, idx), 0)
        return v.to(torch.int32).reshape(F * B, SBd).contiguous()

    if mk.wide_rows(BLOCK_SIZE):
        return rows(adj_ll), rows(ovs), rows(mls)
    return rows((adj_ll << 16) | mls), rows(ovs), None


def _unpack_stats(stats_np, B):
    """Host twin of the stats packing."""
    o = 0

    def take(k, shape=None):
        nonlocal o
        v = stats_np[:, o : o + k]
        o += k
        return v if shape is None else v.reshape((stats_np.shape[0],) + shape)

    head = take(3)
    out = {
        "n_seq": head[:, 0], "n_lit": head[:, 1], "n_raw": head[:, 2],
        "seq_cnt": take(B), "first_idx": take(B), "ml_sum": take(B),
        "litcnt": take(B),
        "ll_hist": take(B * 36, (B, 36)), "ml_hist": take(B * 53, (B, 53)),
        "of_hist": take(B * 32, (B, 32)), "lit_hist": take(B * 256, (B, 256)),
    }
    if o < stats_np.shape[1]:
        out["extrep"] = take(B)
    return out


def _host_jobs(
    F, lengths, overflow, seq_cnt, first_idx, litcnt,
    ll_hist, ml_hist, of_hist, lit_hist,
    lit_stride=None, extrep=None,
):
    """Per-block host decisions from the pulled device stats: block
    descriptors, Huffman literal jobs (with trees/tables), and FSE sequence
    jobs (with chosen symbol tables).

    ``lit_stride``: block-strided literal rows (block b's literals start
    at b*lit_stride). ``extrep``: per-block flags marking rep codes that
    read history inherited from earlier blocks (_plan_block's demotion
    cascade).
    """
    blocks = []  # descriptors for device-encoded blocks
    with trace_range("enc.host_decisions.blocks"):
        for f in range(F):
            if overflow[f]:
                continue
            n_blocks_f = -(-int(lengths[f]) // BLOCK_SIZE)
            lit_lo = 0
            for b in range(n_blocks_f):
                b_len = min(BLOCK_SIZE, int(lengths[f]) - b * BLOCK_SIZE)
                if lit_stride is not None:
                    lit_lo = b * lit_stride
                desc = {
                    "frame": f, "block": b, "len": b_len,
                    "nseq": int(seq_cnt[f, b]), "first": int(first_idx[f, b]),
                    "lit_lo": lit_lo, "nlit": int(litcnt[f, b]),
                }
                if extrep is not None and extrep[f, b]:
                    desc["ext_rep"] = True
                lit_lo += int(litcnt[f, b])
                blocks.append(desc)

    # Literal mode decisions + Huffman tables. Blocks reuse the previous
    # block's tree (Treeless_Literals_Block, RFC 8878 3.1.1.1) when its
    # code lengths price the new histogram no worse than a fresh tree plus
    # its serialized weights. tree_id tracks which emitted tree a treeless
    # block depends on so _plan_block can demote safely.
    huf_jobs = []
    prev_tree = {}  # frame -> (tree_id, nb int64[256], codes256, nb256)
    tree_ids = iter(range(1, 1 << 30))
    with trace_range("enc.host_decisions.huf"):
        for d in blocks:
            f, b = d["frame"], d["block"]
            hist = lit_hist[f, b].astype(np.int64)
            nlit = d["nlit"]
            d["lit_mode"] = "raw"
            nz = np.nonzero(hist)[0]
            if nlit == 0:
                continue
            if len(nz) == 1:
                d["lit_mode"] = "rle"
                d["rle_byte"] = int(nz[0])
                continue
            if nlit < 64 or d["nseq"] == 0:
                continue

            est_reuse = None
            prev = prev_tree.get(f)
            if prev is not None and np.all(prev[1][nz] > 0):
                reuse_bits = int(np.dot(hist[nz], prev[1][nz]))
                est_reuse = 6 + (reuse_bits + 7) // 8 + 4 + 5

            tree = codes256n = nb256n = None
            est_new = None
            native_ht = loader.huf_table(hist)
            if native_ht is not None:
                tree, codes256n, nbu8 = native_ht
                nb256n = nbu8.astype(np.int32)
                stream_bits = int(np.dot(hist, nb256n.astype(np.int64)))
                est_new = len(tree) + 6 + (stream_bits + 7) // 8 + 4 + 5
            else:
                # The native code refused this histogram; the reference then
                # tries the Python table code, and so does the port.
                try:
                    freqs = {int(s): int(hist[s]) for s in nz}
                    lengths_map = huf.package_merge_lengths(freqs)
                    weights = huf.lengths_to_weights(lengths_map, int(nz.max()))
                    tree = huf.write_weights(weights)
                    codes, nb, _ = huf.build_encode_table(weights)
                    codes256n = np.zeros(256, np.uint32)
                    codes256n[: len(codes)] = codes
                    nb256n = np.zeros(256, np.int32)
                    nb256n[: len(nb)] = nb
                    stream_bits = int(
                        np.dot(hist[: len(nb)], np.asarray(nb, np.int64))
                    )
                    est_new = len(tree) + 6 + (stream_bits + 7) // 8 + 4 + 5
                except Exception:
                    pass

            if est_reuse is not None and (est_new is None or est_reuse <= est_new):
                if est_reuse >= nlit:
                    continue
                d["lit_mode"] = "huf"
                d["treeless"] = True
                d["tree"] = b""
                d["tree_id"] = prev[0]
                codes256, nb256 = prev[2], prev[3]
            elif est_new is not None and est_new < nlit:
                d["lit_mode"] = "huf"
                d["tree"] = tree
                d["tree_id"] = next(tree_ids)
                codes256 = codes256n
                nb256 = nb256n
                prev_tree[f] = (
                    d["tree_id"], nb256n.astype(np.int64), codes256, nb256,
                )
            else:
                continue
            seg = (nlit + 3) // 4
            segs = [seg, seg, seg, nlit - 3 * seg]
            d["huf_streams"] = []
            off = 0
            for sl in segs:
                d["huf_streams"].append(len(huf_jobs))
                huf_jobs.append((f, d["lit_lo"] + off, sl, codes256, nb256))
                off += sl

    # Sequence table choices from code histograms. Passing the previous
    # block's chosen table enables Repeat_Mode; tbl_id/dep_tbl_id let
    # _plan_block verify the emitted chain before honoring a repeat. The
    # native chooser makes every block's choices in one call; a block it
    # leaves (None) takes _choose_table, as every block does without it.
    fse_jobs = []
    prev_cat = {}  # (frame, cat) -> (tbl_id, enc_table)
    cat_ids = iter(range(1, 1 << 30))
    hists = (ll_hist, of_hist, ml_hist)
    with trace_range("enc.host_decisions.fse_tables"):
        seq_blocks = [d for d in blocks if d["nseq"] > 0]
        fi = np.array([d["frame"] for d in seq_blocks], np.int64)
        bi = np.array([d["block"] for d in seq_blocks], np.int64)
        native = fse_choice.choose_tables(fi, *(h[fi, bi] for h in hists))
        for d, row in zip(seq_blocks, native):
            f, b = d["frame"], d["block"]
            choices = {}
            d["tbl_id"] = {}
            d["dep_tbl_id"] = {}
            for c, (cat, norm, log, max_code, max_log) in enumerate(fse_choice.CATS):
                prev = prev_cat.get((f, cat))
                if row is None:
                    choice = _choose_table(
                        None, cat, norm, log, max_code, max_log,
                        prev_table=prev[1] if prev else None, hist=hists[c][f, b],
                    )
                elif row[c][0] == seq_mod.MODE_REPEAT:
                    choice = (seq_mod.MODE_REPEAT, prev[1], b"", row[c][3])
                else:
                    choice = row[c]
                choices[cat] = choice
                if choice[0] == seq_mod.MODE_REPEAT:
                    d["tbl_id"][cat] = prev[0]
                    d["dep_tbl_id"][cat] = prev[0]
                else:
                    tid = next(cat_ids)
                    d["tbl_id"][cat] = tid
                    prev_cat[(f, cat)] = (tid, choice[1])
            d["tables"] = choices
            d["fse_job"] = len(fse_jobs)
            fse_jobs.append(d)
    return blocks, huf_jobs, fse_jobs


def _fse_kernel_inputs(fse_jobs, B: int):
    """Stage the FSE job batch: flat job meta + packed encode-table rows,
    deduped across Repeat_Mode blocks."""
    J = len(fse_jobs)
    NRECJ = fk.bucket_nrecj(J)
    meta = np.zeros((NRECJ, fk.JMETA_COLS), np.int32)
    rows = [np.zeros(1024, np.int32)]  # row 0: dummy for padded jobs
    row_of = {}

    def table_row(t):
        k = id(t)
        if k not in row_of:
            dnb = np.zeros(64, np.int32); dnb[: len(t.delta_nb_bits)] = t.delta_nb_bits
            dfs = np.zeros(64, np.int32); dfs[: len(t.delta_find_state)] = t.delta_find_state
            stt = np.asarray(t.state_table, np.int32)
            row_of[k] = len(rows)
            rows.append(fk.pack_enc_table(dnb, dfs, stt))
        return row_of[k]

    for j, d in enumerate(fse_jobs):
        meta[j, fk.J_REC] = d["frame"] * B + d["block"]
        meta[j, fk.J_NSEQ] = d["nseq"]
        meta[j, fk.J_TLL] = table_row(d["tables"]["ll"][1])
        meta[j, fk.J_TOF] = table_row(d["tables"]["of"][1])
        meta[j, fk.J_TML] = table_row(d["tables"]["ml"][1])
        meta[j, fk.J_LOGS] = (
            d["tables"]["ll"][1].accuracy_log
            | d["tables"]["of"][1].accuracy_log << 5
            | d["tables"]["ml"][1].accuracy_log << 10
        )
    Tp = 1 << max((len(rows) - 1).bit_length(), 1)
    pool = np.zeros((Tp, 1024), np.int32)
    pool[: len(rows)] = np.stack(rows)
    return meta, pool, NRECJ


def _huf_inputs(huf_jobs, seg_bound: int | None = None, pad_to: int | None = None):
    """Stage the Huffman job batch (padded by replicating job 0)."""
    if seg_bound is None:
        seg_bound = 1 << max(max(j[2] for j in huf_jobs) - 1, 1).bit_length()
    word_bound = (seg_bound * 12) // 32 + 8
    NJ = len(huf_jobs)
    NJp = pad_to if pad_to is not None else 1 << max((NJ - 1).bit_length(), 3)

    def padjobs(a, dtype=np.int32):
        a = np.asarray(a, dtype)
        return np.concatenate([a, np.repeat(a[:1], NJp - NJ, axis=0)])

    out = {
        "fidx": padjobs([j[0] for j in huf_jobs]),
        "starts": padjobs([j[1] for j in huf_jobs]),
        "ns": padjobs([j[2] for j in huf_jobs]),
        "codes": padjobs(np.stack([j[3] for j in huf_jobs]), np.uint32),
        "nbs": padjobs(np.stack([j[4] for j in huf_jobs])),
    }
    return out, seg_bound, word_bound


def _huf_streams(lits_d, hin, seg_bound: int, word_bound: int):
    """Every Huffman literal stream in one batch: slice each job's
    segment out of its frame's literal row (the start clamps so the slice
    fits, like ``lax.dynamic_slice``), then encode."""
    dev = lits_d.device
    row_len = lits_d.shape[1]
    fidx = torch.from_numpy(hin["fidx"].astype(np.int64)).to(dev)
    starts = torch.from_numpy(hin["starts"].astype(np.int64)).to(dev)
    starts = starts.clamp(0, max(row_len - seg_bound, 0))
    k = torch.arange(seg_bound, dtype=torch.int64, device=dev)
    flat = (fidx * row_len + starts)[:, None] + k[None, :]
    segs = lits_d.reshape(-1)[flat]
    return entropy.huffman_encode_streams(
        segs, torch.from_numpy(hin["ns"]).to(dev),
        torch.from_numpy(hin["codes"].astype(np.int64)).to(dev),
        torch.from_numpy(hin["nbs"]).to(dev), word_bound,
    )


def _entropy_fn(meta_j, lm, ofv, ml, pool, lits_d, hin, seg_bound, hword_bound):
    """Both entropy stages of the encode path: the FSE kernel (its wide
    layout when ``ml`` is given) and the batched Huffman stream encoder."""
    dev = lm.device
    SBd = BLOCK_SIZE // 4
    fse_words, fse_bits = fk.fse_encode(
        torch.from_numpy(fk.make_consts()).to(dev),
        torch.from_numpy(meta_j).to(dev), lm, ofv,
        torch.from_numpy(pool).to(dev), SBd=SBd, WBo=fk.word_bound(SBd), ml=ml,
    )
    huf_words = huf_bits = None
    if hin is not None:
        huf_words, huf_bits = _huf_streams(lits_d, hin, seg_bound, hword_bound)
    return fse_words, fse_bits, huf_words, huf_bits


def _layout_archive(
    datas, blocks, overflow, fse_bits, huf_bits,
    fse_byte_shape, huf_byte_shape, lits_shape, frames_shape,
    checksum: bool, prefix_len: int = 0, window_cap: int | None = None,
):
    """Byte-exact archive layout (host): one SegmentPlan over the frames
    ``datas`` (list of per-frame bytes). Frames whose parse overflowed
    are encoded on the host. Returns (plan, d_sizes)."""
    F = len(datas)
    plan = assemble.SegmentPlan(F, fse_byte_shape, huf_byte_shape, lits_shape,
                                frames_shape)
    d_sizes = []
    bi = 0
    for f in range(F):
        fdata = datas[f]
        flen = len(fdata)
        d_sizes.append(flen)
        if overflow[f]:
            plan.add_static(f, compress_frame(fdata, level=1, checksum=checksum))
            while bi < len(blocks) and blocks[bi]["frame"] == f:
                bi += 1
            continue
        if flen == 0:
            plan.add_static(f, empty_frame(checksum))
            continue
        # Declared window: match-kernel offsets are bounded by its 512 KiB
        # window, so its frames declare the tighter bound (ring-route
        # decode); the parallel parse reaches the whole frame and prefix.
        window = flen + prefix_len
        if window_cap is not None:
            window = min(window, window_cap)
        plan.add_static(
            f, frame_mod.write_frame_header(flen, max(window, 1024), checksum)
        )
        n_blocks_f = -(-flen // BLOCK_SIZE)
        emit_state = {"tree_id": None, "fse_ids": {}}
        for b in range(n_blocks_f):
            d = blocks[bi]
            assert d["frame"] == f and d["block"] == b
            bi += 1
            last = b == n_blocks_f - 1
            _plan_block(plan, d, f, b, last, fdata, fse_bits, huf_bits,
                        emit_state, prefix_len)
        if checksum:
            plan.add_static(f, content_checksum(fdata).to_bytes(4, "little"))
    return plan, d_sizes


def _stream_len(bits: int) -> int:
    """Backward-stream byte length incl. sentinel."""
    return int(bits) // 8 + 1


def _plan_block(plan, d, f, b, last, fdata, fse_bits, huf_bits, emit_state,
                prefix_len: int = 0):
    """Lay out one block's output segments. Every section length is
    host-exact here (stream byte counts come from the pulled bit counts),
    so raw-vs-compressed is decided exactly like the host encoder.

    ``emit_state`` tracks which Huffman tree / FSE tables have actually
    been EMITTED so far in this frame: a treeless or Repeat_Mode block
    whose assumed predecessor was demoted to a raw block must demote too."""
    blen = d["len"]
    raw_block_off = b * BLOCK_SIZE
    nlit = d["nlit"]

    # Rep-history cascade: once a sequence-bearing block of this frame was
    # demoted to raw, the decoder's repeat-offset history diverges from
    # what the parse assumed, so any later block whose rep codes read
    # INHERITED history (ext_rep) must demote too.
    rep_ok = not (d.get("ext_rep") and emit_state.get("rep_broken"))

    body_len = None
    if d["nseq"] > 0 and d.get("slice_shift", 0) == 0 and rep_ok:
        mode = d["lit_mode"]
        treeless = bool(d.get("treeless"))
        if mode == "huf" and treeless and emit_state["tree_id"] != d["tree_id"]:
            mode = "raw"  # defining tree was demoted; reference would dangle
        if mode == "huf":
            parts = [_stream_len(huf_bits[sj]) for sj in d["huf_streams"]]
            if any(p > 0xFFFF for p in parts[:3]):
                mode = "raw"
            else:
                payload_len = len(d["tree"]) + 6 + sum(parts)
                try:
                    hdr = lit_mod.write_literals_header(
                        lit_mod.LIT_TREELESS if treeless else lit_mod.LIT_COMPRESSED,
                        nlit, payload_len, True,
                    )
                except Exception:
                    mode = "raw"
        if mode == "huf":
            jump = b"".join(p.to_bytes(2, "little") for p in parts[:3])
            sec_len = len(hdr) + payload_len

            def emit_lits(hdr=hdr, jump=jump, parts=parts):
                plan.add_static(f, hdr + d["tree"] + jump)
                for sj, p in zip(d["huf_streams"], parts):
                    plan.add_huf(f, sj, p)

        elif mode == "rle":
            hdr = lit_mod.write_literals_header(lit_mod.LIT_RLE, nlit, 0, False)
            sec_len = len(hdr) + 1

            def emit_lits(hdr=hdr):
                plan.add_static(f, hdr + bytes([d["rle_byte"]]))

        else:
            hdr = lit_mod.write_literals_header(lit_mod.LIT_RAW, nlit, 0, False)
            sec_len = len(hdr) + nlit

            def emit_lits(hdr=hdr):
                plan.add_static(f, hdr)
                plan.add_lits(f, f, d["lit_lo"], nlit)

        # Sequences section layout. A Repeat_Mode table is honored only
        # when the table it repeats is the one actually emitted so far.
        for cat in ("ll", "of", "ml"):
            dep = d.get("dep_tbl_id", {}).get(cat)
            if dep is not None and emit_state["fse_ids"].get(cat) != dep:
                body_len = None
                break
        else:
            seq_static = bytearray(write_num_sequences(d["nseq"]))
            ll_mode, of_mode, ml_mode = (
                d["tables"]["ll"][0], d["tables"]["of"][0], d["tables"]["ml"][0]
            )
            seq_static.append((ll_mode << 6) | (of_mode << 4) | (ml_mode << 2))
            seq_static += d["tables"]["ll"][2] + d["tables"]["of"][2] + d["tables"]["ml"][2]
            fse_len = _stream_len(fse_bits[d["fse_job"]])
            body_len = sec_len + len(seq_static) + fse_len

    if body_len is None or body_len >= blen:
        # Raw / RLE fallback block.
        if d["nseq"] > 0:
            emit_state["rep_broken"] = True
        first = fdata[raw_block_off : raw_block_off + 1]
        if blen > 0 and fdata.count(first, raw_block_off, raw_block_off + blen) == blen:
            plan.add_static(
                f,
                frame_mod.write_block_header(last, frame_mod.BLOCK_RLE, blen) + first,
            )
        else:
            plan.add_static(
                f, frame_mod.write_block_header(last, frame_mod.BLOCK_RAW, blen)
            )
            # With a prefix the frame's bytes start prefix_len into its row.
            plan.add_raw(f, f, prefix_len + raw_block_off, blen)
        return

    plan.add_static(
        f, frame_mod.write_block_header(last, frame_mod.BLOCK_COMPRESSED, body_len)
    )
    emit_lits()
    plan.add_static(f, bytes(seq_static))
    plan.add_fse(f, d["fse_job"], fse_len)
    if mode == "huf" and not treeless and "tree_id" in d:
        emit_state["tree_id"] = d["tree_id"]
    for cat in ("ll", "of", "ml"):
        tid = d.get("tbl_id", {}).get(cat)
        if tid is not None:
            emit_state["fse_ids"][cat] = tid


def _assemble_jit(seg_dest, seg_base, c_sizes, frame_bound, static_pool,
                  fse_words, fse_bits, huf_words, huf_bits, lits, frames):
    """Device assembly: finalize both stream batches and gather the rows."""
    return assemble.assemble_archive_runs(
        seg_dest, seg_base, c_sizes, frame_bound, static_pool,
        assemble.finalize_streams(fse_words, fse_bits),
        assemble.finalize_streams(huf_words, huf_bits), lits, frames,
    )


def match_route(level: int, frame_size: int, n_frames: int, prefix_len: int = 0) -> bool:
    """Whether an archive parses on the match kernel: the reference's rule
    (level 1, a frame size that is a multiple of ``BLOCK_SIZE`` and at most
    8 MiB, under 2 GiB in all, no prefix) with ``ZEEKSTD_TPU_MATCH`` read
    at each call. The card stands in for the reference's TPU backend, so
    unset and ``=kernel`` take the kernel on every device and ``=xla`` the
    parallel parse (the reference's default off a TPU)."""
    return (
        level == 1
        and frame_size % BLOCK_SIZE == 0
        and frame_size <= MAX_FRAME_SIZE
        and n_frames * frame_size < (1 << 31)
        and prefix_len == 0
        and os.environ.get("ZEEKSTD_TPU_MATCH", "") != "xla"
    )


def compress_archive(
    data,
    frame_size: int = 2 << 20,
    checksum: bool = False,
    return_device: bool = False,
    level: int = 3,
    prefix: bytes = b"",
    frame_spans=None,
    device=None,
    *,
    _route_frames: int | None = None,
):
    """Compress ``data`` (bytes, or a ``StagedInput``) into seekable frames
    at ``level`` (1-19); returns (frames_blob, SeekTable), byte-identical
    to the reference's ``tpu_compress_archive`` under the same
    ``ZEEKSTD_TPU_MATCH``.

    Route, as the reference chooses it (``match_route``): level 1 takes
    the match kernel unless ``ZEEKSTD_TPU_MATCH=xla``, the frame size or
    the prefix rules it out; everything else the parallel parse
    (``ops/match_tpu.py``). Frames whose parse overflows the sequence
    bound are encoded on the host (``codec/compress.py``, level 1).
    ``_route_frames`` is private to the mesh: the frame count the route
    rule reads in place of this call's (the shards' padded count, as the
    reference's mesh decides once for every shard).

    ``prefix`` enables patch mode: every frame may reference it, like
    zstd's ref_prefix. The parse needs block alignment, so only the last
    floor(len/BLOCK_SIZE) blocks of the prefix are searched (a decoder
    given the whole prefix sees the same bytes at those offsets).

    A ``ZEEKSTD_TPU_BLOCK`` the reference cannot run fails as it fails
    there: 0 with ZeroDivisionError, a negative size with ValueError on
    the match-kernel route and TypeError on the parse's, a size that is
    not a multiple of 4 KiB on the match-kernel route with
    AssertionError (``mk.match``); over 128 KiB, or not a number, the
    import fails.

    With ``return_device=True`` the final pull is skipped and
    (device rows uint8[F, frame_bound], c_sizes, SeekTable) is returned.
    ``frame_spans``: explicit per-frame (start, len) byte spans of
    ``data`` instead of uniform ``frame_size`` slicing.
    """
    staged = data if isinstance(data, StagedInput) else None
    if staged is not None:
        if staged.frame_size != frame_size:
            raise ValueError("StagedInput frame_size mismatch")
        if device is None:
            device = staged.device
        data = staged.data
    dev = resolve_device(device)
    plen = (len(prefix) // BLOCK_SIZE) * BLOCK_SIZE
    prefix_c = prefix[len(prefix) - plen :] if plen else b""
    if plen and staged is not None:
        raise ValueError("StagedInput cannot carry a prefix")
    if frame_spans is not None and (plen or staged is not None):
        raise ValueError("frame_spans cannot combine with prefix/StagedInput")
    n = len(data)
    if n == 0:
        blob = empty_frame(checksum)
        st = SeekTable()
        st.log_frame(len(blob), 0)
        return blob, st

    if frame_spans is not None:
        F = len(frame_spans)
        frame_size = -(-max(l for _s, l in frame_spans) // BLOCK_SIZE) * BLOCK_SIZE
    else:
        F = -(-n // frame_size)
    B = -(-frame_size // BLOCK_SIZE)
    seq_bound = min(1 << 18, max(2048, frame_size // 8))
    use_match_kernel = match_route(level, frame_size, _route_frames or F, plen)
    if BLOCK_SIZE < 0:
        raise (ValueError if use_match_kernel else TypeError)(
            f"ZEEKSTD_TPU_BLOCK={BLOCK_SIZE}: a block size cannot be negative")

    if frame_spans is not None or plen:
        # Rows are prefix||frame in patch mode (the prefix is referenced
        # again at every frame start).
        rows = np.zeros((F, plen + frame_size), np.uint8)
        rows[:, :plen] = np.frombuffer(prefix_c, np.uint8)
        lengths = np.zeros(F, np.int32)
        spans = frame_spans or [(i * frame_size, min(frame_size, n - i * frame_size))
                                for i in range(F)]
        for i, (s, l) in enumerate(spans):
            rows[i, plen : plen + l] = np.frombuffer(data[s : s + l], np.uint8)
            lengths[i] = l
        with phase_timer("enc.input_stage") as _pt:
            frames_dev = torch.from_numpy(rows).to(dev)
            _pt.fence(frames_dev)
    else:
        if staged is None:
            staged = StagedInput(data, frame_size, device=dev)
        frames_dev = staged.frames_dev
        lengths = staged.lengths
    frames_shape = tuple(frames_dev.shape)

    # --- parse + stats ---------------------------------------------------
    with phase_timer("enc.parse_dispatch") as _pt:
        if use_match_kernel:
            meta_mk = mk.build_records(
                F, B, BLOCK_SIZE, frame_size, lengths, n_pad=mk.bucket_nrecp(F * B),
            )
            lits_d, stats_d, lm, ofv, ml = _match_stats_packed_fn(
                frames_dev, torch.from_numpy(meta_mk).to(dev), seq_bound, B, F,
            )
        else:
            lits_d, stats_d, adj_ll, mls_d, ovs_d = _parse_stats_packed_fn(
                frames_dev, lengths, seq_bound, B, level, prefix_len=plen,
            )
        _pt.fence(stats_d)

    with phase_timer("enc.stats_pull"):
        stats = _unpack_stats(stats_d.cpu().numpy(), B)

    # Frames whose parse overflowed are encoded on the host.
    overflow = stats["n_raw"] > seq_bound

    # --- host: per-block decisions ---------------------------------------
    with phase_timer("enc.host_decisions"):
        blocks, huf_jobs, fse_jobs = _host_jobs(
            F, lengths, overflow, stats["seq_cnt"], stats["first_idx"],
            stats["litcnt"], stats["ll_hist"], stats["ml_hist"],
            stats["of_hist"], stats["lit_hist"],
            lit_stride=BLOCK_SIZE if use_match_kernel else None,
            extrep=stats.get("extrep"),
        )

    # --- entropy: FSE kernel + Huffman streams ---------------------------
    fse_words = fse_bits = huf_words = huf_bits = None
    with phase_timer("enc.fse_dispatch") as _pt:
        if fse_jobs:
            if not use_match_kernel:
                lm, ofv, ml = _parse_job_rows(adj_ll, mls_d, ovs_d, stats["seq_cnt"],
                                              stats["first_idx"], B)
            meta_j, pool, _ = _fse_kernel_inputs(fse_jobs, B)
            hin = seg_bound = hword_bound = None
            if huf_jobs:
                hin, seg_bound, hword_bound = _huf_inputs(huf_jobs)
            fse_words, fse_bits, huf_words, huf_bits = _entropy_fn(
                meta_j, lm, ofv, ml, pool, lits_d, hin, seg_bound, hword_bound,
            )
            _pt.fence(fse_words)

    with phase_timer("enc.bits_pull"):
        if fse_bits is not None:
            fse_bits = fse_bits.cpu().numpy()
        if huf_bits is not None:
            huf_bits = huf_bits.cpu().numpy()

    # --- host layout -----------------------------------------------------
    with phase_timer("enc.plan_layout"):
        dummy_w = torch.zeros((1, 4), dtype=torch.int32, device=dev)
        if fse_words is None:
            fse_words, fse_bits = dummy_w, np.zeros(1, np.int32)
        if huf_words is None:
            huf_words, huf_bits = dummy_w, np.zeros(1, np.int32)
        if frame_spans is not None:
            datas = [data[s : s + l] for s, l in frame_spans]
        else:
            datas = [
                data[f * frame_size : f * frame_size + int(lengths[f])]
                for f in range(F)
            ]
        plan, d_sizes = _layout_archive(
            datas, blocks, overflow, fse_bits, huf_bits,
            (fse_words.shape[0], fse_words.shape[1] * 4),
            (huf_words.shape[0], huf_words.shape[1] * 4),
            tuple(lits_d.shape), frames_shape, checksum, prefix_len=plen,
            window_cap=WINDOW_CAP if use_match_kernel else None,
        )
        seg_dest, seg_base, static_pool, c_sizes = plan.build_runs()
        frame_bound = 1 << max((int(c_sizes.max()) - 1).bit_length(), 7)

    # --- device assembly -------------------------------------------------
    with phase_timer("enc.assemble_dispatch") as _pt:
        rows_dev = _assemble_jit(
            torch.from_numpy(seg_dest).to(dev), torch.from_numpy(seg_base).to(dev),
            torch.from_numpy(c_sizes).to(dev), frame_bound,
            torch.from_numpy(static_pool).to(dev),
            fse_words, torch.from_numpy(np.asarray(fse_bits, np.int32)).to(dev),
            huf_words, torch.from_numpy(np.asarray(huf_bits, np.int32)).to(dev),
            lits_d, frames_dev,
        )
        _pt.fence(rows_dev)

    st = SeekTable()
    for f in range(F):
        st.log_frame(int(c_sizes[f]), d_sizes[f])
    if return_device:
        return rows_dev, c_sizes, st

    with phase_timer("enc.blob_pull"):
        rows = rows_dev.cpu().numpy()
        blob = b"".join(rows[f, : c_sizes[f]].tobytes() for f in range(F))
    return blob, st


# --------------------------------------------------------------- decode ---


def decompress_archive(
    blob: bytes,
    seek_table=None,
    verify_checksum: bool = True,
    return_device: bool = False,
    device=None,
):
    """Decode a whole seekable archive on the route
    ``decode_routes.exec_mode`` selects (the serial route past a
    fused-route guard).

    With a ``seek_table`` the frame boundaries come from it; without one
    the frames are walked in order, skipping skippable frames. With
    ``return_device=True`` the output stays on the device and
    (uint8[F, out_bound], sizes) is returned."""
    dev = resolve_device(device)
    with phase_timer("dec.plan"):
        plans = plan_mod.plan_archive(blob, seek_table)
    if not plans:
        return b""
    return decode_routes.decode_planned(
        blob, plans, plan_mod.collect(plans), dev, route=decode_routes.exec_mode(),
        seek_table=seek_table, verify_checksum=verify_checksum, return_device=return_device)


def decode_frames(blob, spans, verify_checksum: bool = True, device=None):
    """Seekable random access: decode the frames at byte spans
    [(start, end), ...] of ``blob`` on the fused route, in launch groups
    (the serial route past a fused-route guard); returns a list of bytes,
    one per span."""
    dev = resolve_device(device)
    plans = [_plan_frame(blob, s) for s, _e in spans]
    return decode_routes.decode_planned(
        blob, plans, plan_mod.collect(plans), dev, verify_checksum=verify_checksum,
        return_parts=True)


def decompress_frame(frame: bytes, pos: int = 0, verify_checksum: bool = True,
                     prefix: bytes = b"", device=None):
    """Decode the one zstd frame at ``pos`` of ``frame``; returns (bytes,
    end_pos). ``prefix`` is zstd's ref_prefix: match offsets may reach
    before the frame into it (patch mode). The fused route by default;
    under ``ZEEKSTD_TPU_EXEC=serial`` or ``doubling`` the classic path
    (device Huffman and FSE decode, pointer doubling), which also takes
    the frames past a fused-route guard."""
    dev = resolve_device(device)
    with phase_timer("dec.plan"):
        hdr, plan, fpos = _plan_frame(frame, pos)
        plans = [(hdr, plan, fpos)]
        lay = plan_mod.collect(plans)
    route = "fused" if decode_routes.exec_mode() == "fused" else "doubling"
    out = decode_routes.decode_planned(
        frame, plans, lay, dev, route=route, fallback="doubling",
        verify_checksum=verify_checksum, prefixes=[prefix] if prefix else None)
    return out, fpos + (4 if hdr.has_checksum else 0)
