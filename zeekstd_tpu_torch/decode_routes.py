"""Every decode route: fused, serial and pointer doubling.

Port of the decode paths of ``zeekstd_tpu/tpu_archive.py``
(``tpu_decompress_archive``, ``_fused_exec_dispatch``, ``_huf_batch_dev``,
``_fse_batch_dev``, ``_serial_*``, ``_dec_exec_fn``) and of
``zeekstd_tpu/tpu_codec.tpu_decompress_frame``. ``decode_planned`` takes
planned frames (``plan.py``) down the route its caller names and, past a
fused-route guard, the caller's fallback; the ``archive`` entry points and
the mesh's ``parallel/pipeline`` call it and nothing else here.
``ZEEKSTD_TPU_EXEC`` (``exec_mode``) selects the serial or doubling route;
the fused route stays the default.

  fused     dec.huf_host (every Huffman literal stream, decoded on the
            host by the native runtime), dec.fused_layout (each frame's
            literal pool and record table), one dec.fused_exec per group
            of frames under ``plan.LAUNCH_BYTES`` that decodes every FSE
            stream and executes every sequence: the ring decoder when
            every declared window (and prefix) is at most 512 KiB, the
            wide decoder otherwise (``ZEEKSTD_TPU_RING=0`` forces it);
            then dec.fused_pull+verify (bad flag, literal count, content
            size, seek-table size, XXH64). Frames past one of the
            reference's guards (a prefix over 128 KiB, a frame bound over
            4 MiB off the ring route, a block bitstream over 16384 words,
            a raw block or literal budget over 128 KiB) take the fallback,
            counted with the reference's reason by ``count_fallback``.

The serial and doubling routes share two device dispatches:
  dec.huf_batch   every Huffman literal stream, decoded on the device by
                  bit reachability (``ops/huffman_spec.py``: torch glue and
                  the two reachability kernels), or by chunk speculation
                  (plain torch) under ``ZEEKSTD_TPU_HUF=spec``
  dec.fse_batch   every block's FSE sequence stream (the ``fse_decode``
                  kernel); repeat offsets resolved per block
Then:
  serial    dec.serial_layout (record table, literal segments), one
            ``exec`` kernel launch per group of frames under
            ``plan.LAUNCH_BYTES`` (repeat offsets threaded across blocks
            in the kernel), dec.serial_pull+verify. An
            archive whose blocks exceed the executor's literal window
            (SERIAL_LITB) goes to the doubling route, counted by
            ``serial_fallback_count``.
  doubling  dec.rep_carry (the host's sequential repeat-offset fix, only
            for frames that need it), dec.layout (run segments of the
            per-frame triple and literal maps, and each launch group's
            slot map), dec.exec_dispatch (the literal map, then pointer
            doubling in torch, ``ops/seq_exec.py``, one call per group of
            frames under ``plan.LAUNCH_BYTES``), dec.pull+verify. Every
            copy reads an earlier byte of its frame, so a frame of at most
            out_bound bytes resolves in ceil(log2(out_bound)) doubling
            passes; the reference's shallow first pass, its escalation and
            its host decode of unresolved frames have nothing left to do
            here.
``archive.decompress_frame`` on either route is the doubling route over
its one frame, a prefix riding as a leading literal run.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from . import plan as plan_mod
from .codec import huffman as huf
from .constants import SEEKABLE_MAX_FRAME_SIZE
from .device import from_reference_arrays, phase_timer, trace_range
from .errors import corruption_detected
from .native import loader
from .ops import decode_kernel as dk
from .ops import entropy, huffman_spec, seq_exec
from .ops import exec_kernel as ek
from .ops import ring_kernel as rk

LITB = 128 << 10         # the wide decoder's literal window (the format's block cap)
SERIAL_LITB = 128 << 10  # literal window per record (>= any block's budget)
# The reference's fused-route guards (tpu_archive.py:2273-2362) beside
# SERIAL_LITB: frames past them take the next route.
SERIAL_OUTB_CAP = 1 << 22  # a frame's output bound off the ring route
FUSED_WB_CAP = 16384       # words of one block's sequence bitstream

# Observability: decodes that fell off the fused route (its guards) or
# off the serial executor, and the last one's reason (the reference's
# strings).
_serial_fallbacks = {"count": 0, "reason": ""}


def exec_mode() -> str:
    """The decode route ``ZEEKSTD_TPU_EXEC`` selects: "serial", "doubling",
    or "fused" (unset, "fused" or any other value)."""
    mode = os.environ.get("ZEEKSTD_TPU_EXEC", "")
    return mode if mode in ("serial", "doubling") else "fused"


def decode_planned(blob, plans, lay, dev, *, route: str = "fused", fallback: str = "serial",
                   seek_table=None, verify_checksum: bool = True, return_device: bool = False,
                   return_parts: bool = False, prefixes=None):
    """Decode planned frames (``lay``: their ``plan.Layout``) on ``route``
    ("fused", "serial" or "doubling"); frames past a fused-route guard
    take ``fallback`` ("serial" or "doubling"). Returns the frames' joined
    bytes, a list of bytes per frame with ``return_parts``, or (uint8[F,
    out_bound] on ``dev``, sizes) with ``return_device``. ``prefixes``:
    optional per-frame ref_prefix bytes (fused and doubling routes)."""
    if route == "fused":
        with phase_timer("dec.huf_host"):
            dec_list = _huf_batch_host(lay.streams)
        res = _fused_exec_dispatch(blob, plans, lay, dec_list, seek_table, verify_checksum,
                                   return_device, dev, return_parts, prefixes)
        if res is not NotImplemented:
            return res
        route = fallback
    with phase_timer("dec.huf_batch") as pt:
        dec_streams, huf_out_bound = _huf_batch_dev(lay.streams, dev)
        pt.fence(dec_streams)
    with phase_timer("dec.fse_batch") as pt2:
        lls_b, mls_b, offs_b, ofvs_b, hasrep_dev, seq_bound = _fse_batch_dev(
            lay.seq_blocks, dev)
        pt2.fence(lls_b)
    res = NotImplemented
    if route == "serial":
        res = _serial_exec_dispatch(
            blob, plans, lay, lls_b, mls_b, ofvs_b, seq_bound, dec_streams, huf_out_bound,
            seek_table, verify_checksum, return_device, dev,
        )
    if res is NotImplemented:
        res = _doubling_dispatch(
            blob, plans, lay, lls_b, mls_b, offs_b, ofvs_b, hasrep_dev, seq_bound, dec_streams,
            huf_out_bound, verify_checksum, return_device, dev, prefixes,
        )
    return res if return_device or return_parts else b"".join(res)


def serial_fallback_count() -> int:
    return _serial_fallbacks["count"]


def count_fallback(reason: str):
    """Count one fallback to the next route; returns NotImplemented."""
    _serial_fallbacks["count"] += 1
    _serial_fallbacks["reason"] = reason
    return NotImplemented


def check_frames(plans, meta_out, nlit_f, bounds, seek_table, plens=None):
    """The reference's checks of a launch's meta_out rows (total, bad flag,
    literals used), frame by frame: raise ``corruption_detected`` at the
    first frame that fails one; else return the frames' totals. ``plens``:
    per frame, the prefix bytes its total includes."""
    meta_np = meta_out[: len(plans)].cpu().numpy()
    plens = plens or [0] * len(plans)
    for (hdr, _p, _c), (total, bad, litc), nlit, bound, plen in zip(
            plans, meta_np[:, :3].tolist(), nlit_f, bounds, plens):
        if bad:
            raise corruption_detected("match offset beyond window or literal overrun")
        if litc != nlit:
            raise corruption_detected("literal budget mismatch")
        if hdr.content_size is not None and total - plen != hdr.content_size:
            raise corruption_detected("frame content size mismatch")
        if seek_table is not None and total != bound:
            raise corruption_detected("frame size disagrees with seek table")
    return [int(t) for t in meta_np[:, 0]]


def place_group(out_dev, out_g, lo: int, hi: int, shape):
    """``return_device`` output across launch groups: a group of every
    frame is the result itself; else each group's rows go into one zeroed
    uint8 tensor of ``shape`` (frames, the archive's largest bound)."""
    if hi - lo == shape[0]:
        return out_g
    if out_dev is None:
        out_dev = torch.zeros(shape, dtype=torch.uint8, device=out_g.device)
    out_dev[lo:hi, : out_g.shape[1]] = out_g
    return out_dev


def verify_checksums(blob, plans, parts) -> None:
    """Each frame's content checksum against its decoded bytes, in order,
    after every launch group's checks."""
    for (hdr, _p, cpos), result in zip(plans, parts):
        plan_mod.check_checksum(blob, hdr, cpos, result)


def _pow2(n: int, floor_log: int) -> int:
    return 1 << max((n - 1).bit_length(), floor_log)


# ----------------------------------------------------------- fused route ---


def _huf_batch_host(stream_list):
    """Host Huffman literal decode (native), in stream order. Tables wider
    than the native decoder's 11 bits take the Python decoder, as in the
    reference."""
    out = []
    for sbytes, olen, table in stream_list:
        dec = None
        if table.max_bits <= 11:
            dec = loader.huf_stream_decode(
                sbytes, table.symbol, table.nb_bits, table.max_bits, olen
            )
        if dec is None:
            dec = np.frombuffer(huf.decode_stream(table, sbytes, olen), np.uint8)
        out.append(dec)
    return out


def use_ring_route(plans, max_bound: int, plens=None) -> bool:
    """The reference's route rule: the ring kernel when every declared
    window and every prefix is at most 512 KiB (and rows stay under 2^27
    bytes), unless ``ZEEKSTD_TPU_RING=0``."""
    plens = plens or [0] * len(plans)
    return (
        os.environ.get("ZEEKSTD_TPU_RING", "") != "0"
        and all((hdr.window_size or 0) <= rk.RING and plen <= rk.RING
                for (hdr, _p, _c), plen in zip(plans, plens))
        and max_bound <= (1 << 27)
    )


def _ring_lw(nlit_max: int) -> int:
    """Words per frame of the ring route's literal pools: the largest pool
    and 64 bytes of slack, in 4 KiB rows."""
    return max(-(-(nlit_max + 64) // 4096), 1) * 1024


def _ring_launch_bytes(n, max_bound, nlit_max, n_rec, n_seq):
    return rk.launch_bytes(n, _pow2(max_bound, 12), _ring_lw(nlit_max), n_rec, n_seq)


def _wide_launch_bytes(n, max_bound, nlit_max, n_rec, n_seq):
    return dk.launch_bytes(n, _pow2(max_bound, 12), lit_rows(nlit_max, LITB), n_rec, n_seq)


def _ring_exec_fn(consts, meta, words, tables, pools, nlit_f, OUTB, dev):
    """Ring route: literal pools packed as LE words; output words viewed
    as bytes."""
    F = len(pools)
    LW = _ring_lw(int(nlit_f.max()) if F else 0)
    litw_np = np.zeros((F, LW * 4), np.uint8)
    for fi in range(F):
        litw_np[fi, : nlit_f[fi]] = pools[fi]
    lit_words = torch.from_numpy(litw_np.view(np.int32)).to(dev)
    outw, meta_out = rk.ring_decode(consts, meta, words, tables, lit_words, OUTB=OUTB)
    return outw.view(torch.uint8).reshape(F, OUTB), meta_out


def _fused_exec_fn(consts, meta, words, tables, pools, nlit_f, OUTB, dev):
    """Wide route: literal pools one int32 per byte, output bytes."""
    F = len(pools)
    LROWS = lit_rows(int(nlit_f.max()) if F else 0, LITB)
    lits_np = np.zeros((F, LROWS * 128), np.uint8)
    for fi in range(F):
        lits_np[fi, : nlit_f[fi]] = pools[fi]
    lits = torch.from_numpy(lits_np).to(dev).to(torch.int32).reshape(F, LROWS, 128)
    out, meta_out = dk.wide_decode(consts, meta, words, tables, lits, OUTB=OUTB,
                                   LITB=LITB)
    return out.reshape(F, OUTB), meta_out


def _fused_exec_dispatch(
    blob, plans, lay, dec_list, seek_table,
    verify_checksum, return_device, dev, return_parts=False, prefixes=None,
):
    """Decode every planned frame on the fused route, or return
    NotImplemented (counted, with the reference's reason) when a
    fused-route guard rules the frames out.

    The frames go in contiguous launch groups, each launch's outputs and
    scratch within ``plan.LAUNCH_BYTES`` (one launch when all fit), each
    group laid out at its own largest bound and pool. With
    ``return_device`` the result is one (F, OUTB) tensor at the archive's
    largest bound, filled group by group: only the scratch is bounded.

    ``dec_list``: host-decoded Huffman literal streams in plan order;
    each frame's literal pool is assembled on the host and staged once.

    ``prefixes``: optional per-frame ref_prefix bytes. Each rides as a
    leading literal record that match offsets reach into, and is sliced
    off the output."""
    F = len(plans)
    plens = [len(p) if p else 0 for p in prefixes] if prefixes else [0] * F
    if any(plens) and return_device:
        raise ValueError("prefixes cannot combine with return_device")
    if max(plens) > SERIAL_LITB:
        return count_fallback("prefix over literal budget")
    bounds = [b + plen for b, plen in zip(plan_mod.frame_bounds(plans, seek_table), plens)]
    max_bound = max(bounds)
    use_ring = use_ring_route(plans, max_bound, plens)
    if not use_ring and max_bound > SERIAL_OUTB_CAP:
        return count_fallback(f"frame bound {max_bound} over cap")

    with phase_timer("dec.fused_layout"):
        if lay.seq_blocks:
            words, starts, tidx, packed, logs_t, wb = plan_mod.fse_stage(lay.seq_blocks)
            if wb > FUSED_WB_CAP:
                return count_fallback("bitstream over SMEM cap")
        else:
            words = np.zeros((2, 16), np.uint32)
            starts = np.zeros(2, np.int32)
            tidx = np.zeros((2, 3), np.int32)
            packed = np.zeros((1, 512), np.int32)
            logs_t = np.zeros(1, np.int32)

        static_np = np.frombuffer(lay.static, np.uint8)
        frames_blocks = []
        pool_parts = [[] for _ in range(F)]
        for fi, fblocks in enumerate(lay.blocks):
            blocks = []
            if plens[fi]:
                pool_parts[fi].append(np.frombuffer(prefixes[fi], np.uint8))
                blocks.append(("lit", plens[fi]))
            for (kind, *_args), blk in zip(plans[fi][1], fblocks):
                if blk[0] == "rle":
                    blocks.append(blk)
                    continue
                chunk_len = plan_mod.seg_len(blk[1])
                if chunk_len > SERIAL_LITB:
                    return count_fallback(
                        "oversize raw block" if kind == "raw" else "oversize literal budget")
                for static, src, n in blk[1]:
                    pool_parts[fi].append(static_np[src : src + n] if static else dec_list[src])
                if blk[0] == "lit":
                    blocks.append(("lit", chunk_len))
                    continue
                _seq, _segs, r, n = blk
                logs = (
                    int(logs_t[tidx[r, 0]])
                    | int(logs_t[tidx[r, 1]]) << 5
                    | int(logs_t[tidx[r, 2]]) << 10
                )
                blocks.append((
                    "seq", r, n, chunk_len,
                    int(tidx[r, 0]), int(tidx[r, 1]),
                    int(tidx[r, 2]), logs, int(starts[r]),
                ))
            frames_blocks.append(blocks)
        nlit_f = np.zeros(F, np.int32)
        pools = []
        for fi in range(F):
            pool = (
                np.concatenate(pool_parts[fi])
                if pool_parts[fi] else np.zeros(0, np.uint8)
            )
            pools.append(pool)
            nlit_f[fi] = len(pool)
        staged = from_reference_arrays(
            dev, consts=dk.make_consts(), words=words, tables=packed,
        )
        counts = [(max(len(blocks), 1), sum(b[2] for b in blocks if b[0] == "seq"))
                  for blocks in frames_blocks]
        route, launch_bytes = ((_ring_exec_fn, _ring_launch_bytes) if use_ring
                               else (_fused_exec_fn, _wide_launch_bytes))
        groups = plan_mod.launch_groups(list(zip(bounds, nlit_f)), counts, launch_bytes)

    out_dev, totals, rows = None, [], []
    for lo, hi in groups:
        with phase_timer("dec.fused_layout"):
            meta, _n_rec = dk.build_records(frames_blocks[lo:hi])
            meta_dev = from_reference_arrays(dev, meta=meta)["meta"]
        with phase_timer("dec.fused_exec") as _pt:
            out_g, meta_out = route(
                staged["consts"], meta_dev, staged["words"], staged["tables"],
                pools[lo:hi], nlit_f[lo:hi], _pow2(max(bounds[lo:hi]), 12), dev,
            )
            _pt.fence(out_g)
        totals += check_frames(plans[lo:hi], meta_out, nlit_f[lo:hi],
                                             bounds[lo:hi], seek_table, plens[lo:hi])
        if return_device:
            out_dev = place_group(out_dev, out_g, lo, hi, (F, _pow2(max_bound, 12)))
        else:
            with phase_timer("dec.fused_pull+verify"):
                out = out_g.cpu().numpy()
                rows += [out[fi - lo, plens[fi] : totals[fi]].tobytes() for fi in range(lo, hi)]
        # The next group allocates only after this one's buffers are freed.
        del out_g, meta_out, meta_dev

    if return_device:
        return out_dev, totals

    if verify_checksum:
        with phase_timer("dec.fused_pull+verify"):
            verify_checksums(blob, plans, rows)
    if return_parts:
        return rows
    with trace_range("dec.join"):
        return b"".join(rows)


# ------------------------------------------------------ shared dispatches ---


def _huf_batch_dev(stream_list, dev):
    """Device batch Huffman decode: (dec uint8[W, out_bound] on ``dev``,
    out_bound), by bit reachability, or by chunk speculation under
    ``ZEEKSTD_TPU_HUF=spec`` (``ops/huffman_spec.py``). No streams yields
    a (1, 8) dummy."""
    if not stream_list:
        return torch.zeros((1, 8), dtype=torch.uint8, device=dev), 8
    out_bound = 1 << max(max(olen for _, olen, _ in stream_list) - 1, 1).bit_length()
    word_bound = 1 << max(
        ((max(len(s) for s, _, _ in stream_list) + 3) // 4).bit_length(), 4
    )
    W = len(stream_list)
    words = np.zeros((W, word_bound), np.uint32)
    starts = np.zeros(W, np.int32)
    tbl_idx = np.zeros(W, np.int32)
    # Dedupe tables by identity: the 4 streams of a block share one.
    tables, tbl_of = [], {}
    for i, (sbytes, _olen, table) in enumerate(stream_list):
        words[i], starts[i] = plan_mod._words_from_bytes(sbytes, word_bound)
        ti = tbl_of.get(id(table))
        if ti is None:
            ti = tbl_of[id(table)] = len(tables)
            tables.append(table)
        tbl_idx[i] = ti
    sym = np.zeros((len(tables), 2048), np.int32)
    nb = np.zeros((len(tables), 2048), np.int32)
    mbs = np.ones(len(tables), np.int32)
    for ti, table in enumerate(tables):
        size = 1 << table.max_bits
        sym[ti, :size] = table.symbol
        nb[ti, :size] = table.nb_bits
        mbs[ti] = table.max_bits
    st = from_reference_arrays(dev, words=words, starts=starts, tbl_idx=tbl_idx,
                               sym=sym, nb=nb, mbs=mbs)
    ti = st["tbl_idx"].long()
    decode = (huffman_spec.decode_stream_spec if os.environ.get("ZEEKSTD_TPU_HUF") == "spec"
              else huffman_spec.decode_stream_bitreach)
    out, _n = decode(
        st["words"], st["starts"], out_bound, st["sym"][ti], st["nb"][ti], st["mbs"][ti])
    return out, out_bound


def _fse_batch_dev(seq_blocks, dev):
    """Device batch FSE decode: (lls, mls, offs, ofvs) int32[Bp, seq_bound]
    on ``dev``, hasrep bool[Bp], seq_bound. No blocks yields dummies."""
    if not seq_blocks:
        z = torch.zeros((1, 32), dtype=torch.int32, device=dev)
        return (z, z, torch.ones_like(z), torch.full_like(z, 4),
                torch.zeros(1, dtype=torch.bool, device=dev), 32)
    seq_bound = _pow2(max(d["nseq"] for d in seq_blocks), 5)
    words, starts, tidx, packed, logs_t, _wb = plan_mod.fse_stage(seq_blocks)
    nseqs = np.zeros(words.shape[0], np.int32)
    nseqs[: len(seq_blocks)] = [d["nseq"] for d in seq_blocks]
    st = from_reference_arrays(dev, words=words, starts=starts, nseqs=nseqs, tidx=tidx,
                               tables=packed, logs=logs_t, consts=dk.make_consts())
    lls, mls, offs, ofvs, _reps, hasrep = entropy.fse_decode_sequences(
        st["words"], st["starts"], st["nseqs"], st["tidx"], st["tables"], st["logs"],
        st["consts"], seq_bound=seq_bound)
    return lls, mls, offs, ofvs, hasrep, seq_bound


def _build_map(dest, base, nval, size: int, fill: int):
    """Dense per-frame index maps from run segments: position j maps to
    base[seg] + (j - dest[seg]), seg the rightmost segment with
    dest[seg] <= j (scatter-add + cumsum), or to ``fill`` past nval."""
    counts = seq_exec._scatter_count(dest, size)
    seg = torch.cumsum(counts, dim=-1).sub_(1).clamp_(0, dest.shape[1] - 1)
    del counts
    j = torch.arange(size, device=dest.device)[None, :]
    m = torch.gather(base, 1, seg).add_(j).sub_(torch.gather(dest, 1, seg))
    return m.masked_fill_(j >= nval[:, None], fill)


def _static_pool(static: bytes) -> np.ndarray:
    sp = _pow2(len(static), 7) if static else 1 << 7
    static_np = np.zeros(sp, np.uint8)
    static_np[: len(static)] = np.frombuffer(static, np.uint8)
    return static_np


def _lit_segments(frame_segs, sp: int, huf_out_bound: int, size: int):
    """Per-frame literal run segments (dest, base) into [static pool of sp
    bytes | decoded Huffman rows of huf_out_bound bytes], padded with
    ``size`` (dropped) destinations."""
    F = len(frame_segs)
    SEGL = _pow2(max((len(s) for s in frame_segs), default=1), 2)
    lit_dest = np.full((F, SEGL), size, np.int32)
    lit_base = np.zeros((F, SEGL), np.int32)
    for fi, segs in enumerate(frame_segs):
        off = 0
        for k, (static, src, n) in enumerate(segs):
            lit_dest[fi, k] = off
            lit_base[fi, k] = src if static else sp + src * huf_out_bound
            off += n
    return lit_dest, lit_base


def _lit_source(static_np, dec_streams, dev):
    """[static pool | decoded Huffman rows], flat on the device."""
    static = from_reference_arrays(dev, static=static_np)["static"]
    return torch.cat([static, dec_streams.reshape(-1)])


def _gather_lits(lit_dest, lit_base, nlit_f, size, lit_flat, dev):
    """Each frame's flat literal stream uint8[F, size], gathered once from
    ``lit_flat`` (``_lit_source``) through the segment map."""
    st = from_reference_arrays(dev, dest=lit_dest, base=lit_base, nval=nlit_f)
    lit_map = _build_map(st["dest"].long(), st["base"].long(), st["nval"].long(), size, 0)
    return lit_flat[lit_map.clamp_(0, lit_flat.shape[0] - 1)]


def _gather_bytes(F: int, size: int, segl: int) -> int:
    """Device bytes of ``_gather_lits`` for F frames of ``size`` slots and
    ``segl`` segments: per slot, 24 B of int64 index maps at most alive at
    once (``_build_map``) and the gathered byte; per segment, 64 B of its
    int32 and int64 copies and the scatter's temporaries."""
    return F * (size * 25 + segl * 64)


# ---------------------------------------------------------- serial route ---


def _literal_segs(fblocks):
    return [s for blk in fblocks if blk[0] != "rle" for s in blk[1]]


def _serial_records(lay, rpb: int):
    """Per frame, the serial executor's record entries (``ek.build_records``
    input), or None when a block's literals exceed SERIAL_LITB."""
    frames_recs = []
    for fblocks in lay.blocks:
        recs = []
        for blk in fblocks:
            if blk[0] == "rle":
                recs.append(blk)
                continue
            chunk_len = plan_mod.seg_len(blk[1])
            if chunk_len > SERIAL_LITB:
                return None
            if blk[0] == "lit":
                recs.append(("lit", chunk_len))
            else:
                recs.append(("seq", blk[2] * rpb, blk[3], chunk_len))
        frames_recs.append(recs)
    return frames_recs


def lit_rows(nlit_max: int, litb: int) -> int:
    """128-byte rows per frame of the literal pools of a kernel whose
    literal window is ``litb`` bytes (the wide decoder, the serial
    executor): the largest pool and one window, rounded up to a power of
    two."""
    return 1 << max((nlit_max // 128 + litb // 128 + 1).bit_length(), 1)


def _serial_launch_bytes(n, max_bound, nlit_max, nseg_max, n_rec):
    size = lit_rows(nlit_max, SERIAL_LITB) * 128
    return (ek.launch_bytes(n, _pow2(max_bound, 12), size // 128, n_rec)
            + _gather_bytes(n, size, _pow2(nseg_max, 2)))


def _serial_exec_dispatch(blob, plans, lay, lls_b, mls_b, ofvs_b, seq_bound, dec_streams,
                          huf_out_bound, seek_table, verify_checksum, return_device, dev):
    """Decode every planned frame through the serial executor, in launch
    groups under ``plan.LAUNCH_BYTES`` (see ``plan.launch_groups``; with
    ``return_device`` one (F, OUTB) tensor at the archive's largest bound,
    filled group by group). Returns the frames' bytes / (device rows,
    sizes), or NotImplemented when the literal-window guard rules this
    archive out (counted). The reference's 4 MiB VMEM ceiling on a frame's
    output does not apply on the card."""
    F = len(plans)
    bounds = plan_mod.frame_bounds(plans, seek_table)
    SBd = min(2048, seq_bound)
    rpb = seq_bound // SBd
    LITB = SERIAL_LITB
    with phase_timer("dec.serial_layout"):
        frames_recs = _serial_records(lay, rpb)
        if frames_recs is None:
            return count_fallback("oversize block literal budget")
        frame_segs = [_literal_segs(fb) for fb in lay.blocks]
        nlit_f = np.asarray([plan_mod.seg_len(s) for s in frame_segs], np.int64)
        static_np = _static_pool(lay.static)
        n_rec = [max(sum(max(1, -(-r[2] // SBd)) if r[0] == "seq" else 1 for r in recs), 1)
                 for recs in frames_recs]
        groups = plan_mod.launch_groups(
            list(zip(bounds, nlit_f, map(len, frame_segs))), n_rec, _serial_launch_bytes)
        lit_flat = _lit_source(static_np, dec_streams, dev)

    out_dev, totals, rows = None, [], []
    for lo, hi in groups:
        Fg, OUTB = hi - lo, _pow2(max(bounds[lo:hi]), 12)
        with phase_timer("dec.serial_layout"):
            meta, _n_rec = ek.build_records(frames_recs[lo:hi], SBd)
            LROWS = lit_rows(int(nlit_f[lo:hi].max()), LITB)
            lit_dest, lit_base = _lit_segments(frame_segs[lo:hi], static_np.shape[0],
                                               huf_out_bound, LROWS * 128)
        with phase_timer("dec.serial_exec") as pt:
            lits = _gather_lits(lit_dest, lit_base, nlit_f[lo:hi], LROWS * 128, lit_flat, dev)
            lits = lits.to(torch.int32).reshape(Fg, LROWS, 128)
            meta_dev = from_reference_arrays(dev, meta=meta)["meta"]
            out_g, meta_out = ek.serial_exec(
                meta_dev, lls_b.reshape(-1, SBd), mls_b.reshape(-1, SBd),
                ofvs_b.reshape(-1, SBd), lits, OUTB=OUTB, LITB=LITB, SBd=SBd,
            )
            out_g = out_g.reshape(Fg, OUTB)
            pt.fence(out_g)
        totals += check_frames(plans[lo:hi], meta_out, nlit_f[lo:hi], bounds[lo:hi],
                               seek_table)
        if return_device:
            out_dev = place_group(out_dev, out_g, lo, hi, (F, _pow2(max(bounds), 12)))
        else:
            with phase_timer("dec.serial_pull+verify"):
                out = out_g.cpu().numpy()
                rows += [out[fi - lo, : totals[fi]].tobytes() for fi in range(lo, hi)]
        # The next group allocates only after this one's buffers are freed.
        del lits, meta_dev, out_g, meta_out

    if return_device:
        return out_dev, totals

    if verify_checksum:
        with phase_timer("dec.serial_pull+verify"):
            verify_checksums(blob, plans, rows)
    return rows


# -------------------------------------------------------- doubling route ---


def _fix_rep_carry(seq_blocks, rows, lls, ofvs, offs):
    """Re-resolve repeat offsets sequentially across ONE frame's blocks
    (batch rows ``rows`` of the FSE batch arrays), mutating ``offs``.
    Same-block rep1 (ofv==1, ll>0, not the block's first sequence) is
    already exact under the per-block fresh history — our own encoder
    emits only that form — so the sequential pass runs only for the other
    repeat forms (foreign archives)."""

    def _unsafe(i):
        n = seq_blocks[i]["nseq"]
        ofv = ofvs[rows[i]][:n]
        ll = lls[rows[i]][:n]
        k = np.arange(n)
        safe = (ofv == 1) & (ll > 0) & (k >= 1)
        return bool(((ofv <= 3) & ~safe).any())

    any_rep_after_first = any(_unsafe(i) for i in range(1, len(seq_blocks)))
    if any_rep_after_first:
        r1, r2, r3 = 1, 4, 8
        for i, d in zip(rows, seq_blocks):
            n = d["nseq"]
            for k in range(n):
                ofv = int(ofvs[i][k])
                ll = int(lls[i][k])
                if ofv > 3:
                    off = ofv - 3
                    r1, r2, r3 = off, r1, r2
                else:
                    j = ofv + (1 if ll == 0 else 0)
                    if j == 1:
                        off = r1
                    elif j == 2:
                        off = r2
                        r1, r2 = r2, r1
                    elif j == 3:
                        off = r3
                        r1, r2, r3 = r3, r1, r2
                    else:
                        off = r1 - 1
                        r1, r2, r3 = off, r1, r2
                offs[i][k] = off


def _rep_carry(lay, hasrep_dev, lls_b, ofvs_b, offs_b, dev):
    """Cross-block repeat-offset carry: only frames that use repeat codes
    beyond their first block need the sequential host fix (our encoder
    never emits them; foreign archives do). Returns ``offs_b`` with only
    those frames' rows replaced."""
    if not lay.seq_blocks:
        return offs_b
    hasrep = hasrep_dev.cpu().numpy()
    frames = [rows for rows in lay.frame_rows if any(hasrep[r] for r in rows[1:])]
    if not frames:
        return offs_b
    fix_rows = [r for rows in frames for r in rows]
    rows_idx = torch.tensor(fix_rows, dtype=torch.long, device=dev)
    lls_f, ofvs_f, offs_f = (t[rows_idx].cpu().numpy() for t in (lls_b, ofvs_b, offs_b))
    row_pos = {r: i for i, r in enumerate(fix_rows)}
    for rows in frames:
        _fix_rep_carry([lay.seq_blocks[r] for r in rows], [row_pos[r] for r in rows],
                       lls_f, ofvs_f, offs_f)
    offs_b = offs_b.clone()
    offs_b[rows_idx] = torch.from_numpy(offs_f).to(dev)
    return offs_b


def _triple_pools(lls_b, mls_b, offs_b, nseq_v, chunk_v, c_ll, c_ml, c_of, NB):
    """The virtual (ll, ml, off) pool: [decoded slots | per-block trailing
    literal runs | host constant pseudo-sequences]; returns the three
    pools, the padding slot (consts[0] = (0, 0, 1)) and each block's output
    bytes (its literal budget plus its match lengths)."""
    seq_bound = lls_b.shape[1]
    k = torch.arange(seq_bound, device=lls_b.device)[None, :]
    mask = k < nseq_v[:, None]
    lls = lls_b[:NB].to(torch.int64)
    mls = mls_b[:NB].to(torch.int64)
    used = torch.where(mask, lls, 0).sum(dim=1)
    blk_out = chunk_v + torch.where(mask, mls, 0).sum(dim=1)
    trail = chunk_v - used
    zero_t = torch.zeros_like(trail)
    ll_pool = torch.cat([lls.reshape(-1), trail, c_ll])
    ml_pool = torch.cat([mls.reshape(-1), zero_t, c_ml])
    of_pool = torch.cat([offs_b[:NB].to(torch.int64).reshape(-1), zero_t + 1, c_of])
    return ll_pool, ml_pool, of_pool, ll_pool.shape[0] - c_ll.shape[0], blk_out


def _slot_maps(runs, nslots, pools, pad_slot: int, const_base: int, dev):
    """One launch group's (ll, ml, off) rows, int64[n, S] each (S the
    group's largest slot count rounded up to a power of two, at least 32):
    each frame's slot runs (start, pool index) mapped through the virtual
    pools, the padding slot past its slots."""
    S = _pow2(max(nslots), 5)
    SEGS = _pow2(max((len(r) for r in runs), default=1), 2)
    seq_dest = np.full((len(runs), SEGS), S, np.int64)  # S = dropped sentinel
    seq_base = np.full((len(runs), SEGS), const_base, np.int64)
    for fi, r in enumerate(runs):
        seq_dest[fi, : len(r)] = r[:, 0]
        seq_base[fi, : len(r)] = r[:, 1]
    st = from_reference_arrays(dev, seq_dest=seq_dest, seq_base=seq_base,
                               nslots=np.asarray(nslots, np.int64))
    map_seq = _build_map(st["seq_dest"], st["seq_base"], st["nslots"], S, pad_slot)
    map_seq.clamp_(0, pools[0].shape[0] - 1)
    return tuple(pool[map_seq] for pool in pools)


def _doubling_launch_bytes(n, bound, nslots, nlit, nsegl, nruns):
    """Device bytes of one doubling launch group of n frames: the executor
    (``seq_exec.launch_bytes``) at the group's output bound and slots; the
    literal gather (``_gather_bytes``); per slot, 96 B of the slot map
    while it is built, the (ll, ml, off) rows and the offset checks' sums;
    per slot run, 64 B of its copies and the scatter's temporaries."""
    S = _pow2(nslots, 5)
    return (seq_exec.launch_bytes(n, _pow2(bound, 7), S)
            + _gather_bytes(n, _pow2(nlit, 7), _pow2(nsegl, 2))
            + n * (S * 96 + _pow2(nruns, 2) * 64))


def _doubling_dispatch(blob, plans, lay, lls_b, mls_b, offs_b, ofvs_b, hasrep_dev, seq_bound,
                       dec_streams, huf_out_bound, verify_checksum, return_device, dev,
                       prefixes=None):
    """Decode every planned frame by pointer doubling, in launch groups
    under ``plan.LAUNCH_BYTES`` (see ``plan.launch_groups``). The (ll, ml,
    off) pools, each frame's slot runs and literal segments are laid out
    once; each group maps its frames' slots and literals and runs
    ``seq_exec.execute_sequences_batch`` at its own slot count, literal
    size and output bound, and is checked (and pulled) frame by frame
    before the next group allocates. With ``return_device``, one (F,
    out_bound) tensor at the archive's largest bound, filled group by
    group."""
    F = len(plans)
    plens = [len(p) if p else 0 for p in prefixes] if prefixes else [0] * F
    with phase_timer("dec.rep_carry"):
        offs_b = _rep_carry(lay, hasrep_dev, lls_b, ofvs_b, offs_b, dev)

    with phase_timer("dec.layout"):
        NB = max(len(lay.seq_blocks), 1)
        # Virtual pool layout for the (ll, ml, off) triples:
        #   [0, NB*seq_bound)       decoded sequence slots
        #   [NB*seq_bound, +NB)     per-block trailing literal runs
        #   [NB*seq_bound+NB, +C)   host constant pseudo-sequences
        trail_base = NB * seq_bound
        const_base = trail_base + NB
        consts = [(0, 0, 1)]  # padding slot
        extra = bytearray()  # prefixes and RLE bytes, after lay.static

        def const(ll, ml):
            consts.append((ll, ml, 1))
            return const_base + len(consts) - 1

        def static_seg(b):
            extra.extend(b)
            return (True, len(lay.static) + len(extra) - len(b), len(b))

        frame_segs, seq_slots, totals = [], [], []
        chunk_lits = np.zeros(NB, np.int64)  # literal bytes per seq block
        for fi, fblocks in enumerate(lay.blocks):
            segs, slots = [], []
            total = plens[fi]
            if plens[fi]:
                segs.append(static_seg(prefixes[fi]))
                slots.append(const(plens[fi], 0))
            for blk in fblocks:
                if blk[0] == "rle":
                    _rle, nrep, byte = blk
                    segs.append(static_seg(bytes([byte])))
                    slots.append(const(1, 0))
                    if nrep > 1:
                        slots.append(const(0, nrep - 1))
                    total += nrep
                elif blk[0] == "lit":
                    segs += blk[1]
                    n = plan_mod.seg_len(blk[1])
                    slots.append(const(n, 0))
                    total += n
                else:
                    _seq, bsegs, r, n = blk
                    segs += bsegs
                    chunk_lits[r] = plan_mod.seg_len(bsegs)
                    slots.extend(range(r * seq_bound, r * seq_bound + n))
                    slots.append(trail_base + r)
            frame_segs.append(segs)
            seq_slots.append(slots)
            totals.append(total)

        # ``totals`` counts only literal-only blocks; frames with sequences
        # take their size from the frame header or, for headerless frames,
        # from their decoded blocks below.
        static_np = _static_pool(lay.static + bytes(extra))
        nlit_f = np.asarray([plan_mod.seg_len(s) for s in frame_segs], np.int64)

        # Per-frame run segments (start, pool index) of the slot map; each
        # group's dense maps are rebuilt on the device (scatter-add + cumsum).
        seq_runs = []
        for slots in seq_slots:
            arr = np.asarray(slots, np.int64)
            if arr.size == 0:
                seq_runs.append(np.zeros((0, 2), np.int64))
                continue
            brk = np.nonzero(np.diff(arr) != 1)[0] + 1
            run_starts = np.concatenate([[0], brk])
            seq_runs.append(np.stack([run_starts, arr[run_starts]], axis=1))
        nslots = [len(s) for s in seq_slots]
        consts_np = np.asarray(consts, np.int64)

        out_sizes = []
        for (hdr, _p, _c), plen in zip(plans, plens):
            if hdr.content_size is not None and hdr.content_size > SEEKABLE_MAX_FRAME_SIZE:
                # A corrupt header must not drive a giant allocation.
                raise corruption_detected("declared frame size exceeds cap")
            out_sizes.append(hdr.content_size + plen if hdr.content_size is not None else -1)

        nseq_np = (np.asarray([d["nseq"] for d in lay.seq_blocks], np.int64)
                   if lay.seq_blocks else np.zeros(NB, np.int64))
        st = from_reference_arrays(dev, nseq=nseq_np, chunk=chunk_lits, c_ll=consts_np[:, 0],
                                   c_ml=consts_np[:, 1], c_of=consts_np[:, 2])
        *pools, pad_slot, blk_out = _triple_pools(
            lls_b, mls_b, offs_b, st["nseq"], st["chunk"], st["c_ll"], st["c_ml"],
            st["c_of"], NB)
        if any(sz < 0 for sz in out_sizes) and lay.seq_blocks:
            # Headerless frames: output sizes from the decoded blocks.
            blk_np = blk_out.cpu().numpy()
            out_sizes = [sz if sz >= 0 else tot + int(blk_np[rows].sum())
                         for sz, tot, rows in zip(out_sizes, totals, lay.frame_rows)]
        bounds = [max(sz, tot, 1) for sz, tot in zip(out_sizes, totals)]
        lit_flat = _lit_source(static_np, dec_streams, dev)
        groups = plan_mod.launch_groups(
            list(zip(bounds, nslots, nlit_f, map(len, frame_segs), map(len, seq_runs))),
            [()] * F, _doubling_launch_bytes)

    out_dev, sizes, parts = None, [], []
    for lo, hi in groups:
        with phase_timer("dec.layout"):
            lls, mls, offs = _slot_maps(seq_runs[lo:hi], nslots[lo:hi], pools, pad_slot,
                                        const_base, dev)
            L = _pow2(int(nlit_f[lo:hi].max()), 7)
            lit_dest, lit_base = _lit_segments(frame_segs[lo:hi], static_np.shape[0],
                                               huf_out_bound, L)
            out_bound = _pow2(max(bounds[lo:hi]), 7)

        with phase_timer("dec.exec_dispatch") as pt3:
            lits = _gather_lits(lit_dest, lit_base, nlit_f[lo:hi], L, lit_flat, dev)
            out_g, conv = seq_exec.execute_sequences_batch(
                lits, lls, mls, offs, out_bound,
                n_doublings=max(1, (out_bound - 1).bit_length()))
            del lits
            # Corruption: a match reaching before the frame start, or a
            # literal run over the block's budget (a negative trailing run).
            pos_end = torch.cumsum(lls + mls, dim=1)
            bad = (((mls > 0) & (offs > pos_end - mls)) | (lls < 0)).any(dim=1)
            checks = torch.stack([pos_end[:, -1], bad.long(), conv.long()], dim=1)
            del lls, mls, offs, pos_end, bad, conv
            pt3.fence(out_g)

        with phase_timer("dec.pull+verify"):
            checks = checks.cpu().numpy()
            out = None if return_device else out_g.cpu().numpy()
            for i, (hdr, _p, cpos) in enumerate(plans[lo:hi]):
                tot, bad_i, conv_i = (int(v) for v in checks[i])
                plen = plens[lo + i]
                if bad_i:
                    raise corruption_detected("match offset beyond window or literal overrun")
                if not conv_i:
                    # A frame that passed the offset check resolves within
                    # these passes unless a match with a non-positive offset
                    # starts at its first byte.
                    raise corruption_detected("copy chain does not end at a literal")
                if hdr.content_size is not None and tot - plen != hdr.content_size:
                    raise corruption_detected("frame content size mismatch")
                if out is not None:
                    result = out[i, plen:tot].tobytes()
                    if verify_checksum:
                        plan_mod.check_checksum(blob, hdr, cpos, result)
                    parts.append(result)
            sizes += [int(t) for t in checks[:, 0]]
        if return_device:
            out_dev = place_group(out_dev, out_g, lo, hi, (F, _pow2(max(bounds), 7)))
        # The next group allocates only after this one's buffers are freed.
        del out_g, out
    if return_device:
        return out_dev, sizes
    return parts
