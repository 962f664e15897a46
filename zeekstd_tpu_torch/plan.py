"""Host decode planning, shared by every decode route (port of
``zeekstd_tpu/tpu_codec._plan_frame`` and ``_words_from_bytes`` and of
the planning helpers of ``zeekstd_tpu/tpu_archive.py``): walk a frame's
block and section headers and entropy-table descriptions into a plan,
lay the planned frames out as literal segments and block entries, stage
the FSE decode inputs, and check the content checksums."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .codec import frame as frame_mod
from .codec import fse
from .codec import huffman as huf
from .codec import literals as lit_mod
from .codec import sequences as seq_mod
from .constants import SEEKABLE_MAX_FRAME_SIZE, ZSTD_BLOCK_SIZE_MAX
from .device import counters
from .errors import checksum_wrong, corruption_detected
from .native import loader, seq_header


def checksum(data) -> int:
    """The low 32 bits of XXH64(data), as a frame's content checksum."""
    return loader.xxh64(data) & 0xFFFF_FFFF


def check_checksum(blob, hdr, cpos: int, result: bytes) -> None:
    """Raise ``checksum_wrong`` when the frame carries a content checksum
    (at ``blob[cpos:cpos + 4]``) that ``result`` does not match."""
    if hdr.has_checksum:
        stored = int.from_bytes(blob[cpos : cpos + 4], "little")
        if checksum(result) != stored:
            raise checksum_wrong("content checksum mismatch")


def plan_archive(blob, seek_table):
    """Plan every frame of the archive: [(hdr, plan, checksum_pos)]."""
    plans = []
    if seek_table is not None:
        for i in range(seek_table.num_frames):
            start = seek_table.frame_start_comp(i)
            if seek_table.frame_size_decomp(i) == 0 and seek_table.frame_end_comp(i) == start:
                continue
            hdr_i, plan_i, fpos_i = _plan_frame(blob, start)
            # The frame must consume exactly its seek-table extent: a
            # corrupted header (e.g. a flipped checksum-flag bit) otherwise
            # shifts the trailer and decodes silently wrong.
            consumed = fpos_i + (4 if hdr_i.has_checksum else 0)
            if consumed != seek_table.frame_end_comp(i):
                raise corruption_detected(
                    f"frame {i} consumed {consumed - start} bytes; seek "
                    f"table records {seek_table.frame_size_comp(i)}"
                )
            plans.append((hdr_i, plan_i, fpos_i))
    else:
        pos = 0
        while pos < len(blob):
            magic = int.from_bytes(blob[pos : pos + 4], "little")
            if (magic & 0xFFFFFFF0) == 0x184D2A50:  # skippable (incl. seek table)
                size = int.from_bytes(blob[pos + 4 : pos + 8], "little")
                pos += 8 + size
                continue
            hdr, plan, fpos = _plan_frame(blob, pos)
            plans.append((hdr, plan, fpos))
            pos = fpos + (4 if hdr.has_checksum else 0)
    return plans


@dataclass
class Layout:
    """The planned frames as the decode routes consume them.

    streams     every Huffman literal stream (bytes, olen, table), in plan
                order; a stream's index is its row of the decoded batch
    seq_blocks  every block with sequences, in plan order; a block's index
                is its row of the FSE-decode batch
    frame_rows  per frame, its rows of ``seq_blocks``
    static      the raw blocks' and the uncompressed literal sections'
                bytes, end to end
    blocks      per frame, its blocks in order:
                  ("lit", segs)            literals only (a raw block, or a
                                           compressed block without
                                           sequences)
                  ("rle", nrep, byte)      an RLE block
                  ("seq", segs, row, nseq) a compressed block with sequences
                ``segs`` are the block's literal segments (static, src, n):
                ``static[src:src + n]`` when static, else the first n bytes
                of decoded stream ``src``."""

    streams: list
    seq_blocks: list
    frame_rows: list
    static: bytes
    blocks: list


def seg_len(segs) -> int:
    return sum(n for _static, _src, n in segs)


def collect(plans) -> Layout:
    """One walk over every planned frame's blocks."""
    streams, seq_blocks, frame_rows, blocks = [], [], [], []
    static = bytearray()
    for _hdr, plan, _c in plans:
        rows, fblocks = [], []
        for kind, *args in plan:
            if kind == "rle":
                fblocks.append(("rle", args[1], args[0]))
                continue
            if kind == "raw":
                segs = [(True, len(static), len(args[0]))]
                static += args[0]
                nseq = 0
            else:
                d = args[0]
                if "streams" in d:
                    segs = [(False, len(streams) + k, olen)
                            for k, (_s, olen, _t) in enumerate(d["streams"])]
                    streams.extend(d["streams"])
                else:
                    lb = d.get("lit_bytes", b"")
                    segs = [(True, len(static), len(lb))]
                    static += lb
                nseq = d.get("nseq", 0)
            if nseq > 0:
                rows.append(len(seq_blocks))
                fblocks.append(("seq", segs, len(seq_blocks), nseq))
                seq_blocks.append(d)
            else:
                fblocks.append(("lit", segs))
        frame_rows.append(rows)
        blocks.append(fblocks)
    return Layout(streams, seq_blocks, frame_rows, bytes(static), blocks)


def fse_stage(seq_blocks):
    """Host staging of the FSE decode inputs: bitstream words, start bits,
    deduped packed decode tables, per-block table indices."""
    word_bound = 1 << max(
        ((max(len(d["payload"]) for d in seq_blocks) + 3) // 4).bit_length(), 4
    )
    B = len(seq_blocks)
    Bp = 1 << max((B - 1).bit_length(), 2)
    words = np.zeros((Bp, word_bound), np.uint32)
    starts = np.zeros(Bp, np.int32)
    tidx = np.zeros((Bp, 3), np.int32)
    tables = []
    tbl_of = {}

    def table_index(t):
        ti = tbl_of.get(id(t))
        if ti is None:
            ti = tbl_of[id(t)] = len(tables)
            tables.append(t)
        return ti

    for i, d in enumerate(seq_blocks):
        w, sb = _words_from_bytes(d["payload"], word_bound)
        words[i] = w
        starts[i] = sb
        ll_t, of_t, ml_t = d["tables"]
        tidx[i] = [table_index(ll_t), table_index(of_t), table_index(ml_t)]
    T = len(tables)
    Tp = 1 << max((T - 1).bit_length(), 1)
    packed = np.zeros((Tp, 512), np.int32)
    logs_t = np.zeros(Tp, np.int32)
    for ti, t in enumerate(tables):
        size = 1 << t.accuracy_log
        packed[ti, :size] = (
            t.symbol.astype(np.int32)
            | (t.nb_bits.astype(np.int32) << 8)
            | (t.baseline.astype(np.int32) << 16)
        )
        logs_t[ti] = t.accuracy_log
    return words, starts, tidx, packed, logs_t, word_bound


def frame_bounds(plans, seek_table):
    """Each planned frame's output bound: its seek-table size, else its
    declared content size, else 128 KiB per block. Raises on a bound over
    the 1 GiB seekable frame cap (a corrupt header must not drive a giant
    allocation)."""
    bounds = []
    for fi, (hdr, plan, _) in enumerate(plans):
        if seek_table is not None:
            b = seek_table.frame_size_decomp(fi)
        elif hdr.content_size is not None:
            b = hdr.content_size
        else:
            b = len(plan) * ZSTD_BLOCK_SIZE_MAX
        if b > SEEKABLE_MAX_FRAME_SIZE:
            raise corruption_detected("declared frame size exceeds cap")
        bounds.append(b)
    return bounds


# Device bytes one decode launch may allocate for its outputs and scratch:
# every decode route splits an archive's frames into launch groups under
# it.
LAUNCH_BYTES = 4 << 30


def launch_groups(maxed, summed, launch_bytes):
    """Split frames into contiguous launch groups [(lo, hi), ...], in order.

    ``maxed`` and ``summed`` hold a count or a row of counts per frame. A
    launch of n frames is laid out at the group's largest value of each
    ``maxed`` column (its output bound, its literal pool) and allocates
    ``launch_bytes(n, *maxes, *sums)`` device bytes, with the ``summed``
    columns (its records, its sequences) summed over the group. Each group
    is the longest run of frames from its first whose launch stays within
    ``LAUNCH_BYTES``; a frame over it alone gets a group of its own."""
    maxed, summed = (np.asarray(c, np.int64).reshape(len(c), -1) for c in (maxed, summed))
    groups, lo = [], 0
    big, tot = maxed[0], summed[0]
    for i in range(1, len(maxed)):
        big_i, tot_i = np.maximum(big, maxed[i]), tot + summed[i]
        if launch_bytes(i + 1 - lo, *big_i.tolist(), *tot_i.tolist()) > LAUNCH_BYTES:
            groups.append((lo, i))
            lo, big_i, tot_i = i, maxed[i], summed[i]
        big, tot = big_i, tot_i
    groups.append((lo, len(maxed)))
    return groups


def _words_from_bytes(payload: bytes, word_bound: int):
    """Little-endian uint32 words + payload bit length (strips the sentinel)."""
    from .codec.bitstream import BackwardBitReader

    br = BackwardBitReader(payload)
    start_bits = br.remaining
    arr = np.zeros(word_bound, np.uint32)
    padded = payload.ljust((len(payload) + 3) // 4 * 4, b"\0")
    w = np.frombuffer(padded, "<u4")
    arr[: len(w)] = w
    return arr, start_bits


# The longest frame header (zstd's ZSTD_FRAMEHEADERSIZE_MAX: magic,
# descriptor, window byte, 4-byte dictionary id, 8-byte content size) and
# a block header.
FRAME_HEADER_MAX = 18
BLOCK_HEADER = 3


def _plan_frame(frame: bytes, pos: int = 0):
    """Host side of one frame's decode: walk block/section headers and
    entropy-table descriptions into a device-ready plan (no symbol loops).
    Returns (hdr, plan, end_pos) with end_pos at the content checksum
    position (if any). Plan entries: ("raw", bytes) | ("rle", byte, n) |
    ("cmp", desc).

    The walk reads ``frame`` at offsets: each slice it takes is no longer
    than what it parses there (the frame header's ``FRAME_HEADER_MAX``
    bytes, a block header's 3, a raw or compressed block's size; an RLE
    block's byte is indexed), each clamped to the end of ``frame``, so
    planning one frame of a large buffer costs that frame alone. Adds the
    lengths of those slices to
    ``counters["plan.copied_bytes"]`` and the frame's compressed size to
    ``counters["plan.planned_bytes"]``.

    A compressed block's sequences-section header (the number of
    sequences, the modes byte, the table descriptions) is read in one call
    of ``native/seq_header.cpp``, held equal to the verbatim
    ``parse_num_sequences`` and ``read_symbol_table``; where that library
    cannot be built, or the block is one those functions raise on, they
    read it, so errors keep their class, message and order. The tables are
    built by the verbatim functions either way. Adds the FSE_Compressed
    descriptions read to ``counters["plan.fse_descs"]``, and those the
    library read to ``counters["plan.fse_descs_native"]``."""
    head = frame[pos : pos + FRAME_HEADER_MAX]
    hdr = frame_mod.parse_frame_header(head)
    fpos = pos + hdr.header_size
    copied = len(head)

    # --- host: walk blocks, parse headers + tables -----------------------
    plan = []  # per block: ("raw", bytes) | ("rle", byte, n) | ("cmp", desc)
    prev_table = None
    _dec_state = {}  # per-frame repeat-mode FSE tables
    read_header = seq_header.reader()
    descs = native_descs = 0  # FSE_Compressed descriptions: all, by the library

    while True:
        bhead = frame[fpos : fpos + BLOCK_HEADER]
        copied += len(bhead)
        last, btype, bsize, consumed = frame_mod.parse_block_header(bhead)
        fpos += consumed
        if btype == frame_mod.BLOCK_RAW:
            raw = frame[fpos : fpos + bsize]
            copied += len(raw)
            plan.append(("raw", raw))
            fpos += bsize
        elif btype == frame_mod.BLOCK_RLE:
            plan.append(("rle", frame[fpos], bsize))
            fpos += 1
        else:
            block = frame[fpos : fpos + bsize]
            copied += len(block)
            fpos += bsize
            sec = lit_mod.parse_literals_header(block)
            bpos = sec.header_size
            desc = {"lit_type": sec.lit_type, "regen": sec.regenerated_size}
            if sec.lit_type == lit_mod.LIT_RAW:
                desc["lit_bytes"] = block[bpos : bpos + sec.regenerated_size]
                bpos += sec.regenerated_size
            elif sec.lit_type == lit_mod.LIT_RLE:
                desc["lit_bytes"] = bytes([block[bpos]]) * sec.regenerated_size
                bpos += 1
            else:
                payload = block[bpos : bpos + sec.compressed_size]
                bpos += sec.compressed_size
                if sec.lit_type == lit_mod.LIT_COMPRESSED:
                    weights, wconsumed = huf.read_weights(payload)
                    prev_table = huf.build_decode_table(weights)
                    payload = payload[wconsumed:]
                if prev_table is None:
                    raise corruption_detected("treeless literals without table")
                table = prev_table
                if sec.four_streams:
                    s1 = int.from_bytes(payload[0:2], "little")
                    s2 = int.from_bytes(payload[2:4], "little")
                    s3 = int.from_bytes(payload[4:6], "little")
                    rest = payload[6:]
                    seg = (sec.regenerated_size + 3) // 4
                    lens = [seg, seg, seg, sec.regenerated_size - 3 * seg]
                    sizes = [s1, s2, s3, len(rest) - s1 - s2 - s3]
                    off = 0
                    desc["streams"] = []
                    for ssize, olen in zip(sizes, lens):
                        desc["streams"].append(
                            (rest[off : off + ssize], olen, table)
                        )
                        off += ssize
                else:
                    desc["streams"] = [(payload, sec.regenerated_size, table)]

            st = _dec_state
            sec_head = read_header(block, bpos) if read_header is not None else None
            if sec_head is None:
                # The verbatim functions: no library, or a block they raise on.
                rest = block[bpos:]
                nseq, nconsumed = seq_mod.parse_num_sequences(rest)
                rest = rest[nconsumed:]
                desc["nseq"] = nseq
                if nseq > 0:
                    modes = rest[0]
                    rest = rest[1:]
                    ll_t, c = seq_mod.read_symbol_table(rest, (modes >> 6) & 3, "ll", st.get("ll"))
                    rest = rest[c:]
                    of_t, c = seq_mod.read_symbol_table(rest, (modes >> 4) & 3, "of", st.get("of"))
                    rest = rest[c:]
                    ml_t, c = seq_mod.read_symbol_table(rest, (modes >> 2) & 3, "ml", st.get("ml"))
                    rest = rest[c:]
                    st["ll"], st["of"], st["ml"] = ll_t, of_t, ml_t
                    desc["tables"] = (ll_t, of_t, ml_t)
                    desc["payload"] = rest
                    descs += sum((modes >> s) & 3 == seq_mod.MODE_FSE for s in (6, 4, 2))
            else:
                nseq, heads, payload_off = sec_head
                desc["nseq"] = nseq
                if nseq > 0:
                    tables = []
                    for cat, (mode, _c, arg, norm) in zip(("ll", "of", "ml"), heads):
                        if mode == seq_mod.MODE_FSE:
                            tables.append(fse.build_decode_table(norm, arg))
                            descs += 1
                            native_descs += 1
                        elif mode == seq_mod.MODE_RLE:
                            tables.append(fse.rle_decode_table(arg))
                        else:  # Predefined, or Repeat (raises without a table)
                            tables.append(seq_mod.read_symbol_table(b"", mode, cat, st.get(cat))[0])
                    st["ll"], st["of"], st["ml"] = tables
                    desc["tables"] = tuple(tables)
                    desc["payload"] = block[payload_off:]
            plan.append(("cmp", desc))
        if last:
            break

    counters["plan.copied_bytes"] += copied
    counters["plan.planned_bytes"] += fpos + (4 if hdr.has_checksum else 0) - pos
    counters["plan.fse_descs"] += descs
    counters["plan.fse_descs_native"] += native_descs
    return hdr, plan, fpos
