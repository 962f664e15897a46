"""Per-frame device encoder: one zstd frame through the parallel parse, the
FSE kernel and the device Huffman stage.

The encode half of ``zeekstd_tpu/tpu_codec.py`` (the decode half is
``archive.decompress_frame``):

  device: parallel LZ parse (``ops/match_tpu``) and the sequence codes
  host:   per-block decisions - literal mode and Huffman table, FSE table
          modes (``codec/seq_encode._choose_table``)
  device: the FSE sequence bitstreams of every block, one launch of
          ``ops/fse_kernel.fse_encode`` per frame (its wide layout: a
          128 KiB block's literal run or match reaches 2^17)
  device: the Huffman literal streams of every block, one batched call of
          ``ops/entropy.huffman_encode_streams`` per frame
  host:   block and frame byte assembly, with the raw and RLE choices

The reference dispatches the two entropy stages once per block; a block's
streams depend only on its own inputs, so one call per frame writes the
same bytes. Inputs under 64 bytes, and a parse whose sequences pass the
frame's bound, take the host frame encoder at level 1, as in the
reference: that is its format decision, not a fallback from the card.

``device=None`` is the CUDA card; ``"cpu"`` runs the kernels' plain
versions. The frames are standard zstd, byte-identical to
``zeekstd_tpu.tpu_codec.tpu_compress_frame``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import archive
from .codec import frame as frame_mod
from .codec import huffman as huf
from .codec import literals as lit_mod
from .codec import sequences as seq_mod
from .codec.compress import compress_frame as host_compress_frame
from .codec.seq_encode import _choose_table, write_num_sequences
from .constants import ZSTD_BLOCK_SIZE_MAX
from .device import phase_timer, resolve_device
from .ops import fse_kernel as fk
from .ops.bitpack import words_to_stream
from .ops.match_tpu import bit_length, parse_frame, rep1_offset_values
from .xxhash64 import content_checksum

SEQ_BOUND = 1 << 18  # per-frame sequence bound; past it the host encoder writes the frame
BLOCK_SIZE = ZSTD_BLOCK_SIZE_MAX  # 128 KiB


def parse_and_code(data_u8, n_valid, seq_bound: int, block_size: int = BLOCK_SIZE):
    """The parallel parse of one frame (``data_u8`` uint8[n], ``n_valid``
    bytes valid) at level 3 and its sequence codes, on the tensor's device.

    Returns (lls, mls, ov, n_seq, lits, n_lit, ll_codes, ml_codes,
    of_codes, n_seq_raw), as ``zeekstd_tpu.tpu_codec.parse_and_code``:
    per-sequence int32[seq_bound] rows (``lls`` unclamped at block starts,
    ``ov`` the repeat-coded offset values), literals uint8[n], and the
    counts as int32 scalars."""
    dev = data_u8.device
    nv = torch.as_tensor([int(n_valid)], dtype=torch.int64, device=dev)
    lls, mls, offs, n_seq, lits, n_lit, n_seq_raw = parse_frame(
        data_u8[None, :], block_size, seq_bound, n_valid=nv
    )
    # Same-block repeat-offset coding (rep code 1 when the offset repeats):
    # the block-clamped first sequence of a block is never rep-eligible,
    # so the unclamped lls are safe to test here.
    ov = rep1_offset_values(lls.long(), lls.long(), mls.long(), offs.long(), n_seq,
                            block_size, seq_bound)
    ll_base = torch.from_numpy(seq_mod.LL_BASE.astype(np.int64)).to(dev)
    ml_base = torch.from_numpy(seq_mod.ML_BASE.astype(np.int64)).to(dev)
    l64, m64 = lls.long(), mls.long()
    of_codes = bit_length(ov.clamp(min=1)) - 1
    ll_codes = torch.where(l64 < 16, l64, torch.searchsorted(ll_base, l64, right=True) - 1)
    ml_codes = torch.where(m64 < 35, (m64 - 3).clamp(min=0),
                           torch.searchsorted(ml_base, m64, right=True) - 1)
    i32 = torch.int32
    return (lls[0], mls[0], ov[0].to(i32), n_seq[0], lits[0], n_lit[0],
            ll_codes[0].to(i32), ml_codes[0].to(i32), of_codes[0].to(i32), n_seq_raw[0])


def compress_frame(data: bytes, checksum: bool = False, device=None) -> bytes:
    """Compress one frame; returns a complete zstd frame, bit-compatible
    with every zstd decoder and equal to the JAX package's
    ``tpu_compress_frame``."""
    dev = resolve_device(device)
    n = len(data)
    if n < 64:
        return host_compress_frame(data, level=1, checksum=checksum)
    n_pad = 1 << max((n - 1).bit_length(), 10)
    seq_bound = min(SEQ_BOUND, max(2048, n_pad // 8))  # >= worst case n/8
    padded = np.zeros(n_pad, np.uint8)
    padded[:n] = np.frombuffer(data, np.uint8)
    with phase_timer("frame.parse_dispatch") as pt:
        results = parse_and_code(torch.from_numpy(padded).to(dev), n, seq_bound)
        n_seq_raw = int(results[-1])
        pt.fence(results[0])
    if n_seq_raw > seq_bound:
        # The parse overflowed the sequence bound: the host encoder.
        return host_compress_frame(data, level=1, checksum=checksum)
    return assemble_frame(data, results, checksum)


def _literal_plan(lits_b: bytes):
    """A block's literal decisions: ``(section, None)`` when the section
    needs no device stream (empty, RLE, raw, or no Huffman table), else
    ``(raw_section, (tree, codes256, nb256, segment lengths))``."""
    n = len(lits_b)
    if n == 0:
        return lit_mod.write_literals_header(lit_mod.LIT_RAW, 0, 0, False), None
    if lits_b.count(lits_b[0]) == n:
        return lit_mod.write_literals_header(lit_mod.LIT_RLE, n, 0, False) + lits_b[:1], None
    raw = lit_mod.write_literals_header(lit_mod.LIT_RAW, n, 0, False) + lits_b
    if n < 64:
        return raw, None
    freqs_arr = np.bincount(np.frombuffer(lits_b, np.uint8), minlength=256)
    freqs = {int(s): int(c) for s, c in enumerate(freqs_arr) if c}
    if len(freqs) < 2:
        return raw, None
    try:
        lengths = huf.package_merge_lengths(freqs)
        weights = huf.lengths_to_weights(lengths, max(freqs))
        tree = huf.write_weights(weights)
        codes, nb, _ = huf.build_encode_table(weights)
    except Exception:
        return raw, None
    codes256 = np.zeros(256, np.uint32)
    codes256[: len(codes)] = codes
    nb256 = np.zeros(256, np.int32)
    nb256[: len(nb)] = nb
    seg = (n + 3) // 4
    return raw, (tree, codes256, nb256, [seg, seg, seg, n - 3 * seg])


def _literal_section(raw: bytes, n: int, tree: bytes, parts) -> bytes:
    """The Huffman literal section from the four streams, or ``raw`` where
    the reference keeps the raw section (a stream too long for the jump
    table, no header for the size, or no saving)."""
    if any(len(p) > 0xFFFF for p in parts[:3]):
        return raw
    jump = b"".join(len(p).to_bytes(2, "little") for p in parts[:3])
    payload = tree + jump + b"".join(parts)
    try:
        header = lit_mod.write_literals_header(lit_mod.LIT_COMPRESSED, n, len(payload), True)
    except Exception:
        return raw
    if len(header) + len(payload) >= len(raw):
        return raw
    return header + payload


def _sequence_plan(llc, mlc, ofc):
    """A block's sequence-section head (count, modes, table descriptions)
    from its sequences' codes, and its table choices by category (each
    ``_choose_table``'s (mode, table, description, cost))."""
    tables = {
        "ll": _choose_table(llc, "ll", seq_mod.LL_DEFAULT_NORM, seq_mod.LL_DEFAULT_LOG, 35, 9),
        "of": _choose_table(ofc, "of", seq_mod.OF_DEFAULT_NORM, seq_mod.OF_DEFAULT_LOG, 31, 8),
        "ml": _choose_table(mlc, "ml", seq_mod.ML_DEFAULT_NORM, seq_mod.ML_DEFAULT_LOG, 52, 9),
    }
    section = bytearray(write_num_sequences(len(llc)))
    section.append((tables["ll"][0] << 6) | (tables["of"][0] << 4) | (tables["ml"][0] << 2))
    section += tables["ll"][2] + tables["of"][2] + tables["ml"][2]
    return bytes(section), tables


def _fse_streams(jobs, dev):
    """One FSE-kernel launch over every sequence-bearing block of the frame
    (the wide layout; meta and table rows staged as the archive's); the
    finished stream bytes per job."""
    meta, pool, _ = archive._fse_kernel_inputs(jobs, 1)
    SBd = 1 << max(max(j["nseq"] for j in jobs) - 1, 31).bit_length()
    rows = {k: np.zeros((len(jobs), SBd), np.int32) for k in ("ll", "ml", "ov")}
    for r, job in enumerate(jobs):
        for k, a in rows.items():
            a[r, : job["nseq"]] = job[k]

    def put(a):
        return torch.from_numpy(a).to(dev)

    words, bits = fk.fse_encode(put(fk.make_consts()), put(meta), put(rows["ll"]),
                                put(rows["ov"]), put(pool), SBd=SBd, WBo=fk.word_bound(SBd),
                                ml=put(rows["ml"]))
    words = words[: len(jobs)].cpu().numpy().view(np.uint32)
    bits = bits[: len(jobs)].cpu().numpy()
    return [words_to_stream(words[r], int(bits[r])) for r in range(len(jobs))]


def _huffman_streams(jobs, lits_dev):
    """One batched Huffman call over the four segments of every block, each
    sliced from the parse's literal row on the device and padded to the
    frame's longest segment (staged as the archive's); the stream bytes
    per segment."""
    seg_bound = 1 << max((max(j[2] for j in jobs) - 1).bit_length(), 6)
    hin, seg_bound, word_bound = archive._huf_inputs(jobs, seg_bound)
    # Room past the row's end, so no slice's start is clamped back.
    row = torch.nn.functional.pad(lits_dev, (0, seg_bound))[None, :]
    words, totals = archive._huf_streams(row, hin, seg_bound, word_bound)
    words = words[: len(jobs)].cpu().numpy().view(np.uint32)
    totals = totals[: len(jobs)].cpu().numpy()
    return [words_to_stream(words[i], int(totals[i])) for i in range(len(jobs))]


def assemble_frame(data: bytes, parse_results, checksum: bool = False) -> bytes:
    """The frame's bytes from the device parse results: host decisions for
    every block, one launch of each entropy stage, then the blocks in
    order."""
    n = len(data)
    lls, mls, ovs, n_seq, lits_dev, n_lit, ll_codes, ml_codes, of_codes = parse_results[:9]
    dev = lls.device
    with phase_timer("frame.host_decisions"):
        n_seq, n_lit = int(n_seq), int(n_lit)
        lls, mls, ovs, ll_codes, ml_codes, of_codes = (
            t[:n_seq].cpu().numpy() for t in (lls, mls, ovs, ll_codes, ml_codes, of_codes))
        lits_np = lits_dev[:n_lit].cpu().numpy()

        # Per-block split (sequences are block-contained by construction).
        starts = np.concatenate([[0], np.cumsum(lls.astype(np.int64) + mls)])
        match_starts = starts[:-1] + lls
        n_blocks = -(-n // BLOCK_SIZE)
        seq_block = match_starts // BLOCK_SIZE
        blocks, fse_jobs, huf_jobs = [], [], []
        lit_consumed = 0
        for b in range(n_blocks):
            b_start = b * BLOCK_SIZE
            b_len = min(b_start + BLOCK_SIZE, n) - b_start
            idx = np.nonzero(seq_block == b)[0]
            nlit_b = b_len - (int(mls[idx].sum()) if len(idx) else 0)
            lits_b = lits_np[lit_consumed : lit_consumed + nlit_b].tobytes()
            blk = {"start": b_start, "len": b_len, "lit_lo": lit_consumed}
            lit_consumed += nlit_b
            blocks.append(blk)
            if len(idx) == 0:
                continue  # no sequences: a raw or RLE block
            # The first sequence's literal run may have started in an
            # earlier block; clamp it (and its code) to this block.
            ll_b = lls[idx].astype(np.int64)
            ll_b[0] = int(match_starts[idx[0]] - max(match_starts[idx[0]] - ll_b[0], b_start))
            llc = ll_codes[idx].copy()
            llc[0] = _ll_code_host(int(ll_b[0]))
            head, tables = _sequence_plan(llc, ml_codes[idx], of_codes[idx])
            blk["seq_head"], blk["fse_job"] = head, len(fse_jobs)
            fse_jobs.append({"frame": 0, "block": len(fse_jobs), "nseq": len(idx),
                             "tables": tables, "ll": ll_b, "ml": mls[idx], "ov": ovs[idx]})
            blk["lit_raw"], plan = _literal_plan(lits_b)
            blk["lit_n"] = len(lits_b)
            if plan is not None:
                tree, codes256, nb256, seg_lens = plan
                blk["tree"], blk["huf"] = tree, len(huf_jobs)
                start = blk["lit_lo"]
                for sl in seg_lens:
                    huf_jobs.append((0, start, sl, codes256, nb256))
                    start += sl
    with phase_timer("frame.entropy_dispatch"):
        fse = _fse_streams(fse_jobs, dev) if fse_jobs else []
        hufs = _huffman_streams(huf_jobs, lits_dev) if huf_jobs else []
    with phase_timer("frame.assembly"):
        out = bytearray(frame_mod.write_frame_header(n, max(n, 1024), checksum))
        for b, blk in enumerate(blocks):
            last = b == n_blocks - 1
            b_len = blk["len"]
            body = None
            if "fse_job" in blk:
                lit = blk["lit_raw"]
                if "huf" in blk:
                    lit = _literal_section(lit, blk["lit_n"], blk["tree"],
                                           hufs[blk["huf"] : blk["huf"] + 4])
                body = lit + blk["seq_head"] + fse[blk["fse_job"]]
            if body is None or len(body) >= b_len:
                block_raw = data[blk["start"] : blk["start"] + b_len]
                if block_raw.count(block_raw[:1]) == b_len:
                    out += frame_mod.write_block_header(last, frame_mod.BLOCK_RLE, b_len)
                    out += block_raw[:1]
                else:
                    out += frame_mod.write_block_header(last, frame_mod.BLOCK_RAW, b_len)
                    out += block_raw
            else:
                out += frame_mod.write_block_header(last, frame_mod.BLOCK_COMPRESSED, len(body))
                out += body
        if checksum:
            # The native XXH64 (the reference hashes with the Python class:
            # the same digest, 0.09 s per MiB on the card's host).
            out += content_checksum(data).to_bytes(4, "little")
    return bytes(out)


def _ll_code_host(ll: int) -> int:
    if ll < 16:
        return ll
    return int(np.searchsorted(seq_mod.LL_BASE, ll, side="right")) - 1
