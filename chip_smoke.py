#!/usr/bin/env python3
"""Drive the PyTorch port's archive path on one CUDA card and check it.

    python3 chip_smoke.py [--out DIR] [--blocks-only]

Phases (any failure raises; nothing is caught):
  1. build   - the CUDA kernel library (one nvcc per csrc/*.cu, in
               parallel) and the native runtime (g++); prints each kernel's
               registers, shared memory and spills (nvcc -Xptxas -v).
  2. kernels - a 256 KiB, 3-frame mixed input (text, an RLE run, random
               bytes, overlapping "abc" repeats) through the pipeline on
               the card; every kernel's output on the inputs it was given
               must equal its plain PyTorch version exactly over the
               valid regions, and the level-1 archive the CPU port's
               byte for byte; the match kernel also on one edge input of
               tests/match_edges.py (1 MiB of text whose lazy probes and
               interior inserts share hash slots).
  2b. levels - the 256 KiB input at level 3 (32 KiB frames) and at level
               19 with a 64 KiB prefix, through the parallel parse: every
               reachability and FSE kernel call on the card equals its
               plain version exactly, each archive equals the CPU port's
               archive of the same input, and every frame decodes back.
  3. main    - 10 MiB of dickens-like text (a copy of bench.py's
               build_corpus, seeded), 1 MiB frames, level 1, checksums on:
               encode (the archive must equal the CPU port's), Foot seek
               table, parse it back, decode on the ring route and on the
               wide route, decode frames 3-5, and a one-bit corruption
               that must never decode to wrong bytes.
               The match, FSE, ring and wide kernels must have launched.
  4. timing  - 5 warm runs of encode and decode (checksums off, input
               staged, output left on the card): median and spread in
               MiB/s; the fenced phase split; every kernel's CUDA-event
               time at the main path's shapes beside its memory bound
               (bytes read + written over 3.35 TB/s) and its plain
               version's time on the same inputs; for the match kernel
               the sequences per launch and the ns and cycles per
               sequence of one frame's chain at the SM clock nvidia-smi
               reads while the kernel runs ([timing] match); for the FSE
               kernel, at levels 1 and 3, its jobs, sequences per launch,
               longest job, ns and cycles per step of that job, and the
               time of the zero fill its wrapper does not do ([timing]
               fse_encode); the ring
               decoder's three stages (FSE pass, scan, pointer jumping)
               timed apart on the level-1 decode's inputs.
  3b. level 3 - the same 10 MiB text, 1 MiB frames, level 3 (the CLI's
               default), checksums on: encode, Foot seek table, decode
               (the 1 MiB windows take the wide route), frames 3-5, the
               flipped bit; then a patch round trip (old = the first 2 MiB,
               new = old with 256 seeded 16-byte overwrites and a 4 KiB
               insertion, encoded with old as prefix, every frame back
               through decompress_frame). The reachability kernels, the
               FSE kernel and the wide decoder must have launched; the
               patch encode's FSE launch must equal its plain version.
  4b. timing - as phase 4 for the level-3 configuration (decode on the
               wide route), and the kernels of the level-3 path; the wide
               decoder's three stages (FSE pass, scan, pointer jumping)
               timed apart on the level-3 decode's inputs.
  2c. routes - the 256 KiB input's level-1 (96 KiB frames) and level-3
               (32 KiB frames) archives decoded on the card under
               ZEEKSTD_TPU_EXEC=serial and =doubling, exactly; every exec,
               FSE-decode and reachability call on those routes equals its
               plain version exactly; synthetic exec rows (every repeat
               form, overlapping matches of period 1 and 3, a match across
               a 128-byte row, literal and RLE records, a block sliced at
               SBd, a bad offset) through the exec kernel and its plain
               version; the byte histogram and table lookup at 10 MiB
               (their launches counted alone) against their plain versions
               and the one-call PyTorch equivalents (bincount, take).
  3c. routes, full size - the level-3 archive of phase 3b (Foot seek
               table) decoded on the serial route, then on the doubling
               route, each alone between a reset and a read of the launch
               counts: the serial route must launch exec, fse_decode and
               both reachability kernels, the doubling route the same but
               exec, and neither any other kernel; every call of those
               decodes equals its plain version. Then the flipped bit on
               each route and frames 3-5 through decompress_frame on the
               doubling route.
  4c. timing - 5 warm level-3 decodes per route (checksums off, output
               on the card): median and spread in MiB/s, the fenced phase
               split, and the four new kernels' rows; the exec kernel's two
               stages (scan, pointer jumping) timed apart on the serial
               route's inputs; the FSE-decode kernel's sequences, ms,
               ns and cycles per step of its longest row, and its rows
               staged whole or windowed ([timing] fse_decode).
  5. streaming and CLI - the same 10 MiB text through the entry points a
               user calls, each counted between a reset and a read of the
               launch counts: (a) the streaming Encoder on the tpu backend
               (1 MiB frames, checksums on, 128 KiB writes) at levels 1 and
               3 must write compress_archive's archive plus its Foot table
               and launch match and FSE (level 1), both reachability
               kernels and FSE (level 3); (b) the Decoder on the tpu backend
               over both archives: the whole, frames 3-5, a window across
               frames 2-3, 16 seek/reads of 4 KiB, and a flipped bit in
               frame 4 that must raise an errors.py error (ring decoder at
               level 1, wide at level 3); (c) the patch pair through
               compress_with_prefix and a Decoder with the prefix; (d) the
               compressed policy at a 256 KiB threshold on the text (match
               kernel) and at 6000 on the 256 KiB input (1500-byte probe
               steps through the parallel parse, whose reachability runs
               as torch pointer doubling at that width; equal to the CPU
               port's):
               round trips, every non-final frame at least half the
               threshold; (e) the CLI in process (compress --backend tpu -s
               1M -l 3, equal to the level-3 archive; list; decompress
               --from-frame 2 --to-frame 4; the whole) and once as python
               -m zeekstd_tpu_torch compress; (f) [timing] streaming: 5
               warm streaming encodes and decodes per level beside
               compress_archive and decompress_archive (host bytes in and
               out, checksums on), decoder dispatches per decode, and the
               fenced phase split of one streaming and one archive decode.
  6a. native - the native runtime (the default backend) on the card
               machine's CPU, the 10 MiB text at levels 1 and 3 in 1 MiB
               frames: compress_stream_mt with nthreads=1 and 0 (equal
               blobs), decoded by decompress_stream_mt and, from a seek
               table of the frame sizes, by decompress_archive on the card,
               exactly; the default Encoder (level 3, checksums on) equals
               with_backend("native") and the CLI's file with no --backend;
               the CLI's list and decompress --backend tpu of it, and
               compress --backend tpu then decompress with no --backend;
               [timing] native: MiB/s medians of 5 with their spread of
               both helpers per level and thread count (the host CPU's,
               with os.cpu_count()).
  6b. frame_codec - the per-frame device encoder on the card over the
               10 MiB text in 1 MiB frames and the 256 KiB input: one FSE
               launch per frame (the wide layout), each equal to its plain
               version; the first frame and the 256 KiB frame equal the
               CPU run's; every frame back through decompress_frame on the
               card and the host codec; [timing] frame_codec: MiB/s median
               of 5 with its spread and the fenced split (parse, host
               decisions, entropy, assembly), and the wide FSE launch's time.
  7a. mesh   - the mesh pipeline (zeekstd_tpu_torch/parallel/) in one
               process on an NCCL group of world size 1 (init_multihost,
               make_mesh() on the card): the 10 MiB text at levels 1 and 3 in
               1 MiB frames, checksums off and on: parallel_compress equal to
               compress_archive with equal seek tables; parallel_decompress
               exact with one ring (L1) or wide (L3) launch, and under
               ZEEKSTD_TPU_MESH_EXEC=doubling with the FSE-decode and both
               reachability kernels; parallel_random_access over ranges across
               frame edges; route_queries owners all 0; multihost_compress rows
               stitched by the write plan equal to the blob; [timing] mesh:
               MiB/s median and spread of 5 in turns of the mesh encode and
               decode, compress_archive and decompress_archive (host bytes in
               and out, checksums off), and the fenced phase split (mesh.stage,
               mesh.gather, mesh.decode_gather beside enc.* and dec.*).
  7b. scale  - 64 MiB of the text at level 1 in 2 MiB frames through 7a's
               mesh: equal to compress_archive, round trip exact, each timed
               once, and the fenced split of a second decode.
  7c. processes - two processes of this script (--mesh-child) on the card in
               a gloo group: each compresses only its frames of the 10 MiB
               text (level 1, multihost_compress) and writes them into one
               file at the write plan's offsets; the stitched archive and both
               seek tables must equal 7a's, and both processes must decode the
               whole text and the same ranges. A child's failure or a
               10-minute timeout fails the phase.
  8. blocks  - the archive block sizes other than the default 32 KiB
               (ZEEKSTD_TPU_BLOCK, read at import): one child of this script
               per block size, 16, 64 and 128 KiB, one after another; a
               child's failure or a 10-minute timeout fails the phase. In
               each: (a) the 256 KiB mixed input and the long-run input of
               tests/block_cases.py (a 100 kB literal run, a 90 kB match) at
               levels 1 and 3 in 256 KiB frames: every match and FSE launch
               equal to its plain version (the FSE kernel's wide instance and
               the match kernel's wide rows above 32 KiB), the card's archive
               the CPU port's, decoded exactly on the fused, wide, serial and
               doubling routes; (b) the 10 MiB text at levels 1 and 3 in 1 MiB
               frames, encoded and decoded on every route (counted); the
               compressed bytes beside phase 3's, encode and decode MiB/s
               (median and spread of 5) and the fenced split beside phase 4's,
               the match kernel's ms per launch, cycles per sequence and
               dynamic shared memory, the FSE launch's ms, and the fused-route
               guard hand-offs per route. A block size named by
               ZEEKSTD_TPU_BLOCK joins the three (phases 1-7 run at the
               default 32 KiB all the same). --blocks-only runs phases 1
               and 8 alone and ends on a line of its own, not the full
               run's.
  9. knobs   - the reference's last route variables, each set in a
               try/finally that restores it (ZEEKSTD_TPU_REACH changes no
               byte in the reference and the port ignores it). (a)-(d) under
               ZEEKSTD_TPU_MATCH=xla (level 1 on the parallel parse, no
               512 KiB window cap): (a) the 256 KiB mixed and long-run
               inputs at level 1 in 64 and 256 KiB frames: the card's
               archive the CPU port's, no match launch, every reach and FSE
               launch equal to its plain version, every route exact; (b) the
               10 MiB text at level 1 in 1 MiB frames, counted: the reach
               kernels, the FSE kernel and the wide decoder launched, no
               match and no ring launch, each 10 MiB launch equal to its
               plain version, the archive decoded exactly on the card and by
               the native runtime; the compressed bytes beside phase 3's,
               the frames that overflowed to the host encoder, encode MiB/s
               in turns with the match-kernel route (median and spread of
               5 each), decode MiB/s and the fenced split beside phase 4's;
               the parse's anchor pass on its step array by the chunked
               kernels and by pointer doubling, equal, in turns;
               (c) parallel_compress on a one-card mesh and (d) the
               streaming Encoder (tpu backend) equal to (b)'s archive and
               table. (e) one child of this script per ZEEKSTD_TPU_TIMING value (1, 2,
               unset; --timing-child, read at import, no set_timing call):
               1 MiB encoded and decoded on the card; under 1 and 2 the
               phase names phase 4 prints and [timing] lines, unset nothing.
               A child's failure or a 10-minute timeout fails the phase.
               (e)'s launches check no kernel and stay out of the table.
  table      - each kernel's row: the wrapper's CUDA-event time at its
               path's shapes; for the byte histogram, the table lookup and
               the two reachability kernels the device time alone instead
               (wrapper_ms beside it): wrapper calls captured into a CUDA
               graph, cold (rotated over copies of the inputs and outputs
               that exceed 2.4 times the L2) and warm ([timing] reach); the byte kernels also cold at 160 MiB (16 copies of
               the text) and their library calls on rotated copies
               ([timing] bytes). Launches add up phases 3, 3b, 3c (each
               route), the byte kernels' run and phases 5, 6a, 6b, 7a-7b,
               7c (both processes), 8 (every child) and 9 (its counted
               runs).

Prints the card's name and power limit, one JSON line with the kernel
table, and as its last line {"ok": true, "device": {...}}. With --out
DIR it also writes the full results to DIR/chip_smoke.json. With
--blocks-only the last line is {"blocks_only": [sizes], "passed": true}
instead, and no kernel table is printed.
"""

import argparse
import contextlib
import io
import json
import os
import random
import socket
import subprocess
import sys
import time
import types

import numpy as np
import torch

from tests.block_cases import long_run, mixed_input

MIB = 1 << 20
ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate


def build_corpus(target=10 << 20, seed=1898) -> bytes:
    """Dickens-like English text: a few thousand distinct words with
    Zipfian reuse and sentence/paragraph structure (bench.py's corpus)."""
    rng = random.Random(seed)
    syll = (
        "ing ly tion ment ness ed er est ous ive al en an ar or at it "
        "be con de dis ex in pre pro re un der ther wh st ch sh th"
    ).split()
    roots = (
        "time work hand hous street light heart night day man wom child "
        "door fire word moment eye face voice friend fath moth city road "
        "wall room turn look walk speak think know feel come go take give "
        "great small good dark cold warm long short high low old young"
    ).split()
    vocab = []
    for r in roots:
        vocab.append(r)
        for s in rng.sample(syll, 6):
            vocab.append(r + s)
    while len(vocab) < 4000:
        vocab.append(rng.choice(roots) + rng.choice(syll) + rng.choice(syll))
    common = ["the", "and", "of", "to", "a", "in", "that", "was", "he",
              "it", "his", "her", "with", "as", "had", "at", "for", "she"]
    out = []
    total = 0
    while total < target:
        sent = []
        n = rng.randrange(6, 26)
        for _ in range(n):
            if rng.random() < 0.45:
                sent.append(rng.choice(common))
            else:
                sent.append(vocab[min(int(rng.paretovariate(1.1)), len(vocab) - 1)])
        text = " ".join(sent).capitalize() + rng.choice([". ", ". ", "; ", ", and ", "? "])
        if rng.random() < 0.02:
            text = f"\n\nCHAPTER {rng.randrange(1, 60)}.\n\n" + text
        b = text.encode()
        out.append(b)
        total += len(b)
    return b"".join(out)[:target]


def log(msg):
    print(msg, flush=True)


class Recorder:
    """Wraps the kernel wrappers to keep the inputs the pipeline gives
    them (the calls still go through the wrappers)."""

    def __init__(self):
        from zeekstd_tpu_torch.ops import (byte_kernels, decode_kernel, entropy,
                                           exec_kernel, fse_kernel, match_kernel,
                                           reach_kernel, ring_kernel)

        self.sites = {
            "match": (match_kernel, "match"),
            "reach_tables": (reach_kernel, "chunk_pointer_tables"),
            "reach_mark": (reach_kernel, "chunk_mark"),
            "fse": (fse_kernel, "fse_encode"),
            "ring_decode": (ring_kernel, "ring_decode"),
            "wide_decode": (decode_kernel, "wide_decode"),
            "fse_decode": (entropy, "fse_decode_sequences"),
            "exec": (exec_kernel, "serial_exec"),
            "byte_histogram": (byte_kernels, "byte_histogram"),
            "table_lookup": (byte_kernels, "table_lookup"),
        }
        self.calls = {k: [] for k in self.sites}
        self._orig = {}

    def __enter__(self):
        for name, (mod, attr) in self.sites.items():
            fn = getattr(mod, attr)
            self._orig[name] = fn

            def rec(*a, _fn=fn, _name=name, **k):
                self.calls[_name].append((a, k))
                return _fn(*a, **k)

            setattr(mod, attr, rec)
        return self

    def __exit__(self, *exc):
        for name, (mod, attr) in self.sites.items():
            setattr(mod, attr, self._orig[name])
        return False


def _max_err(a, b):
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def kernel_modules():
    from zeekstd_tpu_torch.ops import (byte_kernels, decode_kernel, entropy, exec_kernel,
                                       fse_kernel, match_kernel, reach_kernel, ring_kernel)

    return types.SimpleNamespace(mk=match_kernel, fk=fse_kernel, dk=decode_kernel,
                                 rk=ring_kernel, rch=reach_kernel, ek=exec_kernel,
                                 ent=entropy, bk=byte_kernels)


def _rows_err(out, mo, out0, mo0):
    """Max error of the meta lanes and of each frame's bytes in [0, total)."""
    F = mo.shape[0]
    ob, ob0 = out.reshape(F, -1), out0.reshape(F, -1)
    err = _max_err(mo[:, :3], mo0[:, :3])
    for f, tot in enumerate(mo0[:, 0].tolist()):
        err = max(err, _max_err(ob[f, :tot], ob0[f, :tot]))
    return err


def compare(name, a, k, m):
    """Run the plain version on the kernel's inputs and compare the valid
    regions exactly. Returns (max_abs_err, plain seconds)."""
    sync = torch.cuda.synchronize
    sync()
    cpu = [t.cpu() for t in a]
    if name in ("reach_tables", "reach_mark"):
        if name == "reach_tables":
            out = m.rch.chunk_pointer_tables(*a)
        else:
            out = m.rch.chunk_mark(*a)
        sync()
        t0 = time.perf_counter()
        ref = m.rch.tables_plain(*cpu) if name == "reach_tables" else m.rch.mark_plain(*cpu)
        t_plain = time.perf_counter() - t0
        err = _max_err(out, ref.to(out.device))
    elif name == "match":
        out = m.mk.match(*a, **k)
        sync()
        t0 = time.perf_counter()
        ref = m.mk.match_plain(*a, k["BLK"], k["SBd"])
        t_plain = time.perf_counter() - t0
        if len(out) != len(ref):
            raise AssertionError("match: the kernel and its plain version return other rows")
        # Blocks above 32 KiB add the ml row (wide records).
        lm, ofv, litw, stat, *ml = out
        lm0, ofv0, litw0, stat0, *ml0 = (t.to(lm.device) for t in ref)
        err = _max_err(stat, stat0)
        nseq = stat0[:, m.mk.ST_NSEQ].tolist()
        litcnt = stat0[:, m.mk.ST_LITCNT].tolist()
        lb, lb0 = litw.view(torch.uint8), litw0.view(torch.uint8)
        for r in range(stat.shape[0]):
            err = max(err, _max_err(lm[r, : nseq[r]], lm0[r, : nseq[r]]),
                      _max_err(ofv[r, : nseq[r]], ofv0[r, : nseq[r]]),
                      _max_err(lb[r, : litcnt[r]], lb0[r, : litcnt[r]]),
                      *(_max_err(x[r, : nseq[r]], x0[r, : nseq[r]]) for x, x0 in zip(ml, ml0)))
    elif name == "fse":
        words, bits = m.fk.fse_encode(*a, **k)
        sync()
        t0 = time.perf_counter()
        w0, b0 = m.fk.fse_plain(*a, k["SBd"], k["WBo"], k.get("ml"))
        t_plain = time.perf_counter() - t0
        w0, b0 = w0.to(words.device), b0.to(words.device)
        err = _max_err(bits, b0)
        for j, nb in enumerate(b0.tolist()):
            if nb:
                nw = nb // 32 + 1
                err = max(err, _max_err(words[j, :nw], w0[j, :nw]))
    elif name == "exec":
        out, mo = m.ek.serial_exec(*a, **k)
        sync()
        t0 = time.perf_counter()
        out0, mo0 = m.ek.exec_plain(*cpu, k["OUTB"], k["LITB"], k["SBd"])
        t_plain = time.perf_counter() - t0
        err = _rows_err(out.cpu(), mo.cpu(), out0, mo0)
    elif name == "fse_decode":
        got = m.ent.fse_decode_sequences(*a, **k)
        sync()
        t0 = time.perf_counter()
        want = m.ent.fse_decode_plain(*cpu, k["seq_bound"])
        t_plain = time.perf_counter() - t0
        err = max(_max_err(g.cpu(), w) for g, w in zip(got, want))
    elif name == "byte_histogram":
        got = m.bk.byte_histogram(*a, **k)
        sync()
        t0 = time.perf_counter()
        want = m.bk.histogram_plain(*cpu, **k)
        t_plain = time.perf_counter() - t0
        err = _max_err(got.cpu(), want)
    elif name == "table_lookup":
        got = m.bk.table_lookup(*a)
        sync()
        t0 = time.perf_counter()
        want = m.bk.lookup_plain(*cpu)
        t_plain = time.perf_counter() - t0
        err = _max_err(got.cpu(), want)
    else:
        ring = name == "ring_decode"
        out, mo = (m.rk.ring_decode if ring else m.dk.wide_decode)(*a, **k)
        sync()
        t0 = time.perf_counter()
        if ring:
            out0, mo0 = m.rk.ring_plain(*a, k["OUTB"])
        else:
            out0, mo0 = m.dk.wide_plain(*a, k["OUTB"], k["LITB"])
        t_plain = time.perf_counter() - t0
        F = mo.shape[0]
        if ring:
            out, out0 = out.view(torch.uint8), out0.view(torch.uint8)
        err = _rows_err(out.reshape(F, -1).cpu(), mo.cpu(), out0.reshape(F, -1).cpu(),
                        mo0.cpu())
    if err != 0:
        raise AssertionError(f"{name} kernel disagrees with its plain version (max abs err {err})")
    return err, t_plain


def moved_bytes(name, a, result, m, k=None):
    """Bytes the function must move for these inputs: each input byte the
    data uses read once, each output byte written once (``k``: the call's
    keywords; the wide layouts move one more int32 row per sequence)."""
    if name in ("reach_tables", "reach_mark"):
        return sum(t.numel() * 4 for t in a) + result.numel() * 4
    if name == "match":
        consts, meta, words = a
        mt = meta.reshape(-1, m.mk.META_COLS).cpu()
        stat = result[3]
        nseq = int(stat[:, m.mk.ST_NSEQ].sum())
        return (int(mt[:, m.mk.M_BLEN].sum()) + meta.numel() * 4 + consts.numel() * 4
                + nseq * 4 * (len(result) - 2) + int(stat[:, m.mk.ST_LITCNT].sum())
                + stat.numel() * 4)
    if name == "fse":
        consts, meta, lm, ofv, tables = a
        mt = meta.reshape(-1, m.fk.JMETA_COLS).cpu()
        nseq = int(mt[:, m.fk.J_NSEQ].clamp(min=0).sum())
        words, bits = result
        rows = 3 if k and k.get("ml") is not None else 2
        return (nseq * 4 * rows + tables.numel() * 4 + meta.numel() * 4 + consts.numel() * 4
                + int(((bits.to(torch.int64) + 7) // 8).sum()) + bits.numel() * 4)
    if name == "exec":
        meta, lls, mls, ofvs, lits = a
        mt = meta.reshape(-1, m.ek.META_COLS).cpu()
        seq = mt[:, m.ek.M_KIND] == m.ek.KIND_SEQ
        nseq = int(mt[seq, m.ek.M_NSEQ].sum())
        out, mo = result
        return (meta.numel() * 4 + nseq * 12 + int(mo[:, 2].to(torch.int64).sum()) * 4
                + int(mo[:, 0].to(torch.int64).sum()) + mo.numel() * 4)
    if name == "fse_decode":
        words, starts, nseqs, tidx, tables, logs, consts = a
        words_used = int(((starts.to(torch.int64).clamp(min=0) + 7) // 8).sum())
        small = sum(t.numel() * 4 for t in (starts, nseqs, tidx, tables, logs, consts))
        return words_used + small + sum(t.numel() * 4 for t in result)
    if name == "byte_histogram":
        return a[0].numel() + result.numel() * 4
    if name == "table_lookup":
        return a[0].numel() + a[1].numel() * 4 + result.numel() * 4
    consts, meta, words, tables, lits = a
    mt = meta.reshape(-1, m.dk.META_COLS).cpu()
    seq = mt[:, m.dk.M_KIND] == m.dk.KIND_SEQ
    words_used = int(((mt[seq, m.dk.M_STARTBIT] + 7) // 8).sum())
    nlit = int(mt[mt[:, m.dk.M_KIND] != m.dk.KIND_RLE][:, m.dk.M_LITN].clamp(min=0).sum())
    per_lit = 1 if name == "ring_decode" else 4
    out, mo = result
    return (words_used + nlit * per_lit + tables.numel() * 4 + meta.numel() * 4
            + consts.numel() * 4 + int(mo[:, 0].to(torch.int64).sum()) + mo.numel() * 4)


def check_match_edge(mods, dev):
    """Phase 2 (edge input): the match kernel against its plain version on
    the ``collide`` input of tests/match_edges.py at 1 MiB. Returns the
    max abs error (raises unless 0)."""
    from tests import match_edges

    rows, lengths, BLK, SBd = match_edges.edge_case("collide", MIB)
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    a = [torch.from_numpy(x).to(dev) for x in (mods.fk.make_consts(), meta, words)]
    return compare("match", a, dict(BLK=BLK, SBd=SBd, n_frames=rows.shape[0]), mods)[0]


def sm_clock(fn, ms):
    """(SM clock, max SM clock) in MHz as nvidia-smi reads them while about
    0.4 s of launches of ``fn`` (``ms`` each, at least five) run; returns
    them with the last launch's result."""
    for _ in range(max(5, int(400 / max(ms, 1e-3)))):
        result = fn()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    mhz, max_mhz = (float(x) for x in smi.split(","))
    return mhz, max_mhz, result


def match_timing(mk, a, k, ms):
    """The [timing] match line: sequences per launch (from the stat rows),
    ms per launch, and ns and cycles per sequence of one frame's chain
    (frames parse in parallel) at the SM clock nvidia-smi reads while more
    launches run."""
    mhz, max_mhz, out = sm_clock(lambda: mk.match(*a, **k), ms)
    stat = out[3]
    nseq = int(stat[:, mk.ST_NSEQ].sum())
    per_frame = nseq / k["n_frames"]
    ns = ms * 1e6 / per_frame
    log(f"[timing] match: {nseq} sequences per launch ({per_frame:.1f} per frame, "
        f"{k['n_frames']} frames in parallel), {ms:.4f} ms per launch, {ns:.2f} ns and "
        f"{ns * mhz / 1e3:.1f} cycles per sequence at {mhz:.0f} MHz (SM clock under load; "
        f"max {max_mhz:.0f} MHz)")
    return dict(sequences=nseq, per_frame=per_frame, ms=ms, ns_per_seq=ns,
                cycles_per_seq=ns * mhz / 1e3, sm_mhz=mhz, max_sm_mhz=max_mhz)


def fse_decode_timing(ent, a, k, ms):
    """The [timing] fse_decode line: sequences per launch and the longest
    row's, ms per launch, ns and cycles per step of the longest chain (rows
    decode in parallel) at the SM clock under load, and how many rows with
    sequences had their stream staged whole or slid a window over it."""
    words, starts, nseqs = a[0], a[1], a[2]
    mhz, max_mhz, _ = sm_clock(lambda: ent.fse_decode_sequences(*a, **k), ms)
    nn = nseqs.to(torch.int64).clamp(0, k["seq_bound"]).cpu()
    live = nn > 0
    total, longest = int(nn.sum()), int(nn.max())
    whole = ent.staged_whole(starts.cpu(), words.shape[1])
    n_whole, n_window = int((whole & live).sum()), int((~whole & live).sum())
    ns = ms * 1e6 / max(longest, 1)
    log(f"[timing] fse_decode: {total} sequences per launch in {int(live.sum())} rows of "
        f"{words.shape[0]}, longest row {longest}, {ms:.4f} ms per launch, {ns:.2f} ns and "
        f"{ns * mhz / 1e3:.1f} cycles per step of the longest chain at {mhz:.0f} MHz (SM clock "
        f"under load; max {max_mhz:.0f} MHz); rows staged whole {n_whole}, window slid "
        f"{n_window} (stage_words {ent.stage_words(words.shape[1])} of WB {words.shape[1]})")
    return dict(sequences=total, longest=longest, ms=ms, ns_per_step=ns,
                cycles_per_step=ns * mhz / 1e3, sm_mhz=mhz, max_sm_mhz=max_mhz,
                rows_whole=n_whole, rows_window=n_window)


def fse_encode_timing(fk, a, k, ms, level):
    """The [timing] fse_encode line: jobs, sequences per launch and the
    longest job's, ms per launch, ns and cycles per step of the longest
    job (jobs encode in parallel) at the SM clock under load, and the time
    of the zero fill of the words that the wrapper does not do."""
    meta = a[1]
    nseq = meta[:, fk.J_NSEQ].to(torch.int64).clamp(0, k["SBd"]).cpu()
    mhz, max_mhz, _ = sm_clock(lambda: fk.fse_encode(*a, **k), ms)
    fill_ms = cuda_ms(lambda: torch.zeros((meta.shape[0], k["WBo"]), dtype=torch.int32,
                                          device=meta.device), 20)[0]
    total, longest, jobs = int(nseq.sum()), int(nseq.max()), int((nseq > 0).sum())
    ns = ms * 1e6 / max(longest, 1)
    log(f"[timing] fse_encode (level {level}): {jobs} jobs of {meta.shape[0]}, {total} sequences "
        f"per launch, longest job {longest}, {ms:.4f} ms per launch, {ns:.2f} ns and "
        f"{ns * mhz / 1e3:.1f} cycles per step of the longest job at {mhz:.0f} MHz (SM clock "
        f"under load; max {max_mhz:.0f} MHz), chunk {fk.CHUNK}; zero fill of the words (not "
        f"done) {fill_ms:.4f} ms")
    return dict(jobs=jobs, sequences=total, longest=longest, ms=ms, ns_per_step=ns,
                cycles_per_step=ns * mhz / 1e3, sm_mhz=mhz, max_sm_mhz=max_mhz,
                chunk=fk.CHUNK, zero_fill_ms=fill_ms)


def cuda_ms(fn, reps):
    """Mean CUDA-event milliseconds of ``fn()`` over ``reps`` launches,
    after one warm call; returns (ms, the warm call's result)."""
    result = fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps, result


L2_BYTES = 50 * 10**6  # H100 L2 cache

# The kernels whose rows give the device time alone (rows 6-9).
DEVICE_TIMED = ("byte_histogram", "table_lookup", "reach_tables", "reach_mark")


def cold_copies(nbytes):
    """Copies of a launch's inputs and outputs to rotate over so that their
    total exceeds 2.4 times the L2 cache (at least 4): each launch then finds
    its data cold (12 for the byte histogram at 10 MiB, 4 for the lookup)."""
    return max(4, -(-int(2.4 * L2_BYTES) // nbytes))


def graph_ms(calls, replays=5):
    """Device ms per call of ``calls`` (callables, each launching one kernel
    on the current stream and returning its output or None): at least 24
    calls, taken in turn, captured into one CUDA graph; CUDA events around
    each replay; the median of ``replays`` replays after a warm one. A
    wrapper's checks, allocation and ctypes call run only while the graph is
    captured, so a replay times the device alone. Each call's output is held
    until the same callable's next call, so the outputs rotate over
    ``len(calls) + 1`` allocations. Returns (ms, the last round's outputs as
    the replays left them)."""
    n = len(calls) * -(-24 // len(calls))
    for fn in calls:
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    held = [None] * len(calls)
    with torch.cuda.graph(graph):
        for i in range(n):
            held[i % len(calls)] = calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(replays):
        ev0.record()
        graph.replay()
        ev1.record()
        torch.cuda.synchronize()
        times.append(ev0.elapsed_time(ev1) / n)
    return sorted(times)[replays // 2], held


def device_ms(name, a, k, want, m):
    """``name``'s wrapper timed on the device alone (``graph_ms``): warm (on
    ``a``, back to back) and cold (rotated over ``cold_copies`` copies of
    ``a``). Every output must equal ``want``. Returns dict(cold_ms,
    warm_ms, bytes, bound_ms, copies)."""
    fn = wrapper(name, m)
    nbytes = moved_bytes(name, a, want, m)
    copies = cold_copies(nbytes)
    sets = [a] + [[t.clone() for t in a] for _ in range(copies - 1)]
    calls = [lambda s=s: fn(*s, **k) for s in sets]
    cold, outs = graph_ms(calls)
    warm, outs1 = graph_ms(calls[:1])
    for out in outs + outs1:
        if not torch.equal(out, want):
            raise AssertionError(f"{name}: an output of the captured wrapper differs")
    return dict(cold_ms=cold, warm_ms=warm, bytes=nbytes,
                bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, copies=copies)


def library_ms(name, a, k, copies):
    """The one PyTorch call that computes the byte kernel ``name``'s function,
    on ``copies`` rotated copies of its precomputed inputs: ``torch.take``
    in a CUDA graph (``graph_ms``); ``torch.bincount``, which synchronises
    to size its output and cannot be captured, back to back (events around
    24 calls). Returns (ms per call, method)."""
    d = a[0]
    if name == "table_lookup":
        idxs = [d.long() for _ in range(copies)]
        return graph_ms([lambda i=i: torch.take(a[1], i) for i in idxs])[0], "CUDA graph"
    block = k.get("block", 1 << 15)
    nbins = d.numel() // block * 256
    bins = [torch.arange(d.numel(), device=d.device) // block * 256 + d.long()
            for _ in range(copies)]
    for b in bins:
        torch.bincount(b, minlength=nbins)
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for i in range(24):
        torch.bincount(bins[i % copies], minlength=nbins)
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / 24, "back to back (syncs inside)"


def device_timing(name, a, k, result, m, smi):
    """Rows 6-9 of the kernel table on the device alone (``device_ms``):
    cold and warm, and the share of the bound cold ([timing] reach); for
    the byte kernels also cold at 160 MiB (16 copies of the text) and the
    library call on rotated copies ([timing] bytes)."""
    t = device_ms(name, a, k, result, m)
    desc = (f"device ms cold {t['cold_ms']:.6f} ({t['copies']} copies rotated), warm "
            f"{t['warm_ms']:.6f}; bound {t['bound_ms']:.6f} ms ({t['bytes']} bytes), "
            f"{100 * t['bound_ms'] / t['cold_ms']:.1f}% of it cold")
    if name not in ("byte_histogram", "table_lookup"):
        log(f"[timing] reach {name}: {desc}  ({smi})")
        return t
    big_a = [a[0].repeat(16)] + list(a[1:])
    want = result.repeat(16, 1) if name == "byte_histogram" else result.repeat(16)
    big = device_ms(name, big_a, k, want, m)
    lib_ms, method = library_ms(name, a, k, cold_copies(a[0].numel() * 8))
    t.update(big_cold_ms=big["cold_ms"], big_bytes=big["bytes"], big_bound_ms=big["bound_ms"],
             library_ms=lib_ms, library_method=method)
    call = "torch.take" if name == "table_lookup" else "torch.bincount"
    log(f"[timing] bytes {name}: {desc}; at 160 MiB cold {big['cold_ms']:.6f} ms, bound "
        f"{big['bound_ms']:.6f} ms ({100 * big['bound_ms'] / big['cold_ms']:.1f}%); {call} "
        f"{lib_ms:.6f} ms ({method}, rotated)  ({smi})")
    return t


def wrapper(name, m):
    """The wrapper (the entry point the path calls) of kernel ``name``."""
    return {"match": m.mk.match, "reach_tables": m.rch.chunk_pointer_tables,
            "reach_mark": m.rch.chunk_mark, "fse": m.fk.fse_encode,
            "ring_decode": m.rk.ring_decode, "wide_decode": m.dk.wide_decode,
            "exec": m.ek.serial_exec, "fse_decode": m.ent.fse_decode_sequences,
            "byte_histogram": m.bk.byte_histogram, "table_lookup": m.bk.table_lookup}[name]


def time_kernel(name, a, k, m, reps=5):
    fn = wrapper(name, m)
    return cuda_ms(lambda: fn(*a, **k), reps)


def stage_ms(stages_fn, a, k, reps=5):
    """Mean CUDA-event milliseconds of each stage of a staged kernel
    (``decode_kernel.wide_stages``, ``ring_kernel.ring_stages`` or
    ``exec_kernel.exec_stages``) on one call's inputs, over ``reps`` runs
    after a warm one (stage launches made here are not counted)."""
    _out, _mo, stages = stages_fn(*a, **k)
    for _name, launch in stages:
        launch()
    torch.cuda.synchronize()
    evs = [torch.cuda.Event(enable_timing=True) for _ in range(len(stages) + 1)]
    total = [0.0] * len(stages)
    for _ in range(reps):
        evs[0].record()
        for i, (_name, launch) in enumerate(stages):
            launch()
            evs[i + 1].record()
        torch.cuda.synchronize()
        for i in range(len(stages)):
            total[i] += evs[i].elapsed_time(evs[i + 1])
    return {name: t / reps for (name, _l), t in zip(stages, total)}


def med_spread(n, samples):
    s = sorted(samples)
    m = s[len(s) // 2] if len(s) % 2 else (s[len(s) // 2 - 1] + s[len(s) // 2]) / 2
    rates = sorted(n / x / MIB for x in samples)
    return n / m / MIB, rates[0], rates[-1]


def time_path(zt, data, level, dev, smi):
    """5 warm on-device encodes and decodes of ``data`` (1 MiB frames,
    checksums off, input staged): (encode, decode) median and spread in
    MiB/s, and the fenced phase split of one more run of each."""
    n = len(data)
    staged = zt.StagedInput(data, MIB, device=dev)
    zt.compress_archive(staged, frame_size=MIB, level=level, return_device=True)
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zt.compress_archive(staged, frame_size=MIB, level=level, return_device=True)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    enc = med_spread(n, samples)
    blob_nc, st_nc = zt.compress_archive(staged, frame_size=MIB, level=level)
    samples = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
        torch.cuda.synchronize()
        samples.append(time.perf_counter() - t0)
    dec = med_spread(n, samples)
    log(f"[timing] level {level}: on-device encode MiB/s median {enc[0]:.3f} "
        f"[{enc[1]:.3f}-{enc[2]:.3f}] x5; decode median {dec[0]:.3f} "
        f"[{dec[1]:.3f}-{dec[2]:.3f}] x5  ({smi})")
    zt.set_timing(2)
    zt.phase_records.clear()
    zt.compress_archive(staged, frame_size=MIB, level=level, return_device=True)
    enc_phases = dict(zt.phase_records)
    zt.phase_records.clear()
    zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
    dec_phases = dict(zt.phase_records)
    zt.set_timing(0)
    for tag, ph in (("enc", enc_phases), ("dec", dec_phases)):
        log(f"[timing] level {level} {tag} phases (fenced, s per 10 MiB): " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    return dict(enc_mibs=enc, dec_mibs=dec, enc_phases=enc_phases, dec_phases=dec_phases)


def patch_pair(data: bytes, seed: int = 5):
    """(old, new): old is the first 2 MiB of ``data``; new is old with 256
    seeded 16-byte overwrites and one 4 KiB insertion."""
    rng = np.random.default_rng(seed)
    old = data[: 2 * MIB]
    new = bytearray(old)
    for p in rng.integers(0, len(new) - 16, 256):
        new[p : p + 16] = rng.integers(0, 256, 16, dtype=np.uint8).tobytes()
    at = int(rng.integers(0, len(new)))
    new[at:at] = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    return old, bytes(new)


@contextlib.contextmanager
def env_vars(**values):
    """Each variable set to its value (None: unset) inside the block, and
    restored to what it was afterwards."""
    def put(items):
        for k, v in items:
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    old = [(k, os.environ.get(k)) for k in values]
    try:
        put(values.items())
        yield
    finally:
        put(old)


def exec_route(mode, var="ZEEKSTD_TPU_EXEC"):
    """``with exec_route("serial"):`` decodes on that route
    (ZEEKSTD_TPU_EXEC, or the variable ``var``), restoring it afterwards."""
    return env_vars(**{var: mode})


def synthetic_exec_rows(ek, dev):
    """Exec records built by hand, one frame each: every repeat form
    (explicit, rep1-3, the ll == 0 shift, rep1 - 1); overlapping matches of
    period 1 and 3 with trailing literals; a match across a 128-byte row,
    a literal record, an RLE record and 20 seeded sequences sliced at SBd;
    repeat history carried across blocks; a bad offset. Returns the
    wrapper's arguments on ``dev``."""
    SBd, LITB, OUTB = 8, 2048, 4096
    rng = np.random.default_rng(7)
    rows, frames, pools = [], [], []

    def seq_block(seqs, budget):
        first = len(rows)
        for i in range(0, max(len(seqs), 1), SBd):
            chunk = list(seqs[i : i + SBd])
            rows.append(chunk + [(0, 0, 0)] * (SBd - len(chunk)))
        return ("seq", first, len(seqs), budget)

    reps = [(10, 4, 7), (5, 3, 1), (5, 3, 2), (0, 3, 1), (0, 3, 3), (5, 3, 3), (5, 3, 8)]
    frames.append([seq_block(reps, 30)])
    pools.append(b"0123456789" * 4)
    frames.append([seq_block([(1, 500, 4), (3, 400, 6)], 8)])
    pools.append(b"xabcRest")
    seqs, pos = [], 131 + 130 + 50 + 300
    for _ in range(20):
        ll = int(rng.integers(1, 20))
        pos += ll
        ml = int(rng.integers(3, 12))
        seqs.append((ll, ml, int(rng.integers(1, pos + 1)) + 3))
        pos += ml
    budget = sum(q[0] for q in seqs) + 10
    frames.append([seq_block([(131, 130, 133)], 131), ("lit", 50), ("rle", 300, 0x5A),
                   seq_block(seqs, budget)])
    pools.append(bytes(range(131)) + rng.integers(0, 256, 50 + budget, dtype=np.uint8).tobytes())
    frames.append([seq_block([(10, 6, 10)], 10), seq_block([(0, 4, 1), (5, 4, 2)], 5)])
    pools.append(b"abcdefghij" + b"KLMNO")
    frames.append([seq_block([(3, 4, 103)], 3)])
    pools.append(b"abc")
    meta, _n = ek.build_records(frames, SBd)
    arr = np.asarray(rows, np.int32)  # (NROWS, SBd, 3)
    lrows = -(-max(len(p) for p in pools) // 128) + LITB // 128 + 1
    lits = np.zeros((len(pools), lrows * 128), np.int32)
    for f, p in enumerate(pools):
        lits[f, : len(p)] = np.frombuffer(p, np.uint8)
    args = [torch.from_numpy(np.ascontiguousarray(x)).to(dev)
            for x in (meta, arr[..., 0], arr[..., 1], arr[..., 2],
                      lits.reshape(len(pools), lrows, 128))]
    return args, dict(OUTB=OUTB, LITB=LITB, SBd=SBd)


def check_routes_small(zt, small, blob_s, st_s, dev, m, small_err):
    """Phase 2c (routes): the 256 KiB input's level-1 archive (96 KiB
    frames) and a level-3 archive (32 KiB frames) on the serial and the
    doubling route; every exec, FSE-decode and reachability call of those
    decodes against its plain version; the synthetic exec rows."""
    blob_3, st_3 = zt.compress_archive(small, frame_size=32 << 10, level=3, checksum=True,
                                       device=dev)
    with Recorder() as rec:
        for mode in ("serial", "doubling"):
            with exec_route(mode):
                for blob_x, st_x in ((blob_s, st_s), (blob_3, st_3)):
                    assert zt.decompress_archive(blob_x, st_x, device=dev) == small, mode
    out = {}
    for name in ("exec", "fse_decode", "reach_tables", "reach_mark"):
        calls = [(a, k) for a, k in rec.calls[name] if a[0].is_cuda]
        if not calls:
            raise AssertionError(f"{name}: the serial/doubling routes never called it")
        err = max(compare(name, a, k, m)[0] for a, k in calls)
        small_err[name] = max(small_err.get(name, 0), err)
        out[name] = len(calls)
        log(f"[routes] {name}: equal to its plain version on the 256 KiB serial and doubling "
            f"decodes ({len(calls)} call(s), max abs err {err})")
    args, kw = synthetic_exec_rows(m.ek, dev)
    err, _t = compare("exec", args, kw, m)
    _out0, mo0 = m.ek.exec_plain(*(t.cpu() for t in args), kw["OUTB"], kw["LITB"], kw["SBd"])
    assert mo0[:, 1].tolist() == [0, 0, 0, 0, 1], mo0[:, :3]
    log(f"[routes] exec: equal to its plain version on the synthetic rows "
        f"(totals {mo0[:, 0].tolist()}, bad flags {mo0[:, 1].tolist()})")
    return out


def check_byte_kernels(ops, data, dev, m, small_err):
    """Phase 2c (bytes): the byte histogram (32 KiB blocks) and the table
    lookup (a Huffman bit-count table) over the 10 MiB text, against their
    plain versions and against one PyTorch call each. Returns the recorder
    of the two launches and their launch counts."""
    block = 1 << 15
    d = torch.from_numpy(np.frombuffer(data, np.uint8).copy()).to(dev)
    table = torch.from_numpy(
        np.random.default_rng(3).integers(1, 12, 256).astype(np.int32)).to(dev)
    ops.reset_launches()
    with Recorder() as rec:
        hist = m.bk.byte_histogram(d, block=block)
        look = m.bk.table_lookup(d, table)
    counts = dict(ops.launches)
    if counts["byte_histogram"] != 1 or counts["table_lookup"] != 1:
        raise AssertionError(f"the byte kernels did not launch once each: {counts}")
    bins = torch.arange(d.numel(), device=dev) // block * 256 + d.long()
    if not torch.equal(hist.reshape(-1).long(),
                       torch.bincount(bins, minlength=d.numel() // block * 256)):
        raise AssertionError("byte_histogram disagrees with torch.bincount")
    if not torch.equal(look, torch.take(table, d.long())):
        raise AssertionError("table_lookup disagrees with torch.take")
    for name in ("byte_histogram", "table_lookup"):
        (a, k), = rec.calls[name]
        small_err[name] = compare(name, a, k, m)[0]
        log(f"[bytes] {name}: equal to its plain version and to the PyTorch call on "
            f"10 MiB")
    return rec, counts


def time_routes(zt, data, dev, smi):
    """Phase 4c: 5 warm level-3 decodes per route (checksums off, output
    left on the card): median and spread in MiB/s, then the fenced phase
    split of one more run."""
    n = len(data)
    staged = zt.StagedInput(data, MIB, device=dev)
    blob_nc, st_nc = zt.compress_archive(staged, frame_size=MIB, level=3)
    out = {}
    for mode in ("serial", "doubling"):
        with exec_route(mode):
            zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
            samples = []
            for _ in range(5):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
                torch.cuda.synchronize()
                samples.append(time.perf_counter() - t0)
            dec = med_spread(n, samples)
            zt.set_timing(2)
            zt.phase_records.clear()
            zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
            phases = dict(zt.phase_records)
            zt.set_timing(0)
        log(f"[timing] level 3 {mode} route: decode MiB/s median {dec[0]:.3f} "
            f"[{dec[1]:.3f}-{dec[2]:.3f}] x5  ({smi})")
        log(f"[timing] level 3 {mode} route phases (fenced, s per 10 MiB): " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))
        out[mode] = dict(dec_mibs=dec, dec_phases=phases)
    return out


def stream_encode(zt, data, dev, level, policy=None, prefix=None, write=128 << 10):
    """The streaming Encoder's archive (tpu backend on ``dev``, checksums
    on): ``data`` fed in ``write``-byte pieces, as the CLI reads."""
    buf = io.BytesIO()
    policy = policy or zt.FrameSizePolicy.uncompressed(MIB)
    enc = (zt.EncodeOptions().with_backend("tpu").with_device(dev)
           .with_frame_size_policy(policy).with_compression_level(level)
           .with_checksum_flag(True).into_encoder(buf))
    for i in range(0, len(data), write):
        enc.compress_with_prefix(data[i : i + write], prefix)
    enc.finish()
    return buf.getvalue()


def stream_decoder(zt, archive, dev, **kw):
    """A Decoder on the tpu backend over ``archive`` (``with_<name>`` for
    each keyword)."""
    opts = zt.DecodeOptions(zt.BytesWrapper(archive)).with_backend("tpu").with_device(dev)
    for name, value in kw.items():
        opts = getattr(opts, "with_" + name)(value)
    return opts.into_decoder()


def counted(ops, fn):
    """(fn(), the kernel launches it made)."""
    ops.reset_launches()
    out = fn()
    return out, dict(ops.launches)


def need(counts, names, what):
    missing = [k for k in names if counts[k] <= 0]
    if missing:
        raise AssertionError(f"{what}: kernels {missing} were not launched ({counts})")


def check_decoder(zt, archive, data, dev):
    """Phase 5b on one archive: the whole read, frames 3-5, a window across
    the boundary of frames 2 and 3, seek/read in 4 KiB steps for 64 KiB,
    and a flipped bit in frame 4 that must raise an errors.py error."""
    st = zt.SeekTable.from_bytes(archive)
    assert stream_decoder(zt, archive, dev).read(-1) == data, "Decoder: whole read"
    got = stream_decoder(zt, archive, dev, lower_frame=3, upper_frame=5).read(-1)
    assert got == data[st.frame_start_decomp(3) : st.frame_end_decomp(5)], "frames 3-5"
    dec = stream_decoder(zt, archive, dev)
    edge = st.frame_start_decomp(3)
    dec.set_offset(edge - 5000)
    dec.set_offset_limit(edge + 7000)
    assert dec.read(-1) == data[edge - 5000 : edge + 7000], "window across frames 2-3"
    dec.set_offset_limit(len(data))
    at = st.frame_start_decomp(6) - 30000
    dec.seek(at)
    for k in range(16):
        assert dec.read(4096) == data[at + 4096 * k : at + 4096 * (k + 1)], "seek/read"
    assert dec.tell() == at + (64 << 10)
    mid = (st.frame_start_comp(4) + st.frame_end_comp(4)) // 2
    bad = bytearray(archive)
    bad[mid] ^= 1 << 3
    try:
        stream_decoder(zt, bytes(bad), dev, lower_frame=4, upper_frame=4).read(-1)
    except zt.ZeekstdError as e:
        return f"error ({type(e).__name__}: {e})"
    raise AssertionError("a flipped bit in frame 4 did not raise an errors.py error")


def time_streaming(zt, ops, data, archive, level, dev, smi):
    """Phase 5f at one level: 5 warm streaming encodes and decodes (host
    bytes in and out) beside ``compress_archive``/``decompress_archive`` on
    the same input and archive; the device dispatches of each decode; the
    fenced phase split of one streaming and one archive decode."""
    n = len(data)

    def runs(fn):
        fn()
        samples = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples.append(time.perf_counter() - t0)
        return med_spread(n, samples)

    st = zt.SeekTable.from_bytes(archive)
    enc = runs(lambda: stream_encode(zt, data, dev, level))
    dec = runs(lambda: stream_decoder(zt, archive, dev).read(-1))
    a_enc = runs(lambda: zt.compress_archive(data, frame_size=MIB, level=level, checksum=True,
                                             device=dev))
    a_dec = runs(lambda: zt.decompress_archive(archive, st, device=dev))
    decoder = "ring_decode" if level == 1 else "wide_decode"
    _, c_stream = counted(ops, lambda: stream_decoder(zt, archive, dev).read(-1))
    _, c_arch = counted(ops, lambda: zt.decompress_archive(archive, st, device=dev))
    phases = {}
    zt.set_timing(2)
    for tag, fn in (("stream", lambda: stream_decoder(zt, archive, dev).read(-1)),
                    ("archive", lambda: zt.decompress_archive(archive, st, device=dev))):
        zt.phase_records.clear()
        fn()
        phases[tag] = dict(zt.phase_records)
    zt.set_timing(0)
    log(f"[timing] streaming level {level}: Encoder MiB/s median {enc[0]:.3f} "
        f"[{enc[1]:.3f}-{enc[2]:.3f}] x5, compress_archive {a_enc[0]:.3f} "
        f"[{a_enc[1]:.3f}-{a_enc[2]:.3f}]; Decoder {dec[0]:.3f} [{dec[1]:.3f}-{dec[2]:.3f}], "
        f"decompress_archive {a_dec[0]:.3f} [{a_dec[1]:.3f}-{a_dec[2]:.3f}] (host bytes in and "
        f"out, checksums on); {decoder} dispatches per decode: Decoder {c_stream[decoder]} "
        f"({st.num_frames} frames), decompress_archive {c_arch[decoder]}  ({smi})")
    for tag, ph in phases.items():
        log(f"[timing] streaming level {level} {tag} decode phases (fenced, s per 10 MiB): "
            + ", ".join(f"{k} {v:.6f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    return dict(enc_mibs=enc, dec_mibs=dec, archive_enc_mibs=a_enc, archive_dec_mibs=a_dec,
                dispatches=dict(stream=c_stream[decoder], archive=c_arch[decoder],
                                frames=st.num_frames), dec_phases=phases)


def check_streaming(zt, ops, data, small, archives, dev, smi):
    """Phase 5: the streaming Encoder and Decoder and the CLI on the card.
    ``archives`` maps level 1 and 3 to phase 3's and 3b's archives
    (``compress_archive`` at 1 MiB frames, checksums on, plus the Foot
    table). Returns (results, the launches of the counted runs, summed)."""
    from zeekstd_tpu_torch import cli

    res, total = {}, {k: 0 for k in ops.launches}

    def count(fn, names, what):
        out, c = counted(ops, fn)
        log(f"[streaming] {what}: launches {c}")
        need(c, names, what)
        for k, v in c.items():
            total[k] += v
        return out

    # a. the Encoder equals compress_archive plus its table
    for level, names in ((1, ("match", "fse")), (3, ("reach_tables", "reach_mark", "fse"))):
        got = count(lambda: stream_encode(zt, data, dev, level), names, f"Encoder level {level}")
        assert got == archives[level], f"level {level}: streaming archive differs"
        log(f"[streaming] Encoder level {level}: equal to compress_archive + Foot table "
            f"({len(got)} bytes)")
    # b. the Decoder over both archives
    for level, name in ((1, "ring_decode"), (3, "wide_decode")):
        res[f"corrupt{level}"] = count(lambda: check_decoder(zt, archives[level], data, dev),
                                       (name,), f"Decoder level {level}")
        log(f"[streaming] Decoder level {level}: whole, frames 3-5, a window across frames "
            f"2-3 and 16 reads of 4 KiB exact; flipped bit -> {res[f'corrupt{level}']}")
    # c. patch
    old, new = patch_pair(data)
    patch = count(lambda: stream_encode(zt, new, dev, 3, prefix=old), ("fse",), "patch encode")
    got = count(lambda: stream_decoder(zt, patch, dev, prefix=old).read(-1), (), "patch decode")
    assert got == new, "patch round trip"
    log(f"[streaming] patch: {len(new)} bytes against a {len(old)}-byte prefix -> "
        f"{len(patch)} bytes, back exactly")
    # d. the compressed policy
    # At 256 KiB the probe's 64 KiB steps and the cut frames take the match
    # kernel; at 6000 the 1500-byte probe steps take the parallel parse,
    # whose reachability does not tile 1500-byte rows and runs as torch
    # pointer doubling (the reference's route rule), and the cut frames
    # (32 KiB rows) the match kernel.
    for thr, inp, names in ((256 << 10, data, ("match", "fse")),
                            (6000, small, ("match", "fse"))):
        pol = zt.FrameSizePolicy.compressed(thr)
        blob = count(lambda: stream_encode(zt, inp, dev, 1, policy=pol), names,
                     f"compressed policy {thr}")
        st = zt.SeekTable.from_bytes(blob)
        sizes = [st.frame_size_comp(i) for i in range(st.num_frames)]
        assert st.num_frames >= 3 and min(sizes[:-1]) >= thr // 2, sizes
        assert stream_decoder(zt, blob, dev).read(-1) == inp, "compressed policy round trip"
        if inp is small:
            assert blob == stream_encode(zt, inp, "cpu", 1, policy=pol), "card differs from CPU"
        log(f"[streaming] compressed policy {thr} (probe step {max(thr // 4, 1024)}): "
            f"{st.num_frames} frames, compressed sizes {min(sizes[:-1])}-{max(sizes)}, back "
            f"exactly" + ("; equal to the CPU port's" if inp is small else ""))
    # e. the CLI, in process and once as a module
    work = os.path.join(ROOT, "build", "smoke_cli")
    os.makedirs(work, exist_ok=True)
    src, arc = os.path.join(work, "in.bin"), os.path.join(work, "in.bin.zst")
    with open(src, "wb") as fh:
        fh.write(data)

    def read(path):
        with open(path, "rb") as fh:
            return fh.read()

    def run(*argv):
        assert cli.main(list(argv)) == 0, argv

    count(lambda: run("-q", "compress", src, "-f", "--backend", "tpu", "-s", "1M", "-l", "3"),
          ("reach_tables", "reach_mark", "fse"), "CLI compress")
    assert read(arc) == archives[3], "CLI archive differs from compress_archive + table"
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        run("list", arc)
    count(lambda: run("-q", "d", arc, "-o", os.path.join(work, "range.bin"), "-f", "--backend",
                      "tpu", "--from-frame", "2", "--to-frame", "4"), ("wide_decode",),
          "CLI decompress frames 2-4")
    assert read(os.path.join(work, "range.bin")) == data[2 * MIB : 5 * MIB]
    count(lambda: run("-q", "decompress", arc, "-o", os.path.join(work, "out.bin"), "-f",
                      "--backend", "tpu"), ("wide_decode",), "CLI decompress")
    assert read(os.path.join(work, "out.bin")) == data
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "zeekstd_tpu_torch", "-q", "compress", src, "-o",
                    os.path.join(work, "module.zst"), "-f", "--backend", "tpu", "-s", "1M",
                    "-l", "3"], cwd=ROOT, check=True, timeout=300)
    assert read(os.path.join(work, "module.zst")) == archives[3], "module entry differs"
    log(f"[streaming] CLI: compress, list ({listing.getvalue().splitlines()[-1].split()[0]} "
        f"frames), decompress frames 2-4 and whole exact; python -m zeekstd_tpu_torch "
        f"compress on the card equal, {time.perf_counter() - t0:.1f}s")
    # f. timing
    for level in (1, 3):
        res[f"level{level}"] = time_streaming(zt, ops, data, archives[level], level, dev, smi)
    res["launches"] = total
    return res, total


def mt_offsets(zt, sizes, n):
    """The seek table of a ``compress_stream_mt`` blob of ``n`` bytes in
    1 MiB frames, and its compressed and decompressed frame offsets."""
    st = zt.SeekTable.from_frames((c, min(MIB, n - i * MIB)) for i, c in enumerate(sizes))
    c_off, d_off = st.cumulative_offsets()
    return st, [int(x) for x in c_off], [int(x) for x in d_off]


def check_native(zt, ops, data, dev, smi):
    """Phase 6a: the native runtime (``native/zeekstd_native.cpp``, g++ on
    the card machine's CPU), the backend users get with no ``--backend``.
    Returns (results, the launches of the counted runs, summed)."""
    from zeekstd_tpu_torch import cli
    from zeekstd_tpu_torch.native import loader

    res, total = {}, {k: 0 for k in ops.launches}
    decoders = ("ring_decode", "wide_decode", "exec", "fse_decode")
    n = len(data)
    for level in (1, 3):
        blob, sizes = loader.compress_stream_mt(data, MIB, checksum=True, nthreads=1,
                                                level=level)
        assert (blob, sizes) == loader.compress_stream_mt(data, MIB, checksum=True,
                                                          nthreads=0, level=level), \
            f"level {level}: the threaded blob differs from the one-thread blob"
        st, c_off, d_off = mt_offsets(zt, sizes, n)
        assert st.size_comp == len(blob) and st.num_frames == 10
        assert loader.decompress_stream_mt(blob, c_off, d_off, nthreads=0) == data
        out, c = counted(ops, lambda: zt.decompress_archive(blob, st, device=dev))
        assert out == data, f"level {level}: the card's decode of the native blob differs"
        if not any(c[k] for k in decoders):
            raise AssertionError(f"level {level}: the card decoded without a decode kernel ({c})")
        for k, v in c.items():
            total[k] += v
        res[f"ratio{level}"] = len(blob) / n
        log(f"[native] level {level}: compress_stream_mt 10 MiB -> {len(blob)} bytes in "
            f"{len(sizes)} frames, nthreads=1 and 0 equal; decompress_stream_mt and the "
            f"card's decompress_archive exact (launches {c})")
    # The default Encoder writes the native backend's archive; so does the CLI.
    def encode(backend, level=3):
        buf = io.BytesIO()
        opts = (zt.EncodeOptions().with_frame_size_policy(zt.FrameSizePolicy.uncompressed(MIB))
                .with_compression_level(level).with_checksum_flag(True))
        if backend is not None:
            opts = opts.with_backend(backend)
        enc = opts.into_encoder(buf)
        assert enc.raw._use_native()
        for i in range(0, n, 128 << 10):
            enc.write(data[i : i + (128 << 10)])
        enc.finish()
        return buf.getvalue()

    default = encode(None)
    assert default == encode("native"), "the default Encoder differs from the native backend"
    assert zt.DecodeOptions(zt.BytesWrapper(default)).into_decoder().read(-1) == data
    work = os.path.join(ROOT, "build", "smoke_native")
    os.makedirs(work, exist_ok=True)
    src = os.path.join(work, "in.bin")
    with open(src, "wb") as fh:
        fh.write(data)

    def path(name):
        return os.path.join(work, name)

    def read(name):
        with open(path(name), "rb") as fh:
            return fh.read()

    def run(*argv):
        assert cli.main(list(argv)) == 0, argv

    size = f"{MIB >> 10}K"
    run("-q", "compress", src, "-o", path("auto.zst"), "-f", "-s", size)
    assert read("auto.zst") == default, "the CLI's default archive differs from the Encoder's"
    listing = io.StringIO()
    with contextlib.redirect_stdout(listing):
        run("list", path("auto.zst"))
    out, c = counted(ops, lambda: run("-q", "decompress", path("auto.zst"), "-o",
                                      path("auto.bin"), "-f", "--backend", "tpu"))
    assert read("auto.bin") == data, "CLI: native archive, card decode"
    if not any(c[k] for k in decoders):
        raise AssertionError(f"CLI decompress --backend tpu launched no decode kernel ({c})")
    for k, v in c.items():
        total[k] += v
    _, c = counted(ops, lambda: run("-q", "compress", src, "-o", path("tpu.zst"), "-f", "-s",
                                    size, "--backend", "tpu"))
    need(c, ("reach_tables", "reach_mark", "fse"), "CLI compress --backend tpu")
    for k, v in c.items():
        total[k] += v
    run("-q", "decompress", path("tpu.zst"), "-o", path("tpu.bin"), "-f")
    assert read("tpu.bin") == data, "CLI: card archive, native decode"
    log(f"[native] default Encoder (level 3, 1 MiB frames) equals with_backend('native') "
        f"({len(default)} bytes); CLI with no --backend writes it, list "
        f"({listing.getvalue().splitlines()[-1].split()[0]} frames), decompress --backend tpu "
        f"exact; compress --backend tpu, decompress with no --backend exact")
    # Host rates: the card machine's CPU, not the card.
    for level in (1, 3):
        blob, sizes = loader.compress_stream_mt(data, MIB, checksum=True, level=level)
        _, c_off, d_off = mt_offsets(zt, sizes, n)
        into = bytearray(n)
        for nt in (1, 0):
            enc = med_spread(n, host_samples(lambda: loader.compress_stream_mt(
                data, MIB, checksum=True, nthreads=nt, level=level)))
            dec = med_spread(n, host_samples(lambda: loader.decompress_stream_mt(
                blob, c_off, d_off, nthreads=nt, into=into)))
            res[f"level{level}_nthreads{nt}"] = dict(enc_mibs=enc, dec_mibs=dec)
            log(f"[timing] native level {level} nthreads={nt}: compress_stream_mt MiB/s median "
                f"{enc[0]:.3f} [{enc[1]:.3f}-{enc[2]:.3f}] x5, decompress_stream_mt "
                f"{dec[0]:.3f} [{dec[1]:.3f}-{dec[2]:.3f}] x5 (host CPU, os.cpu_count() "
                f"{os.cpu_count()}; card {smi})")
    res["cpu_count"] = os.cpu_count()
    res["launches"] = total
    return res, total


def host_samples(fn, reps=5):
    """Seconds of ``reps`` calls of ``fn`` after one warm call."""
    fn()
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        samples.append(time.perf_counter() - t0)
    return samples


def check_frame_codec(zt, ops, data, small, dev, smi, mods):
    """Phase 6b: the per-frame device encoder (``frame_codec``) on the card
    over the 10 MiB text in 1 MiB frames and over the 256 KiB input.
    Returns (results, the launches of the counted run, its FSE calls, the
    FSE kernel's max error against its plain version)."""
    from zeekstd_tpu_torch import frame_codec
    from zeekstd_tpu_torch.codec.decompress import decompress_frame as host_decompress_frame

    res = {}
    pieces = [data[i : i + MIB] for i in range(0, len(data), MIB)] + [small]
    ops.reset_launches()
    with Recorder() as rec:
        frames = [frame_codec.compress_frame(p, checksum=True, device=dev) for p in pieces]
    counts = dict(ops.launches)
    if counts["fse"] != len(pieces):
        raise AssertionError(f"frame_codec: {counts['fse']} FSE launches for {len(pieces)} "
                             "frames, not one each")
    for i in (0, len(pieces) - 1):
        assert frames[i] == frame_codec.compress_frame(pieces[i], checksum=True, device="cpu"), \
            f"frame_codec: the card's frame {i} differs from the CPU run's"
    for p, f in zip(pieces, frames):
        assert zt.archive.decompress_frame(f, device=dev) == (p, len(f)), "card decode"
        assert host_decompress_frame(f) == (p, len(f)), "host decode"
    err = 0
    for a, k in rec.calls["fse"]:
        err = max(err, compare("fse", a, k, mods)[0])
    log(f"[frame_codec] 10 MiB in 1 MiB frames and the 256 KiB input: {sum(map(len, frames))} "
        f"bytes; frames 0 and 256 KiB equal to the CPU run's; every frame back through "
        f"decompress_frame on the card and the host codec; FSE (wide layout) equal to its "
        f"plain version on every launch (max abs err {err}); launches {counts}")
    a, k = rec.calls["fse"][0]
    ms, result = time_kernel("fse", a, k, mods, reps=5)
    nseq = int(a[1].reshape(-1, mods.fk.JMETA_COLS)[:, mods.fk.J_NSEQ].clamp(min=0).sum())
    moved = moved_bytes("fse", a, result, mods) + nseq * 4  # and the ml row
    res["fse_wide"] = dict(ms=ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3, moved=moved)
    log(f"[timing] fse wide layout (phase 6b, one 1 MiB frame): {ms:.4f} ms/launch, bound "
        f"{res['fse_wide']['bound_ms']:.6f} ms ({moved} bytes)")
    text = pieces[:-1]
    n = len(data)

    def encode_all():
        for p in text:
            frame_codec.compress_frame(p, checksum=True, device=dev)
        torch.cuda.synchronize()

    enc = med_spread(n, host_samples(encode_all))
    zt.set_timing(2)
    zt.phase_records.clear()
    encode_all()
    phases = dict(zt.phase_records)
    zt.set_timing(0)
    res.update(enc_mibs=enc, phases=phases, launches=counts, fse_err=err)
    log(f"[timing] frame_codec: 10 MiB in 1 MiB frames, MiB/s median {enc[0]:.3f} "
        f"[{enc[1]:.3f}-{enc[2]:.3f}] x5 (host bytes in and out, checksums on)  ({smi})")
    log("[timing] frame_codec phases (fenced, s per 10 MiB): " + ", ".join(
        f"{k} {v:.6f}" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))
    return res, counts, err


# Phase 7's ranges cross frame edges of the 1 MiB frames.
MESH_RANGES = [(MIB - 100, MIB + 100), (3 * MIB - 5, 5 * MIB + 5), (0, 10), (9 * MIB + 1, 10 * MIB)]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def add_counts(total, counts):
    for k, v in counts.items():
        total[k] += v


def check_mesh(zt, ops, data, dev, smi):
    """Phases 7a and 7b: the mesh pipeline (``parallel/``) in one process
    on an NCCL group of world size 1. Returns (results, the launches of
    the counted runs, summed, phase 7a's level-1 archive without
    checksums)."""
    import torch.distributed as dist
    from zeekstd_tpu_torch import parallel

    res, total, blobs = {}, {k: 0 for k in ops.launches}, {}
    n = len(data)
    torch.cuda.set_device(dev)
    parallel.init_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    try:
        mesh = parallel.make_mesh()
        assert dist.get_backend(mesh.group) == "nccl" and mesh.size == 1
        assert mesh.collective_device() == dev
        for level in (1, 3):
            route, other = ("ring_decode", "wide_decode")[:: 1 if level == 1 else -1]
            for checksum in (False, True):
                (blob, st), c = counted(ops, lambda: parallel.parallel_compress(
                    data, mesh, frame_size=MIB, level=level, checksum=checksum))
                add_counts(total, c)
                need(c, ("match", "fse") if level == 1 else ("reach_tables", "reach_mark", "fse"),
                     f"mesh encode, level {level}")
                single, single_st = zt.compress_archive(data, frame_size=MIB, level=level,
                                                        checksum=checksum, device=dev)
                assert blob == single, f"level {level}: the mesh archive differs"
                assert st.to_bytes() == single_st.to_bytes(), f"level {level}: seek tables differ"
                out, c = counted(ops, lambda: parallel.parallel_decompress(blob, st, mesh))
                add_counts(total, c)
                assert out == data, f"level {level}: the mesh decode differs"
                if c[route] != 1 or c[other]:
                    raise AssertionError(f"mesh decode, level {level}: not one {route} launch "
                                         f"({c})")
                with exec_route("doubling", "ZEEKSTD_TPU_MESH_EXEC"):
                    out, cd = counted(ops, lambda: parallel.parallel_decompress(blob, st, mesh))
                add_counts(total, cd)
                assert out == data, f"level {level}: the mesh doubling decode differs"
                need(cd, ("fse_decode", "reach_tables", "reach_mark"), "mesh doubling decode")
                if cd["ring_decode"] or cd["wide_decode"]:
                    raise AssertionError(f"the mesh doubling route launched a fused decoder ({cd})")
                blobs[level, checksum] = (blob, st)
                log(f"[mesh] level {level}, checksums {'on' if checksum else 'off'}: archive and "
                    f"seek table equal compress_archive's; fused decode exact with one {route} "
                    f"launch, doubling decode exact (launches {c} / {cd})")
            got, c = counted(ops, lambda: parallel.parallel_random_access(blob, st, MESH_RANGES,
                                                                          mesh))
            add_counts(total, c)
            assert got == [data[a:b] for a, b in MESH_RANGES], f"level {level}: random access"
        frames, owners = parallel.route_queries(st, [0, MIB, 5 * MIB + 3, n - 1], mesh)
        assert list(frames) == [0, 1, 5, 9] and not owners.any(), (frames, owners)
        (rows, plan, st_m), c = counted(ops, lambda: parallel.multihost_compress(
            data, frame_size=MIB, mesh=mesh, level=1))
        add_counts(total, c)
        stitched = bytearray(st_m.size_comp)
        for row, (off, size) in zip(rows, plan):
            stitched[off : off + size] = row
        blob1, st1 = blobs[1, False]
        assert bytes(stitched) == blob1 and st_m.to_bytes() == st1.to_bytes(), "write plan"
        log(f"[mesh] random access over {len(MESH_RANGES)} ranges across frame edges exact at "
            f"levels 1 and 3; route_queries owners all 0; multihost_compress rows stitched by "
            f"the write plan equal the blob")
        res["timing"] = {level: time_mesh(zt, parallel, mesh, data, *blobs[level, False],
                                          level, dev, smi) for level in (1, 3)}
        res["scale"], c = mesh_scale(zt, ops, parallel, mesh, dev, smi)
        add_counts(total, c)
    finally:
        dist.destroy_process_group()
    return res, total, blobs[1, False]


def time_mesh(zt, parallel, mesh, data, blob, st, level, dev, smi):
    """Phase 7a's timing at one level: 5 warm runs each, in turns, of the
    mesh encode and decode and of ``compress_archive`` and
    ``decompress_archive`` (host bytes in and out, checksums off):
    median and spread in MiB/s; the fenced phase split of one mesh encode
    and one mesh decode."""
    n = len(data)
    fns = {
        "mesh_enc": lambda: parallel.parallel_compress(data, mesh, frame_size=MIB, level=level),
        "enc": lambda: zt.compress_archive(data, frame_size=MIB, level=level, device=dev),
        "mesh_dec": lambda: parallel.parallel_decompress(blob, st, mesh),
        "dec": lambda: zt.decompress_archive(blob, st, device=dev),
    }
    samples = {k: [] for k in fns}
    for fn in fns.values():
        fn()
    for _ in range(5):
        for k, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            samples[k].append(time.perf_counter() - t0)
    rates = {k: med_spread(n, v) for k, v in samples.items()}
    log(f"[timing] mesh level {level} (NCCL, one shard; host bytes in and out, checksums off; "
        f"MiB/s median [spread] x5): " + ", ".join(
            f"{k} {m:.3f} [{lo:.3f}-{hi:.3f}]" for k, (m, lo, hi) in rates.items())
        + f"  ({smi})")
    phases = {}
    zt.set_timing(2)
    for tag in ("mesh_enc", "mesh_dec"):
        zt.phase_records.clear()
        fns[tag]()
        phases[tag] = dict(zt.phase_records)
    zt.set_timing(0)
    for tag, ph in phases.items():
        log(f"[timing] mesh level {level} {tag} phases (fenced, s per 10 MiB): " + ", ".join(
            f"{k} {v:.6f}" for k, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    return dict(mibs=rates, phases=phases)


def mesh_scale(zt, ops, parallel, mesh, dev, smi):
    """Phase 7b: one 64 MiB level-1 round trip through the mesh in 2 MiB
    frames, against ``compress_archive``, each timed once; the fenced
    phase split of a second mesh decode."""
    big = build_corpus(64 << 20)
    n = len(big)
    fs = 2 * MIB
    ops.reset_launches()
    t0 = time.perf_counter()
    blob, st = parallel.parallel_compress(big, mesh, frame_size=fs, level=1)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = parallel.parallel_decompress(blob, st, mesh)
    t_dec = time.perf_counter() - t0
    counts = dict(ops.launches)
    assert out == big, "64 MiB: the mesh decode differs"
    t0 = time.perf_counter()
    single, single_st = zt.compress_archive(big, frame_size=fs, level=1, device=dev)
    t_single = time.perf_counter() - t0
    assert blob == single and st.to_bytes() == single_st.to_bytes(), "64 MiB: archive differs"
    need(counts, ("match", "fse", "ring_decode"), "64 MiB mesh round trip")
    zt.set_timing(2)
    zt.phase_records.clear()
    parallel.parallel_decompress(blob, st, mesh)
    phases = dict(zt.phase_records)
    zt.set_timing(0)
    res = dict(frames=st.num_frames, ratio=len(blob) / n, enc_mibs=n / t_enc / MIB,
               dec_mibs=n / t_dec / MIB, single_enc_mibs=n / t_single / MIB,
               dec_phases=phases)
    log(f"[mesh] 64 MiB, 2 MiB frames, level 1: {st.num_frames} frames, ratio "
        f"{res['ratio']:.6f}; archive equal to compress_archive's; round trip exact "
        f"(launches {counts})")
    log(f"[timing] mesh 64 MiB (once, host bytes in and out): encode {res['enc_mibs']:.3f} "
        f"MiB/s, decode {res['dec_mibs']:.3f}; compress_archive {res['single_enc_mibs']:.3f}  "
        f"({smi})")
    log("[timing] mesh 64 MiB decode phases (a second decode, fenced, s per 64 MiB): "
        + ", ".join(f"{k} {v:.6f}" for k, v in sorted(phases.items(), key=lambda kv: -kv[1])))
    return res, counts


def mesh_child(rank: int, port: str, outdir: str) -> int:
    """Phase 7c, one of two processes on the card: a gloo group (two
    processes cannot share a card in one NCCL communicator), the 10 MiB
    text at level 1 in 1 MiB frames. Compresses only this process's
    frames (``multihost_compress``), writes them into one shared archive
    at the write plan's offsets, then decodes the whole archive and
    MESH_RANGES over the two-process mesh; writes child{rank}.json and
    part{rank}.bin to ``outdir``."""
    import hashlib

    import torch.distributed as dist
    from zeekstd_tpu_torch import ops, parallel
    from zeekstd_tpu_torch.parallel.pipeline import _frame_layout

    parallel.init_multihost(f"127.0.0.1:{port}", 2, rank, backend="gloo")
    try:
        data = build_corpus(10 << 20)
        n = len(data)
        mesh = parallel.make_multihost_mesh()
        assert mesh.size == 2 and mesh.devices[0].type == "cuda"
        _, F_pad = _frame_layout(n, MIB, mesh.size)
        lo, hi = parallel.process_frame_slice(F_pad, mesh)
        ops.reset_launches()
        t0 = time.perf_counter()
        rows, plan, st = parallel.multihost_compress(
            data[lo * MIB : min(hi * MIB, n)], first_frame=lo, n_total=n, frame_size=MIB,
            mesh=mesh, level=1)
        t_enc = time.perf_counter() - t0
        with open(os.path.join(outdir, f"part{rank}.bin"), "wb") as f:
            f.write(b"".join(rows))
        path = os.path.join(outdir, "archive.bin")
        if rank == 0:
            with open(path, "wb") as f:
                f.truncate(st.size_comp)
        dist.barrier()
        fd = os.open(path, os.O_WRONLY)
        try:
            for row, (off, size) in zip(rows, plan):
                os.pwrite(fd, row, off)
        finally:
            os.close(fd)
        dist.barrier()
        with open(path, "rb") as f:
            archive = f.read()
        t0 = time.perf_counter()
        out = parallel.parallel_decompress(archive, st, mesh)
        t_dec = time.perf_counter() - t0
        got = parallel.parallel_random_access(archive, st, MESH_RANGES, mesh)
        res = dict(rank=rank, first_frame=lo, plan=plan, st=st.to_bytes().hex(),
                   decoded_whole=out == data, ranges_ok=got == [data[a:b] for a, b in MESH_RANGES],
                   ranges_sha=hashlib.sha256(b"".join(got)).hexdigest(),
                   launches=dict(ops.launches), enc_s=t_enc, dec_s=t_dec)
        with open(os.path.join(outdir, f"child{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()
    return 0


def check_mesh_processes(ops, blob1, st1, smi, timeout=600):
    """Phase 7c: two processes of this script (``--mesh-child``) on the
    card. Their stitched archive must equal phase 7a's level-1 blob, both
    seek tables its table, and both must decode the whole text and the
    same ranges. Returns (results, their launches, summed)."""
    work = os.path.join(ROOT, "build", "smoke_mesh")
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(work):
        os.remove(os.path.join(work, name))
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--mesh-child",
                               str(rank), str(port), work],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for rank in (0, 1)]
    try:
        outs = [p.communicate(timeout=timeout)[0].decode(errors="replace") for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"7c: process {rank} exited {p.returncode}:\n{out[-4000:]}")
    kids = []
    for rank in (0, 1):
        with open(os.path.join(work, f"child{rank}.json")) as f:
            kids.append(json.load(f))
    stitched = bytearray(len(blob1))
    for rank, kid in enumerate(kids):
        with open(os.path.join(work, f"part{rank}.bin"), "rb") as f:
            part = f.read()
        pos = 0
        for off, size in kid["plan"]:
            stitched[off : off + size] = part[pos : pos + size]
            pos += size
        assert pos == len(part), f"7c: process {rank}'s rows do not match its plan"
    assert bytes(stitched) == blob1, "7c: the stitched archive differs from phase 7a's"
    with open(os.path.join(work, "archive.bin"), "rb") as f:
        assert f.read() == blob1, "7c: the shared archive file differs from phase 7a's"
    assert all(bytes.fromhex(k["st"]) == st1.to_bytes() for k in kids), "7c: seek tables"
    assert all(k["decoded_whole"] and k["ranges_ok"] for k in kids), "7c: a process's decode"
    assert kids[0]["ranges_sha"] == kids[1]["ranges_sha"]
    total = {k: 0 for k in ops.launches}
    for kid in kids:
        add_counts(total, kid["launches"])
    log(f"[mesh] 7c: two processes on the card (gloo): frames from {kids[0]['first_frame']} and "
        f"{kids[1]['first_frame']}; stitched archive and both seek tables equal phase 7a's; "
        f"both decoded the whole text and the same ranges (launches {total}, {wall:.1f}s wall)")
    log("[timing] mesh 7c (once per process, the pair sharing the card): " + "; ".join(
        f"process {k['rank']} encode {k['enc_s']:.3f}s, decode {k['dec_s']:.3f}s" for k in kids)
        + f"  ({smi})")
    return dict(wall_s=wall, children=kids), total


# Phase 8: the archive block sizes other than the default 32 KiB, one
# child process each (ZEEKSTD_TPU_BLOCK is read at import).
BLOCK_SIZES = (16 << 10, 64 << 10, 128 << 10)
# The decode routes of phase 8, as (name, variable, value): the fused route
# (ring at level 1, wide at level 3, as the declared windows choose), the
# wide route forced, serial, doubling.
BLOCK_ROUTES = (("fused", None, None), ("wide", "ZEEKSTD_TPU_RING", "0"),
                ("serial", "ZEEKSTD_TPU_EXEC", "serial"),
                ("doubling", "ZEEKSTD_TPU_EXEC", "doubling"))


def decode_routes_exact(zt, blob, st, data, dev):
    """Decode ``blob`` on every route of BLOCK_ROUTES (exact); returns the
    fused-route guard hand-offs each counted."""
    from zeekstd_tpu_torch import decode_routes

    handoffs = {}
    for route, var, value in BLOCK_ROUTES:
        with exec_route(value, var) if var else contextlib.nullcontext():
            n0 = decode_routes.serial_fallback_count()
            assert zt.decompress_archive(blob, st, device=dev) == data, route
            handoffs[route] = decode_routes.serial_fallback_count() - n0
    return handoffs


def block_child(outdir: str) -> int:
    """Phase 8, one block size (this process's ZEEKSTD_TPU_BLOCK): (a) the
    256 KiB mixed input and the long-run input of tests/block_cases.py at
    levels 1 and 3 in 256 KiB frames: every match and FSE launch equals its
    plain version, the FSE kernel on its wide instance above 32 KiB, the
    archive the CPU port's, every route decodes it; (b) the 10 MiB text at
    levels 1 and 3 in 1 MiB frames, encoded and decoded on every route
    (counted), then timed. Writes block<BLK>.json to ``outdir``."""
    import zeekstd_tpu_torch as zt
    from zeekstd_tpu_torch import archive, ops

    mods = kernel_modules()
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    BLK = archive.BLOCK_SIZE
    wide = mods.mk.wide_rows(BLK)
    res = {"block": BLK, "wide_rows": wide}
    tag = f"[blocks {BLK >> 10} KiB]"

    # (a) small inputs: kernels against their plain versions, card = CPU.
    err = {"match": 0, "fse": 0}
    small = {"mixed": mixed_input(256 << 10), "long_run": long_run()}
    small_handoffs = {}
    for name, data in small.items():
        for level in (1, 3):
            with Recorder() as rec:
                blob, st = zt.compress_archive(data, frame_size=256 << 10, level=level,
                                               checksum=True, device=dev)
            cpu, _ = zt.compress_archive(data, frame_size=256 << 10, level=level,
                                         checksum=True, device="cpu")
            assert blob == cpu, f"{tag} {name} L{level}: card archive differs from the CPU's"
            if level == 1 and not rec.calls["match"]:
                raise AssertionError(f"{tag} {name}: level 1 did not call the match kernel")
            for kname in ("match", "fse"):
                for a, k in rec.calls[kname]:
                    err[kname] = max(err[kname], compare(kname, a, k, mods)[0])
                    if kname == "fse" and (k.get("ml") is not None) != wide:
                        raise AssertionError(f"{tag}: the FSE call took the wrong layout")
            small_handoffs[f"{name} L{level}"] = decode_routes_exact(zt, blob, st, data, dev)
    res.update(small_err=err, small_handoffs=small_handoffs)
    log(f"{tag} (a) 256 KiB mixed and long-run inputs, levels 1 and 3: match and FSE "
        f"({'wide' if wide else 'packed'} rows) equal to their plain versions (max abs err "
        f"{max(err.values())}); archives equal the CPU port's; every route exact; guard "
        f"hand-offs {small_handoffs}")

    # (b) the 10 MiB text, counted: encode and every route at levels 1 and 3.
    data = build_corpus(10 << 20)
    n = len(data)
    calls, sizes, handoffs = {}, {}, {}
    ops.reset_launches()
    for level in (1, 3):
        with Recorder() as rec:
            blob, st = zt.compress_archive(data, frame_size=MIB, level=level, checksum=True,
                                           device=dev)
        calls[level] = rec.calls
        sizes[level] = len(blob)
        handoffs[level] = decode_routes_exact(zt, blob, st, data, dev)
    counts = dict(ops.launches)
    for name in ("match", "fse", "ring_decode", "wide_decode", "exec", "fse_decode",
                 "reach_tables", "reach_mark"):
        if counts[name] <= 0:
            raise AssertionError(f"{tag}: kernel {name} was not launched")
    res.update(sizes=sizes, handoffs=handoffs, launches=counts)
    log(f"{tag} (b) 10 MiB text in 1 MiB frames: {sizes[1]} bytes at L1, {sizes[3]} at L3; "
        f"every route exact; guard hand-offs L1 {handoffs[1]}, L3 {handoffs[3]}; launches "
        f"{counts}")
    # (b)'s encode launches against their plain versions (not counted): the
    # level-1 match launch (every frame) and each level's FSE launches.
    err_b, plain_s = {}, {}
    err_b["match"], plain_s["match"] = compare("match", *calls[1]["match"][0], mods)
    for level in (1, 3):
        err_b[f"fse_level{level}"], plain_s[f"fse_level{level}"] = 0, 0.0
        for a, k in calls[level]["fse"]:
            if (k.get("ml") is not None) != wide:
                raise AssertionError(f"{tag}: the 10 MiB FSE call took the wrong layout")
            e, t = compare("fse", a, k, mods)
            err_b[f"fse_level{level}"] = max(err_b[f"fse_level{level}"], e)
            plain_s[f"fse_level{level}"] += t
    res.update(err_10mib=err_b, plain_s_10mib=plain_s)
    log(f"{tag} (b) 10 MiB: match (level 1) and FSE (levels 1 and 3, "
        f"{'wide' if wide else 'packed'} rows) equal to their plain versions at the "
        f"archive's shapes (max abs err {max(err_b.values())}; plain "
        + ", ".join(f"{n} {t:.3f}s" for n, t in plain_s.items()) + ")")

    # Timing (not counted): the 10 MiB paths, the match kernel, the FSE launches.
    res["timing"] = {level: time_path(zt, data, level, dev, smi) for level in (1, 3)}
    a, k = calls[1]["match"][0]
    ms = time_kernel("match", a, k, mods)[0]
    res["match"] = match_timing(mods.mk, a, k, ms)
    res["match"]["smem_bytes"] = mods.mk.smem_bytes(BLK)
    log(f"{tag} [timing] match: {ms:.4f} ms per launch, {res['match']['cycles_per_seq']:.1f} "
        f"cycles per sequence, {res['match']['smem_bytes']} bytes of dynamic shared memory "
        f"per block  ({smi})")
    for level in (1, 3):
        a, k = calls[level]["fse"][0]
        ms, result = time_kernel("fse", a, k, mods)
        moved = moved_bytes("fse", a, result, mods, k)
        res[f"fse_level{level}"] = dict(ms=ms, bound_ms=moved / HBM_BYTES_PER_S * 1e3,
                                        moved=moved, wide=k.get("ml") is not None)
        log(f"{tag} [timing] fse ({'wide' if wide else 'packed'} instance, level {level}, "
            f"10 MiB): {ms:.4f} ms per launch, bound {moved / HBM_BYTES_PER_S * 1e3:.6f} ms "
            f"({moved} bytes)  ({smi})")
    with open(os.path.join(outdir, f"block{BLK}.json"), "w") as f:
        json.dump(res, f, default=str)
    return 0


def run_children(flag, subdir, envs, timeout=600, together=False):
    """Run this script with ``flag`` and a work directory (build/``subdir``,
    emptied first) once per entry of ``envs`` ({label: environment}), one
    after another or, with ``together``, all at once. A child's nonzero
    exit or timeout fails the phase. Returns (the work directory, {label:
    (stdout, stderr, wall seconds)})."""
    work = os.path.join(ROOT, "build", subdir)
    os.makedirs(work, exist_ok=True)
    for name in os.listdir(work):
        os.remove(os.path.join(work, name))
    outs = {}
    for batch in ([list(envs)] if together else [[label] for label in envs]):
        t0 = time.perf_counter()
        procs = {label: subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), flag, work], env=envs[label],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE) for label in batch}
        try:
            for label, proc in procs.items():
                out, err = proc.communicate(timeout=timeout)
                outs[label] = (out.decode(errors="replace"), err.decode(errors="replace"),
                               time.perf_counter() - t0)
        finally:
            for proc in procs.values():
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
        for label, proc in procs.items():
            if proc.returncode != 0:
                raise AssertionError(f"{flag}: the {label} child exited {proc.returncode}:\n"
                                     f"{(outs[label][0] + outs[label][1])[-4000:]}")
    return work, outs


def check_blocks(ops, smi, blocks=BLOCK_SIZES, sizes32=None, timing32=None, timeout=600):
    """Phase 8: one child of this script (``--block-child``) per block size
    of ``blocks``, one after another, each with ZEEKSTD_TPU_BLOCK set. A
    child's failure or timeout fails the phase. Prints the compressed
    bytes, the encode and decode rates and split, beside the 32 KiB
    archive's (phases 3-4) when given. Returns (results, the children's
    launches, summed)."""
    work, outs = run_children(
        "--block-child", "smoke_blocks",
        {BLK: dict(os.environ, ZEEKSTD_TPU_BLOCK=str(BLK)) for BLK in blocks}, timeout)
    kids, total = {}, {k: 0 for k in ops.launches}
    for BLK in blocks:
        out, err, wall = outs[BLK]
        for line in (out + err).splitlines():
            if line.startswith("[") or "Error" in line:
                log("  " + line)
        with open(os.path.join(work, f"block{BLK}.json")) as f:
            kid = json.load(f)
        kid["wall_s"] = wall
        kids[BLK] = kid
        add_counts(total, kid["launches"])
    for level in (1, 3):
        line = f"[blocks] 10 MiB L{level}: compressed bytes " + ", ".join(
            f"{BLK >> 10} KiB {kids[BLK]['sizes'][str(level)]}" for BLK in blocks)
        if sizes32:
            line += f"; 32 KiB {sizes32[level]} (phase {'3' if level == 1 else '3b'})"
        log(line)
        for BLK in blocks:
            t = kids[BLK]["timing"][str(level)]
            line = (f"[blocks] {BLK >> 10} KiB L{level}: encode MiB/s {t['enc_mibs'][0]:.3f} "
                    f"[{t['enc_mibs'][1]:.3f}-{t['enc_mibs'][2]:.3f}], decode "
                    f"{t['dec_mibs'][0]:.3f} [{t['dec_mibs'][1]:.3f}-{t['dec_mibs'][2]:.3f}]; "
                    f"enc.host_decisions {t['enc_phases'].get('enc.host_decisions', 0):.6f} s, "
                    f"dec.plan {t['dec_phases'].get('dec.plan', 0):.6f} s")
            if timing32:
                t32 = timing32[level]
                line += (f" (32 KiB, phase {'4' if level == 1 else '4b'}: encode "
                         f"{t32['enc_mibs'][0]:.3f}, decode {t32['dec_mibs'][0]:.3f}, "
                         f"{t32['enc_phases'].get('enc.host_decisions', 0):.6f} s, "
                         f"{t32['dec_phases'].get('dec.plan', 0):.6f} s)")
            log(line + f"  ({smi})")
    log("[blocks] match kernel per launch (10 MiB, L1): " + ", ".join(
        f"{BLK >> 10} KiB {kids[BLK]['match']['ms']:.4f} ms, "
        f"{kids[BLK]['match']['cycles_per_seq']:.1f} cycles/seq, "
        f"{kids[BLK]['match']['smem_bytes']} B shared" for BLK in blocks)
        + f"  ({smi})")
    log(f"[blocks] launches (phase 8, all children): {total}")
    return {str(b): kid for b, kid in kids.items()}, total


# Phase 9: the reference's last route switches (ZEEKSTD_TPU_MATCH=xla,
# ZEEKSTD_TPU_TIMING).
KNOB_FRAMES = (64 << 10, 256 << 10)  # (a)'s frame sizes
KNOB_KERNELS = ("reach_tables", "reach_mark", "fse")  # (a)'s encode launches


def refuse(counts, names, what):
    """Fail if any kernel of ``names`` was launched."""
    launched = [k for k in names if counts[k]]
    if launched:
        raise AssertionError(f"{what}: kernels {launched} were launched ({counts})")


def timing_child(outdir: str) -> int:
    """Phase 9e, one value of ZEEKSTD_TPU_TIMING (this process's, read at
    import; set_timing is never called): 1 MiB of the text encoded at
    level 1 in one frame and decoded on the card; writes the timing modes,
    the encode's and the decode's recorded phase names and the launches to
    timing<value>.json in ``outdir``."""
    import zeekstd_tpu_torch as zt
    from zeekstd_tpu_torch import device, ops

    dev = torch.device("cuda", 0)
    value = os.environ.get("ZEEKSTD_TPU_TIMING", "unset")
    modes = [device._TIMING, device._FENCE]
    data = build_corpus(MIB)
    ops.reset_launches()
    blob, st = zt.compress_archive(data, frame_size=MIB, level=1, device=dev)
    enc = sorted(device.phase_records)
    device.phase_records.clear()
    assert zt.decompress_archive(blob, st, device=dev) == data, "the 1 MiB round trip differs"
    dec = sorted(device.phase_records)
    with open(os.path.join(outdir, f"timing{value}.json"), "w") as f:
        json.dump(dict(modes=modes, enc=enc, dec=dec, launches=dict(ops.launches)), f)
    return 0


def check_timing_children(phase4, timeout=600):
    """Phase 9e: one child of this script (``--timing-child``) per value of
    ZEEKSTD_TPU_TIMING, 1, 2 and unset, all at once. Under 1 and 2 a child
    must record every phase name phase 4 printed (the reference's) and
    write [timing] lines; unset, nothing. A child's failure or timeout
    fails the phase. Returns the results; the children's launches check
    no kernel, so they stay out of the kernels line."""
    base = {k: v for k, v in os.environ.items() if k != "ZEEKSTD_TPU_TIMING"}
    work, outs = run_children(
        "--timing-child", "smoke_timing",
        {value: dict(base, ZEEKSTD_TPU_TIMING=value) if value != "unset" else base
         for value in ("1", "2", "unset")}, timeout, together=True)
    res = {}
    for value, (_out, err, _wall) in outs.items():
        with open(os.path.join(work, f"timing{value}.json")) as f:
            kid = json.load(f)
        lines = [ln for ln in err.splitlines() if ln.startswith("[timing] ")]
        on = value in ("1", "2")
        if kid["modes"] != [on, value == "2"]:
            raise AssertionError(f"9e: ZEEKSTD_TPU_TIMING={value} gave modes {kid['modes']}")
        for tag in ("enc", "dec"):
            want = set(phase4[f"{tag}_phases"]) if on else set()
            missing, extra = want - set(kid[tag]), (set(kid[tag]) if not on else set())
            if missing or extra:
                raise AssertionError(f"9e: ZEEKSTD_TPU_TIMING={value}: {tag} phases missing "
                                     f"{sorted(missing)}, unexpected {sorted(extra)}")
        if on != bool(lines) or (on and len(lines) < len(kid["enc"]) + len(kid["dec"])):
            raise AssertionError(f"9e: ZEEKSTD_TPU_TIMING={value} wrote {len(lines)} "
                                 f"[timing] lines")
        res[value] = dict(kid, timing_lines=len(lines))
        log(f"[knobs] (e) ZEEKSTD_TPU_TIMING={value}: modes {kid['modes']}, "
            f"{len(kid['enc'])} encode and {len(kid['dec'])} decode phases recorded, "
            f"{len(lines)} [timing] lines")
    return res


def check_knobs(zt, ops, mods, data, dev, smi, base):
    """Phase 9: the reference's route switches on the card. ``base`` holds
    phase 3's level-1 and phase 3b's level-3 blobs (checksums on) and phase
    4's timing. (a)-(d) run under ZEEKSTD_TPU_MATCH=xla: (a) the 256 KiB
    mixed and long-run inputs at level 1 in 64 and 256 KiB frames, the card
    equal to the CPU port, every reach and FSE launch to its plain version,
    no match launch, every route exact; (b) the 10 MiB text at level 1 in
    1 MiB frames (1 MiB windows, so the wide decoder): reach, FSE and wide
    launches each equal to its plain version, no match or ring launch,
    exact on the card and through the native runtime; the frames that
    overflowed to the host encoder; encode in turns with the match-kernel
    route, decode, and the fenced split beside phase 4's; the anchor pass
    on the chunked kernels and by pointer doubling, in turns; (c) the
    one-card mesh and (d) the streaming Encoder equal (b)'s archive. (e)
    ``check_timing_children``. Returns (results, the launches of the
    counted runs, summed)."""
    from zeekstd_tpu_torch import archive as archive_mod
    from zeekstd_tpu_torch import parallel
    from zeekstd_tpu_torch.ops import match_tpu
    from zeekstd_tpu_torch.native import loader

    res, total = {}, {k: 0 for k in ops.launches}
    err = {k: 0 for k in KNOB_KERNELS}
    n = len(data)

    def hold(rec, names, err, plain_s=None):
        """Every card call of ``names`` in ``rec`` against its plain version:
        the max abs error into ``err``, the plain seconds into ``plain_s``."""
        for name in names:
            for a, k in rec.calls[name]:
                if a[0].is_cuda:
                    e, t = compare(name, a, k, mods)
                    err[name] = max(err.get(name, 0), e)
                    if plain_s is not None:
                        plain_s[name] = plain_s.get(name, 0.0) + t

    with env_vars(ZEEKSTD_TPU_MATCH="xla"):
        # (a) small inputs.
        small = {"mixed": mixed_input(256 << 10), "long_run": long_run()}
        for name, d in small.items():
            for fs in KNOB_FRAMES:
                with Recorder() as rec:
                    (blob, st), c = counted(ops, lambda: zt.compress_archive(
                        d, frame_size=fs, level=1, checksum=True, device=dev))
                add_counts(total, c)
                cpu, cpu_st = zt.compress_archive(d, frame_size=fs, level=1, checksum=True,
                                                  device="cpu")
                what = f"9a {name} in {fs >> 10} KiB frames"
                assert blob == cpu and st.to_bytes() == cpu_st.to_bytes(), \
                    f"{what}: the card's archive differs from the CPU port's"
                need(c, KNOB_KERNELS, what)
                refuse(c, ("match",), what)
                hold(rec, KNOB_KERNELS, err)
                decode_routes_exact(zt, blob, st, d, dev)
        log(f"[knobs] (a) ZEEKSTD_TPU_MATCH=xla, 256 KiB mixed and long-run inputs at L1 in "
            f"64 and 256 KiB frames: archives equal the CPU port's, no match launch, reach and "
            f"FSE equal to their plain versions (max abs err {max(err.values())}), every route "
            f"exact")

        # (b) the 10 MiB text at level 1 in 1 MiB frames, counted.
        overflow, reach_args = [], []
        real_jobs, real_reach = archive_mod._host_jobs, match_tpu.greedy_reachability

        def spy(F, lengths, ovf, *a, **k):
            overflow.append(np.asarray(ovf).copy())
            return real_jobs(F, lengths, ovf, *a, **k)

        def reach_spy(*a, **k):
            reach_args.append((a, k))
            return real_reach(*a, **k)

        archive_mod._host_jobs, match_tpu.greedy_reachability = spy, reach_spy
        try:
            ops.reset_launches()
            with Recorder() as rec_b:
                t0 = time.perf_counter()
                blob_x, st_x = zt.compress_archive(data, frame_size=MIB, level=1, checksum=True,
                                                   device=dev)
                t_enc = time.perf_counter() - t0
                archive_x = blob_x + st_x.to_bytes(zt.Format.FOOT)
                t0 = time.perf_counter()
                out = zt.decompress_archive(archive_x, zt.SeekTable.from_bytes(archive_x),
                                            device=dev)
                t_dec = time.perf_counter() - t0
            counts_b = dict(ops.launches)
        finally:
            archive_mod._host_jobs, match_tpu.greedy_reachability = real_jobs, real_reach
        assert out == data, "9b: the card's decode of the level-1 parse archive differs"
        add_counts(total, counts_b)
        need(counts_b, KNOB_KERNELS + ("wide_decode",), "9b")
        refuse(counts_b, ("match", "ring_decode"), "9b")
        c_off, d_off = st_x.cumulative_offsets()
        assert loader.decompress_stream_mt(blob_x, [int(x) for x in c_off],
                                           [int(x) for x in d_off], nthreads=0) == data, \
            "9b: the native runtime's decode differs"
        over = [int(f) for f in np.flatnonzero(overflow[0])]
        ratio_k = len(blob_x) / len(base["blob1"])
        log(f"[knobs] (b) 10 MiB L1 parse in 1 MiB frames: {len(blob_x)} bytes against phase "
            f"3's match-kernel {len(base['blob1'])} ({ratio_k:.6f} of it; ratio "
            f"{len(blob_x) / n:.6f}), first encode {t_enc:.3f}s, first decode {t_dec:.3f}s (wide "
            f"route); card and native decodes exact; frames over seq_bound to the host "
            f"encoder: {over or 'none'}; launches {counts_b}")
        err_b, plain_s = {}, {}
        hold(rec_b, KNOB_KERNELS + ("wide_decode",), err_b, plain_s)
        kernel_ms = {}
        for name in KNOB_KERNELS + ("wide_decode",):
            a, k = next((a, k) for a, k in rec_b.calls[name] if a[0].is_cuda)
            ms, result = time_kernel(name, a, k, mods)
            kernel_ms[name] = dict(ms=ms, calls=len(rec_b.calls[name]),
                                   bound_ms=moved_bytes(name, a, result, mods, k)
                                   / HBM_BYTES_PER_S * 1e3)
        log("[knobs] (b) 10 MiB launches equal to their plain versions (max abs err "
            f"{max(err_b.values())}; plain " + ", ".join(f"{k} {t:.3f}s" for k, t in plain_s.items())
            + "); ms per launch " + ", ".join(
                f"{k} {v['ms']:.4f} (bound {v['bound_ms']:.6f}, {v['calls']} call(s))"
                for k, v in kernel_ms.items()) + f"  ({smi})")
        # (b)'s anchor pass on its two branches (not counted), in turns on the
        # parse's own step array: the chunked kernels (rows 8-9) and the
        # pointer doubling that shapes they do not tile take.
        (step, n_r, blk), k_r = reach_args[0]
        branches = {"chunked": lambda: real_reach(step, n_r, blk, **k_r),
                    "doubling": lambda: real_reach(step, n_r, blk)}
        assert torch.equal(branches["chunked"](), branches["doubling"]()), \
            "9b: pointer doubling's anchors differ from the chunked kernels'"
        got = {name: [] for name in branches}
        for _ in range(5):
            for name, fn in branches.items():
                got[name].append(cuda_ms(fn, 1)[0])
        reach_ms = {name: (sorted(v)[2], min(v), max(v)) for name, v in got.items()}
        c, d = reach_ms["chunked"], reach_ms["doubling"]
        log(f"[knobs] (b) anchor pass per call ({tuple(step.shape)} steps, step_max "
            f"{k_r.get('step_max')}; CUDA events, median [range] x5 in turns): chunked kernels "
            f"{c[0]:.4f} [{c[1]:.4f}-{c[2]:.4f}] ms, pointer doubling {d[0]:.4f} [{d[1]:.4f}-"
            f"{d[2]:.4f}] ms, anchors equal  ({smi})")
        res.update(small_err=err, err_10mib=err_b, plain_s_10mib=plain_s,
                   bytes=len(blob_x), bytes_match_kernel=len(base["blob1"]), overflow=over,
                   launches=counts_b, kernel_ms=kernel_ms, reach_ms=reach_ms)

    # (b) timing: encode in turns with the match-kernel route, decode, split.
    staged = zt.StagedInput(data, MIB, device=dev)
    samples = {"xla": [], "kernel": []}
    for rep in range(6):
        for mode in samples:
            with env_vars(ZEEKSTD_TPU_MATCH=mode):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                zt.compress_archive(staged, frame_size=MIB, level=1, return_device=True)
                torch.cuda.synchronize()
                if rep:  # the first turn warms both routes
                    samples[mode].append(time.perf_counter() - t0)
    enc = {mode: med_spread(n, s) for mode, s in samples.items()}
    with env_vars(ZEEKSTD_TPU_MATCH="xla"):
        blob_nc, st_nc = zt.compress_archive(staged, frame_size=MIB, level=1)
        zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
        dec_s = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
            torch.cuda.synchronize()
            dec_s.append(time.perf_counter() - t0)
        dec = med_spread(n, dec_s)
        zt.set_timing(2)
        try:
            zt.phase_records.clear()
            zt.compress_archive(staged, frame_size=MIB, level=1, return_device=True)
            enc_phases = dict(zt.phase_records)
            zt.phase_records.clear()
            zt.decompress_archive(blob_nc, st_nc, return_device=True, device=dev)
            dec_phases = dict(zt.phase_records)
        finally:
            zt.set_timing(0)
    log(f"[knobs] (b) [timing] L1 encode MiB/s in turns: parse (ZEEKSTD_TPU_MATCH=xla) "
        f"median {enc['xla'][0]:.3f} [{enc['xla'][1]:.3f}-{enc['xla'][2]:.3f}] x5, match "
        f"kernel {enc['kernel'][0]:.3f} [{enc['kernel'][1]:.3f}-{enc['kernel'][2]:.3f}] x5 "
        f"({enc['xla'][0] / enc['kernel'][0]:.3f} of it); wide decode of the parse archive "
        f"{dec[0]:.3f} [{dec[1]:.3f}-{dec[2]:.3f}] x5 (phase 4's ring decode "
        f"{base['timing']['dec_mibs'][0]:.3f})  ({smi})")
    for tag, ph, ph4 in (("enc", enc_phases, base["timing"]["enc_phases"]),
                         ("dec", dec_phases, base["timing"]["dec_phases"])):
        log(f"[knobs] (b) [timing] L1 parse {tag} phases (fenced, s per 10 MiB; phase 4's "
            f"beside): " + ", ".join(f"{k} {v:.6f} ({ph4.get(k, 0):.6f})"
                                     for k, v in sorted(ph.items(), key=lambda kv: -kv[1])))
    res.update(enc_mibs=enc, dec_mibs=dec, enc_phases=enc_phases, dec_phases=dec_phases)

    with env_vars(ZEEKSTD_TPU_MATCH="xla"):
        # (c) the mesh on one card (no process group).
        mesh = parallel.make_mesh([dev])
        (blob_m, st_m), c = counted(ops, lambda: parallel.parallel_compress(
            data, mesh, frame_size=MIB, level=1, checksum=True))
        add_counts(total, c)
        assert blob_m == blob_x and st_m.to_bytes() == st_x.to_bytes(), \
            "9c: the one-card mesh archive differs from compress_archive's"
        refuse(c, ("match",), "9c")
        need(c, KNOB_KERNELS, "9c")
        # (d) the streaming Encoder on the tpu backend.
        streamed, c = counted(ops, lambda: stream_encode(zt, data, dev, 1))
        add_counts(total, c)
        assert streamed == archive_x, "9d: the streaming archive differs from compress_archive's"
        refuse(c, ("match",), "9d")
        need(c, KNOB_KERNELS, "9d")
    log("[knobs] (c) parallel_compress on a one-card mesh and (d) the streaming Encoder at L1 "
        "under ZEEKSTD_TPU_MATCH=xla: equal to compress_archive's archive and table, no match "
        "launch")

    # (e) ZEEKSTD_TPU_TIMING, read at import: one child per value.
    res["timing_children"] = check_timing_children(base["timing"])
    log(f"[knobs] launches (phase 9, counted runs): {total}")
    return res, total


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="directory for chip_smoke.json")
    ap.add_argument("--mesh-child", nargs=3, metavar=("RANK", "PORT", "DIR"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--blocks-only", action="store_true",
                    help="run phases 1 and 8 alone (a reduced run; not the full smoke)")
    ap.add_argument("--block-child", metavar="DIR", help=argparse.SUPPRESS)
    ap.add_argument("--timing-child", metavar="DIR", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if args.mesh_child:
        rank, port, outdir = args.mesh_child
        return mesh_child(int(rank), port, outdir)
    if args.block_child:
        return block_child(args.block_child)
    if args.timing_child:
        return timing_child(args.timing_child)
    # Phases 1-7 run at the default 32 KiB blocks; a size named by
    # ZEEKSTD_TPU_BLOCK joins phase 8's children.
    named = os.environ.pop("ZEEKSTD_TPU_BLOCK", None)
    blocks = tuple(sorted(set(BLOCK_SIZES) | ({int(named)} if named else set())))

    import zeekstd_tpu_torch as zt
    from zeekstd_tpu_torch import _build, decode_routes, ops
    from zeekstd_tpu_torch.native import loader

    mods = kernel_modules()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    results = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda}
    log(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.kernel_library()
    loader.get_lib()
    results["build_s"] = time.perf_counter() - t0
    log(f"[build] kernel + host libraries in {results['build_s']:.1f}s")
    report = _build.ptxas_report()
    results["ptxas"] = report
    for line in report.splitlines():
        if any(s in line for s in ("Compiling entry", "Used", "spill", ".cu:")):
            log("  " + line.strip())
    if args.blocks_only:
        results["blocks"], _ = check_blocks(ops, smi, blocks=blocks)
        print(smi)
        print(json.dumps({"blocks_only": list(blocks), "passed": True}))
        return 0

    # --- 2. every kernel against its plain version ------------------------
    small = mixed_input(256 << 10)
    with Recorder() as rec:
        blob_s, st_s = zt.compress_archive(small, frame_size=96 << 10, level=1,
                                           checksum=True, device=dev)
        assert zt.decompress_archive(blob_s, st_s, device=dev) == small
        os.environ["ZEEKSTD_TPU_RING"] = "0"
        try:
            assert zt.decompress_archive(blob_s, st_s, device=dev) == small
        finally:
            del os.environ["ZEEKSTD_TPU_RING"]
    small_err = {}
    # Level 1 takes the match kernel; phase 2b drives the reachability
    # kernels, phase 2c the serial and doubling routes' kernels.
    for name in ("match", "fse", "ring_decode", "wide_decode"):
        calls = rec.calls[name]
        if not calls:
            raise AssertionError(f"{name}: the 256 KiB run never called it")
        err = 0
        for a, k in calls:
            err = max(err, compare(name, a, k, mods)[0])
        small_err[name] = err
        log(f"[kernels] {name}: equal to its plain version on the 256 KiB input "
            f"({len(calls)} call(s), max abs err {err})")
    small_err["match"] = max(small_err["match"], check_match_edge(mods, dev))
    log("[kernels] match: equal to its plain version on the 1 MiB slot-collision edge input")
    cpu_blob, _ = zt.compress_archive(small, frame_size=96 << 10, level=1, checksum=True,
                                      device="cpu")
    assert blob_s == cpu_blob, "level 1: card archive differs from CPU archive"
    log("[kernels] level 1: the card's archive of the 256 KiB input equals the CPU port's")

    # --- 2b. the parallel parse against the plain versions ---------------
    with Recorder() as rec_b:
        for kw in (dict(level=3), dict(level=19, prefix=mixed_input(64 << 10))):
            blob_b, st_b = zt.compress_archive(small, frame_size=32 << 10, checksum=True,
                                               device=dev, **kw)
            cpu_blob, _ = zt.compress_archive(small, frame_size=32 << 10, checksum=True,
                                              device="cpu", **kw)
            assert blob_b == cpu_blob, f"{kw['level']}: card archive differs from CPU archive"
            for i in range(st_b.num_frames):
                got, _end = zt.archive.decompress_frame(blob_b, st_b.frame_start_comp(i),
                                                        prefix=kw.get("prefix", b""),
                                                        device=dev)
                assert got == small[st_b.frame_start_decomp(i) : st_b.frame_end_decomp(i)]
    for name in ("reach_tables", "reach_mark", "fse"):
        calls = [(a, k) for a, k in rec_b.calls[name] if a[0].is_cuda]
        if not calls:
            raise AssertionError(f"{name}: the level-3/19 runs never called it")
        err = 0
        for a, k in calls:
            err = max(err, compare(name, a, k, mods)[0])
        small_err[name] = max(small_err.get(name, 0), err)
        log(f"[kernels] {name}: equal to its plain version on the 256 KiB input at levels "
            f"3 and 19 ({len(calls)} call(s), max abs err {err}); archives equal the CPU port's")

    # --- 2c. the serial and doubling routes against the plain versions ---
    data = build_corpus(10 << 20)
    n = len(data)
    results["routes_small"] = check_routes_small(zt, small, blob_s, st_s, dev, mods, small_err)
    rec_bytes, counts_bytes = check_byte_kernels(ops, data, dev, mods, small_err)

    # --- 3. main path, full size -----------------------------------------
    ops.reset_launches()
    with Recorder() as main_rec:
        t0 = time.perf_counter()
        blob, st = zt.compress_archive(data, frame_size=MIB, level=1, checksum=True,
                                       device=dev)
        t_enc = time.perf_counter() - t0
        archive = blob + st.to_bytes(zt.Format.FOOT)
        st2 = zt.SeekTable.from_bytes(archive)
        assert st2.num_frames == st.num_frames == 10
        t0 = time.perf_counter()
        out = zt.decompress_archive(archive, st2, device=dev)
        t_dec = time.perf_counter() - t0
        assert out == data, "ring-route round trip differs"
        os.environ["ZEEKSTD_TPU_RING"] = "0"
        try:
            assert zt.decompress_archive(archive, device=dev) == data, "wide route differs"
        finally:
            del os.environ["ZEEKSTD_TPU_RING"]
        spans = [(st2.frame_start_comp(i), st2.frame_end_comp(i)) for i in (3, 4, 5)]
        parts = zt.decode_frames(archive, spans, device=dev)
        assert b"".join(parts) == data[st2.frame_start_decomp(3) : st2.frame_end_decomp(5)]
        # One flipped bit in frame 4's compressed payload.
        mid = (st2.frame_start_comp(4) + st2.frame_end_comp(4)) // 2
        bad = bytearray(archive)
        bad[mid] ^= 1 << 3
        try:
            got = zt.decompress_archive(bytes(bad), st2, device=dev)
            corrupt = "intact" if got == data else "WRONG"
        except zt.ZeekstdError as e:
            corrupt = f"error ({type(e).__name__}: {e})"
        assert corrupt != "WRONG", "a corrupted archive decoded to wrong bytes"
    counts = dict(ops.launches)
    cpu_blob, _ = zt.compress_archive(data, frame_size=MIB, level=1, checksum=True,
                                      device="cpu")
    assert blob == cpu_blob, "level 1: the card's 10 MiB archive differs from the CPU port's"
    log(f"[main] 10 MiB: ratio {len(blob) / n:.6f}, first encode {t_enc:.3f}s, "
        f"first decode {t_dec:.3f}s; archive equal to the CPU port's; ring, wide and "
        f"frames 3-5 exact; "
        f"flipped bit -> {corrupt}")
    log(f"[main] launches: {counts}")
    for name in ("match", "fse", "ring_decode", "wide_decode"):
        if counts[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    results.update(ratio=len(blob) / n, launches=counts, corrupt=corrupt)

    # --- 4. timing --------------------------------------------------------
    results.update(time_path(zt, data, 1, dev, smi))

    # --- 3b. level 3 (the CLI's default), full size ----------------------
    ops.reset_launches()
    with Recorder() as main_rec3:
        t0 = time.perf_counter()
        blob3, st3 = zt.compress_archive(data, frame_size=MIB, level=3, checksum=True,
                                         device=dev)
        t_enc3 = time.perf_counter() - t0
        archive3 = blob3 + st3.to_bytes(zt.Format.FOOT)
        st3b = zt.SeekTable.from_bytes(archive3)
        assert st3b.num_frames == st3.num_frames == 10
        assert os.environ.get("ZEEKSTD_TPU_RING") is None
        t0 = time.perf_counter()
        assert zt.decompress_archive(archive3, st3b, device=dev) == data, "level-3 round trip"
        t_dec3 = time.perf_counter() - t0
        spans = [(st3b.frame_start_comp(i), st3b.frame_end_comp(i)) for i in (3, 4, 5)]
        parts = zt.decode_frames(archive3, spans, device=dev)
        assert b"".join(parts) == data[st3b.frame_start_decomp(3) : st3b.frame_end_decomp(5)]
        mid = (st3b.frame_start_comp(4) + st3b.frame_end_comp(4)) // 2
        bad = bytearray(archive3)
        bad[mid] ^= 1 << 3
        flipped3 = bytes(bad)
        try:
            got = zt.decompress_archive(flipped3, st3b, device=dev)
            corrupt3 = "intact" if got == data else "WRONG"
        except zt.ZeekstdError as e:
            corrupt3 = f"error ({type(e).__name__}: {e})"
        assert corrupt3 != "WRONG", "a corrupted level-3 archive decoded to wrong bytes"
        old, new = patch_pair(data)
        blob_p, st_p = zt.compress_archive(new, frame_size=MIB, level=3, checksum=True,
                                           prefix=old, device=dev)
        for i in range(st_p.num_frames):
            got, end = zt.archive.decompress_frame(blob_p, st_p.frame_start_comp(i),
                                                   prefix=old, device=dev)
            assert got == new[st_p.frame_start_decomp(i) : st_p.frame_end_decomp(i)], i
            assert end == st_p.frame_end_comp(i)
    counts3 = dict(ops.launches)
    log(f"[level 3] 10 MiB: ratio {len(blob3) / n:.6f}, first encode {t_enc3:.3f}s, "
        f"first decode {t_dec3:.3f}s (wide route); frames 3-5 exact; flipped bit -> "
        f"{corrupt3}; patch {len(new)} bytes against a {len(old)}-byte prefix -> "
        f"{len(blob_p)} bytes in {st_p.num_frames} frames, every frame back")
    log(f"[level 3] launches: {counts3}")
    for name in ("reach_tables", "reach_mark", "fse", "wide_decode"):
        if counts3[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on the level-3 path")
    if counts3["ring_decode"] or counts3["match"]:
        raise AssertionError("the level-3 path took the ring decoder or the match kernel")
    results.update(ratio3=len(blob3) / n, patch_bytes=len(blob_p), launches3=counts3,
                   corrupt3=corrupt3)
    # The archive encode's FSE launch is compared in the kernel table below.
    for a, k in main_rec3.calls["fse"][1:]:
        err = compare("fse", a, k, mods)[0]
        small_err["fse"] = max(small_err["fse"], err)
        log(f"[level 3] fse: the patch encode's launch equals its plain version "
            f"(max abs err {err})")

    # --- 4b. level-3 timing ------------------------------------------------
    results["level3"] = time_path(zt, data, 3, dev, smi)

    # --- 3c. the serial and doubling routes, full size ---------------------
    fallbacks0 = decode_routes.serial_fallback_count()
    routes, route_calls = {}, {}
    for mode, kernels in (("serial", ("exec", "fse_decode", "reach_tables", "reach_mark")),
                          ("doubling", ("fse_decode", "reach_tables", "reach_mark"))):
        with exec_route(mode):
            ops.reset_launches()
            with Recorder() as rec_r:
                t0 = time.perf_counter()
                assert zt.decompress_archive(archive3, st3b, device=dev) == data, mode
                t_first = time.perf_counter() - t0
            counts_r = dict(ops.launches)
        log(f"[routes] 10 MiB level 3 on the {mode} route: exact, first decode "
            f"{t_first:.3f}s; launches: {counts_r}")
        for name in kernels:
            if counts_r[name] <= 0:
                raise AssertionError(f"kernel {name} was not launched on the {mode} route")
        others = [k for k, v in counts_r.items() if v and k not in kernels]
        if others:
            raise AssertionError(f"the {mode} route launched {others}")
        calls = {k: [(a, kw) for a, kw in rec_r.calls[k] if a[0].is_cuda] for k in kernels}
        checked = {}
        for name in kernels:
            checked[name] = compare(name, *calls[name][0], mods)
            err = max([checked[name][0]]
                      + [compare(name, a, kw, mods)[0] for a, kw in calls[name][1:]])
            small_err[name] = max(small_err.get(name, 0), err)
            log(f"[routes] {name}: equal to its plain version on the {mode} route's 10 MiB "
                f"decode ({len(calls[name])} call(s), plain {checked[name][1]:.3f}s)")
        routes[mode] = dict(first_decode_s=t_first, launches=counts_r)
        route_calls[mode] = (calls, checked)
    if decode_routes.serial_fallback_count() != fallbacks0:
        raise AssertionError("the serial route fell back to the doubling route")
    for mode in ("serial", "doubling"):
        with exec_route(mode):
            try:
                got = zt.decompress_archive(flipped3, st3b, device=dev)
                corrupt_r = "intact" if got == data else "WRONG"
            except zt.ZeekstdError as e:
                corrupt_r = f"error ({type(e).__name__}: {e})"
        assert corrupt_r != "WRONG", f"{mode}: a corrupted archive decoded to wrong bytes"
        routes[mode]["corrupt"] = corrupt_r
        log(f"[routes] flipped bit on the {mode} route -> {corrupt_r}")
    with exec_route("doubling"):
        for i in (3, 4, 5):
            got, end = zt.archive.decompress_frame(archive3, st3b.frame_start_comp(i),
                                                   device=dev)
            assert got == data[st3b.frame_start_decomp(i) : st3b.frame_end_decomp(i)], i
            assert end == st3b.frame_end_comp(i)
    log("[routes] frames 3-5 through decompress_frame on the doubling route exact")
    results.update(routes=routes)

    # --- 4c. route timing -------------------------------------------------
    results["route_timing"] = time_routes(zt, data, dev, smi)

    # --- 5. the streaming Encoder and Decoder and the CLI -------------------
    results["streaming"], counts5 = check_streaming(
        zt, ops, data, small, {1: archive, 3: archive3}, dev, smi)

    # --- 6. the native runtime and the per-frame device encoder -----------
    results["native"], counts6a = check_native(zt, ops, data, dev, smi)
    results["frame_codec"], counts6b, err6 = check_frame_codec(zt, ops, data, small, dev, smi,
                                                               mods)
    small_err["fse"] = max(small_err["fse"], err6)

    # --- 7. the mesh pipeline on an NCCL group, and two processes ---------
    results["mesh"], counts7, (blob7, st7) = check_mesh(zt, ops, data, dev, smi)
    results["mesh"]["processes"], counts7c = check_mesh_processes(ops, blob7, st7, smi)

    # --- 8. the archive block sizes, one child each ------------------------
    results["blocks"], counts8 = check_blocks(
        ops, smi, blocks=blocks, sizes32={1: len(blob), 3: len(blob3)},
        timing32={1: {k: results[k] for k in ("enc_mibs", "dec_mibs", "enc_phases",
                                              "dec_phases")},
                  3: results["level3"]})

    # --- 9. the reference's route switches --------------------------------
    results["knobs"], counts9 = check_knobs(
        zt, ops, mods, data, dev, smi,
        dict(blob1=blob, blob3=blob3, timing={k: results[k] for k in (
            "enc_mibs", "dec_mibs", "enc_phases", "dec_phases")}))

    sources = {
        "match": ("zeekstd_tpu_torch/csrc/match_kernel.cu", "zeekstd_tpu/ops/match_kernel.py:512"),
        "reach_tables": ("zeekstd_tpu_torch/csrc/reach_kernel.cu",
                         "zeekstd_tpu/ops/pallas_kernels.py:152"),
        "reach_mark": ("zeekstd_tpu_torch/csrc/reach_kernel.cu",
                       "zeekstd_tpu/ops/pallas_kernels.py:181"),
        "fse": ("zeekstd_tpu_torch/csrc/fse_kernel.cu", "zeekstd_tpu/ops/fse_kernel.py:280"),
        "ring_decode": ("zeekstd_tpu_torch/csrc/wide_decode.cu",
                        "zeekstd_tpu/ops/ring_kernel.py:541"),
        "wide_decode": ("zeekstd_tpu_torch/csrc/wide_decode.cu", "zeekstd_tpu/ops/decode_kernel.py:388"),
        "exec": ("zeekstd_tpu_torch/csrc/wide_decode.cu", "zeekstd_tpu/ops/exec_kernel.py:372"),
        "fse_decode": ("zeekstd_tpu_torch/csrc/fse_decode.cu",
                       "zeekstd_tpu/ops/entropy.py:199 (an XLA scan, not a pallas_call)"),
        "byte_histogram": ("zeekstd_tpu_torch/csrc/byte_kernels.cu",
                           "zeekstd_tpu/ops/pallas_kernels.py:68"),
        "table_lookup": ("zeekstd_tpu_torch/csrc/byte_kernels.cu",
                         "zeekstd_tpu/ops/pallas_kernels.py:111"),
    }
    # Each kernel at the shapes of the path that needs it: the level-1 path
    # for the match, FSE and ring kernels, the level-3 path for the
    # reachability kernels and the wide decoder (its 1 MiB windows), the
    # serial route's 10 MiB decode for the exec and FSE-decode kernels
    # (their plain comparison is phase 3c's); the FSE kernel is also timed
    # at the level-3 shapes; the byte kernels, on no archive path (as in
    # the reference), on the 10 MiB text of phase 2c. Launches add up the
    # counted runs: phases 3 and 3b, each route of 3c, the byte kernels' own
    # run, the counted runs of phase 5, those of phases 6a and 6b, of 7a and
    # 7b, the two processes of 7c, every child of phase 8 and phase 9's
    # counted runs.
    runs = [counts, counts3, routes["serial"]["launches"], routes["doubling"]["launches"],
            counts_bytes, counts5, counts6a, counts6b, counts7, counts7c, counts8, counts9]
    serial_calls, serial_checked = route_calls["serial"]
    table, extra = [], {}
    for name, path, rec_m in (("match", 1, main_rec.calls), ("reach_tables", 3, main_rec3.calls),
                              ("reach_mark", 3, main_rec3.calls), ("fse", 1, main_rec.calls),
                              ("fse", 3, main_rec3.calls), ("ring_decode", 1, main_rec.calls),
                              ("wide_decode", 3, main_rec3.calls),
                              ("exec", "3c", serial_calls), ("fse_decode", "3c", serial_calls),
                              ("byte_histogram", "2c", rec_bytes.calls),
                              ("table_lookup", "2c", rec_bytes.calls)):
        a, k = rec_m[name][0]
        small_kernel = name in ("byte_histogram", "table_lookup")
        ms, result = time_kernel(name, a, k, mods, reps=20 if small_kernel else 5)
        if path == "3c":
            err, t_plain = serial_checked[name]
        else:
            err, t_plain = compare(name, a, k, mods)
        moved = moved_bytes(name, a, result, mods, k)
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        lib_ms = None
        wrapper_ms = None
        if name in DEVICE_TIMED:
            # Rows 6-9: the device time alone, cold, beside the wrapper's
            # events (the checks, the allocation and the ctypes call too).
            wrapper_ms, dev_t = ms, device_timing(name, a, k, result, mods, smi)
            ms, lib_ms = dev_t["cold_ms"], dev_t.get("library_ms")
            extra[f"{name}_device"] = dev_t
        launched = sum(run[name] for run in runs)
        row = {
            "name": name, "route": "cuda", "source": sources[name][0],
            "replaces": sources[name][1], "launches": launched,
            "max_abs_err": max(err, small_err[name]), "ms": ms,
            "plain_ms": t_plain * 1e3, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms,
        }
        if wrapper_ms is not None:
            row["wrapper_ms"] = wrapper_ms
        if name == "fse" and path == 3:
            extra["fse_level3"] = row
        else:
            table.append(row)
        if name == "match":
            extra["match_timing"] = match_timing(mods.mk, a, k, ms)
        if name == "fse_decode":
            extra["fse_decode_timing"] = fse_decode_timing(mods.ent, a, k, ms)
        if name == "fse":
            extra[f"fse_encode_timing_level{path}"] = fse_encode_timing(mods.fk, a, k, ms, path)
        stages_fn = {"wide_decode": mods.dk.wide_stages, "ring_decode": mods.rk.ring_stages,
                     "exec": mods.ek.exec_stages}.get(name)
        if stages_fn is not None:
            stages = stage_ms(stages_fn, a, k)
            extra[f"{name.split('_')[0]}_stages_ms"] = stages
            log(f"[timing] {name} stages (phase {path} shapes, F={a[4].shape[0]}, "
                f"OUTB={k['OUTB']}): " + ", ".join(f"{n} {t:.4f} ms" for n, t in stages.items()))
        lib = f", library {lib_ms:.4f} ms" if lib_ms is not None else ""
        if wrapper_ms is not None:
            lib += f", wrapper {wrapper_ms:.4f} ms"
        log(f"[timing] {name} (phase {path} shapes): {ms:.4f} ms/launch, bound "
            f"{bound_ms:.6f} ms ({moved} bytes), plain {t_plain * 1e3:.1f} ms{lib}, "
            f"launches {launched} ({' + '.join(str(run[name]) for run in runs)})")
    results["kernels"] = table
    results.update(extra)

    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as fh:
            json.dump(results, fh, indent=1, default=str)
    print(smi)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
