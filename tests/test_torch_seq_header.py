"""The decode planner's native reader of a compressed block's
sequences-section header (``native/seq_header.cpp``) against the verbatim
chain it replaces on the planner's path (``sequences.parse_num_sequences``,
``sequences.read_symbol_table`` with ``fse.read_ncount``), on the CPU:

- field by field (the number of sequences, each mode, the bytes each
  description takes, the normalized counts and accuracy logs, the offset of
  the FSE bitstream) on every compressed block of port archives at levels 1,
  3 and 19 and of libzstd's, on descriptions ``fse.write_ncount`` writes from
  random normalized counts at each category's largest log, and on random
  sections, where the reader refuses exactly what the chain raises on;
- ``plan.plan_archive`` and ``plan.fse_stage`` give what they give with the
  library patched away (the verbatim path);
- hostile frames raise the same error class and message with and without
  the library;
- the counters ``plan.fse_descs`` and ``plan.fse_descs_native``, and the
  benchmark's reader of their share.

Inputs of at most 96 KiB; no JAX."""

import random
import sys
import types

import numpy as np
import pytest

from portbench import manifest
from zeekstd_tpu_torch import archive, device, plan
from zeekstd_tpu_torch.codec import frame as frame_mod
from zeekstd_tpu_torch.codec import fse
from zeekstd_tpu_torch.codec import literals as lit_mod
from zeekstd_tpu_torch.codec import sequences as seq
from zeekstd_tpu_torch.native import seq_header

from .block_cases import word_text
from .oracle import zstd_compress
from .torch_threads import two_torch_threads  # noqa: F401

# (category, largest code, largest accuracy log), in the section's order.
CATS = (("ll", seq.MAX_LL_CODE, seq.LL_MAX_LOG), ("of", seq.MAX_OFFSET_CODE, seq.OF_MAX_LOG),
        ("ml", seq.MAX_ML_CODE, seq.ML_MAX_LOG))
FRAME = 32 << 10


def _mixed(n: int) -> bytes:
    """Text, a run, random bytes and a repeat: raw, RLE and compressed
    blocks, and every table mode."""
    rng = np.random.default_rng(25)
    text = word_text(n)
    return (text[: n // 2] + b"R" * 3000 + bytes(rng.integers(0, 256, 5000, dtype=np.uint8))
            + b"abcabcabc" * 1000 + text[n // 2 :])[:n]


DATA = {"words": word_text(88 << 10), "mixed": _mixed(88 << 10)}


def _port(name, level):
    blob, st = archive.compress_archive(DATA[name], frame_size=FRAME, level=level,
                                        checksum=True, device="cpu")
    return blob, st


def _libzstd(name, level):
    return zstd_compress(DATA[name], level=level, checksum=True), None


SOURCES = [(kind, name, level) for kind in ("port", "libzstd") for name in DATA
           for level in (1, 3, 19)]


@pytest.fixture(scope="module")
def archives():
    made = {}

    def get(kind, name, level):
        key = (kind, name, level)
        if key not in made:
            made[key] = (_port if kind == "port" else _libzstd)(name, level)
        return made[key]

    return get


def _sections(blob):
    """(block, offset of its sequences section) for every compressed block
    of every frame of ``blob``, skippable frames skipped."""
    pos = 0
    while pos < len(blob):
        if int.from_bytes(blob[pos : pos + 4], "little") & 0xFFFFFFF0 == 0x184D2A50:
            pos += 8 + int.from_bytes(blob[pos + 4 : pos + 8], "little")
            continue
        hdr = frame_mod.parse_frame_header(blob[pos : pos + 18])
        fpos = pos + hdr.header_size
        while True:
            last, btype, bsize, c = frame_mod.parse_block_header(blob[fpos : fpos + 3])
            fpos += c
            if btype == frame_mod.BLOCK_RLE:
                fpos += 1
            elif btype == frame_mod.BLOCK_RAW:
                fpos += bsize
            else:
                block = blob[fpos : fpos + bsize]
                fpos += bsize
                sec = lit_mod.parse_literals_header(block)
                lit = {lit_mod.LIT_RAW: sec.regenerated_size, lit_mod.LIT_RLE: 1}
                yield block, sec.header_size + lit.get(sec.lit_type, sec.compressed_size)
            if last:
                break
        pos = fpos + 4 * hdr.has_checksum


_PREV = seq.default_table("ll")  # a previous table, so Repeat reads through


def _verbatim(block, off):
    """(nseq, [(mode, consumed, arg, norm)], payload_off) as the verbatim
    chain reads the section at ``block[off]``; raises where it raises."""
    nseq, c = seq.parse_num_sequences(block[off:])
    off += c
    heads = []
    if nseq > 0:
        modes = block[off]
        off += 1
        for k, (cat, max_code, max_log) in enumerate(CATS):
            mode = (modes >> (6 - 2 * k)) & 3
            data = block[off:]
            table, used = seq.read_symbol_table(data, mode, cat, _PREV)
            arg, norm = 0, None
            if mode == seq.MODE_FSE:
                norm, arg, n = fse.read_ncount(data, max_code, max_log)
                assert n == used and table is fse.build_decode_table(norm, arg)
            elif mode == seq.MODE_RLE:
                arg = data[0]
            heads.append((mode, used, arg, norm))
            off += used
    return nseq, heads, off


def _native(read, block, off):
    got = read(block, off)
    if got is None:
        return None
    nseq, heads, poff = got
    heads = [(m, c, a, None if n is None else n.tolist()) for m, c, a, n in heads]
    return nseq, (heads if nseq > 0 else []), poff


def _outcome(block, off):
    try:
        return _verbatim(block, off)
    except Exception:  # noqa: BLE001 - every raise of the chain counts
        return None


@pytest.fixture(scope="module")
def read():
    r = seq_header.reader()
    assert r is not None, "the seq_header library did not build"
    return r


@pytest.mark.parametrize("kind,name,level", SOURCES)
def test_every_block_of_an_archive_reads_the_same(archives, read, kind, name, level):
    blob, _st = archives(kind, name, level)
    n = fse_modes = 0
    for block, off in _sections(blob):
        want = _verbatim(block, off)
        assert _native(read, block, off) == want
        n += 1
        fse_modes += sum(m == seq.MODE_FSE for m, *_r in want[1])
    assert n >= 1
    if level > 1 or kind == "libzstd":
        assert fse_modes > 0


def _random_norms(rng, max_code, log):
    """Normalized counts at ``log`` from a random histogram: sparse, skewed
    or flat, so -1 counts, zero runs and large counts all occur."""
    width = rng.randint(1, max_code + 1)
    shape = rng.choice(("flat", "skewed", "sparse"))
    counts = [0] * (max_code + 1)
    for s in range(width):
        if shape == "sparse" and rng.random() < 0.7:
            continue
        counts[s] = (rng.randint(1, 50) if shape == "flat"
                     else max(1, int(4000 * rng.random() ** 6)))
    if sum(counts) <= 1 or sum(c > 0 for c in counts) < 2:
        counts[0], counts[width] = 3000, 1
    return fse.normalize_counts(counts, log, sum(counts), max_code)


@pytest.mark.parametrize("k", range(3), ids=[c for c, *_r in CATS])
def test_written_descriptions_read_the_same(read, k):
    """``fse.write_ncount``'s descriptions at the category's largest log,
    behind a one-sequence count and a modes byte that names them; a
    payload byte follows."""
    cat, max_code, max_log = CATS[k]
    rng = random.Random(2500 + k)
    for _ in range(60):
        norm = _random_norms(rng, max_code, max_log)
        while norm and norm[-1] == 0:
            norm.pop()
        desc = fse.write_ncount(norm, max_log)
        block = b"\x01" + bytes([seq.MODE_FSE << (6 - 2 * k)]) + desc + b"\x80"
        want = _verbatim(block, 0)
        assert want[1][k] == (seq.MODE_FSE, len(desc), max_log, norm)
        assert _native(read, block, 0) == want


def _random_section(rng):
    first = rng.choice((0, 1, 0x7F, 0x80, 0xC5, 0xFE, 0xFF))
    modes = rng.getrandbits(8)
    tail = bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 14)))
    if rng.random() < 0.5 and modes >> 2 & 3 == seq.MODE_FSE:
        tail = bytes([rng.randint(0, 4)]) + tail  # accuracy logs in range
    lead = bytes(rng.getrandbits(8) for _ in range(rng.randint(0, 3)))
    body = bytes([first]) + bytes(rng.getrandbits(8) for _ in range(2 if first > 127 else 0))
    return lead + body[: rng.randint(0, len(body))] + bytes([modes]) + tail, len(lead)


def test_random_sections_refused_where_the_chain_raises(read):
    """Random counts, modes and descriptions: the reader gives the chain's
    fields, and None exactly where the chain raises. ``read_ncount``'s
    check that the counts sum to the table size never fires: a count never
    takes more than is left, so what is left never falls below 1; the C++
    file keeps the check all the same."""
    rng = random.Random(25)
    refused = read_through = 0
    for _ in range(4000):
        block, off = _random_section(rng)
        want = _outcome(block, off)
        assert _native(read, block, off) == want, block.hex()
        refused += want is None
        read_through += want is not None and want[0] > 0
    assert refused > 400 and read_through > 400


def _same_tables(a, b):
    for x, y in zip(a, b):
        if x.accuracy_log == 0:  # an RLE table, made anew for each block
            assert y.accuracy_log == 0 and x.symbol.tolist() == y.symbol.tolist()
        else:
            assert x is y


def _same_plans(got, want):
    assert len(got) == len(want)
    for (gh, gp, gpos), (wh, wp, wpos) in zip(got, want):
        assert (gh, gpos) == (wh, wpos) and len(gp) == len(wp)
        for g, w in zip(gp, wp):
            assert g[0] == w[0]
            if g[0] != "cmp":
                assert g == w
                continue
            gd, wd = g[1], w[1]
            assert gd.keys() == wd.keys()
            for key in gd:
                if key == "tables":
                    _same_tables(gd[key], wd[key])
                elif key == "streams":
                    assert [s[:2] for s in gd[key]] == [s[:2] for s in wd[key]]
                    assert all(s[2] is t[2] for s, t in zip(gd[key], wd[key]))
                else:
                    assert type(gd[key]) is type(wd[key]) and gd[key] == wd[key]


def _without_library(monkeypatch):
    monkeypatch.setattr(seq_header, "reader", lambda: None)


@pytest.mark.parametrize("kind,name,level", [("port", "words", 3), ("port", "mixed", 19),
                                             ("libzstd", "mixed", 3)])
def test_plans_and_fse_stage_equal_the_verbatim_path(archives, monkeypatch, kind, name, level):
    blob, st = archives(kind, name, level)
    got = plan.plan_archive(blob, st)
    with monkeypatch.context() as m:
        _without_library(m)
        want = plan.plan_archive(blob, st)
    _same_plans(got, want)
    staged = [plan.fse_stage(plan.collect(p).seq_blocks) for p in (got, want)]
    for a, b in zip(*staged):
        assert np.array_equal(a, b)


# --- hostile frames --------------------------------------------------------


def _bits(*fields):
    """LSB-first bytes of (value, width) fields, as ``read_ncount`` reads."""
    acc = n = 0
    for value, width in fields:
        acc |= value << n
        n += width
    return acc.to_bytes((n + 7) // 8, "little")


def _frame(*sections):
    """A frame of compressed blocks, each 4 raw literals and the sequences
    section given."""
    body = b""
    for i, s in enumerate(sections):
        block = bytes([4 << 3]) + b"abcd" + s
        body += frame_mod.write_block_header(i == len(sections) - 1,
                                             frame_mod.BLOCK_COMPRESSED, len(block)) + block
    return frame_mod.write_frame_header(None, 1 << 17, checksum=False) + body


LL, OF, ML = (seq.MODE_FSE << 6, seq.MODE_FSE << 4, seq.MODE_FSE << 2)
# An ll description that uses 4 + 5 bits and then needs zero bits past its
# byte: a count of 14, then 18 counts of -1 from the zeros.
LL_PAST_END = _bits((0, 4), (15, 5))
# An ll count of 0, then zero-run fields of 3 past the 36 symbols.
LL_ZERO_RUN = _bits((0, 4), (1, 5), *[(3, 2)] * 12)
GOOD = b"\x01" + bytes([LL]) + fse.write_ncount(seq.LL_DEFAULT_NORM, 6) + b"\x80"

HOSTILE = {
    "truncated_description": ([b"\x01" + bytes([LL]) + LL_PAST_END], "truncated"),
    "counts_short_of_the_table": ([b"\x01" + bytes([OF]) + _bits((0, 4), (20, 5))],
                                  "truncated"),
    "accuracy_log_too_large": ([b"\x01" + bytes([OF]) + b"\x04\x00\x00"],
                               "accuracy log 9 too large"),
    "too_many_symbols": ([b"\x01" + bytes([OF]) + b"\x01" + bytes(8)], "too many symbols"),
    # A zero count, then the 32 counts of -1 that fill a log-5 table: 33
    # symbols where the offset codes have 32.
    "one_symbol_too_many": ([b"\x01" + bytes([OF]) + _bits((0, 4), (1, 5), (0, 2)) + bytes(24)],
                            "too many symbols"),
    "zero_run_past_the_symbols": ([b"\x01" + bytes([LL]) + LL_ZERO_RUN], "zero-run overflows"),
    "rle_symbol_out_of_range": ([b"\x01" + bytes([seq.MODE_RLE << 2, 53])],
                                "RLE symbol 53 out of range for ml"),
    "repeat_without_a_table": ([b"\x01" + bytes([seq.MODE_REPEAT << 4])],
                               "repeat mode without previous of table"),
    "repeat_before_a_bad_description": (
        [b"\x01" + bytes([seq.MODE_REPEAT << 6 | OF, 0x04])],
        "repeat mode without previous ll table"),
    "bad_description_before_a_repeat": (
        [b"\x01" + bytes([LL | seq.MODE_REPEAT << 4]) + LL_PAST_END], "truncated"),
    "second_block_bad": ([GOOD, b"\x01" + bytes([LL]) + LL_PAST_END], "truncated"),
    "first_of_two_bad_blocks": ([b"\x01" + bytes([seq.MODE_RLE << 2, 53]),
                                 b"\x01" + bytes([LL]) + LL_PAST_END],
                                "RLE symbol 53 out of range for ml"),
    "truncated_sequence_count": ([b"\xff\x01"], "truncated sequence count"),
    "truncated_two_byte_count": ([b"\x85"], "truncated sequence count"),
    "empty_sequences_section": ([b""], "empty sequences section"),
    "rle_symbol_missing": ([b"\x01" + bytes([seq.MODE_RLE << 6])], "truncated RLE symbol"),
    "no_modes_byte": ([b"\x01"], None),
}


def _error(frame):
    try:
        archive.decompress_frame(frame, device="cpu")
    except Exception as e:  # noqa: BLE001 - the class and message are compared
        return type(e), str(e)
    return None


@pytest.mark.parametrize("case", sorted(HOSTILE))
def test_hostile_frames_raise_the_verbatim_error(monkeypatch, case):
    sections, words = HOSTILE[case]
    frame = _frame(*sections)
    got = _error(frame)
    with monkeypatch.context() as m:
        _without_library(m)
        want = _error(frame)
    assert got == want and want is not None
    if words is not None:
        assert words in want[1]


# --- counters --------------------------------------------------------------


def test_counters_and_their_metric(archives, monkeypatch):
    blob, st = archives("port", "words", 3)
    ctx = types.SimpleNamespace(calls=[types.SimpleNamespace(kind="decode")])
    metric = manifest.reader("dec_plan_native_pct")
    device.reset_counters()
    out = archive.decompress_archive(blob, st, device="cpu")
    assert out == DATA["words"]
    c = dict(device.counters)
    assert c["plan.fse_descs_native"] == c["plan.fse_descs"] > 0
    assert metric(ctx) == 100
    with monkeypatch.context() as m:
        _without_library(m)
        device.reset_counters()
        assert archive.decompress_archive(blob, st, device="cpu") == out
        assert device.counters["plan.fse_descs"] == c["plan.fse_descs"]
        assert device.counters["plan.fse_descs_native"] == 0
        assert metric(ctx) == 0
    # A program without the counters (the parent of this reader): nothing.
    m = types.ModuleType("zeekstd_tpu_torch.device")
    m.counters = {"plan.copied_bytes": 1, "plan.planned_bytes": 1}
    monkeypatch.setitem(sys.modules, "zeekstd_tpu_torch.device", m)
    assert metric(ctx) is None
    device.reset_counters()
