"""PyTorch port on the CUDA card: every kernel against its plain version.

Marked ``gpu``; each test skips when no card is present. On a machine
with one: ``python -m pytest -m gpu tests/test_torch_gpu.py``. This file
imports no JAX, so it runs where JAX is not installed.
"""

import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import zeekstd_tpu_torch as zt
from zeekstd_tpu_torch import archive as archive_mod
from zeekstd_tpu_torch import decode_routes, frame_codec, ops, plan
from zeekstd_tpu_torch.cli import main as cli_main
from zeekstd_tpu_torch.ops import byte_kernels as bk
from zeekstd_tpu_torch.ops import decode_kernel as dk
from zeekstd_tpu_torch.ops import entropy
from zeekstd_tpu_torch.ops import exec_kernel as ek
from zeekstd_tpu_torch.ops import fse_kernel as fk
from zeekstd_tpu_torch.ops import match_kernel as mk
from zeekstd_tpu_torch.ops import match_tpu as mt
from zeekstd_tpu_torch.ops import reach_kernel as rch
from zeekstd_tpu_torch.ops import ring_kernel as rk

from . import (block_cases, byte_cases, frame_cases, fse_cases, fse_enc_cases, launch_cases,
               match_edges, ring_cases)
from . import test_torch_exec as exec_cases
from .torch_threads import two_torch_threads  # noqa: F401

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _data(n=160 << 10):
    rng = np.random.default_rng(8)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    text = b" ".join(words[rng.integers(0, 200)] for _ in range(n // 5))
    return (text[: n // 2] + b"B" * 5000 + bytes(rng.integers(0, 256, n // 5, dtype=np.uint8))
            + b"abcabcab" * n)[:n]


@pytest.fixture(scope="module")
def calls(card):
    """The inputs the pipeline hands each wrapper, on the card."""
    sites = {"match": (mk, "match"), "fse": (fk, "fse_encode"),
             "ring": (rk, "ring_decode"), "wide": (dk, "wide_decode")}
    rec = {k: [] for k in sites}
    orig = {k: getattr(m, a) for k, (m, a) in sites.items()}
    for k, (m, a) in sites.items():
        def wrap(*args, _k=k, **kw):
            rec[_k].append((args, kw))
            return orig[_k](*args, **kw)
        setattr(m, a, wrap)
    data = _data()
    try:
        blob, st = zt.compress_archive(data, frame_size=64 << 10, level=1, checksum=True,
                                       device=card)
        assert zt.decompress_archive(blob, st, device=card) == data
        os.environ["ZEEKSTD_TPU_RING"] = "0"
        assert zt.decompress_archive(blob, st, device=card) == data
    finally:
        os.environ.pop("ZEEKSTD_TPU_RING", None)
        for k, (m, a) in sites.items():
            setattr(m, a, orig[k])
    return rec


def test_match_kernel_equals_plain(calls):
    (a, k), = calls["match"]
    lm, ofv, litw, stat = mk.match(*a, **k)
    ref = mk.match_plain(*a, k["BLK"], k["SBd"])
    for got, want in zip((lm, ofv, litw, stat), ref):
        torch.testing.assert_close(got.cpu(), want.cpu(), rtol=0, atol=0)


@pytest.mark.parametrize("name", match_edges.NAMES)
def test_match_kernel_equals_plain_on_edge_inputs(card, name):
    """The match kernel on the edge inputs of ``match_edges`` (512 KiB, and
    2 MiB for the slot collisions and the 2^19 window in an 8 MiB frame
    row): every row equals the plain version exactly, one launch each."""
    n = (2 << 20) if name in ("collide", "window") else (512 << 10)
    rows, lengths, BLK, SBd = match_edges.edge_case(name, n)
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    args = [torch.from_numpy(x).to(card) for x in (fk.make_consts(), meta, words)]
    before = ops.launches["match"]
    got = mk.match(*args, BLK=BLK, SBd=SBd, n_frames=rows.shape[0])
    assert ops.launches["match"] == before + 1
    want = mk.match_plain(*(a.cpu() for a in args), BLK, SBd)
    assert int(want[3][:, mk.ST_NSEQ].sum()) > 0 or name == "random"
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


def test_fse_kernel_equals_plain(calls):
    (a, k), = calls["fse"]
    words, bits = fk.fse_encode(*a, **k)
    w0, b0 = fk.fse_plain(*a, k["SBd"], k["WBo"])
    assert torch.equal(bits.cpu(), b0.cpu())
    for j, nb in enumerate(b0.tolist()):
        if nb:
            assert torch.equal(words[j, : nb // 32 + 1].cpu(), w0[j, : nb // 32 + 1].cpu())


@pytest.mark.parametrize("chunk", fk.CHUNKS)
@pytest.mark.parametrize("name", fse_enc_cases.CASES)
def test_fse_kernel_equals_plain_on_cases(card, name, chunk, monkeypatch):
    """Each case of ``tests/fse_enc_cases.py`` (archive jobs at levels 1 and
    3, chunk-edge sequence counts, RLE and predefined tables, shared rows,
    code edges, table indices past the pool, a WBo the streams overflow)
    through one launch at each chunk size the kernel is built for (at 32
    every job of more than 32 sequences crosses chunks), into memory the
    allocator hands back filled with ones: bit counts equal fse_plain's,
    and words up to and including word bits // 32 (below WBo)."""
    monkeypatch.setattr(fk, "CHUNK", chunk)
    consts, meta, lm, ofv, tables, SBd, WBo = fse_enc_cases.case(name)
    host = [torch.from_numpy(x) for x in (consts, meta, lm, ofv, tables)]
    args = [t.to(card) for t in host]
    torch.full((meta.shape[0], WBo), -1, dtype=torch.int32, device=card)  # freed for the words
    before = ops.launches["fse"]
    words, bits = fk.fse_encode(*args, SBd=SBd, WBo=WBo)
    assert ops.launches["fse"] == before + 1
    w0, b0 = fk.fse_plain(*host, SBd, WBo)
    assert torch.equal(bits.cpu(), b0)
    for j, nb in enumerate(b0.tolist()):
        n = min(nb // 32 + 1, WBo)
        assert torch.equal(words[j, :n].cpu(), w0[j, :n]), j


def test_fse_kernel_refuses_an_unbuilt_chunk(card, monkeypatch):
    consts, meta, lm, ofv, tables, SBd, WBo = fse_enc_cases.case("rle")
    args = [torch.from_numpy(x).to(card) for x in (consts, meta, lm, ofv, tables)]
    monkeypatch.setattr(fk, "CHUNK", 100)
    before = ops.launches["fse"]
    with pytest.raises(ValueError):
        fk.fse_encode(*args, SBd=SBd, WBo=WBo)
    assert ops.launches["fse"] == before


@pytest.mark.parametrize("route", ["ring", "wide"])
def test_decode_kernels_equal_plain(calls, route):
    (a, k), = calls[route]
    if route == "ring":
        out, mo = rk.ring_decode(*a, **k)
        out0, mo0 = rk.ring_plain(*a, k["OUTB"])
    else:
        out, mo = dk.wide_decode(*a, **k)
        out0, mo0 = dk.wide_plain(*a, k["OUTB"], k["LITB"])
    assert torch.equal(mo[:, :3].cpu(), mo0[:, :3].cpu())
    F = mo.shape[0]
    ob = out.cpu().numpy().view(np.uint8).reshape(F, -1)
    ob0 = out0.cpu().numpy().view(np.uint8).reshape(F, -1)
    for f, tot in enumerate(mo0[:, 0].tolist()):
        np.testing.assert_array_equal(ob[f, :tot], ob0[f, :tot])


def _wide_equals_plain(a, k):
    """The CUDA wide decoder on ``a`` equals wide_plain exactly: meta_out
    columns 0-2 and each frame's bytes up to its total. Returns meta_out."""
    before = ops.launches["wide_decode"]
    out, mo = dk.wide_decode(*a, **k)
    assert ops.launches["wide_decode"] == before + 1
    out0, mo0 = dk.wide_plain(*(t.cpu() for t in a), k["OUTB"], k["LITB"])
    assert torch.equal(mo[:, :3].cpu(), mo0[:, :3])
    F = mo.shape[0]
    ob, ob0 = out.reshape(F, -1).cpu(), out0.reshape(F, -1)
    for f, tot in enumerate(mo0[:, 0].tolist()):
        assert torch.equal(ob[f, :tot], ob0[f, :tot]), f
    return mo0


def _fused_mutation(i, a):
    """Mutation ``i`` of 16 (seeded) of a fused call's meta rows or words."""
    consts, meta, words, tables, lits = a
    rng = np.random.default_rng(100 + i)
    m = meta.cpu().reshape(-1, dk.META_COLS).clone()
    w = words.cpu().clone()
    seq = torch.nonzero(m[:, dk.M_KIND] == dk.KIND_SEQ).flatten().tolist()
    r = seq[int(rng.integers(0, len(seq)))]
    if i < 3:
        m[r, dk.M_NSEQ] = (m[r, dk.M_NSEQ] + 1, m[r, dk.M_NSEQ] - 1, m[r, dk.M_NSEQ] * 8)[i]
    elif i < 7:
        m[r, dk.M_STARTBIT] += (1, -1, 33, -int(rng.integers(2, 33)))[i - 3]
    elif i < 9:
        m[r, dk.M_LITN] += (57, -int(rng.integers(1, 200)))[i - 7]
    elif i < 11:
        m[r, dk.M_LOGS] = int(rng.integers(0, 1 << 15))
    elif i < 14:
        col = (dk.M_TLL, dk.M_TOF, dk.M_TML)[i - 11]
        m[r, col] = (-1, tables.shape[0], tables.shape[0] + 9)[i - 11]
    else:
        row = w[min(max(int(m[r, dk.M_WROW]), 0), w.shape[0] - 1)]
        nbits = max(int(m[r, dk.M_STARTBIT]), 32)
        for _ in range(1 + 4 * (i - 14)):
            j = int(rng.integers(0, nbits))
            row[j // 32] ^= torch.tensor(1 << (j % 32), dtype=torch.int64).to(torch.int32)
    dev = meta.device
    return [consts, m.reshape(meta.shape).to(dev), w.to(dev), tables, lits]


@pytest.mark.parametrize("i", range(16))
def test_wide_decode_equals_plain_on_mutations(calls, i):
    (a, k), = calls["wide"]
    _wide_equals_plain(_fused_mutation(i, a), k)


def _ring_equals_plain(a, OUTB):
    """The CUDA ring decoder (one launch of its three stages) on ``a``
    equals ring_plain exactly: meta_out columns 0-2 and each frame's bytes
    up to its total. Returns meta_out."""
    before = ops.launches["ring_decode"]
    out, mo = rk.ring_decode(*a, OUTB=OUTB)
    assert ops.launches["ring_decode"] == before + 1
    out0, mo0 = rk.ring_plain(*(t.cpu() for t in a), OUTB)
    assert torch.equal(mo[:, :3].cpu(), mo0[:, :3])
    F = mo.shape[0]
    ob = out.cpu().numpy().view(np.uint8).reshape(F, -1)
    ob0 = out0.numpy().view(np.uint8).reshape(F, -1)
    for f, tot in enumerate(mo0[:, 0].tolist()):
        np.testing.assert_array_equal(ob[f, :tot], ob0[f, :tot])
    return mo0


@pytest.mark.parametrize("i", range(16))
def test_ring_decode_equals_plain_on_mutations(calls, i):
    """The 16 mutations of the wide route's test on the ring route: record
    counts, start bits, literal budgets, table logs, table rows outside the
    pool and flipped bits."""
    (a, k), = calls["ring"]
    _ring_equals_plain(_fused_mutation(i, a), k["OUTB"])


@pytest.mark.parametrize("name", ring_cases.NAMES)
def test_ring_decode_equals_plain_on_hand_built_records(card, name):
    """The places where the ring contract differs from the wide one
    (``ring_cases``): offsets over 512 KiB in a frame longer than 512 KiB,
    literal runs past their block's budget, sequences that read below their
    four-word window, a match at position 0."""
    arrays, OUTB = ring_cases.ring_case(name)
    mo0 = _ring_equals_plain([torch.from_numpy(x).to(card) for x in arrays], OUTB)
    assert mo0[:, 1].any()


@pytest.mark.parametrize("OUTB", [4096, 640])
def test_ring_decode_output_smaller_than_frames(calls, OUTB):
    (a, _k), = calls["ring"]
    mo0 = _ring_equals_plain(a, OUTB)
    assert (mo0[:, 0] == OUTB).all() and mo0[:, 1].all()


def _hand_wide(card, frames, pools, OUTB, tabs=None, words=None):
    meta, _n = dk.build_records(frames)
    lits = np.zeros((len(pools), 2048, 128), np.int32)
    for f, p in enumerate(pools):
        lits[f].reshape(-1)[: len(p)] = np.frombuffer(p, np.uint8)
    if tabs is None:
        tabs = np.zeros((1, 512), np.int32)
    if words is None:
        words = np.zeros((2, 16), np.int32)
    a = [torch.from_numpy(np.ascontiguousarray(x)).to(card)
         for x in (dk.make_consts(), meta, words, tabs, lits)]
    return a, dict(OUTB=OUTB, LITB=128 << 10)


def test_wide_decode_match_at_position_zero(card):
    """A record whose first sequence is a match at position 0 (its bytes
    read 0), then matches and literals at random, an RLE run and a frame
    of one literal run."""
    rng = np.random.default_rng(3)
    tabs = np.zeros((3, 512), np.int64)
    tabs[0, 0::2] = 0 | (1 << 8)   # ll code 0: ll 0; one update bit
    tabs[0, 1::2] = 4 | (1 << 8)   # ll code 4: ll 4
    tabs[1, :] = 3                 # offset code 3: offset value 8-15
    tabs[2, :] = 5                 # ml code 5: ml 8
    words = rng.integers(0, 1 << 32, (2, 16), dtype=np.uint64).astype(np.uint32).view(np.int32)
    nseq = 40
    pools = [rng.integers(0, 256, 256, dtype=np.uint8).tobytes(), b"literal!!"]
    a, k = _hand_wide(card, [[("seq", 0, nseq, 200, 0, 1, 2, 0, 4 * nseq - 1), ("rle", 5, 7)],
                             [("lit", 9)]], pools, 8192, tabs.astype(np.int32), words)
    mo0 = _wide_equals_plain(a, k)
    assert mo0[:, 1].tolist() == [1, 0]


def test_wide_decode_literal_and_rle_frames(card):
    rng = np.random.default_rng(4)
    pools = [rng.integers(0, 256, 700, dtype=np.uint8).tobytes(), b"", b"xyz"]
    a, k = _hand_wide(card, [[("lit", 300), ("rle", 1000, 0x41), ("lit", 400)],
                             [("rle", 4096, 200)], [("lit", 3), ("rle", 77, 0)]], pools, 4096)
    mo0 = _wide_equals_plain(a, k)
    assert mo0[:, :3].tolist() == [[1700, 0, 700], [4096, 0, 0], [80, 0, 3]]


@pytest.mark.parametrize("OUTB", [4096, 640])
def test_wide_decode_output_smaller_than_frames(calls, OUTB):
    (a, k), = calls["wide"]
    mo0 = _wide_equals_plain(a, dict(k, OUTB=OUTB))
    assert (mo0[:, 0] == OUTB).all() and mo0[:, 1].all()


# Per route, the function each launch group calls first.
GROUP_START = {"ring": (dk, "build_records"), "wide": (dk, "build_records"),
               "serial": (ek, "build_records"), "doubling": (decode_routes, "_slot_maps")}


def _watch_group_memory(monkeypatch, route):
    """Per launch group of ``route``, the device bytes allocated at its peak
    beyond those allocated when it began (its ``GROUP_START`` call).
    Returns (peaks, close): ``close()`` ends the last group."""
    peaks, base = [], []
    mod, attr = GROUP_START[route]
    orig = getattr(mod, attr)

    def close():
        if len(base) > len(peaks):
            peaks.append(torch.cuda.max_memory_allocated() - base[-1])

    def start(*a, **k):
        close()
        base.append(torch.cuda.memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        return orig(*a, **k)

    monkeypatch.setattr(mod, attr, start)
    return peaks, close


def _count_calls(monkeypatch, wrapper):
    """Count the calls of ``wrapper`` (module, attribute)."""
    mod, attr = wrapper
    orig, calls = getattr(mod, attr), [0]

    def call(*a, **k):
        calls[0] += 1
        return orig(*a, **k)

    monkeypatch.setattr(mod, attr, call)
    return calls


def _groups_within_counts(watched, peaks):
    """The one ``plan.launch_groups`` call's groups, each of which stayed
    within its ``launch_bytes`` count, and within ``plan.LAUNCH_BYTES``
    unless it is one frame."""
    (args, groups), = watched
    costs = launch_cases.group_costs(args, groups)
    assert len(peaks) == len(groups)
    for (lo, hi), peak, cost in zip(groups, peaks, costs):
        assert peak <= cost, (groups, peaks, costs)
        assert hi - lo == 1 or cost <= plan.LAUNCH_BYTES
    return args, groups, peaks, costs


@pytest.mark.parametrize("route", list(launch_cases.ROUTES))
def test_routes_decode_in_launch_groups(card, route, monkeypatch):
    """The uneven archive of the CPU launch-group tests on each route with
    ``plan.LAUNCH_BYTES`` small: one launch per group (one executor call on
    the doubling route), each group's device bytes within its count, and
    the bytes of one group."""
    env, wrapper, key, budget = launch_cases.ROUTES[route]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    blob, st, data, _spans = launch_cases.uneven("cpu")

    def rows():
        out, sizes = zt.decompress_archive(blob, st, return_device=True, device=card)
        return [out[i, :n].cpu().numpy().tobytes() for i, n in enumerate(sizes)]

    one = rows()
    monkeypatch.setattr(plan, "LAUNCH_BYTES", budget)
    watched = launch_cases.watch_groups(monkeypatch)
    peaks, close = _watch_group_memory(monkeypatch, route)
    calls = _count_calls(monkeypatch, wrapper)
    ops.reset_launches()
    assert zt.decompress_archive(blob, st, device=card) == data
    close()
    _args, groups, peaks, costs = _groups_within_counts(watched, peaks)
    assert len(groups) >= 2 and any(hi - lo >= 2 for lo, hi in groups), groups
    assert calls[0] == len(groups)
    if key is not None:
        assert ops.launches[key] == len(groups)
    print(f"{route} launch groups {groups}: peak device bytes {peaks}, counted {costs}")
    assert rows() == one and b"".join(one) == data


@pytest.mark.parametrize("route", ["serial", "doubling"])
def test_uneven_archive_decodes_in_launch_groups(card, route, monkeypatch):
    """One 48 MiB frame of random bytes (level 3: a 2 MiB window and a bound
    over 4 MiB, so the serial route by default) among 300 frames of 64 KiB
    of text, encoded apart and joined under one seek table, on the serial
    route and on the doubling route (``ZEEKSTD_TPU_EXEC=doubling``). Laid
    out at the largest frame in one launch either route would need far more
    than the card's 80 GB (the doubling route did so until it took launch
    groups, and ran out of memory); in launch groups it decodes exactly,
    each group within its count of device bytes."""
    rng = np.random.default_rng(48)
    big = rng.integers(0, 256, 48 << 20, dtype=np.uint8).tobytes()
    small = [_data(150 << 16), _data(150 << 16)[::-1]]
    parts = [zt.compress_archive(x, frame_size=n, level=3, checksum=True, device=card)
             for x, n in ((small[0], 1 << 16), (big, len(big)), (small[1], 1 << 16))]
    st = zt.SeekTable()
    for _blob, part_st in parts:
        for i in range(part_st.num_frames):
            st.log_frame(part_st.frame_size_comp(i), part_st.frame_size_decomp(i))
    blob, data = b"".join(b for b, _st in parts), small[0] + big + small[1]
    assert st.num_frames == 301
    if route == "doubling":
        monkeypatch.setenv("ZEEKSTD_TPU_EXEC", "doubling")
    watched = launch_cases.watch_groups(monkeypatch)
    peaks, close = _watch_group_memory(monkeypatch, route)
    calls = _count_calls(monkeypatch, launch_cases.ROUTES[route][1])
    ops.reset_launches()
    fallbacks = decode_routes.serial_fallback_count()
    assert zt.decompress_archive(blob, st, device=card) == data
    close()
    if route == "serial":
        assert decode_routes.serial_fallback_count() == fallbacks + 1  # the fused bound guard
        assert decode_routes._serial_fallbacks["reason"].startswith("frame bound")
    else:
        assert decode_routes.serial_fallback_count() == fallbacks
    args, groups, peaks, costs = _groups_within_counts(watched, peaks)
    assert len(groups) >= 2 and calls[0] == len(groups)
    if route == "serial":
        assert ops.launches["exec"] == len(groups)
    (one_launch,) = launch_cases.group_costs(args, [(0, 301)])
    assert one_launch > 80 << 30
    print(f"{route} launch groups {groups}: peak device bytes {peaks}, counted {costs}; "
          f"one launch would count {one_launch}")


def test_card_archives_equal_cpu_archives(card):
    data = _data(96 << 10)
    before = dict(ops.launches)
    blob, st = zt.compress_archive(data, frame_size=32 << 10, level=1, device=card)
    cpu_blob, _ = zt.compress_archive(data, frame_size=32 << 10, level=1, device="cpu")
    assert blob == cpu_blob
    assert zt.decode_frames(blob, [(st.frame_start_comp(1), st.frame_end_comp(1))],
                            device=card) == [data[32 << 10 : 64 << 10]]
    assert ops.launches["match"] > before["match"]
    assert ops.launches["ring_decode"] > before["ring_decode"]


def test_reach_kernels_equal_plain(card):
    """Both reachability kernels on a level-3 parse's steps and on odd
    steps (saturation and clipping), exactly."""
    rng = np.random.default_rng(11)
    odd = rng.integers(-40, 200, (1000, rch.CHUNK)).astype(np.int32)
    calls = []
    orig = rch.chunk_pointer_tables

    def rec(step2):
        calls.append(step2)
        return orig(step2)

    rch.chunk_pointer_tables = rec
    try:
        zt.compress_archive(_data(), frame_size=64 << 10, level=3, device=card)
    finally:
        rch.chunk_pointer_tables = orig
    assert calls
    for step2 in calls + [torch.from_numpy(odd).to(card)]:
        tables = rch.chunk_pointer_tables(step2)
        assert torch.equal(tables.cpu(), rch.tables_plain(step2.cpu()))
        entry2 = torch.from_numpy(
            rng.integers(-5, 140, tuple(step2.shape)).astype(np.int32)).to(card)
        mask = rch.chunk_mark(tables, entry2)
        assert torch.equal(mask.cpu(), rch.mark_plain(tables.cpu(), entry2.cpu()))


def test_card_level3_and_patch_archives_equal_cpu_archives(card):
    data = _data(96 << 10)
    old = data[: 40 << 10]
    before = dict(ops.launches)
    for kw in (dict(level=3), dict(level=19, prefix=old, checksum=True)):
        blob, st = zt.compress_archive(data, frame_size=32 << 10, device=card, **kw)
        cpu_blob, _ = zt.compress_archive(data, frame_size=32 << 10, device="cpu", **kw)
        assert blob == cpu_blob
    for i in range(st.num_frames):
        got, _end = archive_mod.decompress_frame(blob, st.frame_start_comp(i), prefix=old,
                                                 device=card)
        assert got == data[st.frame_start_decomp(i) : st.frame_end_decomp(i)]
    for k in ("reach_tables", "reach_mark", "fse"):
        assert ops.launches[k] > before[k]


@pytest.fixture(scope="module")
def route_calls(card):
    """Serial- and doubling-route decodes of level-1 and level-3 archives
    on the card (each equal to the CPU port's bytes), with the inputs the
    routes hand the exec, FSE-decode and reachability wrappers."""
    sites = {"exec": (ek, "serial_exec"), "fse_decode": (entropy, "fse_decode_sequences"),
             "reach_tables": (rch, "chunk_pointer_tables"), "reach_mark": (rch, "chunk_mark")}
    rec = {k: [] for k in sites}
    orig = {k: getattr(m, a) for k, (m, a) in sites.items()}
    for k, (m, a) in sites.items():
        def wrap(*args, _k=k, **kw):
            rec[_k].append((args, kw))
            return orig[_k](*args, **kw)
        setattr(m, a, wrap)
    data = _data(96 << 10)
    before = dict(ops.launches)
    try:
        for level, frame in ((1, 32 << 10), (3, 32 << 10)):
            blob, st = zt.compress_archive(data, frame_size=frame, level=level, checksum=True,
                                           device=card)
            for mode in ("serial", "doubling"):
                os.environ["ZEEKSTD_TPU_EXEC"] = mode
                assert zt.decompress_archive(blob, st, device=card) == data
                assert zt.decompress_archive(blob, st, device="cpu") == data
                got, _end = archive_mod.decompress_frame(blob, st.frame_start_comp(1), device=card)
                assert got == data[st.frame_start_decomp(1) : st.frame_end_decomp(1)]
    finally:
        os.environ.pop("ZEEKSTD_TPU_EXEC", None)
        for k, (m, a) in sites.items():
            setattr(m, a, orig[k])
    for k in sites:
        assert ops.launches[k] > before[k], k
    return {k: [(a, kw) for a, kw in v if a[0].is_cuda] for k, v in rec.items()}


def test_exec_kernel_equals_plain(route_calls):
    assert route_calls["exec"]
    for a, k in route_calls["exec"]:
        out, mo = ek.serial_exec(*a, **k)
        out0, mo0 = ek.exec_plain(*(t.cpu() for t in a), k["OUTB"], k["LITB"], k["SBd"])
        assert torch.equal(mo[:, :3].cpu(), mo0[:, :3])
        F = mo.shape[0]
        ob, ob0 = out.reshape(F, -1).cpu(), out0.reshape(F, -1)
        for f, tot in enumerate(mo0[:, 0].tolist()):
            assert torch.equal(ob[f, :tot], ob0[f, :tot])


def _exec_equals_plain(a, k):
    """The CUDA executor (one launch of its scan and resolve) on ``a``
    equals exec_plain exactly: meta_out columns 0-2 and each frame's bytes
    up to its total. Returns meta_out."""
    before = ops.launches["exec"]
    out, mo = ek.serial_exec(*a, **k)
    assert ops.launches["exec"] == before + 1
    out0, mo0 = ek.exec_plain(*(t.cpu() for t in a), k["OUTB"], k["LITB"], k["SBd"])
    assert torch.equal(mo[:, :3].cpu(), mo0[:, :3])
    F = mo.shape[0]
    ob, ob0 = out.reshape(F, -1).cpu(), out0.reshape(F, -1)
    for f, tot in enumerate(mo0[:, 0].tolist()):
        assert torch.equal(ob[f, :tot], ob0[f, :tot]), f
    return mo0


EXEC_MUTATIONS = 16


def exec_mutation(i, a, k):
    """Mutation ``i`` of ``EXEC_MUTATIONS`` (seeded) of a serial call's
    records or sequence rows: rows out of range (0, 1), M_NSEQ negative or
    over SBd or one short (2-4), M_LITN below what the slices use or one
    short (5, 6), offsets of 0 or past the position (7-10), a literal run
    past the record's window (11, 12), a match past OUTB (13), an OUTB below
    the frames (14), and noise in 64 sequences (15). The records stay as
    ``build_records`` makes them: a frame's F_FRAME_START only on its first
    record, which the executor takes as given. Returns (args, kwargs)."""
    meta, lls, mls, ofvs, lits = a
    rng = np.random.default_rng(200 + i)
    m = meta.cpu().reshape(-1, ek.META_COLS).clone()
    ll, ml, of = (t.cpu().clone() for t in (lls, mls, ofvs))
    seq = torch.nonzero(m[:, ek.M_KIND] == ek.KIND_SEQ).flatten().tolist()
    r = seq[int(rng.integers(0, len(seq)))]
    row, nseq = int(m[r, ek.M_ROW]), int(m[r, ek.M_NSEQ])
    j = int(rng.integers(0, max(nseq, 1)))
    ends = [q for q in seq if m[q, ek.M_FLAGS] & ek.F_BLOCK_END]
    kw = dict(k)
    if i < 2:
        m[r, ek.M_ROW] = (-5, ll.shape[0] + 3)[i]
    elif i < 5:
        m[r, ek.M_NSEQ] = (-3, k["SBd"] + 7, nseq - 1)[i - 2]
    elif i < 7:
        q = ends[int(rng.integers(0, len(ends)))]
        m[q, ek.M_LITN] -= (int(m[q, ek.M_LITN]) + 50, 1)[i - 5]
    elif i == 7:  # offset 1, then rep1 - 1 = 0
        j = max(j, 1) if nseq > 1 else j
        of[row, j - 1] = 4
        ll[row, j], of[row, j] = 5, 0
    elif i < 11:
        ll[row, j] = (0, ll[row, j], ll[row, j])[i - 8]
        of[row, j] = (3, k["OUTB"] + 1003, -7)[i - 8]
    elif i == 11:
        ll[row, j] = k["LITB"] + 700
    elif i == 12:
        lit = torch.nonzero(m[:, ek.M_KIND] == ek.KIND_LIT).flatten().tolist() or ends
        m[lit[0], ek.M_LITN] += k["LITB"] + 300
    elif i == 13:
        ml[row, j] = k["OUTB"] + 5
    elif i == 14:
        kw["OUTB"] = 4096
    else:
        for _ in range(64):
            q = int(rng.integers(0, ll.shape[0])), int(rng.integers(0, ll.shape[1]))
            ll[q], ml[q] = int(rng.integers(0, 300)), int(rng.integers(0, 300))
            of[q] = int(rng.integers(-2, 5000))
    dev = meta.device
    return [m.reshape(meta.shape).to(dev), ll.to(dev), ml.to(dev), of.to(dev), lits], kw


@pytest.mark.parametrize("i", range(EXEC_MUTATIONS))
def test_exec_kernel_equals_plain_on_mutations(route_calls, i):
    """Each mutation of ``exec_mutation`` of every serial call on the card:
    the executor equals exec_plain exactly."""
    for a, k in route_calls["exec"]:
        _exec_equals_plain(*exec_mutation(i, a, k))


@pytest.mark.parametrize("name", exec_cases.CASES)
def test_exec_kernel_equals_plain_on_cases(card, name):
    """The twelve cases of ``test_torch_exec.py`` (repeat offsets threaded
    across blocks, overlapped matches, literal and RLE records, SBd
    slicing, a bad offset, multi-frame batches) through the CUDA executor:
    each equals exec_plain exactly."""
    for a, k in exec_cases.case_args(name):
        _exec_equals_plain([t.to(card) for t in a], k)


def test_exec_kernel_refuses_outputs_past_int32_descriptors(card):
    """An OUTB at which a descriptor (a position, or -257 - i for a literal
    index i below it) would leave int32 raises the package's error before
    anything is allocated or launched."""
    (a, k), = exec_cases.case_args("simple_match")
    before = ops.launches["exec"]
    with pytest.raises(zt.ZeekstdError, match="corruption_detected"):
        ek.serial_exec(*(t.to(card) for t in a), **dict(k, OUTB=1 << 31))
    assert ops.launches["exec"] == before


def test_fse_decode_kernel_equals_plain(route_calls):
    assert route_calls["fse_decode"]
    for a, k in route_calls["fse_decode"]:
        got = entropy.fse_decode_sequences(*a, **k)
        want = entropy.fse_decode_plain(*(t.cpu() for t in a), k["seq_bound"])
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)


def test_fse_decode_kernel_equals_plain_on_hostile_tables(card):
    rng = np.random.default_rng(17)
    B, WB, T = 70, 16, 5
    words = rng.integers(0, 1 << 32, (B, WB), dtype=np.uint64).astype(np.uint32)
    sym, nb = rng.integers(0, 256, (T, 512)), rng.integers(0, 256, (T, 512))
    base = rng.integers(0, 1 << 15, (T, 512))
    st = zt.from_reference_arrays(
        card, words=words, starts=rng.integers(-40, WB * 32 + 40, B).astype(np.int32),
        nseqs=rng.integers(-3, 40, B).astype(np.int32),
        tidx=rng.integers(0, T, (B, 3)).astype(np.int32),
        tables=(sym | (nb << 8) | (base << 16)).astype(np.int32),
        logs=rng.integers(0, 12, T).astype(np.int32), consts=dk.make_consts())
    args = [st[n] for n in ("words", "starts", "nseqs", "tidx", "tables", "logs", "consts")]
    got = entropy.fse_decode_sequences(*args, seq_bound=32)
    want = entropy.fse_decode_plain(*(t.cpu() for t in args), 32)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


@pytest.mark.parametrize("stage", ["budget", "window64", "odd_bound"])
@pytest.mark.parametrize("name", fse_cases.CASES)
def test_fse_decode_kernel_equals_plain_on_cases(card, name, stage, monkeypatch):
    """Each case of ``tests/fse_cases.py`` (a planned level-3 call, its
    mutations, rows past the staging budget, a chain of 12,000 sequences)
    through one kernel launch: at the staging budget, with a 64-word
    window (every row slides it and reads past it from global memory), and
    with an odd ``seq_bound`` (rows not 8-byte aligned: no paired stores).
    Equal to fse_decode_plain in all six outputs."""
    if stage == "window64":
        monkeypatch.setattr(entropy, "STAGE_WORDS", 64)
    *arrays, seq_bound = fse_cases.case(name)
    if stage == "odd_bound":
        seq_bound += 1
    st = zt.from_reference_arrays(card, **dict(zip(
        ("words", "starts", "nseqs", "tidx", "tables", "logs", "consts"), arrays)))
    args = [st[n] for n in ("words", "starts", "nseqs", "tidx", "tables", "logs", "consts")]
    before = ops.launches["fse_decode"]
    got = entropy.fse_decode_sequences(*args, seq_bound=seq_bound)
    assert ops.launches["fse_decode"] == before + 1
    want = entropy.fse_decode_plain(*(t.cpu() for t in args), seq_bound)
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)


def test_route_reach_kernels_equal_plain(route_calls):
    assert route_calls["reach_tables"] and route_calls["reach_mark"]
    for (a, _k) in route_calls["reach_tables"]:
        assert torch.equal(rch.chunk_pointer_tables(*a).cpu(), rch.tables_plain(a[0].cpu()))
    for (a, _k) in route_calls["reach_mark"]:
        assert torch.equal(rch.chunk_mark(*a).cpu(),
                           rch.mark_plain(*(t.cpu() for t in a)))


@pytest.mark.parametrize("n,block", [(1 << 20, 1 << 15), (3 << 13, 1 << 13), (1 << 12, 128)])
def test_byte_kernels_equal_plain(card, n, block):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 256, n).astype(np.uint8)
    data[: n // 4] = 7  # a long run: one hot bin
    d = torch.from_numpy(data)
    table = torch.from_numpy(rng.integers(-(1 << 31), 1 << 31, 256).astype(np.int32))
    hist = bk.byte_histogram(d.to(card), block=block)
    assert torch.equal(hist.cpu(), bk.histogram_plain(d, block))
    look = bk.table_lookup(d.to(card), table.to(card))
    assert torch.equal(look.cpu(), bk.lookup_plain(d, table))
    # An unaligned view takes the byte-wise paths.
    off = d.to(card)[1 : 1 + n - 1024]
    m = (n - 1024) // block * block
    assert torch.equal(bk.byte_histogram(off[:m], block=block).cpu(),
                       bk.histogram_plain(d[1 : 1 + m], block))
    assert torch.equal(bk.table_lookup(off[: n - 1024], table.to(card)).cpu(),
                       bk.lookup_plain(d[1 : 1 + n - 1024], table))


def _card_view(card, x, aligned):
    """``x`` (a CPU tensor) on the card: at an allocation's start, or one
    byte past it (not 4- or 16-byte aligned)."""
    if aligned:
        return x.to(card)
    buf = torch.empty(x.numel() + 16, dtype=x.dtype, device=card)
    view = buf[1 : 1 + x.numel()]
    view.copy_(x.to(card))
    assert view.data_ptr() % 4 != 0
    return view


def _card_table(card, table):
    """A numpy table on the card, strided there too where it is strided."""
    if table.flags.c_contiguous:
        return torch.from_numpy(table).to(card)
    tab = torch.from_numpy(np.repeat(table, 2)).to(card)[::2]
    assert not tab.is_contiguous()
    return tab


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", list(byte_cases.HIST))
def test_byte_histogram_equals_plain_on_cases(card, name, aligned):
    """Each case of ``tests/byte_cases.py`` through one launch, on an aligned
    tensor and on an unaligned view, into memory the allocator hands back
    filled with ones."""
    data, block = byte_cases.HIST[name]
    d = torch.from_numpy(data)
    dd = _card_view(card, d, aligned)
    torch.full((d.numel() // block, 256), -1, dtype=torch.int32, device=card)  # freed
    before = ops.launches["byte_histogram"]
    got = bk.byte_histogram(dd, block=block)
    assert ops.launches["byte_histogram"] == before + 1
    assert torch.equal(got.cpu(), bk.histogram_plain(d, block))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("name", list(byte_cases.LOOKUP))
def test_table_lookup_equals_plain_on_cases(card, name, aligned):
    """As above for the lookup; the tables are of several integer dtypes,
    one strided, each cast to int32 as the reference casts it, and the
    caller's table is left as it was."""
    data, table = byte_cases.LOOKUP[name]
    d = torch.from_numpy(data)
    dd = _card_view(card, d, aligned)
    tab = _card_table(card, table)
    kept = tab.clone()
    torch.full((d.numel(),), -1, dtype=torch.int32, device=card)  # freed
    before = ops.launches["table_lookup"]
    got = bk.table_lookup(dd, tab)
    assert ops.launches["table_lookup"] == before + 1
    assert got.dtype == torch.int32
    assert torch.equal(got.cpu(), bk.lookup_plain(d, torch.from_numpy(table)))
    assert torch.equal(tab, kept) and tab.dtype == kept.dtype


@pytest.mark.parametrize("name,n,block", [
    ("byte_histogram", 10 << 20, 1 << 15), ("byte_histogram", 3 << 20, 1 << 20),
    ("byte_histogram", 3 * 49152, 49152), ("byte_histogram", 1 << 12, 128),
    ("table_lookup", 10 << 20, 0), ("table_lookup", 1024 * 12345, 0), ("table_lookup", 1024, 0)])
def test_byte_kernels_write_every_output(card, name, n, block):
    """The histogram's launch and the lookup's one-wave grid leave no output
    element unwritten: the wrapper's output lands in memory the allocator
    hands back filled with -1 (no count and no table entry here) and equals
    the plain version."""
    rng = np.random.default_rng(n)
    d = torch.from_numpy(rng.integers(0, 256, n).astype(np.uint8))
    table = torch.arange(256, dtype=torch.int32) * 7 + 1
    dd, tab = d.to(card), table.to(card)
    shape = (n // block, 256) if name == "byte_histogram" else (n,)
    pool = torch.cuda.MemPool()  # holds only the filled memory, then the output
    with torch.cuda.use_mem_pool(pool):
        filled = torch.full(shape, -1, dtype=torch.int32, device=card)
        where = filled.data_ptr()
        del filled
        if name == "byte_histogram":
            out = bk.byte_histogram(dd, block=block)
        else:
            out = bk.table_lookup(dd, tab)
    assert out.data_ptr() == where  # the filled memory, handed back
    want = bk.histogram_plain(d, block) if name == "byte_histogram" else bk.lookup_plain(d, table)
    assert torch.equal(out.cpu(), want)


# --- the streaming Encoder and Decoder and the CLI on the card -------------


def _stream_encode(level, device, data, fsize=64 << 10):
    """The streaming Encoder's archive (tpu backend, 48 KiB writes)."""
    buf = io.BytesIO()
    enc = (zt.EncodeOptions().with_backend("tpu").with_device(device)
           .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(fsize))
           .with_compression_level(level).with_checksum_flag(True).into_encoder(buf))
    step = 48 << 10
    for i in range(0, len(data), step):
        enc.write(data[i : i + step])
    enc.finish()
    return buf.getvalue()


@pytest.mark.parametrize("level", [1, 3])
def test_streaming_encoder_on_card_equals_cpu(card, level):
    data = _data(640 << 10)
    ops.reset_launches()
    archive = _stream_encode(level, card, data)
    counts = dict(ops.launches)
    assert archive == _stream_encode(level, "cpu", data)
    assert counts["fse"] > 0
    assert counts["match" if level == 1 else "reach_tables"] > 0


@pytest.mark.parametrize("level,route", [(1, "ring"), (3, "wide")])
def test_streaming_decoder_on_card_round_trips(card, level, route, monkeypatch):
    """64 KiB windows take the ring route; ZEEKSTD_TPU_RING=0 the wide one."""
    if route == "wide":
        monkeypatch.setenv("ZEEKSTD_TPU_RING", "0")
    else:
        monkeypatch.delenv("ZEEKSTD_TPU_RING", raising=False)
    data = _data(640 << 10)
    archive = _stream_encode(level, "cpu", data)
    st = zt.SeekTable.from_seekable(zt.BytesWrapper(archive))

    def decoder(**kw):
        opts = zt.DecodeOptions(zt.BytesWrapper(archive)).with_backend("tpu").with_device(card)
        for name, value in kw.items():
            opts = getattr(opts, "with_" + name)(value)
        return opts.into_decoder()

    ops.reset_launches()
    assert decoder().read(-1) == data
    counts = dict(ops.launches)
    assert counts[route + "_decode"] == st.num_frames
    assert decoder(lower_frame=3, upper_frame=5).read(-1) == data[3 * 65536 : 6 * 65536]
    dec = decoder()
    dec.seek(65536 - 1000)
    assert dec.read(3000) == data[65536 - 1000 : 65536 + 2000]


def test_cli_round_trip_on_card(card, tmp_path):
    data = _data(640 << 10)
    src, arc, out = tmp_path / "in.bin", tmp_path / "in.bin.zst", tmp_path / "out.bin"
    src.write_bytes(data)
    assert cli_main(["-q", "compress", str(src), "--backend", "tpu", "-s", "64K", "-l", "3"]) == 0
    assert cli_main(["-q", "compress", str(src), "-o", str(tmp_path / "cpu.zst"), "--backend",
                     "tpu", "--device", "cpu", "-s", "64K", "-l", "3"]) == 0
    assert arc.read_bytes() == (tmp_path / "cpu.zst").read_bytes()
    assert cli_main(["-q", "decompress", str(arc), "-o", str(out), "--backend", "tpu"]) == 0
    assert out.read_bytes() == data
    assert cli_main(["-q", "d", str(arc), "-o", str(out), "-f", "--backend", "tpu",
                     "--from-frame", "2", "--to-frame", "4"]) == 0
    assert out.read_bytes() == data[2 * 65536 : 5 * 65536]


# --- the per-frame device encoder and the native runtime on the card ------


@pytest.mark.parametrize("checksum", [False, True])
@pytest.mark.parametrize("name", list(frame_cases.CASES))
def test_frame_codec_on_card_equals_cpu(card, name, checksum, monkeypatch):
    """``frame_codec.compress_frame`` on the card writes the CPU run's frame
    (the plain versions), with one FSE-kernel launch per frame that has a
    sequence-bearing block; the card's decoder reads it back."""
    data = frame_cases.CASES[name]
    calls = []
    plain = fk.fse_encode

    def counted(*a, **k):
        calls.append(1)
        return plain(*a, **k)

    monkeypatch.setattr(fk, "fse_encode", counted)
    want = frame_codec.compress_frame(data, checksum=checksum, device="cpu")
    monkeypatch.setattr(fk, "fse_encode", plain)
    ops.reset_launches()
    got = frame_codec.compress_frame(data, checksum=checksum, device=card)
    assert ops.launches["fse"] == len(calls) <= 1
    assert got == want
    assert archive_mod.decompress_frame(got, device=card) == (data, len(got))


def test_default_backend_is_native_on_card_machine(card):
    """The native runtime builds on the card's host: ``auto`` picks it, and
    its archive decodes on the card."""
    from zeekstd_tpu_torch.native import loader

    assert loader.available()
    data = _data(256 << 10)
    buf = io.BytesIO()
    enc = zt.EncodeOptions().with_frame_size_policy(
        zt.FrameSizePolicy.uncompressed(64 << 10)).into_encoder(buf)
    assert enc.raw._use_native()
    enc.write(data)
    enc.finish()
    blob = buf.getvalue()
    st = zt.SeekTable.from_seekable(zt.BytesWrapper(blob))
    assert zt.decompress_archive(blob[: st.size_comp], st, device=card) == data
    assert zt.DecodeOptions(zt.BytesWrapper(blob)).into_decoder().read(-1) == data


@pytest.mark.parametrize("level,frame", [(1, 32 << 10), (3, 16 << 10)])
def test_mesh8_on_card_equals_cpu(card, level, frame, monkeypatch):
    """The 8-shard mesh over the card (one process) writes the CPU mesh's
    archive, decodes it with one fused launch per shard that owns frames
    (ring at level 1, wide at level 3 by ZEEKSTD_TPU_RING=0), on the
    doubling route with either Huffman decoder, and serves ranges."""
    from zeekstd_tpu_torch import parallel

    data = _data()
    gpu, cpu = parallel.make_mesh(["cuda"] * 8), parallel.make_mesh(["cpu"] * 8)
    blob, st = parallel.parallel_compress(data, gpu, frame_size=frame, level=level,
                                          checksum=True)
    want, want_st = parallel.parallel_compress(data, cpu, frame_size=frame, level=level,
                                               checksum=True)
    assert blob == want and st.to_bytes() == want_st.to_bytes()
    if level == 3:
        monkeypatch.setenv("ZEEKSTD_TPU_RING", "0")
    ops.reset_launches()
    assert parallel.parallel_decompress(blob, st, gpu) == data
    route = "ring_decode" if level == 1 else "wide_decode"
    per_shard = -(-st.num_frames // 8)
    assert ops.launches[route] == -(-st.num_frames // per_shard) > 1
    monkeypatch.setenv("ZEEKSTD_TPU_MESH_EXEC", "doubling")
    for huf in ("bitreach", "spec"):
        monkeypatch.setenv("ZEEKSTD_TPU_HUF", huf)
        assert parallel.parallel_decompress(blob, st, gpu) == data
    monkeypatch.delenv("ZEEKSTD_TPU_MESH_EXEC")
    ranges = [(100, 5000), (frame - 7, 3 * frame + 11)]
    got = parallel.parallel_random_access(blob, st, ranges, gpu)
    assert got == [data[a:b] for a, b in ranges]


@pytest.mark.parametrize("BLK", (16 << 10, 32 << 10, 36 << 10, 64 << 10, 128 << 10))
@pytest.mark.parametrize("name", list(block_cases.INPUTS))
def test_match_kernel_equals_plain_at_block_sizes(card, name, BLK):
    """The match kernel on one frame of each block case (``block_cases``;
    the largest multiple of BLK in 256 KiB) at archive block sizes from
    16 to 128 KiB: the packed instance up to 32 KiB, the WIDE one above
    (a window's last 4 KiB at 36 KiB). Every row equals the plain
    version, the wide rows included; the long-run input holds a literal
    run and a match past 16 bits."""
    FR = block_cases.FRAME // BLK * BLK
    rows, lengths = match_edges._frames([block_cases.INPUTS[name][:FR]], FR)
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    args = [torch.from_numpy(x).to(card) for x in (fk.make_consts(), meta, words)]
    got = mk.match(*args, BLK=BLK, SBd=BLK // 4, n_frames=1)
    want = mk.match_plain(*(a.cpu() for a in args), BLK, BLK // 4)
    assert len(got) == (5 if mk.wide_rows(BLK) else 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    if name == "long_run" and BLK == 128 << 10:
        assert int(want[4].max()) > 1 << 16


@pytest.mark.parametrize("BLK", (16 << 10, 32 << 10, 64 << 10))
def test_match_kernel_instance_follows_the_ml_row(card, BLK):
    """The launcher takes the WIDE instance exactly when the caller passes
    an ``ml`` row (``wide_rows`` is the only rule): at 16 and 32 KiB the
    WIDE instance's ll and ml, packed again, equal the packed wrapper's
    rows; above 32 KiB the packed instance, which stages whole blocks, is
    refused."""
    from zeekstd_tpu_torch.ops._launch import I, L, P, ptr, stream

    FR = block_cases.FRAME // BLK * BLK
    rows, lengths = match_edges._frames([block_cases.INPUTS["long_run"][:FR]], FR)
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    cst, meta_d, words_d = (torch.from_numpy(x).to(card)
                            for x in (fk.make_consts(), meta, words))
    nrecp, SBd = meta.shape[0], BLK // 4
    lm, ml, ofv, stat = (torch.zeros((nrecp, n), dtype=torch.int32, device=card)
                         for n in (SBd, SBd, SBd, 512))
    litw = torch.zeros((nrecp, BLK // 4), dtype=torch.int32, device=card)
    fn = mk.kernel_fn("zk_match_launch", [P, P, P, L, I, I, I, I, P, P, P, P, P, P])
    head = (ptr(cst), ptr(meta_d), ptr(words_d), words_d.numel(), nrecp, 1, BLK, SBd, ptr(lm))
    tail = (ptr(ofv), ptr(litw), ptr(stat), stream())
    if mk.wide_rows(BLK):
        assert fn(*head, None, *tail) != 0
        return
    assert fn(*head, ptr(ml), *tail) == 0
    want = mk.match(cst, meta_d, words_d, BLK=BLK, SBd=SBd, n_frames=1)
    for g, w in zip(((lm << 16) | ml, ofv, litw, stat), want):
        torch.testing.assert_close(g.cpu(), w.cpu(), rtol=0, atol=0)


@pytest.mark.parametrize("BLK", (64 << 10, 128 << 10))
def test_match_kernel_equals_plain_on_collisions_at_wide_blocks(card, BLK):
    """The 2 MiB slot-collision edge input in 128 KiB blocks (its frame
    rows are multiples of them): the WIDE instance's windows cross over
    lazy probes and interior inserts sharing slots."""
    rows, lengths, _BLK, _SBd = match_edges.edge_case("collide", 2 << 20)
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    args = [torch.from_numpy(x).to(card) for x in (fk.make_consts(), meta, words)]
    got = mk.match(*args, BLK=BLK, SBd=BLK // 4, n_frames=rows.shape[0])
    want = mk.match_plain(*(a.cpu() for a in args), BLK, BLK // 4)
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)


@pytest.mark.parametrize("BLK", block_cases.BLOCKS)
def test_card_archives_equal_cpu_archives_at_block_sizes(card, BLK, monkeypatch):
    """Archives of the block cases at levels 1 and 3 with the archive block
    size patched (``archive.BLOCK_SIZE``, what ``ZEEKSTD_TPU_BLOCK`` sets at
    import): the card's equals the CPU port's, the FSE kernel's wide
    instance launched above 32 KiB, and every route decodes it on the
    card."""
    monkeypatch.setattr(archive_mod, "BLOCK_SIZE", BLK)
    for name, data in block_cases.INPUTS.items():
        for level in block_cases.LEVELS:
            seen = []
            fse_encode = fk.fse_encode

            def record(*a, **k):
                seen.append(k.get("ml") is not None)
                return fse_encode(*a, **k)

            monkeypatch.setattr(fk, "fse_encode", record)
            blob, st = zt.compress_archive(data, frame_size=block_cases.FRAME, level=level,
                                           device=card)
            monkeypatch.setattr(fk, "fse_encode", fse_encode)
            want, _ = zt.compress_archive(data, frame_size=block_cases.FRAME, level=level,
                                          device="cpu")
            assert blob == want, (name, level)
            assert seen == [mk.wide_rows(BLK)], (name, level)
            for env in ({}, {"ZEEKSTD_TPU_RING": "0"}, {"ZEEKSTD_TPU_EXEC": "serial"},
                        {"ZEEKSTD_TPU_EXEC": "doubling"}):
                for var in ("ZEEKSTD_TPU_RING", "ZEEKSTD_TPU_EXEC"):
                    monkeypatch.delenv(var, raising=False)
                for var, val in env.items():
                    monkeypatch.setenv(var, val)
                assert zt.decompress_archive(blob, st, device=card) == data, (name, level, env)


# --- the reference's route switches (ZEEKSTD_TPU_MATCH, ZEEKSTD_TPU_TIMING) ---


@pytest.mark.parametrize("frame", [64 << 10, 256 << 10])
def test_card_match_xla_archive_equals_cpu(card, frame, monkeypatch):
    """``ZEEKSTD_TPU_MATCH=xla`` at level 1: the 256 KiB mixed input's
    archive on the card (the parallel parse) equals the CPU port's, with no
    match launch and both reachability kernels launched, and decodes."""
    monkeypatch.setenv("ZEEKSTD_TPU_MATCH", "xla")
    data = block_cases.mixed_input(256 << 10)
    before = dict(ops.launches)
    blob, st = zt.compress_archive(data, frame_size=frame, level=1, checksum=True, device=card)
    after = dict(ops.launches)
    want, want_st = zt.compress_archive(data, frame_size=frame, level=1, checksum=True,
                                        device="cpu")
    assert blob == want and st.to_bytes() == want_st.to_bytes()
    assert after["match"] == before["match"]
    assert after["reach_tables"] > before["reach_tables"]
    assert after["reach_mark"] > before["reach_mark"]
    assert zt.decompress_archive(blob, st, device=card) == data


@pytest.mark.parametrize("n,block", [(1 << 20, 32 << 10), (256 << 10, 128 << 10)],
                         ids=["1m-32k", "256k-128k"])
def test_card_anchor_pass_doubling_equals_chunked(card, n, block):
    """``greedy_reachability`` on the card: pointer doubling (no
    ``step_max``, the branch untiled shapes take) gives the chunked
    kernels' anchors, and launches no reachability kernel."""
    rng = np.random.default_rng(n + block)
    step = np.minimum(rng.integers(1, mt.SMAX + 1, (3, n)),
                      (block - np.arange(n) % block)[None, :]).astype(np.int32)
    step = torch.from_numpy(step).to(card)
    chunked = mt.greedy_reachability(step, n, block, step_max=mt.SMAX)
    before = dict(ops.launches)
    doubling = mt.greedy_reachability(step, n, block)
    assert torch.equal(doubling, chunked)
    assert ops.launches["reach_tables"] == before["reach_tables"]
    assert ops.launches["reach_mark"] == before["reach_mark"]


# The encode phases of the reference's tpu_compress_archive
# (zeekstd_tpu/tpu_archive.py); the port merges enc.huf_dispatch into
# enc.fse_dispatch.
REF_ENC_PHASES = {"enc.input_stage", "enc.parse_dispatch", "enc.stats_pull",
                  "enc.host_decisions", "enc.fse_dispatch", "enc.huf_dispatch",
                  "enc.bits_pull", "enc.plan_layout", "enc.assemble_dispatch",
                  "enc.blob_pull"}

TIMING_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
from zeekstd_tpu_torch import archive, device
from tests.block_cases import word_text
modes = [device._TIMING, device._FENCE]
data = word_text(1 << 20)
blob, st = archive.compress_archive(data, frame_size=1 << 20, level=1, device="cuda")
enc = sorted(device.phase_records)
assert archive.decompress_archive(blob, st, device="cuda") == data
print(json.dumps(dict(modes=modes, enc=enc)))
"""


def test_card_timing_child_records_reference_phases(card):
    """A child with ``ZEEKSTD_TPU_TIMING=2`` (read at import, no
    ``set_timing`` call) times the card's encode in the reference's phase
    names and writes ``[timing]`` lines."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", TIMING_CHILD.format(root=root)], cwd=root,
                          env=dict(os.environ, ZEEKSTD_TPU_TIMING="2"), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["modes"] == [True, True]
    assert {"enc.parse_dispatch", "enc.host_decisions", "enc.fse_dispatch"} <= set(got["enc"])
    assert set(got["enc"]) <= REF_ENC_PHASES
    assert any(ln.startswith("[timing] enc.parse_dispatch") for ln in proc.stderr.splitlines())
