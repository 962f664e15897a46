"""The ``seek`` mix on ``enwiki-l3-512k``: the page layout and the list of
reads are the same for every run seed and every round does the same work;
the readers of the Decoder's range and counters on known samples; the cell
correct on the CPU and not correct with the Decoder broken underneath it;
on the card, the configuration's control."""

import importlib
import sys
import types

import numpy as np
import pytest

from portbench import driver, manifest
from portbench.kinds import seek
from portbench.trace import Trace

from .helpers import cell_parts, execute, planted

CELL = "enwiki-l3-512k.seek"
XML = importlib.import_module("portbench.data.enwiki_xml_like")
DEC = ("dec.read_bytes", "dec.frame_visits", "dec.frame_hits", "dec.frame_load_bytes")


def test_pages_and_reads_are_the_same_for_every_seed():
    size = 400_000
    offs, lens = XML.layout(size)
    assert np.array_equal(offs, XML.layout(size)[0]) and np.array_equal(lens, XML.layout(size)[1])
    a, b = XML.generate(size, 2**31 + 1), XML.generate(size, 2**33 + 7)
    assert a != b and len(a) == len(b) == size
    for data in (a, b):
        assert data.startswith(XML.HEAD) and data.endswith(XML.FOOT)
        for off, n in zip(offs.tolist(), lens.tolist()):
            assert data[off:off + 9] == b"  <page>\n" and data[off + n - 10:off + n] == b"  </page>\n"
    assert offs[0] == len(XML.HEAD) and offs[-1] + lens[-1] == size - len(XML.FOOT)
    # A larger archive keeps the smaller one's pages (all but the last, cut to fit).
    big_offs, big_lens = XML.layout(4 * size)
    assert np.array_equal(big_lens[:len(lens) - 1], lens[:-1])
    _cell, _cfg, mix = cell_parts(CELL)
    assert seek.queries(mix, len(offs)) == seek.queries(dict(mix), len(offs))
    assert len(seek.queries(mix, len(offs))) == mix["reads_per_round"] == 256


def test_page_lengths_follow_the_stated_model():
    _cell, cfg, _mix = cell_parts(CELL, tiny=False)
    offs, lens = XML.layout(cfg["data"]["bytes"])
    assert 13_000 < len(lens) < 16_000
    assert 4_300 < lens.mean() < 5_100
    assert lens.max() <= XML.PAGE_MAX
    assert 0.40 < np.mean(lens <= XML.REDIRECT_MAX) < 0.50


def _round_counts(seed, reads):
    """The ``dec.*`` counters of the warm round and of the round after it."""
    import zeekstd_tpu_torch as zt

    _cell, cfg, mix = cell_parts(CELL)
    mix = dict(mix, reads_per_round=reads)
    data = manifest.generator(cfg["data"]["generator"])(cfg["data"]["bytes"], seed)
    loop = driver.make(zt, cfg, mix, data, seed, "cpu", driver.Recorder())
    zt.device.reset_counters()
    loop.warm()
    warm = [zt.device.counters[k] for k in DEC]
    loop.round()
    both = [zt.device.counters[k] for k in DEC]
    assert loop.tally["bad_bytes"] == 0
    return warm, [y - x for x, y in zip(warm, both)]


def test_every_round_and_every_seed_does_the_same_work():
    warm, later = _round_counts(2**31 + 3, 64)
    assert warm == later
    assert _round_counts(2**40 + 5, 64) == (warm, later)
    read_bytes, visits, hits, loads = warm
    assert read_bytes > 0 and visits >= 64 and loads > read_bytes


def test_reads_are_turned_to_start_in_a_frame_the_last_read_left():
    reads = [(10, 5), (70_000, 10), (65_536, 100), (20, 5)]
    got = seek.turned(reads, 65_536)
    assert got == reads[1:] + reads[:1]
    assert seek.turned([(0, 1), (5, 1)], 65_536) == [(0, 1), (5, 1)]


def _fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for byte in data:
        h = ((h ^ byte) * 0x100000001B3) % 2**64
    return h


def test_the_scrambled_zipfian_of_ycsb():
    assert _fnv1a64(b"a") == 0xAF63DC4C8601EC8C  # the FNV-1a test vector
    for v in (0, 1, 12345, 10**10):
        h = _fnv1a64(v.to_bytes(8, "little"))
        assert seek.fnv64(v) == abs(h - 2**64 if h >= 2**63 else h)
    ranks = np.array(seek.zipf_ranks(np.random.default_rng(3), 200_000, 0.99))
    # P(0) = 1 / zeta(n, 0.99), P(1) = 0.5**0.99 / zeta(n, 0.99).
    assert np.mean(ranks == 0) == pytest.approx(1 / seek.ZETAN, rel=0.05)
    assert np.mean(ranks == 1) == pytest.approx(0.5**0.99 / seek.ZETAN, rel=0.07)
    assert ranks.max() < seek.ITEMS
    with pytest.raises(ValueError):
        seek.zipf_ranks(np.random.default_rng(3), 4, 0.9)


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _ctx(events):
    call = driver.Call("decode", 100)
    call.seconds, call.out_bytes = 0.01, 100
    return types.SimpleNamespace(calls=[call], setup_s=1.0, trace=Trace(events), traced=[call],
                                 phases=[], device_kind="NVIDIA H100 80GB HBM3")


def test_readers_on_known_samples(monkeypatch):
    window = [_x("user_annotation", "portbench.window", 0, 1000),
              _x("user_annotation", "portbench.decode", 100, 300),
              _x("user_annotation", "portbench.decode", 500, 300)]
    reads = [_x("cpu_op", "zk.dec.read", 110, 250), _x("cpu_op", "zk.dec.frame_load", 120, 200),
             _x("cpu_op", "zk.dec.read", 510, 50)]
    assert manifest.reader("dec_read_ms")(_ctx(window + reads)) == pytest.approx(0.150)
    assert manifest.reader("dec_read_ms")(_ctx(window)) is None
    dev = types.ModuleType("zeekstd_tpu_torch.device")
    dev.counters = {"dec.read_bytes": 4000, "dec.frame_visits": 40, "dec.frame_hits": 3,
                    "dec.frame_load_bytes": 37 * 65536}
    monkeypatch.setitem(sys.modules, "zeekstd_tpu_torch.device", dev)
    ctx = _ctx(window)
    assert manifest.reader("dec_read_amp_x")(ctx) == pytest.approx(37 * 65536 / 4000)
    assert manifest.reader("dec_frame_hit_pct")(ctx) == pytest.approx(7.5)
    dev.counters = {"dec.read_bytes": 0, "dec.frame_visits": 0, "dec.frame_hits": 0,
                    "dec.frame_load_bytes": 0}
    assert manifest.reader("dec_read_amp_x")(ctx) is None
    assert manifest.reader("dec_frame_hit_pct")(ctx) is None
    # A program without the counters (the parent of these readers): nothing.
    dev.counters = {"plan.copied_bytes": 5, "plan.planned_bytes": 5}
    assert manifest.reader("dec_read_amp_x")(ctx) is None
    assert manifest.reader("dec_frame_hit_pct")(ctx) is None


@pytest.mark.parametrize("trace,names", [
    (False, ("decode_MiBps", "setup_s")),
    (True, ("dec_read_amp_x", "dec_frame_hit_pct", "dec_plan_ms.decode", "dec_exec_ms",
            "dec_plan_copy_x"))],
    ids=["window", "traced"])
def test_the_cell_runs_correct_on_the_cpu(trace, names):
    line = execute(CELL, seed=2**31 + 9, seconds=0.2, trace=trace, reads_per_round=32)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert set(names) <= set(line["metrics"]), line["metrics"]
    assert all(line["metrics"][n]["value"] > 0 for n in names if n != "dec_frame_hit_pct")


@pytest.mark.parametrize("fault", ["stale_frame", "flip_frame"])
def test_a_broken_decoder_makes_the_cell_incorrect(monkeypatch, fault):
    with planted(monkeypatch, fault):
        line = execute(CELL, seed=3, seconds=0.1, reads_per_round=64)
    assert not line["correct"], line["checks"]
    assert line["checks"]["bad_bytes"]["value"] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("seed", [4_000_000_021, 4_000_000_022, 4_000_000_023])
def test_stale_frame_control_is_not_correct_on_the_card(card, monkeypatch, seed):
    with planted(monkeypatch, "stale_frame"):
        line = execute(CELL, seed=seed, seconds=2.0, tiny=False, device=None)
    print(CELL, seed, {k: c["value"] for k, c in line["checks"].items()})
    assert not line["correct"], line["checks"]
