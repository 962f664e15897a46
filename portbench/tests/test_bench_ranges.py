"""The program's ranges (``zk.<name>``) and counters as the benchmark reads
them (``portbench/ranges.py`` and the readers built on it): over synthetic
traces, and over a CPU profile of one round of a cell."""

import json
import os
import sys
import tempfile
import types

import pytest

from portbench import driver, manifest, ranges
from portbench.trace import Trace

from .helpers import cell_parts

OLD_READERS = ["setup_s", "encode_MiBps", "decode_MiBps", "stored_pct", "enc_host_ms",
               "enc_parse_ms", "dec_plan_ms.decode", "dec_exec_ms", "device_idle_pct.encode",
               "device_idle_pct.decode", "encode_kernels_roofline", "decode_kernels_roofline"]


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _base():
    """A window with one encode call (100-500) and one decode call (500-900)."""
    return [_x("user_annotation", "portbench.window", 0, 1000),
            _x("user_annotation", "portbench.encode", 100, 400),
            _x("user_annotation", "portbench.decode", 500, 400),
            _x("kernel", "k1", 120, 30),
            _x("kernel", "k2", 460, 30),
            _x("gpu_memcpy", "Memcpy DtoH", 850, 40),
            _x("cpu_op", "aten::to", 840, 55)]


def _zk():
    """The program's ranges inside those calls, as the port records them
    (host operations), and a device-side copy of one that the profiler
    adds for a user annotation."""
    return [_x("cpu_op", "zk.enc.parse_dispatch", 110, 50),
            _x("cpu_op", "zk.enc.host_decisions", 160, 290),
            _x("cpu_op", "zk.enc.host_decisions.blocks", 165, 10),
            _x("cpu_op", "zk.enc.host_decisions.huf", 180, 200),
            _x("cpu_op", "zk.enc.host_decisions.fse_tables", 390, 50),
            _x("cpu_op", "zk.enc.fse_dispatch", 450, 45),
            _x("cpu_op", "zk.dec.plan", 510, 300),
            _x("cpu_op", "zk.dec.fused_exec", 815, 80),
            _x("gpu_user_annotation", "zk.dec.plan", 510, 300)]


def _ctx(events, **kw):
    calls = []
    for kind, secs, n_in, n_out in (("encode", 0.5, 2**20, 2**18), ("decode", 0.25, 2**18, 2**20)):
        c = driver.Call(kind, n_in)
        c.seconds, c.out_bytes = secs, n_out
        calls.append(c)
    phases = []
    for kind, ph in (("encode", {"enc.host_decisions": 0.2, "enc.parse_dispatch": 0.1}),
                     ("decode", {"dec.plan": 0.003, "dec.fused_exec": 0.001})):
        c = driver.Call(kind, 1)
        c.phases = ph
        phases.append(c)
    base = dict(calls=calls, setup_s=7.5, trace=Trace(events), traced=calls, phases=phases,
                device_kind="NVIDIA H100 80GB HBM3")
    return types.SimpleNamespace(**dict(base, **kw))


def test_own_time_leaves_out_the_ranges_inside():
    rs = ranges._ranges(Trace(_base() + _zk()))
    own = {n: ranges.own_us(rs, i) for i, (_a, _b, n) in enumerate(rs)}
    assert own["enc.host_decisions"] == 290 - 10 - 200 - 50
    assert own["enc.host_decisions.huf"] == 200
    assert own["dec.plan"] == 300
    # A child that starts with its parent is still the parent's child.
    rs = ranges._ranges(Trace(_base() + [_x("cpu_op", "zk.a.b", 200, 20),
                                         _x("cpu_op", "zk.a", 200, 100)]))
    assert [n for _a, _b, n in rs] == ["a", "a.b"]
    assert ranges.own_us(rs, 0) == 80


def test_range_readers_per_call():
    ctx = _ctx(_base() + _zk())
    assert manifest.reader("enc_huf_host_ms")(ctx) == pytest.approx(0.200)
    assert manifest.reader("enc_fse_tables_ms")(ctx) == pytest.approx(0.050)
    assert ranges.range_ms(ctx, "encode", "enc.host_decisions") == pytest.approx(0.290)
    assert ranges.range_ms(ctx, "encode", "enc.host_decisions", own=True) == pytest.approx(0.030)
    assert ranges.range_ms(ctx, "decode", "dec.plan") == pytest.approx(0.300)
    # Two decode calls, the range in one of them: per call of the kind.
    two = _base() + _zk() + [_x("user_annotation", "portbench.decode", 920, 50)]
    assert ranges.range_ms(_ctx(two), "decode", "dec.plan") == pytest.approx(0.150)
    # No range of that name, no range at all, no trace: nothing to read.
    assert manifest.reader("dec_frame_load_ms")(ctx) is None
    assert manifest.reader("enc_huf_host_ms")(_ctx(_base())) is None
    assert manifest.reader("enc_huf_host_ms")(_ctx(_base(), trace=None)) is None


def test_frame_loads_summed_per_decode_call():
    loads = [_x("cpu_op", "zk.dec.frame_load", t, 60) for t in (510, 600, 700)]
    inner = [_x("cpu_op", "zk.dec.plan", t + 5, 20) for t in (510, 600, 700)]
    ctx = _ctx(_base() + loads + inner)
    assert manifest.reader("dec_frame_load_ms")(ctx) == pytest.approx(0.180)


def test_gaps_named_by_the_programs_range():
    gaps = Trace(_base() + _zk()).gaps()
    # The decode call's gap (500-850) lies in zk.dec.plan (510-810) for
    # most of it, the encode call's (150-460) in zk.enc.host_decisions.
    assert gaps[0] == ["decode: zk.dec.plan", pytest.approx(350e-6)]
    assert gaps[1] == ["encode: zk.enc.host_decisions", pytest.approx(310e-6)]
    # Without the program's ranges, as before.
    old = Trace(_base()).gaps()
    assert [g[0] for g in old[:2]] == ["decode: host code outside torch ops",
                                       "encode: host code outside torch ops"]
    assert [g[1] for g in old] == [g[1] for g in gaps]


def test_gpu_user_annotation_is_not_device_time_nor_a_range():
    with_copy = Trace(_base() + _zk())
    without = Trace(_base() + _zk()[:-1])
    assert with_copy.busy_s == without.busy_s
    assert with_copy.device == without.device
    assert ranges._ranges(with_copy) == ranges._ranges(without)
    # The user annotation a record_function would leave is not read either.
    ua = Trace(_base() + [_x("user_annotation", "zk.dec.plan", 510, 300)])
    assert ranges._ranges(ua) == []


@pytest.mark.parametrize("name", OLD_READERS)
def test_existing_readers_read_the_same_with_ranges(name):
    read = manifest.reader(name)
    assert read(_ctx(_base() + _zk())) == read(_ctx(_base()))
    assert read(_ctx(_base())) is not None or name == "dec_exec_ms"


def test_plan_copy_ratio_from_known_counters(monkeypatch):
    dev = types.ModuleType("zeekstd_tpu_torch.device")
    dev.counters = {"plan.copied_bytes": 3 * 8_000_000 + 500, "plan.planned_bytes": 1000}
    monkeypatch.setitem(sys.modules, "zeekstd_tpu_torch.device", dev)
    read = manifest.reader("dec_plan_copy_x")
    ctx = _ctx(_base())
    assert read(ctx) == pytest.approx(24000.5)
    dev.counters["plan.planned_bytes"] = 0
    assert read(ctx) is None
    dev.counters["plan.planned_bytes"] = 1000
    ctx.calls = [c for c in ctx.calls if c.kind == "encode"]
    assert read(ctx) is None
    # A program without the counters (the parent of this reader): nothing.
    monkeypatch.setitem(sys.modules, "zeekstd_tpu_torch.device", types.ModuleType("x"))
    assert read(_ctx(_base())) is None
    monkeypatch.delitem(sys.modules, "zeekstd_tpu_torch.device")
    assert read(_ctx(_base())) is None


def _cpu_profile(name):
    """One round of the cell, cut to the tests' size, under the profiler on
    the CPU with the harness's ranges, read back as the harness reads it."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    import zeekstd_tpu_torch as zt

    _cell, cfg, mix = cell_parts(name)
    data = manifest.generator(cfg["data"]["generator"])(cfg["data"]["bytes"], 11)
    rec = driver.Recorder()
    loop = driver.make(zt, cfg, mix, data, 11, "cpu", rec)
    loop.warm()
    rec.calls, rec.profiling = [], True
    with torch.profiler.profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("portbench.window"):
            loop.round()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
    finally:
        os.remove(path)
    assert loop.tally["bad_bytes"] == 0
    return _ctx(events, calls=rec.calls, traced=rec.calls, phases=[])


@pytest.mark.parametrize("name", ["loghub-hdfs-l3-2m.stream"])
def test_readers_find_the_programs_ranges_in_a_cpu_profile(name):
    ctx = _cpu_profile(name)
    got = {m: manifest.reader(m)(ctx) for m in
           ("enc_huf_host_ms", "enc_fse_tables_ms", "dec_frame_load_ms", "dec_plan_copy_x")}
    assert all(v is not None and v > 0 for v in got.values()), got
    # The frame loads hold the decode's plans, Huffman and layout phases.
    assert got["dec_frame_load_ms"] >= ranges.range_ms(ctx, "decode", "dec.plan")
    assert got["dec_plan_copy_x"] >= 1
