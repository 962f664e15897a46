"""Each mix's loop and each metric reader, on the CPU with the kernels'
plain versions, on inputs of 150,000 bytes in 64 KiB frames."""

import types

import pytest

from portbench import driver, manifest
from portbench.trace import Trace

from .helpers import BENCH, CELLS, execute


@pytest.mark.parametrize("trace", [False, True], ids=["window", "traced"])
@pytest.mark.parametrize("name", CELLS)
def test_each_cell_runs_correct_on_the_cpu(name, trace):
    line = execute(name, seed=2**31 + 9, seconds=0.3, trace=trace)
    assert line["correct"], line["checks"]
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert list(line)[-1] == "checks"
    assert line["device"]["platform"] == "cpu"
    want = {m["name"] for m in manifest.metrics_for(BENCH, name, trace)
            if m["source"] != "device_trace"}
    assert want <= set(line["metrics"]), (want, line["metrics"])


def _call(kind, seconds, n_in, n_out, phases=None):
    c = driver.Call(kind, n_in)
    c.seconds, c.out_bytes, c.phases = seconds, n_out, phases
    return c


def _trace():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 1000},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.encode", "ts": 100, "dur": 400},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.decode", "ts": 500, "dur": 200},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 150, "dur": 100},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 200, "dur": 100},
          {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 600, "dur": 50},
          {"ph": "X", "cat": "cpu_op", "name": "aten::to", "ts": 300, "dur": 190},
          {"ph": "X", "cat": "kernel", "name": "outside", "ts": 2000, "dur": 100}]
    return Trace(ev)


def test_trace_reads_busy_idle_and_gaps():
    tr = _trace()
    assert tr.window_s == pytest.approx(1e-3)
    assert tr.busy_s == pytest.approx(200e-6)
    assert tr.kind("encode") == pytest.approx((400e-6, 150e-6, 1))
    assert tr.kind("decode") == pytest.approx((200e-6, 50e-6, 1))
    gaps = tr.gaps()
    assert gaps[0] == ["encode: aten::to", pytest.approx(200e-6)]
    assert gaps[1][0] == "decode: host code outside torch ops"
    assert tr.breakdown()["device_ops"][0] == ["k1", pytest.approx(100e-6)]


def test_readers_on_known_samples():
    calls = [_call("encode", 0.5, 2**20, 2**18), _call("encode", 1.5, 2**20, 2**18),
             _call("decode", 0.25, 2**18, 2**20)]
    phases = [_call("encode", 0, 1, 1, {"enc.host_decisions": 0.2, "enc.parse_dispatch": 0.1}),
              _call("encode", 0, 1, 1, {"enc.host_decisions": 0.4}),
              _call("decode", 0, 1, 1, {}), _call("decode", 0, 1, 1, {"dec.plan": 0.003})]
    ctx = types.SimpleNamespace(calls=calls, setup_s=7.5, trace=_trace(),
                                traced=[_call("encode", 0, 10**6, 2 * 10**6),
                                        _call("decode", 0, 10**6, 3 * 10**6)],
                                phases=phases, device_kind="NVIDIA H100 80GB HBM3")
    r = {m: manifest.reader(m)(ctx) for m in
         ["setup_s", "encode_MiBps", "decode_MiBps", "stored_pct", "enc_host_ms",
          "enc_parse_ms", "dec_plan_ms.decode", "dec_exec_ms", "device_idle_pct.encode",
          "device_idle_pct.decode", "encode_kernels_roofline", "decode_kernels_roofline"]}
    assert r["setup_s"] == 7.5
    assert r["encode_MiBps"] == pytest.approx(1.0)
    assert r["decode_MiBps"] == pytest.approx(4.0)
    assert r["stored_pct"] == pytest.approx(25.0)
    assert r["enc_host_ms"] == pytest.approx(300.0)
    assert r["enc_parse_ms"] == pytest.approx(100.0)
    assert r["dec_plan_ms.decode"] == pytest.approx(3.0)
    assert r["dec_exec_ms"] is None
    assert r["device_idle_pct.encode"] == pytest.approx(62.5)
    assert r["device_idle_pct.decode"] == pytest.approx(75.0)
    assert r["encode_kernels_roofline"] == pytest.approx(100 * 3e6 / 3.35e12 / 150e-6)
    assert r["decode_kernels_roofline"] == pytest.approx(100 * 4e6 / 3.35e12 / 50e-6)
    # No trace, no device metric; an unknown card, no roofline; no calls, no rate.
    ctx.trace = None
    assert manifest.reader("device_idle_pct.encode")(ctx) is None
    ctx.trace, ctx.device_kind = _trace(), "cpu"
    assert manifest.reader("encode_kernels_roofline")(ctx) is None
    ctx.calls = []
    assert manifest.reader("encode_MiBps")(ctx) is None
