"""One run of one cell: set-up, the measured window, the traced stretches,
the comparison with the plain reference, and the result line.

The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``; ``launches`` and, last, ``checks``). Each number compared is
also printed on standard error, beside its limit, as the last lines there.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import os
import sys
import time
import traceback
import types

from . import driver, manifest

FORBIDDEN = ("jax", "jaxlib", "flax", "zeekstd_tpu")


def process_start(fallback: float) -> float:
    """The process's start on the ``perf_counter`` clock (10 ms ticks), or
    ``fallback`` where ``/proc`` cannot say."""
    try:
        with open("/proc/self/stat") as fh:
            ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return fallback
    now = time.perf_counter()
    return now - age if 0.0 <= age < now - fallback + 60.0 else fallback


def route_env(cfg: dict) -> None:
    """Only the configuration's ``ZEEKSTD_*`` variables reach the program."""
    for k in [k for k in os.environ if k.startswith("ZEEKSTD_")]:
        del os.environ[k]
    os.environ.update({k: str(v) for k, v in cfg["env"].items()})


def forbidden_modules() -> list[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_libraries(zt) -> None:
    """Build or load the program's two libraries where it says how, so that
    set-up can be split; otherwise the warm round loads them."""
    build = getattr(zt, "_build", None)
    if hasattr(build, "kernel_library"):
        build.kernel_library()
    native = getattr(zt, "native", None)
    loader = getattr(native, "loader", None)
    if hasattr(loader, "available"):
        loader.available()


def execute(bench, cell, cfg, mix, zt, seed: int, seconds: float, trace: bool,
            device=None, t_start: float | None = None, marks: list | None = None) -> dict:
    """Run the cell on ``device`` (``None``: the card) and return the result
    line as a dict. The port is passed in as ``zt``; ``marks`` collects
    (stage, clock) pairs of set-up."""
    import torch

    from .reference.judge import judge_archive

    on_card = device is None
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", t_start)] if marks is None else marks

    def mark(stage):
        marks.append((stage, time.perf_counter()))

    data = manifest.generator(cfg["data"]["generator"])(cfg["data"]["bytes"], seed)
    mark("data")
    if on_card:
        load_libraries(zt)
        mark("libraries")
    rec = driver.Recorder()
    loop = driver.make(zt, cfg, mix, data, seed, device, rec)
    mark("program set-up")
    counts = {"attempted": 0, "failed": 0}

    def run_round(step):
        counts["attempted"] += 1
        try:
            step()
        except Exception:  # a failed call counts against correct; the run goes on
            counts["failed"] += 1
            if counts["failed"] <= 3:
                traceback.print_exc()

    run_round(loop.warm)
    if on_card:
        torch.cuda.synchronize()
    mark("warm round")

    zt.ops.reset_launches()
    rec.calls = []
    setup_s = time.perf_counter() - t_start
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        run_round(loop.round)
    window = rec.calls
    launches = {k: v for k, v in zt.ops.launches.items() if v}

    tr, traced, fenced = None, [], []
    if trace:
        from . import trace as trace_mod

        if on_card:
            def traced_rounds():
                rec.calls = []
                for _ in range(mix["trace_rounds"]):
                    run_round(loop.round)

            rec.profiling = True
            try:
                # The profiler's first round sets up its tracer, outside the window.
                tr = trace_mod.profile(traced_rounds, lambda: run_round(loop.round))
            finally:
                rec.profiling = False
            traced = rec.calls
        rec.calls, rec.phases = [], zt.device.phase_records
        zt.device.set_timing(2)
        try:
            with contextlib.redirect_stderr(io.StringIO()):
                for _ in range(mix["phase_rounds"]):
                    run_round(loop.round)
        finally:
            zt.device.set_timing(0)
            rec.phases = None
        fenced = rec.calls

    peak = torch.cuda.max_memory_allocated() if on_card else 0
    archives, tally = loop.archives, loop.tally
    loop.close()
    del loop, rec
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    judged = [judge_archive(a, data, cfg["frame_size"], cfg["checksum"]) for a in archives]
    checks = {
        "failed_rounds": [counts["failed"], 0],
        "bad_bytes": [tally["bad_bytes"], 0],
        "ref_bad_frames": [sum(j["ref_bad_frames"] for j in judged), 0],
        "table_faults": [sum(j["table_faults"] for j in judged), 0],
        "size_variants": [max(len({len(a) for a in archives}) - 1, 0), 0],
    }
    correct = all(v <= lim for v, lim in checks.values())

    dev_info = {"platform": "gpu" if on_card else "cpu",
                "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
                "count": cell["chips"], "memory_peak_bytes": peak}
    if tr is not None:
        dev_info["busy_s"] = tr.busy_s
        dev_info["window_s"] = tr.window_s
    ctx = types.SimpleNamespace(calls=window, setup_s=setup_s, trace=tr, traced=traced,
                                phases=fenced, device_kind=dev_info["kind"])
    metrics = {}
    for m in manifest.metrics_for(bench, cell["name"], trace):
        value = manifest.reader(m["name"])(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": counts["attempted"], "failed": counts["failed"],
            "metrics": metrics, "device": dev_info}
    if tr is not None:
        line["breakdown"] = tr.breakdown()
    line["launches"] = launches
    line["setup_split_s"] = {b[0]: b[1] - a[1] for a, b in zip(marks, marks[1:])}
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return line


def main(t0: float, argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    t_start = process_start(t0)
    try:
        bench = manifest.load()
        cell = manifest.cell(bench, args.workload)
        cfg = manifest.config(bench, cell["config"])
        mix = manifest.mix(cell["traffic"])
    except (OSError, KeyError, ValueError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    route_env(cfg)
    # The driver's JIT cache, if the card ever needs it, stays in the checkout.
    os.environ["CUDA_CACHE_PATH"] = os.path.join(manifest.ROOT, "build", "portbench", "cuda-cache")
    marks = [("start", t_start)]

    import torch

    marks.append(("torch import", time.perf_counter()))

    if not torch.cuda.is_available():
        print("portbench: no CUDA device is available; the benchmark runs on the card only",
              file=sys.stderr)
        return 1
    if torch.cuda.device_count() < cell["chips"]:
        print(f"portbench: {cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 1
    torch.empty(1, device="cuda")
    marks.append(("cuda context", time.perf_counter()))
    try:
        import zeekstd_tpu_torch as zt
        import zeekstd_tpu_torch.ops  # noqa: F401  (launch counters)
    except ImportError as e:
        print(f"portbench: the program does not import: {e}", file=sys.stderr)
        return 1
    marks.append(("program import", time.perf_counter()))

    line = execute(bench, cell, cfg, mix, zt, args.seed, args.seconds, bool(args.trace),
                   t_start=t_start, marks=marks)
    found = forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 1
    print(f"launches: {json.dumps(line['launches'], sort_keys=True)}", file=sys.stderr)
    print("setup split: " + ", ".join(f"{k} {v:.3f} s" for k, v in line["setup_split_s"].items()),
          file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
