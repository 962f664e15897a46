#!/usr/bin/env python3
"""What tracing costs in one benchmark cell, and what the trace names.

    python3 tools/torch_trace_cost.py --workload CELL [--seed N] [--turns T]
        [--rounds R] [--out FILE]

Needs one CUDA card. Runs the cell's loop (``portbench``: its input, its
configuration's variables, its mix) in one process: a warm round, then T
turns of R rounds without the profiler and R rounds under it
(``portbench.trace.profile``, as a ``--trace 1`` run profiles). Prints one
JSON object, also written to FILE: per kind of call, the median seconds of
the plain and of the profiled calls and their ratio; from the last profiled
turn, the program's ranges (``zk.<name>``) by wall and own time per call,
the ten longest idle gaps as the benchmark names them with the ranges that
hold each gap's middle (outermost first), and the program's counters; the
card's name and power limit.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def ranges_per_call(tr, ranges_mod) -> dict:
    """{kind: {name: [wall ms, own ms] per call}} over the profiled calls."""
    rs = ranges_mod._ranges(tr)
    out = {}
    for kind in sorted({k for _a, _b, k in tr.spans}):
        spans = [(a, b) for a, b, k in tr.spans if k == kind]
        acc = {}
        for i, (a, b, name) in enumerate(rs):
            if any(s0 <= a and b <= s1 for s0, s1 in spans):
                w, o = acc.get(name, (0.0, 0.0))
                acc[name] = (w + (b - a), o + ranges_mod.own_us(rs, i))
        out[kind] = {n: [1e-3 * w / len(spans), 1e-3 * o / len(spans)]
                     for n, (w, o) in sorted(acc.items(), key=lambda kv: -kv[1][1])}
    return out


def gaps_with_ranges(tr, ranges_mod, limit=10) -> list:
    """The benchmark's longest idle gaps, each with the ranges holding its
    middle, outermost first."""
    rs = ranges_mod._ranges(tr)
    found = []
    for t0, t1, kind in tr.spans:
        cur = t0
        for a, b in tr.device:
            if b <= t0 or a >= t1:
                continue
            if a > cur:
                found.append((a - cur, cur, a, kind))
            cur = max(cur, b)
        if t1 > cur:
            found.append((t1 - cur, cur, t1, kind))
    found.sort(reverse=True)
    named = tr.gaps(limit)
    out = []
    for (length, g0, g1, _kind), (label, _s) in zip(found[:limit], named):
        mid = 0.5 * (g0 + g1)
        held = [n for a, b, n in rs if a <= mid <= b]
        out.append([label, 1e-6 * length, held])
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 17)
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    args = ap.parse_args()

    from portbench import driver, manifest, ranges, run, trace

    bench = manifest.load()
    cell = manifest.cell(bench, args.workload)
    cfg = manifest.config(bench, cell["config"])
    mix = manifest.mix(cell["traffic"])
    run.route_env(cfg)
    import torch

    if not torch.cuda.is_available():
        print("torch_trace_cost: no CUDA device is available", file=sys.stderr)
        return 2
    import zeekstd_tpu_torch as zt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    run.load_libraries(zt)
    data = manifest.generator(cfg["data"]["generator"])(cfg["data"]["bytes"], args.seed)
    rec = driver.Recorder()
    loop = driver.make(zt, cfg, mix, data, args.seed, None, rec)
    loop.warm()
    torch.cuda.synchronize()

    def rounds():
        rec.calls = []
        for _ in range(args.rounds):
            loop.round()

    plain, profiled, tr = [], [], None
    for _ in range(args.turns):
        rounds()
        plain += rec.calls
        rec.profiling = True
        try:
            tr = trace.profile(rounds, loop.round)
        finally:
            rec.profiling = False
        profiled += rec.calls
    calls = {}
    for kind in sorted({c.kind for c in plain}):
        p = statistics.median(c.seconds for c in plain if c.kind == kind)
        q = statistics.median(c.seconds for c in profiled if c.kind == kind)
        calls[kind] = {"plain_s": p, "profiled_s": q, "ratio": q / p,
                       "n": [sum(c.kind == kind for c in plain),
                             sum(c.kind == kind for c in profiled)]}
    found = ranges.counters()
    line = {"workload": args.workload, "seed": args.seed, "card": smi, "calls": calls,
            "ranges_ms": ranges_per_call(tr, ranges), "gaps": gaps_with_ranges(tr, ranges),
            "counters": dict(found) if found is not None else None,
            "bad_bytes": loop.tally["bad_bytes"]}
    text = json.dumps(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0 if loop.tally["bad_bytes"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
