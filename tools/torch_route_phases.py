#!/usr/bin/env python3
"""The serial and doubling routes' fenced decode phases, per 10 MiB.

    python3 tools/torch_route_phases.py [--root DIR] [--runs N]

Needs one CUDA card. Imports ``zeekstd_tpu_torch`` and ``chip_smoke``
from DIR (default: this checkout), so that two trees, a change and its
parent unpacked with ``git archive``, can be compared in turns within one
call. Compresses chip_smoke.py's 10 MiB text at level 3 (1 MiB frames,
input staged on the card), decodes it once per route to warm up, then N
times per route with every phase fenced (``set_timing(2)``, output left
on the card), and prints each phase's median and range in seconds, with
the card's name and power limit.
"""

import argparse
import os
import statistics
import subprocess
import sys

import torch


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_route_phases: no CUDA device is available", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    import zeekstd_tpu_torch as zt

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    mib = 1 << 20
    data = chip_smoke.build_corpus(10 * mib)
    staged = zt.StagedInput(data, mib, device=dev)
    blob, st = zt.compress_archive(staged, frame_size=mib, level=3)
    for mode in ("serial", "doubling"):
        with chip_smoke.exec_route(mode):
            zt.decompress_archive(blob, st, return_device=True, device=dev)
            runs = []
            zt.set_timing(2)
            for _ in range(args.runs):
                zt.phase_records.clear()
                zt.decompress_archive(blob, st, return_device=True, device=dev)
                runs.append(dict(zt.phase_records))
            zt.set_timing(0)
        names = sorted(runs[0], key=lambda k: -statistics.median(r[k] for r in runs))
        print(f"[route phases] {root} {mode} route, {args.runs} fenced runs ({smi}): " + ", ".join(
            f"{k} {statistics.median(r[k] for r in runs):.6f} "
            f"[{min(r[k] for r in runs):.6f}-{max(r[k] for r in runs):.6f}]" for k in names),
            flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
