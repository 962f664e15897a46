#!/usr/bin/env python3
"""The byte histogram and table lookup timed on the card alone.

    python3 tools/torch_byte_kernels.py [--out DIR] [--compare SRC ...]

Needs one CUDA card and nvcc. On chip_smoke.py's 10 MiB text (32 KiB
histogram blocks, a Huffman bit-count table) and on 160 MiB (16 copies
of it), it times the wrappers (``byte_histogram``, ``table_lookup``) on
the device alone: 24 or more calls captured into one CUDA graph with
events around each replay, so that the wrapper's host work runs only at
capture (``chip_smoke.graph_ms``): cold, rotated over copies of the
inputs and outputs whose total exceeds 2.4 times the 50 MB L2 (12 copies
for the histogram at 10 MiB, 4 for the lookup), and warm, one set back
to back. The histogram is also timed on 10 MiB of one byte value (the
skew its counters must survive) and at 1 MiB blocks (10 CTAs). Beside
them: the share of the bound (the bytes ``chip_smoke.moved_bytes``
counts over 3.35 TB/s), the wrapper's time as chip_smoke.py measured it
before device timing (events around 20 wrapper calls), an empty
kernel's time in the same kind of graph (one block, and one block per SM
times 8), the library calls on rotated copies of their precomputed
inputs (``torch.take`` in a graph, ``torch.bincount`` back to back: it
synchronises to size its output), and for the lookup ``fill_`` of as
many outputs alone (the write side). Each ``--compare`` source (another
version of ``zeekstd_tpu_torch/csrc/byte_kernels.cu`` with the same
launchers, for example the parent commit's) is built alone with nvcc
(sm_90a), launched through the same wrappers, held to the kernel's
outputs on every input and timed in turns with it (kernel, others,
others reversed, kernel; the mean of the two). Prints the card's name
and power limit; writes everything to DIR/byte_kernels.json (default
``build/byte_kernels``).
"""

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from zeekstd_tpu_torch import _build, ops  # noqa: E402
from zeekstd_tpu_torch.ops import byte_kernels as bk  # noqa: E402

CSRC = os.path.join(ROOT, "zeekstd_tpu_torch", "csrc")
BLOCK = 1 << 15
MIB = 1 << 20
EMPTY_CU = r"""
#include <cuda_runtime.h>
__global__ void zk_empty_kernel() {}
extern "C" int zk_empty_launch(int grid, int threads, void* stream) {
  zk_empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def build_all(out_dir, compare):
    """The empty kernel's library and one library per compare source, each
    one nvcc started together with the others; the package's kernel
    library as the package builds it."""
    os.makedirs(out_dir, exist_ok=True)
    empty = os.path.join(out_dir, "empty.cu")
    with open(empty, "w") as fh:
        fh.write(EMPTY_CU)
    jobs = [(empty, os.path.join(out_dir, "libempty.so"))]
    jobs += [(src, os.path.join(out_dir, f"libcompare{i}.so")) for i, src in enumerate(compare)]
    procs = [(so, subprocess.Popen([_build.nvcc()] + _build.NVCC_FLAGS
                                   + ["-I", CSRC, "-o", so, src]))
             for src, so in jobs]
    _build.kernel_library()
    for so, proc in procs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {so}")
    return [ctypes.CDLL(so) for _src, so in jobs]


@contextlib.contextmanager
def launching(lib):
    """The byte kernels' wrappers launch ``lib``'s launchers (None: the
    package's kernel library) inside the block."""
    if lib is None:
        yield
        return

    def kernel_fn(name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int
        return fn

    saved = bk.kernel_fn
    bk.kernel_fn = kernel_fn
    try:
        yield
    finally:
        bk.kernel_fn = saved


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "byte_kernels"))
    ap.add_argument("--compare", nargs="*", default=[], help="other versions of the source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_byte_kernels: no CUDA device is available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    empty_lib, *others = build_all(args.out, args.compare)
    versions = [("kernel", None)] + list(zip(args.compare, others))
    dev = torch.device("cuda", 0)
    mods = chip_smoke.kernel_modules()
    text = torch.from_numpy(np.frombuffer(chip_smoke.build_corpus(10 << 20), np.uint8).copy())
    text = text.to(dev)
    table = torch.from_numpy(
        np.random.default_rng(3).integers(1, 12, 256).astype(np.int32)).to(dev)
    inputs = {
        ("byte_histogram", "text", 10): (text,),
        ("byte_histogram", "one byte", 10): (torch.full_like(text, 0x20),),
        ("byte_histogram", "text", 160): (text.repeat(16),),
        ("byte_histogram", "text, 1 MiB blocks", 10): (text,),
        ("table_lookup", "text", 10): (text, table),
        ("table_lookup", "text", 160): (text.repeat(16), table),
    }
    results = {"card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
               "versions": [v for v, _lib in versions], "cases": [], "wrapper_ms": {},
               "library": [], "empty": {}}

    # The empty kernel: the floor of a launch in a graph.
    empty = empty_lib.zk_empty_launch
    empty.argtypes, empty.restype = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p], ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for grid in (1, sms * 8):
        def launch(grid=grid):
            assert empty(grid, 128, ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)) == 0
        results["empty"][grid] = chip_smoke.graph_ms([launch])[0]
    print("empty kernel in a graph: " + ", ".join(
        f"{g} blocks {ms:.6f} ms" for g, ms in results["empty"].items()) + " per launch")

    for (name, what, mib), a in inputs.items():
        block = MIB if "1 MiB blocks" in what else BLOCK
        k = {"block": block} if name == "byte_histogram" else {}
        fn = bk.byte_histogram if name == "byte_histogram" else bk.table_lookup
        want = fn(*a, **k)
        plain = (bk.histogram_plain(a[0].cpu(), block) if name == "byte_histogram"
                 else bk.lookup_plain(a[0].cpu(), table.cpu()))
        if not torch.equal(want.cpu(), plain):
            raise AssertionError(f"{name} on {what} at {mib} MiB: the kernel differs from plain")
        nbytes = chip_smoke.moved_bytes(name, a, want, mods)
        copies = chip_smoke.cold_copies(nbytes)
        sets = [a] + [[t.clone() for t in a] for _ in range(copies - 1)]
        calls = [lambda s=s: fn(*s, **k) for s in sets]
        row = {"name": name, "input": what, "mib": mib, "bytes": nbytes, "copies": copies,
               "bound_ms": nbytes / chip_smoke.HBM_BYTES_PER_S * 1e3, "cold": {}, "warm": {}}
        for mode, use in (("cold", calls), ("warm", calls[:1])):
            order = versions + versions[::-1]
            for label, lib in order:
                with launching(lib):
                    ms, outs = chip_smoke.graph_ms(use)
                row[mode][label] = row[mode].get(label, 0.0) + ms / 2
                for out in outs:
                    if not torch.equal(out, want):
                        raise AssertionError(f"{label}: {name} on {what} at {mib} MiB differs")
        results["cases"].append(row)
        print(f"{name} on {what}, {mib} MiB ({nbytes} bytes, bound {row['bound_ms']:.6f} ms; "
              f"cold: {copies} copies rotated):")
        for label, _lib in versions:
            c, w = row["cold"][label], row["warm"][label]
            print(f"  {label}: cold {c:.6f} ms ({100 * row['bound_ms'] / c:.1f}% of the bound), "
                  f"warm {w:.6f} ms ({100 * row['bound_ms'] / w:.1f}%); outputs equal")
        if name == "table_lookup":
            outs = [torch.empty_like(want) for _ in range(copies)]
            row["fill_ms"] = chip_smoke.graph_ms([lambda o=o: o.fill_(7) for o in outs])[0]
            print(f"  fill_ of the outputs alone, rotated (the write side): {row['fill_ms']:.6f} "
                  f"ms ({100 * want.numel() * 4 / chip_smoke.HBM_BYTES_PER_S * 1e3 / row['fill_ms']:.1f}"
                  f"% of its bound)")
        if mib == 10 and what == "text":
            ops.reset_launches()
            results["wrapper_ms"][name] = chip_smoke.cuda_ms(lambda: fn(*a, **k), 20)[0]
            lib_ms, method = chip_smoke.library_ms(name, a, k, chip_smoke.cold_copies(
                a[0].numel() * 8))
            results["library"].append({"name": name, "mib": mib, "ms": lib_ms,
                                       "method": method})
            print(f"  wrapper (events around 20 wrapper calls): "
                  f"{results['wrapper_ms'][name]:.6f} ms; library "
                  f"{'torch.take' if name == 'table_lookup' else 'torch.bincount'} "
                  f"{lib_ms:.6f} ms ({method}, rotated)")
        del sets, calls
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "byte_kernels.json"), "w") as fh:
        json.dump(results, fh, indent=1)
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
