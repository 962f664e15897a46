#!/usr/bin/env python3
"""Where the CUDA FSE-decode kernel's cycles go, per sequence step.

    python3 tools/torch_fse_decode_steps.py [--out DIR] [--compare SRC ...]

Needs one CUDA card and nvcc. Copies ``zeekstd_tpu_torch/csrc/fse_decode.cu``
with a clock64() mark at each phase boundary of the batch loop (lane 0
sums the cycles of each phase per row), builds the copy with nvcc
(sm_90a) into DIR (default ``build/fse_decode_steps``), runs it on the
FSE-decode call of chip_smoke.py's phase 3c (the 10 MiB text at level 3,
1 MiB frames, every block of the archive in one launch), checks that its
six outputs equal the uninstrumented kernel's, and prints the cycles per
sequence step of each phase over all rows and over the longest row, both
kernels' launch times, and the card's name and power limit. Each
``--compare`` source (another version of ``csrc/fse_decode.cu``, for
example the parent commit's; a launcher without the ``stage_words``
argument is called without it) is built as it is, held to the kernel's
outputs on the same inputs and timed in turns with it.
"""

import argparse
import ctypes
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
import zeekstd_tpu_torch as zt  # noqa: E402
from zeekstd_tpu_torch import _build, plan  # noqa: E402
from zeekstd_tpu_torch.ops import decode_kernel as dk  # noqa: E402
from zeekstd_tpu_torch.ops import entropy  # noqa: E402
from zeekstd_tpu_torch.ops._launch import I, P, ptr, stream  # noqa: E402

SRC = os.path.join(ROOT, "zeekstd_tpu_torch", "csrc", "fse_decode.cu")
ROWS = 1 << 14
# (anchor in the batch loop, the phase that ends there)
MARKS = [
    ("      const int cnt = min(BATCH, nn - i0);\n", "stores, loop back-edge and window check"),
    ("      // Lane L decodes sequences 2L and 2L + 1", "state walk"),
    ("      HMap m = compose(qa.map, qb.map);\n", "the lanes' value decode"),
    ("      rep |= __any_sync", "history scan, new history"),
]


def instrumented(src: str) -> str:
    """The kernel source with the marks and a zk_phase_read launcher."""
    head = "namespace {\n"
    src = src.replace(head, head + f"__device__ long long g_phase[{ROWS} * 8];\n"
                      "#define ZK_MARK(i) do { const long long t_ = clock64(); "
                      "acc_[i] += t_ - t0_; t0_ = t_; } while (0)\n", 1)
    loop = "    for (int i0 = 0; i0 < nn; i0 += BATCH) {\n"
    assert src.count(loop) == 1, "batch loop not found"
    src = src.replace(loop, "    long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                      "    long long t0_ = clock64();\n" + loop)
    for i, (anchor, _name) in enumerate(MARKS):
        assert src.count(anchor) == 1, f"anchor not found: {anchor.strip()}"
        src = src.replace(anchor, f"      ZK_MARK({i});\n" + anchor)
    tail = "  if (lane == 0) {\n    a.reps["
    assert src.count(tail) == 1, "kernel tail not found"
    close = src.rindex("    }\n", 0, src.index(tail))  # the batch loop's closing brace
    src = (src[:close + 6] + "    ZK_MARK(0);\n"
           f"    if (lane == 0 && b < {ROWS}) for (int i = 0; i < 8; ++i) "
           "g_phase[b * 8 + i] += acc_[i];\n" + src[close + 6:])
    return src + f'''
extern "C" int zk_phase_read(long long* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(long long) * {ROWS} * 8);
}}
'''


def phase_3c_args(dev):
    """The FSE-decode wrapper's arguments on the serial route's decode of
    the 10 MiB level-3 archive, staged as ``decode_routes._fse_batch_dev``
    stages them."""
    data = chip_smoke.build_corpus(10 << 20)
    blob, _st = zt.compress_archive(data, frame_size=1 << 20, level=3, device=dev)
    seq_blocks = plan.collect(plan.plan_archive(blob, None)).seq_blocks
    words, starts, tidx, packed, logs_t, _wb = plan.fse_stage(seq_blocks)
    nseqs = np.zeros(words.shape[0], np.int32)
    nseqs[: len(seq_blocks)] = [d["nseq"] for d in seq_blocks]
    seq_bound = 1 << max((int(nseqs.max()) - 1).bit_length(), 5)
    st = zt.from_reference_arrays(dev, words=words, starts=starts, nseqs=nseqs, tidx=tidx,
                                  tables=packed, logs=logs_t, consts=dk.make_consts())
    return [st[n] for n in ("words", "starts", "nseqs", "tidx", "tables", "logs",
                            "consts")], seq_bound


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "fse_decode_steps"))
    ap.add_argument("--compare", nargs="*", default=[], help="other versions of the source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fse_decode_steps: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    cu = os.path.join(args.out, "fse_decode_steps.cu")
    with open(SRC) as fh, open(cu, "w") as out:
        out.write(instrumented(fh.read()))

    def build(src, name):
        so = os.path.join(args.out, f"lib{name}.so")
        subprocess.run([_build.nvcc()] + _build.NVCC_FLAGS
                       + ["-I", os.path.dirname(SRC), "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
        fn = lib.zk_fse_seq_decode_launch
        with open(src) as fh:
            staged = "int stage_words" in fh.read()
        fn.argtypes = [P, I, P, P, P, P, I, P, P, I, I] + [I] * staged + [P] * 7
        fn.restype = ctypes.c_int
        return lib, (fn, staged)

    lib, fn = build(cu, "fse_decode_steps")
    others = [build(src, f"fse_decode_compare{i}")[1] for i, src in enumerate(args.compare)]

    dev = torch.device("cuda", 0)
    a, SB = phase_3c_args(dev)
    words, starts, nseqs, tidx, tables, logs, consts = a
    B, WB = words.shape
    assert B <= ROWS
    outs = [torch.empty((B, SB), dtype=torch.int32, device=dev) for _ in range(4)]
    outs += [torch.empty((B, 3), dtype=torch.int32, device=dev),
             torch.empty(B, dtype=torch.int32, device=dev)]

    def launcher(f_staged):
        f, staged = f_staged
        stage = [entropy.stage_words(WB)] if staged else []

        def launch():
            rc = f(ptr(words), WB, ptr(starts), ptr(nseqs), ptr(tidx), ptr(tables),
                   tables.shape[0], ptr(logs), ptr(consts), B, SB, *stage,
                   *(ptr(t) for t in outs), stream())
            assert rc == 0, rc
        return launch

    instr = launcher(fn)

    def kernel():
        return entropy.fse_decode_sequences(*a, seq_bound=SB)

    instr()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (ROWS * 8))()
    assert lib.zk_phase_read(buf) == 0
    per_row = np.array(buf[:]).reshape(ROWS, 8)[:B, : len(MARKS)]
    want = kernel()
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref.to(torch.int32)), "the instrumented kernel's outputs differ"
    ms = {"kernel": 0.0, "instrumented": 0.0}
    for name in ("kernel", "instrumented", "instrumented", "kernel"):
        ms[name] += chip_smoke.cuda_ms(kernel if name == "kernel" else instr, 20)[0] / 2
    for i, other in enumerate(others):
        launch = launcher(other)
        for t in outs:
            t.fill_(-1)
        launch()
        for got, ref in zip(outs, want):
            assert torch.equal(got, ref.to(torch.int32)), f"{args.compare[i]}: outputs differ"
        t_k = t_o = 0.0
        for name in ("kernel", "other", "other", "kernel"):
            t = chip_smoke.cuda_ms(kernel if name == "kernel" else launch, 20)[0] / 2
            t_k, t_o = (t_k + t, t_o) if name == "kernel" else (t_k, t_o + t)
        ms[args.compare[i]] = (t_o, t_k)
    nn = nseqs.cpu().numpy().clip(0, SB)
    longest = int(nn.argmax())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"{int(nn.sum())} sequences in {int((nn > 0).sum())} rows of {B} (WB {WB}, "
          f"seq_bound {SB}); longest row {int(nn[longest])}; kernel {ms['kernel']:.4f} ms, "
          f"instrumented {ms['instrumented']:.4f} ms per launch; outputs equal the kernel's")
    all_rows = per_row.sum(axis=0) / nn.sum()
    one = per_row[longest] / nn[longest]
    print(f"  {'phase':50s} {'all rows':>10s} {'longest':>10s}  (cycles per step)")
    for (_anchor, name), c_all, c_one in zip(MARKS, all_rows, one):
        print(f"  {name:50s} {c_all:10.1f} {c_one:10.1f}")
    print(f"  {'all phases':50s} {all_rows.sum():10.1f} {one.sum():10.1f}")
    for src in args.compare:
        t_o, t_k = ms[src]
        print(f"compare {src}: {t_o:.4f} ms per launch against the kernel's {t_k:.4f} "
              f"(in turns); outputs equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
