#!/usr/bin/env python3
"""Where one sequence's step of the CUDA match kernel spends its cycles.

    python3 tools/torch_match_phases.py [--out DIR]

Needs one CUDA card and nvcc. Copies ``zeekstd_tpu_torch/csrc/match_kernel.cu``
with a clock64() mark at each phase boundary of the parse loop (warp 0
sums the cycles of each phase per frame), builds the copy with nvcc
(sm_90a) into DIR (default ``build/match_phases``), runs it on
chip_smoke.py's 10 MiB text (1 MiB frames, the level-1 path's records),
checks that its rows equal the uninstrumented kernel's, and prints the
cycles per sequence of each phase (summed over the frames, over all
sequences), the instrumented launch time, and the card's name and power
limit. The marks cost a few percent of the launch time.
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
from tests import match_edges  # noqa: E402
from zeekstd_tpu_torch import _build  # noqa: E402
from zeekstd_tpu_torch.ops import fse_kernel as fk  # noqa: E402
from zeekstd_tpu_torch.ops import match_kernel as mk  # noqa: E402
from zeekstd_tpu_torch.ops._launch import I, L, P, ptr, stream  # noqa: E402

SRC = os.path.join(ROOT, "zeekstd_tpu_torch", "csrc", "match_kernel.cu")
# (anchor in the parse loop, the phase that ends there)
MARKS = [
    ("    // Hash words of p and p + 1", "loop back-edge and the previous step's tail"),
    ("    // One round over the four candidates.", "hash words and table reads"),
    ("    // Probe p: rep1 first", "probe round (loads, ballot, shuffles)"),
    ("    // Backward extension over the pending literal run", "decisions (A, lazy B)"),
    ("    const int ll = m_pos - anchor;", "backward extension"),
    ("    // The step's inserts", "emit (repeat codes, literals, rows) or miss"),
    ("  // Block-trailing literals.", "inserts"),
]


def instrumented(src: str) -> str:
    """The kernel source with the marks and a zk_phase_read launcher."""
    head = "namespace {\n"
    src = src.replace(head, head + "__device__ long long g_phase[64 * 8];\n"
                      "#define ZK_MARK(i) do { const long long t_ = clock64(); "
                      "acc_[i] += t_ - t0_; t0_ = t_; } while (0)\n", 1)
    loop = "  while (p < limit) {\n"
    assert src.count(loop) == 1, "parse loop not found"
    src = src.replace(loop, "  long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                      "  long long t0_ = clock64();\n" + loop)
    for i, (anchor, _name) in enumerate(MARKS[:-1]):
        assert src.count(anchor) == 1, f"anchor not found: {anchor.strip()}"
        src = src.replace(anchor, f"    ZK_MARK({i});\n" + anchor)
    tail = MARKS[-1][0]
    end = src.index(tail)
    close = src.rindex("  }\n", 0, end)  # the parse loop's closing brace
    src = (src[:close] + f"    ZK_MARK({len(MARKS) - 1});\n" + src[close:end]
           + "  if (lane == 0) for (int i = 0; i < 8; ++i) "
           "g_phase[blockIdx.x * 8 + i] += acc_[i];\n" + src[end:])
    return src + '''
extern "C" int zk_phase_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(long long) * 64 * 8);
}
'''


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "match_phases"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_match_phases: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    cu = os.path.join(args.out, "match_phases.cu")
    with open(SRC) as fh, open(cu, "w") as out:
        out.write(instrumented(fh.read()))
    so = os.path.join(args.out, "libmatch_phases.so")
    subprocess.run([_build.nvcc()] + _build.NVCC_FLAGS
                   + ["-I", os.path.dirname(SRC), "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    fn = lib.zk_match_launch
    fn.argtypes = [P, P, P, L, I, I, I, I, P, P, P, P, P, P]

    dev = torch.device("cuda", 0)
    MIB = 1 << 20
    data = chip_smoke.build_corpus(10 * MIB)
    rows, lengths = match_edges._frames([data[i:i + MIB] for i in range(0, len(data), MIB)],
                                        MIB)
    BLK, SBd, F = 32 << 10, 8192, rows.shape[0]
    meta, words = match_edges.match_inputs(rows, lengths, BLK)
    consts, meta_d, words_d = (torch.from_numpy(x).to(dev)
                               for x in (fk.make_consts(), meta, words))
    nrecp = meta.shape[0]
    outs = [torch.zeros((nrecp, n), dtype=torch.int32, device=dev)
            for n in (SBd, SBd, BLK // 4, 512)]

    def launch():
        lm, ofv, litw, stat = outs  # 32 KiB blocks: the packed rows, no ml row
        rc = fn(ptr(consts), ptr(meta_d), ptr(words_d), words_d.numel(), nrecp, F, BLK, SBd,
                ptr(lm), None, ptr(ofv), ptr(litw), ptr(stat), stream())
        assert rc == 0, rc

    launch()
    torch.cuda.synchronize()
    buf = (ctypes.c_longlong * (64 * 8))()
    assert lib.zk_phase_read(buf) == 0
    phases = np.array(buf[:]).reshape(64, 8)[:F].sum(axis=0)
    want = mk.match(consts, meta_d, words_d, BLK=BLK, SBd=SBd, n_frames=F)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref), "the instrumented kernel's rows differ"
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(3):
        launch()
    ev1.record()
    torch.cuda.synchronize()
    ms = ev0.elapsed_time(ev1) / 3
    nseq = int(outs[3][:, mk.ST_NSEQ].sum())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    print(f"instrumented launch {ms:.4f} ms, {nseq} sequences, {F} frames; rows equal the "
          f"kernel's")
    total = phases.sum() / nseq
    for (_anchor, name), cyc in zip(MARKS, phases):
        print(f"  {name:45s} {cyc / nseq:8.1f} cycles per sequence")
    print(f"  {'all phases':45s} {total:8.1f} cycles per sequence")
    return 0


if __name__ == "__main__":
    sys.exit(main())
