#!/usr/bin/env python3
"""Where the CUDA FSE-encode kernel's cycles go, per sequence step.

    python3 tools/torch_fse_encode_steps.py [--out DIR] [--compare SRC ...]

Needs one CUDA card and nvcc. Copies ``zeekstd_tpu_torch/csrc/fse_kernel.cu``
with a clock64() mark after each phase of its chunk loop (thread 0, a lane
of the walk, sums the cycles of each phase per job: staging, phase A up to
its barrier, the walk, phase C up to the packed barrier, its own share of
the flush), builds the copy with nvcc (sm_90a) into DIR (default
``build/fse_encode_steps``), runs it on the FSE-encode calls of
chip_smoke.py's level-1 and level-3 encodes (the 10 MiB text, 1 MiB
frames), checks that its outputs equal the kernel's, and prints per call
the cycles per sequence step of each phase over all jobs and over the
longest job, the launch times (the launcher alone on preallocated outputs,
and the wrapper), the time of the zero fill of the words that the wrapper
no longer does, the chain floor (the longest job's steps times one
shared-load round trip, measured by a pointer chase through shared memory,
at the SM clock nvidia-smi reads under load), and the card's name and
power limit. Each ``--compare``
source (another version of ``csrc/fse_kernel.cu``, for example the parent
commit's; a launcher without the ``chunk`` argument is called without it)
is built as it is, held to the kernel's outputs on the same inputs (bit
counts, and words up to word bits // 32 of each job with sequences) and
timed in turns with it.
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
from zeekstd_tpu_torch import _build  # noqa: E402
from zeekstd_tpu_torch.ops import fse_kernel as fk  # noqa: E402
from zeekstd_tpu_torch.ops._launch import I, P, kernel_fn, ptr, stream  # noqa: E402

SRC = os.path.join(ROOT, "zeekstd_tpu_torch", "csrc", "fse_kernel.cu")
JOBS = 1 << 12
# (anchor, the phase that ends there); each mark goes right after its anchor.
MARKS = [
    ("  __syncthreads();  // staged\n", "staging"),
    ("    __syncthreads();  // phase A done\n", "A: codes, table pairs"),
    ("    __syncthreads();  // walk done\n", "B: the walk"),
    ("    __syncthreads();  // packed\n", "C: state bits, scan, pack"),
    ("    carry = total & 31;\n", "flush (thread 0's share)"),
]


def instrumented(src: str) -> str:
    """The kernel source with the marks and the zk_phase_read and
    zk_phase_clear launchers."""
    head = "namespace {\n"
    src = src.replace(head, head + f"__device__ long long g_phase[{JOBS} * 8];\n"
                      "#define ZK_MARK(i) do { const long long t_ = clock64(); "
                      "acc_[i] += t_ - t0_; t0_ = t_; } while (0)\n", 1)
    start = "  const int j = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;\n"
    assert src.count(start) == 1, "kernel start not found"
    src = src.replace(start, start + "  long long acc_[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
                      "  long long t0_ = clock64();\n")
    for i, (anchor, _name) in enumerate(MARKS):
        assert src.count(anchor) == 1, f"anchor not found: {anchor.strip()}"
        src = src.replace(anchor, anchor + f"    if (tid == 0) ZK_MARK({i});\n")
    tail = "    carry = total & 31;\n    if (tid == 0) ZK_MARK(4);\n  }\n"
    assert src.count(tail) == 1, "chunk loop end not found"
    src = src.replace(tail, tail + f"  if (tid == 0 && j < {JOBS}) for (int i = 0; i < 8; ++i) "
                      "g_phase[j * 8 + i] += acc_[i];\n")
    return src + f'''
// One thread chases a permutation of byte addresses through shared memory:
// the cycles of one shared-load round trip on a dependent chain.
__global__ void zk_lds_chase_kernel(int n, long long* out) {{
  __shared__ unsigned tab[1024];
  const unsigned base = (unsigned)__cvta_generic_to_shared(tab);
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) tab[i] = base + ((i * 389 + 7) & 1023) * 4;
  __syncthreads();
  if (threadIdx.x == 0) {{
    unsigned a = base;
    const long long t0 = clock64();
    for (int i = 0; i < n; ++i) asm volatile("ld.shared.b32 %0, [%0];" : "+r"(a));
    out[0] = clock64() - t0;
    out[1] = a;
  }}
}}
extern "C" int zk_lds_chase(int n, long long* out) {{
  zk_lds_chase_kernel<<<1, 32>>>(n, out);
  return (int)cudaGetLastError();
}}
extern "C" int zk_phase_read(long long* host) {{
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(long long) * {JOBS} * 8);
}}
extern "C" int zk_phase_clear() {{
  static long long zero[{JOBS} * 8];
  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}}
'''


def encode_calls(dev):
    """The fse_encode arguments of the level-1 and level-3 encodes of the
    10 MiB text (1 MiB frames), as the pipeline hands them over."""
    data = chip_smoke.build_corpus(10 << 20)
    calls = {}
    orig = fk.fse_encode
    for level in (1, 3):
        rec = []

        def wrap(*a, _rec=rec, **k):
            _rec.append((a, k))
            return orig(*a, **k)

        fk.fse_encode = wrap
        try:
            zt.compress_archive(data, frame_size=1 << 20, level=level, device=dev)
        finally:
            fk.fse_encode = orig
        calls[level] = rec[0]
    return calls


def equal_outputs(words, bits, ref_words, ref_bits, nseq):
    if not torch.equal(bits, ref_bits):
        return False
    for j, nb in enumerate(ref_bits.tolist()):
        n = min(nb // 32 + 1, words.shape[1])
        if nseq[j] > 0 and not torch.equal(words[j, :n], ref_words[j, :n]):
            return False
    return True


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "fse_encode_steps"))
    ap.add_argument("--compare", nargs="*", default=[], help="other versions of the source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_fse_encode_steps: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    cu = os.path.join(args.out, "fse_encode_steps.cu")
    with open(SRC) as fh, open(cu, "w") as out:
        out.write(instrumented(fh.read()))

    def build(src, name):
        so = os.path.join(args.out, f"lib{name}.so")
        subprocess.run([_build.nvcc()] + _build.NVCC_FLAGS
                       + ["-I", os.path.dirname(SRC), "-o", so, src], check=True)
        lib = ctypes.CDLL(so)
        fn = lib.zk_fse_launch
        with open(src) as fh:
            chunked = "int chunk" in fh.read()
        fn.argtypes = [P] * 5 + [I] * (4 + chunked) + [P] * 3
        fn.restype = ctypes.c_int
        return lib, (fn, chunked)

    lib, instr_fn = build(cu, "fse_encode_steps")
    others = [build(src, f"fse_encode_compare{i}")[1] for i, src in enumerate(args.compare)]
    kernel = (kernel_fn("zk_fse_launch", [P] * 5 + [I] * 5 + [P] * 3), True)

    dev = torch.device("cuda", 0)
    chase = torch.zeros(2, dtype=torch.int64, device=dev)
    lib.zk_lds_chase.argtypes = [I, P]
    assert lib.zk_lds_chase(1 << 16, ptr(chase)) == 0
    torch.cuda.synchronize()
    lds_cycles = int(chase[0]) / (1 << 16)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    for level, (a, k) in encode_calls(dev).items():
        consts, meta, lm, ofv, tables = a
        SBd, WBo = k["SBd"], k["WBo"]
        njobs = meta.shape[0]
        assert njobs <= JOBS
        words = torch.empty((njobs, WBo), dtype=torch.int32, device=dev)
        bits = torch.empty(njobs, dtype=torch.int32, device=dev)

        def launcher(f_chunked, words=words, bits=bits):
            f, chunked = f_chunked
            chunk = [fk.CHUNK] if chunked else []

            def launch():
                rc = f(ptr(consts), ptr(meta), ptr(lm), ptr(ofv), ptr(tables),
                       tables.shape[0], njobs, SBd, WBo, *chunk, ptr(words), ptr(bits),
                       stream())
                assert rc == 0, rc
            return launch

        ref_words, ref_bits = fk.fse_encode(*a, **k)
        nseq = meta[:, fk.J_NSEQ].clamp(0, SBd).cpu().numpy()
        assert lib.zk_phase_clear() == 0
        launcher(instr_fn)()
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * (JOBS * 8))()
        assert lib.zk_phase_read(buf) == 0
        per_job = np.array(buf[:]).reshape(JOBS, 8)[:njobs, : len(MARKS)]
        assert equal_outputs(words, bits, ref_words, ref_bits, nseq), \
            "the instrumented kernel's outputs differ"
        kern, instr = launcher(kernel), launcher(instr_fn)
        ms = {"kernel": 0.0, "instrumented": 0.0}
        for name in ("kernel", "instrumented", "instrumented", "kernel"):
            ms[name] += chip_smoke.cuda_ms(kern if name == "kernel" else instr, 20)[0] / 2
        wrapper_ms = chip_smoke.cuda_ms(lambda: fk.fse_encode(*a, **k), 20)[0]
        fill_ms = chip_smoke.cuda_ms(
            lambda: torch.zeros((njobs, WBo), dtype=torch.int32, device=dev), 20)[0]
        compared = []
        for src, other in zip(args.compare, others):
            launch = launcher(other)
            words.zero_()  # the parent's wrapper zero-filled both: its kernel
            bits.zero_()   # leaves jobs without sequences unwritten
            launch()
            assert equal_outputs(words, bits, ref_words, ref_bits, nseq), f"{src}: outputs differ"
            t_k = t_o = 0.0
            for name in ("kernel", "other", "other", "kernel"):
                t = chip_smoke.cuda_ms(kern if name == "kernel" else launch, 20)[0] / 2
                t_k, t_o = (t_k + t, t_o) if name == "kernel" else (t_k, t_o + t)
            compared.append((src, t_o, t_k))
        longest = int(nseq.argmax())
        mhz = chip_smoke.sm_clock(kern, ms["kernel"])[0]
        floor_ms = int(nseq[longest]) * lds_cycles / (mhz * 1e3)
        print(f"level {level}: {int(nseq.sum())} sequences in {int((nseq > 0).sum())} jobs of "
              f"{njobs} (SBd {SBd}, WBo {WBo}, chunk {fk.CHUNK}); longest job {int(nseq[longest])}; "
              f"kernel {ms['kernel']:.4f} ms, instrumented {ms['instrumented']:.4f} ms per launch "
              f"(launcher alone), wrapper {wrapper_ms:.4f} ms; zero fill of the words "
              f"{fill_ms:.4f} ms (not done); outputs equal the kernel's")
        print(f"  SM clock under load {mhz:.0f} MHz: the kernel takes "
              f"{ms['kernel'] * mhz * 1e3 / nseq[longest]:.1f} cycles per step of the longest "
              f"job; one shared-load round trip {lds_cycles:.1f} cycles, so the chain floor "
              f"(longest job x one round trip) is {floor_ms:.4f} ms")
        all_jobs = per_job.sum(axis=0) / nseq.sum()
        one = per_job[longest] / nseq[longest]
        print(f"  {'phase':32s} {'all jobs':>10s} {'longest':>10s}  (cycles per step)")
        for (_anchor, name), c_all, c_one in zip(MARKS, all_jobs, one):
            print(f"  {name:32s} {c_all:10.1f} {c_one:10.1f}")
        print(f"  {'all phases':32s} {all_jobs.sum():10.1f} {one.sum():10.1f}")
        for src, t_o, t_k in compared:
            print(f"  compare {src}: {t_o:.4f} ms per launch against the kernel's {t_k:.4f} "
                  f"(in turns); outputs equal")
    return 0


if __name__ == "__main__":
    sys.exit(main())
