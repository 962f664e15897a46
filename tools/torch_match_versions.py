#!/usr/bin/env python3
"""Versions of the CUDA match kernel timed in turns on the card.

    python3 tools/torch_match_versions.py [--out DIR] [--compare SRC[:packed] ...]

Needs one CUDA card and nvcc. Builds ``zeekstd_tpu_torch/csrc/match_kernel.cu``
and each ``--compare`` source (another version of it) alone with nvcc
(sm_90a) into DIR (default ``build/match_versions``), all at once. A source
marked ``:packed`` has the launcher of the kernel before blocks above
32 KiB existed (no ``ml`` argument; the parent commit's, for example, from
``git show <commit>:zeekstd_tpu_torch/csrc/match_kernel.cu``) and runs at
32 KiB only. On chip_smoke.py's 10 MiB text in 1 MiB frames (the level-1
path's records), at 32 KiB and 128 KiB blocks, every version's rows must
equal the package's wrapper (``match_kernel.match``); at 32 KiB the
kernel's WIDE instance (``ml`` given, the instance blocks above 32 KiB
take) runs too, its ll and ml rows packed again equal to the wrapper's
packed rows. Then each version is timed in turns with the others (every
version, then the same in reverse, three times; CUDA events around three
launches) and the median ms per launch is printed with its range, the
cycles per sequence of one frame's chain at the SM clock nvidia-smi reads
while more launches run, and the card's name and power limit. Last, the
FSE kernel's packed and wide instances are timed in turns the same way on
the first FSE launch of ``compress_archive`` of that text at levels 1 and
3 (32 KiB blocks, packed rows; the wide call takes the same rows split
into ll and ml), their bitstreams equal.
"""

import argparse
import ctypes
import os
import subprocess
import sys

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
MIB = 1 << 20


def build_all(out_dir, sources):
    """One library per (label, source, packed) in ``sources``, built in
    parallel; returns [(label, packed, launcher)]."""
    jobs = []
    for i, (label, src, packed) in enumerate(sources):
        so = os.path.join(out_dir, f"libmatch{i}.so")
        cmd = [_build.nvcc()] + _build.NVCC_FLAGS + ["-I", os.path.dirname(SRC), "-o", so, src]
        jobs.append((label, packed, so, subprocess.Popen(cmd)))
    out = []
    for label, packed, so, proc in jobs:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed on {label}")
        fn = ctypes.CDLL(so).zk_match_launch
        fn.argtypes = [P, P, P, L, I, I, I, I] + [P] * (5 if packed else 6)
        fn.restype = ctypes.c_int
        out.append((label, packed, fn))
    return out


def in_turns(runs):
    """CUDA-event ms per launch of each (label, launch) of ``runs``: every
    run, then the same in reverse, three times, three launches a sample."""
    times = {label: [] for label, _ in runs}
    for _ in range(3):
        for label, launch in runs + runs[::-1]:
            ev0 = torch.cuda.Event(enable_timing=True)
            ev1 = torch.cuda.Event(enable_timing=True)
            ev0.record()
            for _ in range(3):
                launch()
            ev1.record()
            torch.cuda.synchronize()
            times[label].append(ev0.elapsed_time(ev1) / 3)
    return times


def fse_instances(data, dev):
    """The FSE kernel's packed and wide instances in turns on the first FSE
    launch of the 32 KiB archive of ``data`` at levels 1 and 3."""
    import zeekstd_tpu_torch as zt
    from zeekstd_tpu_torch import archive

    if mk.wide_rows(archive.BLOCK_SIZE):
        raise SystemExit("fse instances: run with 32 KiB blocks (ZEEKSTD_TPU_BLOCK unset)")
    for level in (1, 3):
        with chip_smoke.Recorder() as rec:
            zt.compress_archive(data, frame_size=MIB, level=level, checksum=True, device=dev)
        (cst, meta, lm, ofv, tables), k = rec.calls["fse"][0]
        assert k.get("ml") is None
        kw = dict(SBd=k["SBd"], WBo=k["WBo"])
        ll, ml = lm >> 16, lm & 0xFFFF
        runs = [("packed", lambda: fk.fse_encode(cst, meta, lm, ofv, tables, **kw)),
                ("wide", lambda: fk.fse_encode(cst, meta, ll, ofv, tables, ml=ml, **kw))]
        (w0, b0), (w1, b1) = (launch() for _, launch in runs)
        torch.cuda.synchronize()
        assert torch.equal(b0, b1), "fse: the wide instance's bit counts differ"
        for j, nb in enumerate(b0.tolist()):
            assert torch.equal(w0[j, : nb // 32 + 1], w1[j, : nb // 32 + 1]), (
                f"fse: the wide instance's stream {j} differs")
        for label, ts in in_turns(runs).items():
            ts = sorted(ts)
            print(f"fse L{level} 32 KiB {label} instance: median {ts[len(ts) // 2]:.4f} ms per "
                  f"launch over {len(ts)} turns [{ts[0]:.4f}-{ts[-1]:.4f}], {b0.numel()} jobs; "
                  f"streams equal")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "match_versions"))
    ap.add_argument("--compare", nargs="*", default=[],
                    help="other versions of the source (SRC, or SRC:packed for the old launcher)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_match_versions: no CUDA device is available", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    sources = [("kernel", SRC, False)]
    for c in args.compare:
        packed = c.endswith(":packed")
        src = c[: -len(":packed")] if packed else c
        sources.append((src, src, packed))
    versions = build_all(args.out, sources)
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}")
    data = chip_smoke.build_corpus(10 * MIB)
    rows, lengths = match_edges._frames([data[i:i + MIB] for i in range(0, len(data), MIB)],
                                        MIB)
    consts = torch.from_numpy(fk.make_consts()).to(dev)
    F = rows.shape[0]
    for BLK in (32 << 10, 128 << 10):
        SBd = BLK // 4
        meta, words = match_edges.match_inputs(rows, lengths, BLK)
        meta_d, words_d = (torch.from_numpy(x).to(dev) for x in (meta, words))
        nrecp = meta.shape[0]
        want = mk.match(consts, meta_d, words_d, BLK=BLK, SBd=SBd, n_frames=F)
        nseq = int(want[3][:, mk.ST_NSEQ].sum())
        runs = []
        for label, packed, fn in versions:
            if packed and mk.wide_rows(BLK):
                continue
            # The current kernel's WIDE instance also runs at 32 KiB.
            for wide in (True, False) if label == "kernel" and not mk.wide_rows(BLK) else (
                    mk.wide_rows(BLK),):
                lm, ml, ofv, stat = (torch.zeros((nrecp, n), dtype=torch.int32, device=dev)
                                     for n in (SBd, SBd, SBd, 512))
                litw = torch.zeros((nrecp, BLK // 4), dtype=torch.int32, device=dev)
                rest = (ptr(ofv), ptr(litw), ptr(stat), stream())
                head = (ptr(consts), ptr(meta_d), ptr(words_d), words_d.numel(), nrecp, F, BLK,
                        SBd)
                if packed:
                    def launch(fn=fn, head=head, lm=lm, rest=rest):
                        return fn(*head, ptr(lm), *rest)
                else:
                    def launch(fn=fn, head=head, lm=lm, ml=ml if wide else None, rest=rest):
                        return fn(*head, ptr(lm), None if ml is None else ptr(ml), *rest)
                name = label + (" (WIDE instance)" if wide and not mk.wide_rows(BLK) else "")
                if launch() != 0:
                    raise RuntimeError(f"{name}: the launch failed at {BLK}")
                torch.cuda.synchronize()
                if wide and not mk.wide_rows(BLK):
                    got = ((lm << 16) | ml, ofv, litw, stat)
                else:
                    got = (lm, ofv, litw, stat) + ((ml,) if wide else ())
                if not all(torch.equal(g, w) for g, w in zip(got, want)):
                    raise AssertionError(f"{name}: rows differ from the wrapper's at {BLK}")
                runs.append((name, launch))
        times = in_turns(runs)
        for _ in range(6):  # the SM clock under load: read while these run
            runs[0][1]()
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
            capture_output=True, text=True, check=True).stdout.split()[0])
        torch.cuda.synchronize()
        for label, ts in times.items():
            ts = sorted(ts)
            med = ts[len(ts) // 2]
            cyc = med * 1e-3 / (nseq / F) * mhz * 1e6
            print(f"BLK {BLK >> 10} KiB {label}: median {med:.4f} ms per launch over {len(ts)} "
                  f"turns [{ts[0]:.4f}-{ts[-1]:.4f}], {cyc:.1f} cycles per sequence at {mhz:.0f} "
                  f"MHz (under load), {nseq} sequences; rows equal the wrapper's")
    fse_instances(data, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
