"""One process of the two-process mesh test of the PyTorch port.

    python tests/torch_mh_worker.py RANK NPROC PORT OUTDIR

Joins a gloo process group over a localhost rendezvous at PORT with 4 CPU
devices (8 shards over 2 processes, the layout of tests/mh_worker.py),
compresses only this process's frames of the 120 KiB corpus through
``multihost_compress`` (level 1, 16 KiB frames), and writes its rows, the
write plan and its seek table to OUTDIR (part{RANK}.bin, st{RANK}.bin,
meta{RANK}.json). Then every process writes its rows into one shared
archive file at the plan's offsets, and, once all have, decodes the whole
archive and a few ranges over the two-process mesh, recording whether it
got the corpus back. Imports no JAX.
"""

import hashlib
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from zeekstd_tpu_torch.parallel import (  # noqa: E402
    init_multihost,
    make_multihost_mesh,
    multihost_compress,
    parallel_decompress,
    parallel_random_access,
    process_frame_slice,
)
from zeekstd_tpu_torch.parallel.pipeline import _frame_layout  # noqa: E402

FR = 16 << 10
RANGES = [(100, 300), (FR - 50, FR + 4000), (5 * FR + 7, 7 * FR + 1)]


def corpus(n):
    """tests/test_multihost.py's corpus: seeded words, 120 KiB."""
    rng = np.random.default_rng(7)
    words = [rng.bytes(rng.integers(3, 9)) for _ in range(50)]
    out = bytearray()
    while len(out) < n:
        out += words[int(rng.integers(0, 50))]
    return bytes(out[:n])


def main():
    rank, nproc, port, outdir = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                 sys.argv[4])
    torch.set_num_threads(2)
    init_multihost(f"127.0.0.1:{port}", nproc, rank, backend="gloo")
    try:
        data = corpus(120 << 10)  # 8 frames, the last one partial
        mesh = make_multihost_mesh(devices=["cpu"] * 4)
        _, F_pad = _frame_layout(len(data), FR, mesh.size)
        lo, hi = process_frame_slice(F_pad, mesh)
        local = data[lo * FR : min(hi * FR, len(data))]
        rows, plan, st = multihost_compress(local, first_frame=lo, n_total=len(data),
                                            frame_size=FR, mesh=mesh, level=1)
        with open(os.path.join(outdir, f"part{rank}.bin"), "wb") as f:
            f.write(b"".join(rows))
        with open(os.path.join(outdir, f"st{rank}.bin"), "wb") as f:
            f.write(st.to_bytes())

        # The distributed writer: each process writes its rows at the
        # plan's offsets of one shared file.
        path = os.path.join(outdir, "archive.bin")
        if rank == 0:
            with open(path, "wb") as f:
                f.truncate(st.size_comp)
        dist.barrier()
        fd = os.open(path, os.O_WRONLY)
        try:
            for row, (off, size) in zip(rows, plan):
                assert len(row) == size
                os.pwrite(fd, row, off)
        finally:
            os.close(fd)
        dist.barrier()
        with open(path, "rb") as f:
            archive = f.read()

        out = parallel_decompress(archive, st, mesh)
        got = parallel_random_access(archive, st, RANGES, mesh)
        meta = {
            "first_frame": lo,
            "plan": plan,
            "n_rows": len(rows),
            "decoded_whole": out == data,
            "decoded_sha": hashlib.sha256(out).hexdigest(),
            "ranges_ok": got == [data[a:b] for a, b in RANGES],
            "ranges_sha": hashlib.sha256(b"".join(got)).hexdigest(),
        }
        with open(os.path.join(outdir, f"meta{rank}.json"), "w") as f:
            json.dump(meta, f)
        print(f"proc {rank}: frames [{lo}, {hi}) rows={len(rows)} "
              f"decoded_whole={meta['decoded_whole']}", flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
