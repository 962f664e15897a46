"""Multi-process scale-out for the frame pipeline.

Port of ``zeekstd_tpu/parallel/multihost.py`` onto ``torch.distributed``.
The pipeline in ``pipeline.py`` already runs across processes: each
process encodes its own shards' frames, and the gathers that build the
seek table move the other processes' entries. What multi-process adds is
topological, and lives here:

- process bootstrap (``init_multihost``: ``init_process_group`` over a
  TCP rendezvous; NCCL with a card, gloo without one or when processes
  share a card, which NCCL refuses);
- the host-major mesh (``make_multihost_mesh``): process r's devices are
  shards r * n_local ..., so each process's contiguous frame block stays
  on its own devices and only the entry (and row) gathers cross
  processes;
- process-local staging: each process passes only its own frames' bytes
  (``process_frame_slice``);
- the per-process write plan: each process writes its own compressed rows
  at the byte offsets the gathered entries imply (``host_write_plan``),
  the distributed form of the reference's sequential writer and
  ``log_frame`` (reference lib/src/encode.rs:466-467,743-775).

Every function degrades to the single-process case, which is how the
tests' one-process meshes exercise it.
"""

from __future__ import annotations

from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from ..seek_table import SeekTable
from .pipeline import make_mesh, parallel_compress

# Seconds a rendezvous or a collective waits for the other processes
# before it raises.
TIMEOUT_S = 300


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None,
                   backend: str | None = None) -> int:
    """Join the process group (a no-op for a single process, or when a
    group is already initialised); returns this process's rank.

    ``coordinator_address`` is "host:port" of rank 0's TCP rendezvous;
    ``backend`` defaults to NCCL with a card and gloo without."""
    if dist.is_initialized():
        return dist.get_rank()
    if (num_processes is not None and num_processes > 1) or coordinator_address:
        if not coordinator_address:
            raise ValueError("a process group of several processes needs a coordinator_address")
        if backend is None:
            backend = "nccl" if torch.cuda.is_available() else "gloo"
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_address}",
            world_size=num_processes or 1, rank=process_id or 0,
            timeout=timedelta(seconds=TIMEOUT_S),
        )
        return dist.get_rank()
    return 0


def make_multihost_mesh(axis: str = "data", devices=None):
    """1-D frame mesh over every process's devices, ordered host-major:
    this process's ``devices`` (default: the current CUDA device) in the
    default process group."""
    return make_mesh(devices, axis)


def process_frame_slice(n_frames_padded: int, mesh=None):
    """(lo, hi) frame indices this process owns under the host-major mesh:
    the rows its shards carry."""
    if mesh is None:
        mesh = make_multihost_mesh()
    per_dev = n_frames_padded // mesh.size
    shards = mesh.shards()
    return shards[0] * per_dev, (shards[-1] + 1) * per_dev


def host_write_plan(c_sizes, d_sizes, first_frame: int, n_local: int):
    """Byte-offset plan for this host's ordered write of its own frames.

    ``c_sizes``/``d_sizes`` are the REPLICATED gathered per-frame entry
    arrays (every process holds them after the pipeline's all-gather).
    Returns (file_offset_of_first_local_frame, [per-frame (offset, size)]),
    plus the SeekTable every host can build identically.
    """
    c_sizes = np.asarray(c_sizes, np.int64)
    d_sizes = np.asarray(d_sizes, np.int64)
    starts = np.concatenate([[0], np.cumsum(c_sizes)])
    plan = [
        (int(starts[f]), int(c_sizes[f]))
        for f in range(first_frame, first_frame + n_local)
    ]
    st = SeekTable()
    for c, d in zip(c_sizes, d_sizes):
        st.log_frame(int(c), int(d))
    return int(starts[first_frame]), plan, st


def multihost_compress(data_local: bytes, first_frame: int = 0,
                       n_total: int | None = None,
                       frame_size: int = 2 << 20, mesh=None,
                       level: int = 3):
    """SPMD entry point: compress this process's slice of a logical
    ``n_total``-byte input; every process calls this with its own slice
    (``data_local`` starts at global frame ``first_frame``).

    Each process encodes only its rows on its own devices, ONLY the
    per-frame entries are all-gathered, and every process builds the
    identical SeekTable from them. Returns (local_rows, write_plan,
    seek_table): ``local_rows`` are this process's compressed frames in
    order and ``write_plan`` the (file_offset, size) each must land at.
    Single-process, the same call covers the whole input with
    first_frame=0.
    """
    if mesh is None:
        mesh = make_multihost_mesh()
    if n_total is None:
        n_total = len(data_local)
    local_rows, first_row, st = parallel_compress(
        data_local, mesh, frame_size=frame_size,
        first_frame=first_frame, n_total=n_total, gather_bytes=False,
        level=level,
    )
    _start, plan, _ = host_write_plan(
        [st.frame_size_comp(i) for i in range(st.num_frames)],
        [st.frame_size_decomp(i) for i in range(st.num_frames)],
        first_row, len(local_rows),
    )
    return local_rows, plan, st
