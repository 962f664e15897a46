"""Mesh-parallel frame pipeline: shard frames, encode and decode them per
device, gather the seek-table entries and the archive bytes over
``torch.distributed`` (NCCL on the card, gloo on the CPU).

Port of ``zeekstd_tpu/parallel/pipeline.py``.

A mesh (``Mesh``, ``make_mesh``) is this process's devices times a
process group: global shard ``rank * n_local + i`` is local device i, the
host-major order of the reference's ``make_multihost_mesh``. An input of
N bytes is cut into ``frame_size`` frames (one empty frame for an empty
input), padded to a multiple of the mesh size, and laid out in contiguous
blocks of F_loc frames per shard, as the reference lays out its sharded
(F, frame_size) array.

Encode (``parallel_compress``): each local shard runs the single-device
pipeline (``archive.compress_archive``) over its own frame block on its
own device; a frame's bytes depend on that frame alone, so the archive
equals the single-device one byte for byte. The per-frame (c_size,
d_size) entries are then all-gathered over the group, and every process
builds the seek table from the gathered entries alone, the collective in
place of the reference's sequential ``log_frame`` writer
(lib/src/encode.rs:466-467, 743-775). With ``gather_bytes`` the frame rows
are gathered too, at a row width the processes agree on first.

Decode (``parallel_decompress``): frames are planned on every process,
each shard decodes its block in one fused dispatch per launch group
(``decode_routes.decode_planned``: the ring or wide decoder), or on the
doubling route (``ZEEKSTD_TPU_MESH_EXEC=doubling``, or past a fused-route
guard), and the decoded rows and sizes are all-gathered, so that every
process returns the whole result. Repeat offsets resolve in order on both
routes, so foreign archives need no per-frame redo.

Random access (``route_queries``, ``parallel_random_access``) routes
offsets to their frames and owning shards through the replicated seek
table and decodes only the touched frames, in one ``parallel_decompress``.

Phase spans, beside the ``enc.*`` and ``dec.*`` spans of the calls they
wrap: ``mesh.stage`` (each shard's slice of the input; its rows padded to
the agreed width on the collective's device), ``mesh.gather`` (the
encode's entry and row collectives and the pull of the archive bytes),
``mesh.decode_gather`` (the decode's row and size collectives, the pull,
and the size and checksum checks).
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from .. import archive as archive_mod
from .. import decode_routes
from .. import plan as plan_mod
from ..constants import DEFAULT_FRAME_SIZE
from ..device import phase_timer, resolve_device
from ..errors import ZeekstdError, corruption_detected
from ..seek_table import SeekTable

# Frames that left the mesh routes for a per-frame decode. The
# reference's doubling route redoes frames with cross-block repeat
# history there; the port's routes resolve them in place, so nothing
# increments it. Fused-route guard fallbacks to the doubling route are
# counted by ``decode_routes.serial_fallback_count``.
DECODE_FALLBACKS = {"frames": 0, "calls": 0}


class Mesh:
    """A 1-D frame mesh: ``devices``, this process's shards in order, in a
    process group of ``world`` processes that each bring as many devices
    (``group`` is None for a single process)."""

    def __init__(self, devices, axis: str, group, rank: int, world: int):
        self.devices = devices
        self.axis_names = (axis,)
        self.group = group
        self.rank = rank
        self.world = world

    @property
    def size(self) -> int:
        """The global shard count D."""
        return len(self.devices) * self.world

    def shards(self) -> range:
        """This process's global shard indices."""
        n = len(self.devices)
        return range(self.rank * n, (self.rank + 1) * n)

    def collective_device(self) -> torch.device:
        """Where a collective's tensors live: the card for NCCL, the CPU
        for gloo, this process's first device without a group."""
        if self.group is None or dist.get_backend(self.group) == "nccl":
            return self.devices[0]
        return torch.device("cpu")


def make_mesh(devices=None, axis: str = "data", group=None) -> Mesh:
    """1-D mesh over ``devices`` (default: the current CUDA device; raises
    with no card) in ``group`` (default: the default process group when
    one is initialised, else a single process). Every process of the
    group must bring the same number of devices."""
    devs = [resolve_device(d) for d in (devices if devices is not None else [None])]
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    if group is None:
        return Mesh(devs, axis, None, 0, 1)
    mesh = Mesh(devs, axis, group, dist.get_rank(group), dist.get_world_size(group))
    counts = _gather_rows(mesh, torch.tensor([len(devs)], dtype=torch.int64,
                                             device=mesh.collective_device()))
    if int(counts.min()) != int(counts.max()):
        raise ValueError(f"processes bring different device counts: {counts.tolist()}")
    return mesh


def _frame_layout(n: int, frame_size: int, n_devices: int):
    n_frames = max(-(-n // frame_size), 1)
    padded_frames = -(-n_frames // n_devices) * n_devices
    return n_frames, padded_frames


def _allmax(mesh: Mesh, value: int) -> int:
    """Global max of a host integer over the mesh's processes (identity
    for a single process): shapes of gathered tensors must agree."""
    if mesh.group is None:
        return int(value)
    t = torch.tensor([int(value)], dtype=torch.int64, device=mesh.collective_device())
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return int(t.item())


def _gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """All-gather ``local`` (rows of this process, on the collective's
    device, the same shape on every process) in rank order along dim 0;
    the local tensor itself for a single process."""
    if mesh.group is None:
        return local
    local = local.contiguous()
    out = torch.empty((mesh.world * local.shape[0],) + tuple(local.shape[1:]),
                      dtype=local.dtype, device=local.device)
    gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
    gather(out, local, group=mesh.group)
    return out


def parallel_parse_step(mesh: Mesh, frame_size: int, seq_bound: int, level: int = 3):
    """The mesh's parse + statistics step (dispatch 1 of the sharded
    compressor): ``step(frames, lengths)`` with ``frames`` uint8[F,
    frame_size], this process's rows (F_loc per local shard, in shard
    order), and ``lengths`` int[F]. Each shard's rows go through the
    parallel parse and its statistics (``archive._parse_stats_packed_fn``,
    the reachability kernels on the card) on the shard's device.

    Returns the reference's 18 outputs in its order, rows concatenated
    over the local shards on the mesh's first device: per frame adj_ll,
    mls, ovs, llc, mlc, ofc [seq_bound] (the reference pads these six
    with seq_bound zeros for its FSE job slices; the port's FSE staging
    needs no pad), lits [frame_size]; n_seq, n_lit,
    n_raw; per block seq_cnt, first_idx, ml_sum, litcnt [B]; ll_hist
    [B, 36], ml_hist [B, 53], of_hist [B, 32], lit_hist [B, 256]. The
    scalars and per-block rows are the packed statistics row unpacked
    (``archive._unpack_stats``), the codes those of
    ``archive._seq_codes``; values past a frame's n_seq (n_lit for lits)
    are not defined."""
    B = -(-frame_size // archive_mod.BLOCK_SIZE)
    n_local = len(mesh.devices)

    def step(frames, lengths):
        frames = torch.as_tensor(frames)
        lengths = np.asarray(lengths, np.int64)
        if frames.shape[0] % n_local or frames.shape[1] != frame_size:
            raise ValueError(f"frames {tuple(frames.shape)} do not split into "
                             f"{n_local} shards of {frame_size}-byte rows")
        F_loc = frames.shape[0] // n_local
        outs = []
        for i, dev in enumerate(mesh.devices):
            rows = slice(i * F_loc, (i + 1) * F_loc)
            lits, stats, adj_ll, mls, ovs = archive_mod._parse_stats_packed_fn(
                frames[rows].to(dev), lengths[rows], seq_bound, B, level)
            s = archive_mod._unpack_stats(stats, B)
            outs.append((adj_ll, mls, ovs, *archive_mod._seq_codes(adj_ll, mls, ovs), lits,
                         s["n_seq"], s["n_lit"], s["n_raw"], s["seq_cnt"], s["first_idx"],
                         s["ml_sum"], s["litcnt"], s["ll_hist"], s["ml_hist"], s["of_hist"],
                         s["lit_hist"]))
        return tuple(torch.cat([o[j].to(mesh.devices[0]) for o in outs]) for j in range(18))

    return step


def _encode_block(chunk: bytes, frame_size: int, checksum: bool, level: int, dev,
                  F_loc: int):
    """One shard's frames: (rows uint8[k, w] on ``dev``, c_sizes, d_sizes).
    An empty chunk is the empty input's one empty frame. The level-1 route
    is the reference's mesh rule: ``archive.match_route`` on ``F_loc``
    frames, the padded shard every shard shares, not the chunk's own."""
    if not chunk:
        blob = archive_mod.empty_frame(checksum)
        rows = torch.frombuffer(bytearray(blob), dtype=torch.uint8)[None].to(dev)
        return rows, [len(blob)], [0]
    rows, c_sizes, st = archive_mod.compress_archive(
        chunk, frame_size=frame_size, checksum=checksum, return_device=True, level=level,
        device=dev, _route_frames=F_loc)
    return rows, [int(c) for c in c_sizes], [st.frame_size_decomp(i) for i in range(st.num_frames)]


def parallel_compress(
    data: bytes,
    mesh: Mesh | None = None,
    frame_size: int = DEFAULT_FRAME_SIZE,
    checksum: bool = False,
    first_frame: int = 0,
    n_total: int | None = None,
    gather_bytes: bool = True,
    level: int = 3,
):
    """Data-parallel seekable compression over the mesh. Returns
    (archive_frames_bytes, SeekTable), the SeekTable built from the
    all-gathered per-frame entries (never from host-local sizes).

    Multi-process form (one call per process, the same arguments except
    the data slice): ``data`` covers only this process's frames, starting
    at global frame ``first_frame`` of a logical ``n_total``-byte input,
    and ``gather_bytes=False`` keeps the compressed rows local (only the
    entries are gathered). The return value is then (local_rows_list,
    first_frame, SeekTable), and each process writes its rows at the
    offsets the shared table implies (``multihost.host_write_plan``)."""
    if mesh is None:
        mesh = make_mesh()
    D = mesh.size
    n = len(data) if n_total is None else n_total
    n_frames, F_pad = _frame_layout(n, frame_size, D)
    F_loc = F_pad // D
    shards = mesh.shards()
    p_lo_f, p_hi_f = shards[0] * F_loc, (shards[-1] + 1) * F_loc
    if first_frame > p_lo_f or (n_total is not None and
                                first_frame + -(-len(data) // frame_size) <
                                min(p_hi_f, n_frames)):
        raise ValueError("data slice does not cover this process's frames")

    lengths = np.zeros(F_pad, np.int64)
    for i in range(n_frames):
        lengths[i] = min(frame_size, n - i * frame_size)

    # Each local shard encodes its own frame block; a padded shard owns
    # no frame and encodes nothing.
    blocks = []
    for g, dev in zip(shards, mesh.devices):
        lo, hi = g * F_loc, min((g + 1) * F_loc, n_frames)
        if lo >= hi:
            blocks.append(None)
            continue
        with phase_timer("mesh.stage"):
            start = (lo - first_frame) * frame_size
            chunk = data[start : start + int(lengths[lo:hi].sum())]
        blocks.append(_encode_block(chunk, frame_size, checksum, level, dev, F_loc))

    cdev = mesh.collective_device()
    n_rows = len(mesh.devices) * F_loc
    entries = np.zeros((n_rows, 2), np.int64)
    for i, blk in enumerate(blocks):
        if blk is not None:
            _rows, c_sizes, d_sizes = blk
            entries[i * F_loc : i * F_loc + len(c_sizes)] = np.stack([c_sizes, d_sizes], axis=1)

    with phase_timer("mesh.gather"):
        entries_all = _gather_rows(mesh, torch.from_numpy(entries).to(cdev)).cpu().numpy()
    st = SeekTable()
    for f in range(n_frames):
        st.log_frame(int(entries_all[f, 0]), int(entries_all[f, 1]))

    if not gather_bytes:
        local = []
        for blk in blocks:
            if blk is not None:
                rows = blk[0].cpu().numpy()
                local += [rows[r, :c].tobytes() for r, c in enumerate(blk[1])]
        return local, p_lo_f, st

    bound = _allmax(mesh, int(entries[:, 0].max()))
    with phase_timer("mesh.stage") as pt:
        buf = _pad_rows(blocks, F_loc, bound, cdev)
        pt.fence(buf)
    with phase_timer("mesh.gather"):
        rows_all = _gather_rows(mesh, buf).cpu().numpy()
        blob = b"".join(rows_all[f, : int(entries_all[f, 0])].tobytes() for f in range(n_frames))
    return blob, st


def _pad_rows(blocks, F_loc: int, width: int, cdev) -> torch.Tensor:
    """This process's shard rows uint8[n_local * F_loc, width] on the
    collective's device, each block ((rows, ...) or None) at its shard's
    offset, zero elsewhere."""
    buf = torch.zeros((len(blocks) * F_loc, width), dtype=torch.uint8, device=cdev)
    for i, blk in enumerate(blocks):
        if blk is not None:
            rows = blk[0]
            w = min(width, rows.shape[1])
            buf[i * F_loc : i * F_loc + rows.shape[0], :w] = rows[:, :w].to(cdev)
    return buf


def _decode_block(archive: bytes, plans, sub_table: SeekTable, dev):
    """One shard's frames on its device: the fused route (one dispatch per
    launch group) unless ``ZEEKSTD_TPU_MESH_EXEC=doubling`` or a
    fused-route guard sends them to the doubling route. Returns (rows
    uint8[k, w] on ``dev``, sizes)."""
    route = "doubling" if os.environ.get("ZEEKSTD_TPU_MESH_EXEC", "") == "doubling" else "fused"
    return decode_routes.decode_planned(
        archive, plans, plan_mod.collect(plans), dev, route=route, fallback="doubling",
        seek_table=sub_table, verify_checksum=False, return_device=True)


def parallel_decompress(archive: bytes, seek_table: SeekTable, mesh: Mesh | None = None,
                        frame_ids=None):
    """Mesh-sharded archive decode: the frames (or the subset
    ``frame_ids``) go to the shards in contiguous blocks; each shard
    decodes its block on its device, and the results are gathered, so
    every process returns the concatenated decompressed bytes (or, with
    ``frame_ids``, a dict frame_id -> bytes). A frame that fails its
    checks on any process raises ``corruption_detected`` on every process
    (a checksum mismatch ``checksum_wrong``)."""
    if mesh is None:
        mesh = make_mesh()
    all_ids = frame_ids is None
    if all_ids:
        frame_ids = [
            i for i in range(seek_table.num_frames)
            if seek_table.frame_size_decomp(i) > 0
            or seek_table.frame_end_comp(i) > seek_table.frame_start_comp(i)
        ]
    if not frame_ids:
        return b"" if all_ids else {}

    with phase_timer("dec.plan"):
        plans = []
        for i in frame_ids:
            start = seek_table.frame_start_comp(i)
            hdr_i, plan_i, fpos_i = plan_mod._plan_frame(archive, start)
            # Each frame must consume exactly its seek-table extent (a
            # flipped checksum-flag bit otherwise skips verification).
            consumed = fpos_i + (4 if hdr_i.has_checksum else 0)
            if consumed != seek_table.frame_end_comp(i):
                raise corruption_detected(
                    f"frame {i} consumed {consumed - start} bytes; seek table "
                    f"records {seek_table.frame_size_comp(i)}"
                )
            plans.append((hdr_i, plan_i, fpos_i))

    F = len(plans)
    F_loc = -(-F // mesh.size)
    blocks, failed = [], None
    try:
        for g, dev in zip(mesh.shards(), mesh.devices):
            lo, hi = g * F_loc, min((g + 1) * F_loc, F)
            if lo >= hi:
                blocks.append(None)
                continue
            sub_table = SeekTable.from_frames(
                (seek_table.frame_size_comp(i), seek_table.frame_size_decomp(i))
                for i in frame_ids[lo:hi])
            blocks.append(_decode_block(archive, plans[lo:hi], sub_table, dev))
    except ZeekstdError as e:
        failed = e
    # Every process learns of a failure before any waits in a gather.
    if _allmax(mesh, failed is not None):
        raise failed or corruption_detected("a frame failed to decode on another process")

    cdev = mesh.collective_device()
    with phase_timer("mesh.decode_gather") as pt:
        sizes = np.zeros(len(mesh.devices) * F_loc, np.int64)
        for i, blk in enumerate(blocks):
            if blk is not None:
                sizes[i * F_loc : i * F_loc + len(blk[1])] = blk[1]
        width = _allmax(mesh, max(int(sizes.max()), 1))
        rows_all = _gather_rows(mesh, _pad_rows(blocks, F_loc, width, cdev))
        sizes_all = _gather_rows(mesh, torch.from_numpy(sizes).to(cdev))
        pt.fence(rows_all)
        rows_all, sizes_all = rows_all.cpu().numpy(), sizes_all.cpu().numpy()
        results = {}
        for slot, fid in enumerate(frame_ids):
            hdr, _p, cpos = plans[slot]
            total = int(sizes_all[slot])
            if total != seek_table.frame_size_decomp(fid):
                raise corruption_detected("frame size disagrees with seek table")
            result = rows_all[slot, :total].tobytes()
            plan_mod.check_checksum(archive, hdr, cpos, result)
            results[fid] = result
    if all_ids:
        return b"".join(results[i] for i in frame_ids)
    return results


def route_queries(seek_table: SeekTable, queries, mesh: Mesh | None = None):
    """Map random-access queries to owning frames and shards (reference
    analog: frame_index binary search, lib/src/seek_table.rs:916-934,
    distributed).

    ``queries``: int array of decompressed byte offsets. Returns
    (frame_indices, owner_shards): the frame containing each offset and
    the shard holding it under the contiguous frame blocks of
    ``parallel_compress``. The search runs on the mesh's first device."""
    dev = mesh.devices[0] if mesh is not None else resolve_device(None)
    _c_off, d_off = seek_table.cumulative_offsets()
    d = torch.from_numpy(d_off.astype(np.int64)).to(dev)
    q = torch.from_numpy(np.asarray(queries, dtype=np.int64)).to(dev)
    idx = torch.clamp(torch.searchsorted(d, q, right=True) - 1, 0,
                      seek_table.num_frames - 1)
    n_dev = mesh.size if mesh is not None else 1
    frames_per_dev = -(-seek_table.num_frames // max(n_dev, 1))
    owners = idx // max(frames_per_dev, 1)
    return idx.cpu().numpy(), owners.cpu().numpy()


def parallel_random_access(archive: bytes, seek_table: SeekTable, ranges,
                           mesh: Mesh | None = None):
    """Serve (offset, limit) random-access queries: the frames any range
    touches are decoded in ONE ``parallel_decompress`` (sharded by owner),
    then sliced."""
    if mesh is None:
        mesh = make_mesh()

    need = set()
    for lo, hi in ranges:
        pos = lo
        while pos < hi:
            idx = seek_table.frame_index_decomp(pos)
            f_end = seek_table.frame_end_decomp(idx)
            need.add(idx)
            pos = max(f_end, pos + 1)
    frame_ids = sorted(need)
    decoded = parallel_decompress(archive, seek_table, mesh, frame_ids=frame_ids)

    results = []
    for lo, hi in ranges:
        out = []
        pos = lo
        while pos < hi:
            idx = seek_table.frame_index_decomp(pos)
            f_start = seek_table.frame_start_decomp(idx)
            f_end = seek_table.frame_end_decomp(idx)
            take = min(hi, f_end) - pos
            out.append(decoded[idx][pos - f_start : pos - f_start + take])
            pos += take
        results.append(b"".join(out))
    return results
