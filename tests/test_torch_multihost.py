"""PyTorch port: the multi-process layer (``zeekstd_tpu_torch.parallel.
multihost``), mirroring ``tests/test_multihost.py``.

The single-process cases run the code paths a process of a group runs:
the host-major mesh, process frame spans, process-local staging through
``parallel_compress``'s first_frame / gather_bytes form, and the write
plan. The two-process case runs ``tests/torch_mh_worker.py`` twice, a
gloo group over a free localhost port with 4 CPU devices each: the
stitched archive must equal the JAX package's single-process
``multihost_compress`` bytes, both processes' seek tables must be equal,
and both must decode the whole corpus, which the reference's fused mesh
decode cannot do across processes (``pipeline.py:1089``). No process
group is initialised in the test process itself.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from zeekstd_tpu.parallel import host_write_plan as ref_host_write_plan  # noqa: E402
from zeekstd_tpu.parallel import multihost_compress as ref_multihost_compress  # noqa: E402

import zeekstd_tpu_torch as zt  # noqa: E402
from zeekstd_tpu_torch.parallel import (  # noqa: E402
    host_write_plan,
    init_multihost,
    make_multihost_mesh,
    multihost_compress,
    process_frame_slice,
)
from zeekstd_tpu_torch.parallel.pipeline import make_mesh, parallel_compress  # noqa: E402

from .torch_threads import two_torch_threads  # noqa: F401

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_mh_worker.py")
TIMEOUT_S = 180


def _corpus(n):
    rng = np.random.default_rng(7)
    words = [rng.bytes(rng.integers(3, 9)) for _ in range(50)]
    out = bytearray()
    while len(out) < n:
        out += words[int(rng.integers(0, 50))]
    return bytes(out[:n])


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(["cpu"] * 8)


def test_init_multihost_single_process():
    assert init_multihost() == 0


def test_multihost_mesh_host_major():
    mesh = make_multihost_mesh(devices=["cpu"] * 4)
    assert list(mesh.shards()) == [0, 1, 2, 3]
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert mesh.axis_names == ("data",)


def test_process_frame_slice_covers_all():
    mesh = make_multihost_mesh(devices=["cpu"] * 8)
    # single process: owns everything
    assert process_frame_slice(16, mesh) == (0, 16)


def test_write_plan_offsets_and_table():
    c = [10, 20, 30, 40]
    d = [100, 100, 100, 50]
    start, plan, st = host_write_plan(c, d, first_frame=2, n_local=2)
    assert start == 30
    assert plan == [(30, 30), (60, 40)]
    assert st.num_frames == 4
    assert st.frame_size_comp(3) == 40
    assert st.frame_size_decomp(3) == 50
    ref_start, ref_plan, ref_st = ref_host_write_plan(c, d, first_frame=2, n_local=2)
    assert (start, plan, st.to_bytes()) == (ref_start, ref_plan, ref_st.to_bytes())


def test_multihost_compress_matches_parallel(mesh):
    data = _corpus(96 << 10)
    fs = 16 << 10
    blob_ref, st_ref = parallel_compress(data, mesh, frame_size=fs)

    rows, plan, st = multihost_compress(data, frame_size=fs, mesh=mesh)
    # Reassemble via the write plan: must equal the gathered blob.
    out = bytearray(sum(p[1] for p in plan))
    for row, (off, sz) in zip(rows, plan):
        assert len(row) == sz
        out[off : off + sz] = row
    assert bytes(out) == blob_ref
    assert st.to_bytes() == st_ref.to_bytes()


def test_parallel_compress_slice_contract(mesh):
    # A data slice that does not cover the process's frames must be
    # rejected (the multi-process misuse case).
    data = _corpus(64 << 10)
    with pytest.raises(ValueError):
        parallel_compress(
            data[: 16 << 10], mesh, frame_size=8 << 10,
            first_frame=0, n_total=64 << 10, gather_bytes=False,
        )


def test_gather_bytes_false_returns_local_rows(mesh):
    data = _corpus(64 << 10)
    fs = 8 << 10
    blob_ref, st_ref = parallel_compress(data, mesh, frame_size=fs)
    rows, first_row, st = parallel_compress(data, mesh, frame_size=fs, gather_bytes=False)
    assert first_row == 0
    assert b"".join(rows) == blob_ref
    assert st.to_bytes() == st_ref.to_bytes()


def test_two_process_multihost_compress(tmp_path):
    """Two OS processes, a gloo group, 4 CPU devices each: each encodes
    only its frames; the parent stitches the parts by the write plan and
    holds them to the JAX package's single-process encode; both processes
    decode the whole archive they wrote into one file by the plan."""
    s = socket.socket()
    try:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    finally:
        s.close()
    procs = [
        subprocess.Popen([sys.executable, WORKER, str(i), "2", str(port), str(tmp_path)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(2)
    ]
    # The JAX package's single-process encode runs while the workers do.
    data = _corpus(120 << 10)
    ref_rows, _plan, ref_st = ref_multihost_compress(
        data, first_frame=0, n_total=len(data), frame_size=16 << 10, level=1)
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    except subprocess.TimeoutExpired:
        pytest.fail(f"the two workers did not finish within {TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"worker {i} failed:\n{outs[i]}"

    metas = [json.loads((tmp_path / f"meta{i}.json").read_text()) for i in range(2)]
    parts = [(tmp_path / f"part{i}.bin").read_bytes() for i in range(2)]
    sts = [(tmp_path / f"st{i}.bin").read_bytes() for i in range(2)]
    assert sts[0] == sts[1], "processes built different seek tables"
    assert [m["first_frame"] for m in metas] == [0, 4]

    total = max(off + sz for m in metas for off, sz in m["plan"])
    stitched = bytearray(total)
    for m, part in zip(metas, parts):
        pos = 0
        for off, sz in m["plan"]:
            stitched[off : off + sz] = part[pos : pos + sz]
            pos += sz
        assert pos == len(part)
    assert (tmp_path / "archive.bin").read_bytes() == bytes(stitched)

    assert bytes(stitched) == b"".join(ref_rows), "stitched archive != the JAX package's"
    assert ref_st.to_bytes() == sts[0], "seek table != the JAX package's"

    # Both processes got the whole corpus back, and the same ranges.
    assert all(m["decoded_whole"] and m["ranges_ok"] for m in metas), outs
    assert metas[0]["decoded_sha"] == metas[1]["decoded_sha"]
    assert metas[0]["ranges_sha"] == metas[1]["ranges_sha"]
    full = bytes(stitched) + sts[0]
    assert zt.DecodeOptions(zt.BytesWrapper(full)).into_decoder().read(-1) == data
