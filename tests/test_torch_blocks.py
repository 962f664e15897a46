"""PyTorch port: the archive block size (``ZEEKSTD_TPU_BLOCK``) against the
JAX package, on the CPU.

Both packages read the variable once, at import, so each block size of
``tests/block_cases.py`` (16, 64 and 128 KiB) runs in a child process of
its own that writes the JAX package's archives (``tpu_compress_archive``
on its match-kernel route at level 1, ``ZEEKSTD_TPU_MATCH=kernel``) and
the port's (``device="cpu"``) of the text and long-run inputs at levels 1
and 3. Then:

- the port's archive equals the JAX package's wherever libzstd accepts
  the latter, and libzstd, the JAX package's host ``DCtx`` and the port's
  ring, wide, serial and doubling routes decode every port archive, with
  no fused-route guard hand-off;
- two faults of the reference are shown, not copied: its FSE kernel
  stores stream word w at (w >> 12, w & 4095) of an (8, WBo / 8) block,
  right only at 32 KiB blocks (text at 128 KiB), and its match kernel
  packs ml into 16 bits (a 64 KiB match on the long-run input at 64 KiB);
  libzstd rejects those JAX archives and reads the port's;
- the port in this process, its ``BLOCK_SIZE`` patched, writes the child's
  archives, the mesh on 8 CPU shards equals ``compress_archive``, and the
  streaming Encoder and Decoder on the tpu backend follow it;
- up to 32 KiB the FSE job rows stay packed, above they are wide;
- block sizes the reference cannot run fail in the port as they fail
  there, with the same error type.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from zeekstd_tpu.codec.decompress import DCtx as RefDCtx  # noqa: E402
from zeekstd_tpu.ops import fse_kernel as ref_fk  # noqa: E402
from zeekstd_tpu.ops import match_kernel as ref_mk  # noqa: E402

from zeekstd_tpu_torch import archive, decode_routes  # noqa: E402
from zeekstd_tpu_torch.ops import fse_kernel as fk  # noqa: E402
from zeekstd_tpu_torch.ops import match_kernel as mk  # noqa: E402
from zeekstd_tpu_torch.parallel import make_mesh, parallel_compress  # noqa: E402

from . import match_edges  # noqa: E402
from .block_cases import BLOCKS, FRAME, INPUTS, LEVELS, word_text  # noqa: E402
from .oracle import zstd_decompress  # noqa: E402
from .torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = [(b, name, lv) for b in BLOCKS for name in INPUTS for lv in LEVELS]
ROUTES = {"ring": {}, "wide": {"ZEEKSTD_TPU_RING": "0"},
          "serial": {"ZEEKSTD_TPU_EXEC": "serial"}, "doubling": {"ZEEKSTD_TPU_EXEC": "doubling"}}

# One child per block size: both packages' archives of every case.
WRITER = """
import os, pickle, sys
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import torch
torch.set_num_threads(2)
from zeekstd_tpu.tpu_archive import tpu_compress_archive, BLOCK_SIZE as REF_BLOCK
from zeekstd_tpu_torch import archive
from tests.block_cases import FRAME, INPUTS, LEVELS
out = {{"blocks": (REF_BLOCK, archive.BLOCK_SIZE)}}
for name, data in INPUTS.items():
    for level in LEVELS:
        out["ref", name, level] = tpu_compress_archive(data, frame_size=FRAME, level=level)[0]
        out["port", name, level] = archive.compress_archive(
            data, frame_size=FRAME, level=level, device="cpu")[0]
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


def _children(runs, tmp_path):
    """Run each (script, env) of ``runs`` in a child, all at once; returns
    {key: (returncode, stdout, stderr, path of the child's output file)}."""
    procs = {}
    for i, (name, (script, env)) in enumerate(runs.items()):
        path = str(tmp_path / f"{i}.pkl")
        procs[name] = (subprocess.Popen(
            [sys.executable, "-c", script.format(root=ROOT), path], cwd=ROOT, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            env=dict(os.environ, ZEEKSTD_TPU_MATCH="kernel", **env)), path)
    out = {}
    for name, (proc, path) in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        out[name] = (proc.returncode, stdout, stderr, path)
    return out


@pytest.fixture(scope="module")
def children(tmp_path_factory):
    """Every child of the module, started together: {("block", b): the
    archives of block size b, both packages per case; ("odd", case): what
    each package did with the ``ODD`` case}."""
    runs = {("block", b): (WRITER, {"ZEEKSTD_TPU_BLOCK": str(b)}) for b in BLOCKS}
    runs.update({("odd", k): (ODD_SCRIPT, {"ZEEKSTD_TPU_BLOCK": v}) for k, v in ODD.items()})
    done = _children(runs, tmp_path_factory.mktemp("blocks"))
    out = {}
    for key, (rc, _stdout, stderr, path) in done.items():
        assert rc == 0, (key, stderr[-3000:])
        with open(path, "rb") as fh:
            out[key] = pickle.load(fh)
    return out


@pytest.fixture(scope="module")
def written(children):
    """{block: the child's archives}, both packages per case."""
    out = {b: children["block", b] for b in BLOCKS}
    for b in BLOCKS:
        assert out[b]["blocks"] == (b, b)
    return out


def _libzstd_reads(blob, data) -> bool:
    try:
        return zstd_decompress(blob) == data
    except Exception:
        return False


@pytest.fixture
def block(monkeypatch):
    """Patch the port's block size in this process (its functions read
    ``archive.BLOCK_SIZE`` at each call)."""
    return lambda b: monkeypatch.setattr(archive, "BLOCK_SIZE", b)


@pytest.mark.parametrize("b,name,level", CASES)
def test_archive_equals_reference_where_libzstd_reads_it(written, b, name, level):
    data = INPUTS[name]
    ref, port = written[b]["ref", name, level], written[b]["port", name, level]
    assert _libzstd_reads(port, data)
    if _libzstd_reads(ref, data):
        assert port == ref
    else:
        # Only the reference's two level-1 faults (the tests below) fail.
        assert (level, b) in ((1, 64 << 10), (1, 128 << 10)), (b, name, level)


@pytest.mark.parametrize("b,name,level", CASES)
def test_every_decoder_reads_the_port_archive(written, b, name, level, monkeypatch):
    data = INPUTS[name]
    blob = written[b]["port", name, level]
    assert zstd_decompress(blob) == data
    assert RefDCtx().decompress_frame(blob)[0] == data
    n0 = decode_routes.serial_fallback_count()
    for route, env in ROUTES.items():
        for var in ("ZEEKSTD_TPU_RING", "ZEEKSTD_TPU_EXEC"):
            monkeypatch.delenv(var, raising=False)
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        assert archive.decompress_archive(blob, device="cpu") == data, route
    assert decode_routes.serial_fallback_count() == n0


@pytest.mark.parametrize("b", BLOCKS)
def test_patched_block_size_writes_the_child_archives(written, block, b):
    block(b)
    for name, data in INPUTS.items():
        for level in LEVELS:
            blob, _st = archive.compress_archive(data, frame_size=FRAME, level=level,
                                                 device="cpu")
            assert blob == written[b]["port", name, level], (name, level)


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("b", BLOCKS)
def test_mesh_equals_compress_archive(block, b, level):
    """One frame per block: 16, 4 or 2 frames over the 8 shards."""
    block(b)
    data = INPUTS["text"]
    blob, st = archive.compress_archive(data, frame_size=b, level=level, device="cpu")
    mblob, mst = parallel_compress(data, make_mesh(["cpu"] * 8), frame_size=b, level=level)
    assert mblob == blob
    assert mst.to_bytes() == st.to_bytes()


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("b", BLOCKS[1:])
def test_streaming_encoder_and_decoder_follow_the_block_size(block, b, level):
    """The Encoder's tpu backend writes ``compress_archive``'s archive and
    Foot table at the patched block size, and the Decoder's tpu backend
    reads it back."""
    import io

    import zeekstd_tpu_torch as zt

    block(b)
    data = INPUTS["long_run"]
    buf = io.BytesIO()
    enc = (zt.EncodeOptions().with_backend("tpu").with_device("cpu")
           .with_frame_size_policy(zt.FrameSizePolicy.uncompressed(b))
           .with_compression_level(level).with_checksum_flag(True).into_encoder(buf))
    for i in range(0, len(data), 100_000):
        enc.write(data[i : i + 100_000])
    enc.finish()
    blob, st = archive.compress_archive(data, frame_size=b, level=level, checksum=True,
                                        device="cpu")
    assert buf.getvalue() == blob + st.to_bytes()
    dec = (zt.DecodeOptions(zt.BytesWrapper(buf.getvalue())).with_backend("tpu")
           .with_device("cpu").into_decoder())
    assert dec.read(-1) == data


def test_reference_fault_fse_word_store(written, block):
    """At 128 KiB the reference's level-1 archive of the text is rejected:
    its FSE kernel stores stream word w at (w >> 12, w & 4095) of an
    (8, WBo / 8) block (``zeekstd_tpu/ops/fse_kernel.py:174, 236``), which
    is word w only where WBo / 8 = 4096 (32 KiB blocks). Here the port's
    FSE job rows, packed, through the reference kernel: every word below
    4096 agrees with the port's, the words from 4096 on do not."""
    b, data = 128 << 10, INPUTS["text"]
    assert not _libzstd_reads(written[b]["ref", "text", 1], data)
    assert zstd_decompress(written[b]["port", "text", 1]) == data
    block(b)
    calls = []

    def record(*a, **k):
        calls.append((a, k))
        return fse_encode(*a, **k)

    fse_encode = fk.fse_encode
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "fse_encode", record)
        archive.compress_archive(data, frame_size=FRAME, level=1, device="cpu")
    (consts, meta, ll, ofv, pool), k = calls[0]
    lm = (ll.long() << 16 | k["ml"].long()).to(torch.int32)
    words, bits = fk.fse_plain(consts, meta, lm, ofv, pool, k["SBd"], k["WBo"])
    kern = ref_fk.get_fse_kernel(k["SBd"], k["WBo"], meta.shape[0], interpret=True)
    rw, rb = (np.asarray(x) for x in kern(*(jnp.asarray(t.numpy()) for t in
                                            (consts, meta, lm.reshape(-1), ofv.reshape(-1),
                                             pool))))
    assert np.array_equal(rb, bits.numpy())
    words = words.numpy().view(np.uint32)
    long_jobs = 0
    for j, nb in enumerate(bits.tolist()):
        if not nb:
            continue  # a padding job: nothing written
        nw = nb // 32 + 1
        assert np.array_equal(rw[j, : min(nw, 4096)], words[j, : min(nw, 4096)])
        if nw > 4096:
            long_jobs += 1
            assert not np.array_equal(rw[j, 4096:nw], words[j, 4096:nw])
    assert long_jobs > 0


def test_reference_fault_packed_match_length(written):
    """At 64 KiB the reference's level-1 archive of the long-run input is
    rejected: the 90 kB repeat covers block 2, whose match of 65,536 bytes
    its match kernel packs as ``ll << 16 | ml``
    (``zeekstd_tpu/ops/match_kernel.py:458``), which reads back as ll + 1
    and ml = 0. The port's wide rows carry ll = 0, ml = 65,536."""
    b, data = 64 << 10, INPUTS["long_run"]
    assert not _libzstd_reads(written[b]["ref", "long_run", 1], data)
    assert zstd_decompress(written[b]["port", "long_run", 1]) == data
    rows, lengths = match_edges._frames([data], FRAME)
    meta, words = match_edges.match_inputs(rows, lengths, b)
    consts = fk.make_consts()
    ll, ofv, _litw, stat, ml = mk.match(*(torch.from_numpy(x) for x in (consts, meta, words)),
                                        BLK=b, SBd=b // 4, n_frames=1)
    assert mk.wide_rows(b)
    r, j = 2, 0
    assert (int(ll[r, j]), int(ml[r, j])) == (0, 65536)
    kern = ref_mk.get_match_kernel(b, b // 4, meta.shape[0], interpret=True)
    rlm, _rofv, _rlitw, rstat = (np.asarray(x) for x in kern(
        jnp.asarray(consts), jnp.asarray(meta), jnp.asarray(words)))
    # The counters agree (the code histograms do not: the reference's row
    # of block 2 reads ml = 0).
    assert np.array_equal(rstat[:4, :5], stat.numpy()[:4, :5])
    assert (int(rlm[r, j]) >> 16, int(rlm[r, j]) & 0xFFFF) == (1, 0)


def test_rows_stay_packed_up_to_32_kib(block):
    """The default block keeps the packed record and the FSE kernel's
    packed instance; 64 KiB blocks take the wide layout."""
    data = word_text(96 << 10)
    seen = {}

    def record(*a, **k):
        seen[archive.BLOCK_SIZE] = k.get("ml")
        return fse_encode(*a, **k)

    fse_encode = fk.fse_encode
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fk, "fse_encode", record)
        for b in (32 << 10, 64 << 10):
            block(b)
            for level in LEVELS:
                archive.compress_archive(data, frame_size=64 << 10, level=level, device="cpu")
                assert (seen.pop(b) is None) == (b == 32 << 10), (b, level)
    assert not mk.wide_rows(32 << 10) and mk.wide_rows(36 << 10)


# Sizes the reference cannot run (and one it can, 12288, a multiple of 4 KiB
# that divides the 36 KiB frames): each child runs both packages on 40 kB
# at level 1 in 36 KiB and 64,000-byte frames (the match-kernel route for
# a size that divides the frame, the parse's otherwise) and at level 3,
# and keeps what each did.
ODD = {"zero": "0", "negative": "-4096", "not_4k": "4000", "over_128k": "262144",
       "not_a_number": "abc", "12k": "12288"}
ODD_SCRIPT = """
import os, pickle, sys
sys.path.insert(0, {root!r})
import jax
jax.config.update("jax_platforms", "cpu")
import torch
torch.set_num_threads(2)
from tests.block_cases import word_text

def outcome(fn):
    try:
        return fn()[0]
    except BaseException as e:
        return type(e).__name__

data = word_text(40_000)
runs = [(1, 36 << 10), (1, 64000), (3, 1 << 15)]
out = {{}}
for pkg in ("ref", "port"):
    try:
        if pkg == "ref":
            from zeekstd_tpu.tpu_archive import tpu_compress_archive as fn
        else:
            from zeekstd_tpu_torch import archive
            fn = lambda d, **k: archive.compress_archive(d, device="cpu", **k)
    except BaseException as e:
        out[pkg] = type(e).__name__
        continue
    out[pkg] = [outcome(lambda: fn(data, frame_size=fs, level=lv)) for lv, fs in runs]
with open(sys.argv[1], "wb") as fh:
    pickle.dump(out, fh)
"""


@pytest.mark.parametrize("case", list(ODD))
def test_odd_block_sizes_fail_as_the_reference_fails(children, case):
    """The same archive or the same error type, run by run (an import that
    fails gives one error type for the whole child)."""
    got = children["odd", case]
    assert got["port"] == got["ref"]
    if case == "12k":
        assert all(isinstance(x, bytes) for x in got["port"])
