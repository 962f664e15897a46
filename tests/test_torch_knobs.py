"""PyTorch port: the reference's route switches against the JAX package, on
the CPU.

- ``ZEEKSTD_TPU_MATCH`` (read per call): under ``=xla`` level 1 parses
  with the parallel parse instead of the match kernel, and the port's
  archives and seek tables equal ``tpu_compress_archive``'s under the
  same setting (the word text of ``tests/test_exec_kernel.py`` in 64 KiB
  frames, two blocks each; the mixed input in 32 and 64 KiB frames; with
  checksums on and off). Unset and ``=kernel`` keep the match kernel and
  equal the reference under ``=kernel``. libzstd and the port's fused,
  serial and doubling routes read every ``=xla`` archive, and the
  kernel's archive is at most 1.05 times the parse's, as the reference's
  own test asks. The mesh (8 CPU shards, the route decided on the padded
  shard as the reference's mesh decides it), the ``tpu`` Encoder and the
  CLI follow the switch.
- ``ZEEKSTD_TPU_REACH``: the reference's ``=xla`` takes pointer
  doubling instead of its reach kernels and changes no byte; the port
  ignores the variable and its archives equal the reference's under
  either setting. ``greedy_reachability``'s two branches (the chunked
  kernels, pointer doubling) each equal the JAX function.
- ``ZEEKSTD_TPU_TIMING`` (read at import): one JAX-free child per value
  takes the reference's timing modes and records the encode's phases
  only under ``1`` and ``2``; ``set_timing(0)`` turns them off again.

Each JAX reference is computed once for the module.
"""

import contextlib
import importlib.util
import io
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import zeekstd_tpu as zr  # noqa: E402
from zeekstd_tpu import parallel as ref_par  # noqa: E402
from zeekstd_tpu.cli import main as ref_cli  # noqa: E402
from zeekstd_tpu.ops import match_tpu as ref_mt  # noqa: E402
from zeekstd_tpu.tpu_archive import tpu_compress_archive  # noqa: E402

import zeekstd_tpu_torch as zt  # noqa: E402
from zeekstd_tpu_torch import archive  # noqa: E402
from zeekstd_tpu_torch.cli import main as port_cli  # noqa: E402
from zeekstd_tpu_torch.ops import match_kernel as mk  # noqa: E402
from zeekstd_tpu_torch.ops import match_tpu as mt  # noqa: E402
from zeekstd_tpu_torch.parallel import make_mesh, parallel_compress  # noqa: E402

from .block_cases import mixed_input  # noqa: E402
from .oracle import zstd_decompress  # noqa: E402
from .torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KIB = 1 << 10


def _word_text() -> bytes:
    """``tests/test_exec_kernel.py::test_match_kernel_encode_roundtrip``'s
    input: 75,535 bytes of words, two 64 KiB frames of two blocks."""
    rng = np.random.default_rng(5)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(200)]
    return b" ".join(words[rng.integers(0, 200)] for _ in range(9000))[:65536 + 9999]


INPUTS = {"text": _word_text(), "mixed": mixed_input(96 * KIB)}
CASES = [("text", 64 * KIB), ("mixed", 32 * KIB), ("mixed", 64 * KIB)]
CASE_IDS = [f"{name}-{fs >> 10}k" for name, fs in CASES]
CHECKSUMS = [False, True]
MODES = {"xla": "xla", "kernel": "kernel", "unset": None}
ROUTES = {"fused": None, "serial": "serial", "doubling": "doubling"}


@contextlib.contextmanager
def _env(**values):
    """Each variable set (or unset, for None) inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        for name, value in values.items():
            if value is None:
                mp.delenv(name, raising=False)
            else:
                mp.setenv(name, value)
        yield


@pytest.fixture(scope="module")
def ref():
    """{(mode, input, frame size, checksum): (blob, seek table bytes)} of
    ``tpu_compress_archive`` at level 1, mode ``xla`` or ``kernel``."""
    out = {}
    for mode in ("xla", "kernel"):
        with _env(ZEEKSTD_TPU_MATCH=mode):
            for name, fs in CASES:
                for ck in CHECKSUMS:
                    blob, st = tpu_compress_archive(INPUTS[name], frame_size=fs, level=1,
                                                    checksum=ck)
                    out[mode, name, fs, ck] = (blob, st.to_bytes())
    return out


@pytest.fixture(scope="module")
def port():
    """The port's archives as ``ref``'s, under each of MODES, with the
    match kernel's calls counted per mode."""
    out, calls = {}, {m: 0 for m in MODES}
    real = mk.match

    for mode, value in MODES.items():
        def counted(*a, _mode=mode, **k):
            calls[_mode] += 1
            return real(*a, **k)

        with _env(ZEEKSTD_TPU_MATCH=value), pytest.MonkeyPatch.context() as mp:
            mp.setattr(mk, "match", counted)
            for name, fs in CASES:
                for ck in CHECKSUMS:
                    blob, st = archive.compress_archive(INPUTS[name], frame_size=fs, level=1,
                                                        checksum=ck, device="cpu")
                    out[mode, name, fs, ck] = (blob, st.to_bytes())
    out["match_calls"] = calls
    return out


@pytest.mark.parametrize("checksum", CHECKSUMS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_xla_archive_equals_reference(ref, port, case, checksum):
    assert port["xla", *case, checksum] == ref["xla", *case, checksum]


@pytest.mark.parametrize("mode", ["kernel", "unset"])
@pytest.mark.parametrize("checksum", CHECKSUMS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_and_unset_archives_equal_reference_kernel(ref, port, case, checksum, mode):
    assert port[mode, *case, checksum] == ref["kernel", *case, checksum]


def test_xla_route_never_calls_the_match_kernel(port, ref):
    """``=xla`` parses without the match kernel; unset and ``=kernel``
    call it once per archive, and their archives differ from ``=xla``'s."""
    n = len(CASES) * len(CHECKSUMS)
    assert port["match_calls"] == {"xla": 0, "kernel": n, "unset": n}
    assert all(ref["xla", *c, ck][0] != ref["kernel", *c, ck][0]
               for c in CASES for ck in CHECKSUMS)


@pytest.mark.parametrize("checksum", CHECKSUMS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_libzstd_reads_the_xla_archive(port, case, checksum):
    name, fs = case
    blob, st_bytes = port["xla", *case, checksum]
    st = zt.SeekTable.from_bytes(st_bytes)
    parts = [zstd_decompress(blob[st.frame_start_comp(i) : st.frame_end_comp(i)],
                             st.frame_size_decomp(i)) for i in range(st.num_frames)]
    assert b"".join(parts) == INPUTS[name]


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("checksum", CHECKSUMS)
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_port_routes_decode_the_xla_archive(port, case, checksum, route):
    name, fs = case
    blob, st_bytes = port["xla", *case, checksum]
    with _env(ZEEKSTD_TPU_EXEC=ROUTES[route]):
        got = archive.decompress_archive(blob, zt.SeekTable.from_bytes(st_bytes), device="cpu")
    assert got == INPUTS[name]


@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_kernel_archive_within_5_percent_of_the_parse(port, case):
    """The reference's bound (``test_exec_kernel.py``): the match kernel's
    archive is at most 1.05 times the parallel parse's."""
    kernel, xla = port["kernel", *case, False][0], port["xla", *case, False][0]
    assert len(kernel) <= len(xla) * 1.05, (len(kernel), len(xla))


def _reference_rule(mode, level, frame_size, n_frames, prefix_len, backend):
    """``tpu_archive.py:900-910`` (``prefix_len`` 0 is
    ``parallel/pipeline.py:498-507``, with ``n_frames`` its F_loc)."""
    return (level == 1 and frame_size % archive.BLOCK_SIZE == 0
            and frame_size <= (8 << 20) and n_frames * frame_size < (1 << 31)
            and prefix_len == 0
            and (mode == "kernel" or (mode != "xla" and backend == "tpu")))


@pytest.mark.parametrize("mode", [None, "kernel", "xla", "other"])
def test_match_route_is_the_reference_rule_on_its_tpu(mode):
    """``archive.match_route`` is the reference's rule with the card in its
    TPU backend's place, the variable read at each call."""
    grid = [(lv, fs, nf, pl) for lv in (1, 3)
            for fs in (32 * KIB, 48 * KIB, 1 << 20, 8 << 20, 16 << 20)
            for nf in (1, 255, 256, 2047, 2048) for pl in (0, 32 * KIB)]
    with _env(ZEEKSTD_TPU_MATCH=mode):
        got = [archive.match_route(*g) for g in grid]
    assert got == [_reference_rule(mode or "", *g, "tpu") for g in grid]
    assert any(got) == (mode != "xla")


def test_mesh_route_reads_the_padded_shard(monkeypatch):
    """Three frames on two shards: each shard's route is read on F_loc = 2
    frames, the reference mesh's one decision, also for the shard that
    holds one frame."""
    seen = []
    real = archive.match_route

    def spy(level, frame_size, n_frames, prefix_len=0):
        seen.append(n_frames)
        return real(level, frame_size, n_frames, prefix_len)

    monkeypatch.setattr(archive, "match_route", spy)
    data = INPUTS["mixed"]
    blob, st = parallel_compress(data, make_mesh(["cpu"] * 2), frame_size=32 * KIB, level=1)
    assert seen == [2, 2]
    assert archive.decompress_archive(blob, st, device="cpu") == data


@pytest.mark.parametrize("checksum", CHECKSUMS)
def test_mesh_xla_archive_equals_reference(checksum):
    data = INPUTS["mixed"]
    with _env(ZEEKSTD_TPU_MATCH="xla"):
        want_blob, want_st = ref_par.parallel_compress(data, ref_par.make_mesh(),
                                                       frame_size=32 * KIB, level=1,
                                                       checksum=checksum)
        blob, st = parallel_compress(data, make_mesh(["cpu"] * 8), frame_size=32 * KIB,
                                     level=1, checksum=checksum)
    assert (blob, st.to_bytes()) == (want_blob, want_st.to_bytes())
    single = archive.compress_archive(data, frame_size=32 * KIB, level=1, checksum=checksum,
                                      device="cpu")
    with _env(ZEEKSTD_TPU_MATCH="xla"):
        single_xla = archive.compress_archive(data, frame_size=32 * KIB, level=1,
                                              checksum=checksum, device="cpu")
    assert blob == single_xla[0] != single[0]


def _stream(mod, data, frame_size):
    opts = (mod.EncodeOptions().with_backend("tpu")
            .with_frame_size_policy(mod.FrameSizePolicy.uncompressed(frame_size))
            .with_compression_level(1).with_checksum_flag(True))
    if mod is zt:
        opts = opts.with_device("cpu")
    out = io.BytesIO()
    enc = mod.Encoder(opts, out)
    for i in range(0, len(data), 20000):
        enc.compress(data[i : i + 20000])
    enc.finish()
    return out.getvalue()


def test_streaming_encoder_follows_the_switch():
    """The ``tpu`` Encoder at level 1 under ``=xla`` writes the JAX
    Encoder's archive, which is ``compress_archive``'s plus its Foot table."""
    data = INPUTS["mixed"]
    with _env(ZEEKSTD_TPU_MATCH="xla"):
        want = _stream(zr, data, 32 * KIB)
        got = _stream(zt, data, 32 * KIB)
        blob, st = archive.compress_archive(data, frame_size=32 * KIB, level=1, checksum=True,
                                            device="cpu")
    assert got == want == blob + st.to_bytes(zt.Format.FOOT)


def test_cli_follows_the_switch(tmp_path):
    """``compress --backend tpu -l 1`` under ``=xla``: the port's file (with
    ``--device cpu``) equals the JAX CLI's."""
    files = {}
    for name, entry, extra in (("ref", ref_cli, []), ("port", port_cli, ["--device", "cpu"])):
        work = tmp_path / name
        work.mkdir()
        (work / "in.bin").write_bytes(INPUTS["text"])
        argv = ["-q", "compress", str(work / "in.bin"), "-o", str(work / "in.zst"), "-f",
                "-s", "32K", "-l", "1", "--backend", "tpu"] + extra
        with _env(ZEEKSTD_TPU_MATCH="xla"), contextlib.redirect_stdout(io.StringIO()):
            assert entry(argv) == 0
        files[name] = (work / "in.zst").read_bytes()
    assert files["port"] == files["ref"]
    st = zt.SeekTable.from_bytes(files["port"])
    with _env(ZEEKSTD_TPU_MATCH="xla"):
        blob, _ = archive.compress_archive(INPUTS["text"], frame_size=32 * KIB, level=1,
                                           checksum=True, device="cpu")
    assert files["port"][: st.frame_end_comp(st.num_frames - 1)] == blob


# --- ZEEKSTD_TPU_REACH and the reachability branches ----------------------

REACH = {"default": None, "xla": "xla"}


def _block_steps(F, n, block, seed):
    """Greedy steps in [1, SMAX] that never cross a multiple of ``block``."""
    rng = np.random.default_rng(seed)
    step = rng.integers(1, mt.SMAX + 1, (F, n)).astype(np.int32)
    to_end = block - np.arange(n) % block
    return np.minimum(step, to_end[None, :]).astype(np.int32)


@pytest.fixture(scope="module")
def reach_calls():
    """{setting: (level-3 archive of the mixed input in 32 KiB frames, calls
    of the chunked kernels' entry, the reference's archive under the same
    setting)}."""
    out = {}
    real = mt.reachability_chunked
    for name, value in REACH.items():
        calls = []

        def counted(*a, _calls=calls, **k):
            _calls.append(a[1:])
            return real(*a, **k)

        with _env(ZEEKSTD_TPU_REACH=value), pytest.MonkeyPatch.context() as mp:
            mp.setattr(mt, "reachability_chunked", counted)
            blob, st = archive.compress_archive(INPUTS["mixed"], frame_size=32 * KIB, level=3,
                                                device="cpu")
            ref_blob, ref_st = tpu_compress_archive(INPUTS["mixed"], frame_size=32 * KIB,
                                                    level=3)
        out[name] = ((blob, st.to_bytes()), calls, (ref_blob, ref_st.to_bytes()))
    return out


def test_reach_variable_keeps_the_chunked_kernels(reach_calls):
    """The port ignores ``ZEEKSTD_TPU_REACH`` (it changes no byte in the
    reference): the parse takes the chunked kernels under either setting."""
    assert reach_calls["default"][1], "the default parse did not take the chunked kernels"
    assert reach_calls["xla"][1] == reach_calls["default"][1]


@pytest.mark.parametrize("setting", list(REACH))
def test_level3_archive_equals_reference_under_reach(reach_calls, setting):
    got, _calls, want = reach_calls[setting]
    assert got == want == reach_calls["default"][2]


TILED = {"32k": (32 * KIB, 32 * KIB), "4k-blocks": (32 * KIB, 4 * KIB),
         "64k": (64 * KIB, 32 * KIB)}
UNTILED = {"1000": (1000, None), "40000-32k-blocks": (40000, 32 * KIB)}
BRANCHES = {"chunked": mt.SMAX, "doubling": None}


def _reachability_case(n, block, step_max):
    """(the port's mask, the JAX function's, whether the chunked kernels ran)."""
    step = _block_steps(2, n, block or n, seed=n + (block or 0))
    calls = []
    real = mt.reachability_chunked
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(mt, "reachability_chunked", lambda *a: calls.append(1) or real(*a))
        got = mt.greedy_reachability(torch.from_numpy(step), n, block, step_max=step_max)
    want = np.stack([np.asarray(ref_mt.greedy_reachability(
        jnp.asarray(row), n, block, step_max=step_max)) for row in step])
    return got.numpy(), want, bool(calls)


@pytest.mark.parametrize("branch", list(BRANCHES))
@pytest.mark.parametrize("shape", list(TILED))
def test_greedy_reachability_equals_reference(branch, shape):
    """Tiled step arrays: the port's mask equals the JAX function's per
    row, on the chunked kernels with ``step_max`` given and by pointer
    doubling without it."""
    got, want, chunked = _reachability_case(*TILED[shape], BRANCHES[branch])
    assert np.array_equal(got, want)
    assert chunked == (branch == "chunked")


@pytest.mark.parametrize("shape", list(UNTILED))
def test_greedy_reachability_untiled_shapes_double(shape):
    """Shapes the chunked kernels do not tile take pointer doubling even
    with ``step_max`` given, and equal the JAX function."""
    got, want, chunked = _reachability_case(*UNTILED[shape], mt.SMAX)
    assert np.array_equal(got, want)
    assert not chunked


# --- ZEEKSTD_TPU_TIMING -------------------------------------------------

TIMING_VALUES = {"unset": None, "0": "0", "1": "1", "2": "2", "x": "x"}

TIMING_CHILD = """
import json, sys
sys.path.insert(0, {root!r})
import torch
torch.set_num_threads(2)
from zeekstd_tpu_torch import archive, device
from tests.block_cases import word_text
modes = (device._TIMING, device._FENCE)
data = word_text(64 << 10)
archive.compress_archive(data, frame_size=32 << 10, level=1, device="cpu")
first = sorted(device.phase_records)
device.set_timing(0)
device.phase_records.clear()
archive.compress_archive(data, frame_size=32 << 10, level=1, device="cpu")
print(json.dumps(dict(modes=modes, first=first, after=sorted(device.phase_records),
                      foreign=sorted(m for m in sys.modules
                                     if m == "jax" or m.split(".")[0] == "zeekstd_tpu"))))
"""


@pytest.fixture(scope="module")
def timing_children():
    """{value: (the child's JSON line, its standard error)}, one JAX-free
    child per value of ZEEKSTD_TPU_TIMING, all started together."""
    procs = {}
    for name, value in TIMING_VALUES.items():
        env = {k: v for k, v in os.environ.items() if k != "ZEEKSTD_TPU_TIMING"}
        if value is not None:
            env["ZEEKSTD_TPU_TIMING"] = value
        procs[name] = subprocess.Popen(
            [sys.executable, "-c", TIMING_CHILD.format(root=ROOT)], cwd=ROOT, env=env,
            text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    for name, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        assert proc.returncode == 0, (name, stderr[-3000:])
        out[name] = (json.loads(stdout.strip().splitlines()[-1]), stderr)
    return out


def _reference_modes(value):
    """(_TIMING, _FENCE) of the reference's ``jax_setup.py`` imported afresh
    under ``value`` (a module object of its own; the package's stays)."""
    with _env(ZEEKSTD_TPU_TIMING=value):
        spec = importlib.util.spec_from_file_location(
            "_ref_jax_setup", os.path.join(ROOT, "zeekstd_tpu", "jax_setup.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    return [mod._TIMING, mod._FENCE]


def _reference_encode_phases():
    with open(os.path.join(ROOT, "zeekstd_tpu", "tpu_archive.py")) as f:
        return set(re.findall(r'phase_timer\("(enc\.[a-z_]+)"', f.read()))


@pytest.mark.parametrize("value", list(TIMING_VALUES))
def test_timing_read_at_import(timing_children, value):
    """The child's modes are the reference's for the same value; only 1
    and 2 record the reference's encode phases and write ``[timing]``
    lines; after ``set_timing(0)`` nothing is recorded."""
    got, stderr = timing_children[value]
    assert got["foreign"] == []
    assert got["modes"] == _reference_modes(TIMING_VALUES[value])
    on = value in ("1", "2")
    assert got["modes"] == [on, value == "2"]
    lines = [ln for ln in stderr.splitlines() if ln.startswith("[timing] enc.")]
    if on:
        names = set(got["first"])
        assert {"enc.parse_dispatch", "enc.host_decisions", "enc.fse_dispatch"} <= names
        assert names <= _reference_encode_phases()
        assert len(lines) >= len(names)
    else:
        assert got["first"] == [] and lines == []
    assert got["after"] == []
