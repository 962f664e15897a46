"""PyTorch port: the ``zeekstd`` command line against the JAX package's.

The same argv (the port's with ``--device cpu`` on the ``tpu`` backend)
through ``zeekstd_tpu.cli.main`` and ``zeekstd_tpu_torch.cli.main`` in
separate directories: compress, ``list``, decompress of a byte window
(``--from``/``--to``), of a frame range (``--from-frame``/``--to-frame``)
and of the whole, on the ``python`` and ``tpu`` backends, and on ``tpu``
a patch made with ``--patch-from`` and applied with ``--patch-apply``
(``tests/test_cli.py::test_cli_backend_tpu_roundtrip``). Every output
file and the ``list`` output are equal. Also: ``python -m
zeekstd_tpu_torch --version``; ``--backend tpu`` with no card and no
``--device cpu`` exits non-zero and writes nothing; the refusals. The
cycle also runs on ``native`` and with no ``--backend`` (the native
runtime), whose files equal the JAX CLI's.
"""

import contextlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from zeekstd_tpu.cli import main as ref_main
from zeekstd_tpu_torch.cli import main

from .torch_threads import two_torch_threads  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text(n: int, seed: int = 3) -> bytes:
    rng = np.random.default_rng(seed)
    words = [bytes(rng.integers(97, 123, rng.integers(2, 9), dtype=np.uint8))
             for _ in range(400)]
    return b" ".join(words[rng.integers(0, 400)] for _ in range(n // 4))[:n]


DATA = _text(96 << 10)
NEWER = DATA[:40000] + b"INSERTED-PATCH-CHUNK" + DATA[40000:]
# "auto" runs the cycle with no --backend (the native runtime).
BACKENDS = ["python", "tpu", "native", "auto"]


def _commands(backend):
    """(argv, output file or None for stdout) of the cycle on ``backend``
    (``auto``: no ``--backend``, the default)."""
    b = [] if backend == "auto" else ["--backend", backend]
    cmds = [
        (["-q", "compress", "in.bin", "-o", "in.zst", "-f", "-s", "16K"] + b, "in.zst"),
        (["list", "in.zst", "--detail", "--raw-bytes"], None),
        (["list", "in.zst", "--from-frame", "1", "--num-frames", "3"], None),
        (["-q", "decompress", "in.zst", "-o", "range.bin", "-f", "--from", "5000",
          "--to", "30000"] + b, "range.bin"),
        (["-q", "d", "in.zst", "-o", "frames.bin", "-f", "--from-frame", "1",
          "--to-frame", "3"] + b, "frames.bin"),
        (["-q", "decompress", "in.zst", "-o", "full.bin", "-f"] + b, "full.bin"),
    ]
    if backend == "tpu":
        cmds += [
            (["-q", "compress", "new.bin", "-o", "new.patch.zst", "-f", "-s", "16K",
              "--patch-from", "in.bin"] + b, "new.patch.zst"),
            (["-q", "decompress", "new.patch.zst", "-o", "applied.bin", "-f",
              "--patch-apply", "in.bin"] + b, "applied.bin"),
            (["-q", "compress", "new.bin", "-o", "new.zst", "-f", "-s", "16K"] + b, "new.zst"),
        ]
    return cmds


def _run(entry, workdir, backend, port):
    """Run the cycle in ``workdir``; returns {output: bytes or stdout}."""
    (workdir / "in.bin").write_bytes(DATA)
    (workdir / "new.bin").write_bytes(NEWER)
    out = {}
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        for i, (argv, target) in enumerate(_commands(backend)):
            if port and "--backend" in argv and backend == "tpu":
                argv = argv + ["--device", "cpu"]
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                assert entry(argv) == 0, argv
            out[target or f"stdout{i}"] = (
                (workdir / target).read_bytes() if target else text.getvalue())
    finally:
        os.chdir(cwd)
    return out


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("ZEEKSTD_TPU_EXEC", "fused")
        res = {}
        for backend in BACKENDS:
            for port, entry in ((False, ref_main), (True, main)):
                d = tmp_path_factory.mktemp(f"{backend}_{'port' if port else 'ref'}")
                res[backend, port] = _run(entry, d, backend, port)
    return res


@pytest.mark.parametrize("backend", BACKENDS)
def test_cli_outputs_equal_reference(outputs, backend):
    got, want = outputs[backend, True], outputs[backend, False]
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


@pytest.mark.parametrize("backend", BACKENDS)
def test_cli_cycle_round_trips(outputs, backend):
    got = outputs[backend, True]
    assert got["full.bin"] == DATA
    assert got["range.bin"] == DATA[5000:30000]
    assert got["frames.bin"] == DATA[16 << 10 : 64 << 10]
    assert len(got["stdout1"].splitlines()) == 1 + 6  # header, 6 frames of 16 KiB


def test_cli_backend_tpu_patch_round_trip(outputs):
    got = outputs["tpu", True]
    assert got["applied.bin"] == NEWER
    assert len(got["new.patch.zst"]) < len(got["new.zst"]) / 2


def test_module_entry_prints_version():
    res = subprocess.run([sys.executable, "-m", "zeekstd_tpu_torch", "--version"],
                         capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "zeekstd_tpu_torch 0.1.0"


def test_tpu_backend_without_card_exits_and_writes_nothing(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    src = tmp_path / "in.bin"
    src.write_bytes(DATA[:1000])
    out = tmp_path / "out.zst"
    assert main(["compress", str(src), "-o", str(out), "--backend", "tpu"]) == 1
    assert "no CUDA device is available" in capsys.readouterr().err
    assert not out.exists()
    assert main(["compress", str(src), "-o", str(out), "--backend", "tpu",
                 "--device", "cpu"]) == 0
    rt = tmp_path / "rt.bin"
    assert main(["decompress", str(out), "-o", str(rt), "--backend", "tpu"]) == 1
    assert not rt.exists()


@pytest.mark.parametrize("argv", [
    ["--backend", "tpu", "--device", "cpu", "--frame-size-policy", "compressed"],
])
def test_refused_backends_write_nothing(tmp_path, capsys, argv):
    src = tmp_path / "in.bin"
    src.write_bytes(DATA[:1000])
    out = tmp_path / "out.zst"
    assert main(["compress", str(src), "-o", str(out)] + argv) == 1
    assert "error" in capsys.readouterr().err
    assert not out.exists()


def test_default_backend_is_native_and_writes_reference_file(outputs):
    """With no ``--backend`` the CLI writes what ``--backend native`` writes,
    and the JAX package's CLI writes the same file."""
    assert outputs["auto", True]["in.zst"] == outputs["native", True]["in.zst"]
    assert outputs["auto", True]["in.zst"] == outputs["auto", False]["in.zst"]


def test_cli_native_backend_round_trip(tmp_path):
    """A native cycle crossing backends: compress on ``tpu`` (the plain
    versions) and decompress with no ``--backend``, then compress with
    ``--backend native`` and decompress on ``tpu``."""
    data = DATA[:40000]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    a, b, ra, rb = (str(tmp_path / n) for n in ("a.zst", "b.zst", "ra.bin", "rb.bin"))
    assert main(["-q", "compress", str(src), "-o", a, "-s", "16K", "--backend", "tpu",
                 "--device", "cpu"]) == 0
    assert main(["-q", "decompress", a, "-o", ra]) == 0
    assert main(["-q", "compress", str(src), "-o", b, "-s", "16K", "--backend", "native"]) == 0
    assert main(["-q", "decompress", b, "-o", rb, "--backend", "tpu", "--device", "cpu"]) == 0
    assert (tmp_path / "ra.bin").read_bytes() == data
    assert (tmp_path / "rb.bin").read_bytes() == data
