"""The command as the checker runs it: no card, no result; a directory with
the benchmark alone, no result; and nothing it loads imports JAX or the JAX
package."""

import os
import shutil
import subprocess
import sys

import pytest

from portbench import manifest

ROOT = manifest.ROOT
ARGS = ["--workload", "libbench-l1-2m.archive", "--seed", str(2**31 + 3), "--seconds", "1",
        "--trace", "0"]


def _run(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "portbench", *ARGS], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_without_a_card_the_command_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = _run(ROOT, env)
    assert res.returncode != 0
    assert res.stdout.strip() == ""
    assert "no CUDA device" in res.stderr


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = _run(tmp_path, dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def test_an_unknown_workload_fails():
    res = subprocess.run([sys.executable, "-m", "portbench", "--workload", "nope", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode != 0 and res.stdout.strip() == ""


GUARD = r"""
import importlib, os, sys
sys.path.insert(0, ROOT)
only = sys.argv[1]
base = os.path.join(ROOT, "portbench")
for dirpath, _dirs, files in os.walk(os.path.join(base, only) if only else base):
    if "tests" in dirpath.split(os.sep) or "__pycache__" in dirpath:
        continue
    for f in sorted(files):
        if not f.endswith(".py") or f == "__main__.py":
            continue
        path = os.path.join(dirpath, f)
        rel = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
        if rel.endswith("__init__"):
            rel = rel[: -len(".__init__")]
        if "." in os.path.basename(path)[:-3] or "-" in rel:
            spec = importlib.util.spec_from_file_location("m_" + str(abs(hash(path))), path)
            spec.loader.exec_module(importlib.util.module_from_spec(spec))
        else:
            importlib.import_module(rel)
print(" ".join(sorted({m.split(".", 1)[0] for m in sys.modules})))
""".replace("ROOT", repr(ROOT))


def _top_level_modules(only=""):
    res = subprocess.run([sys.executable, "-c", "import importlib.util\n" + GUARD, only],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    return set(res.stdout.split())


def test_no_module_of_the_benchmark_imports_jax_or_the_jax_package():
    names = _top_level_modules()
    assert "portbench" in names
    assert not names & {"jax", "jaxlib", "flax", "zeekstd_tpu"}, names


def test_the_reference_imports_nothing_of_the_program():
    names = _top_level_modules("reference")
    assert "zeekstd_tpu_torch" not in names and "zeekstd_tpu" not in names
    assert "torch" not in names
    for f in os.listdir(os.path.join(ROOT, "portbench", "reference")):
        if f.endswith(".py"):
            with open(os.path.join(ROOT, "portbench", "reference", f)) as fh:
                assert "zeekstd" not in fh.read()


def test_the_run_refuses_a_process_that_holds_the_jax_package(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "zeekstd_tpu.codec", sys)
    assert run.forbidden_modules() == ["zeekstd_tpu"]


@pytest.mark.parametrize("name", ["zeekstd_tpu_torch", "zeekstd_tpu_torch.ops", "jaxtyping"])
def test_names_are_compared_whole(monkeypatch, name):
    from portbench import run

    monkeypatch.setitem(sys.modules, name, sys)
    assert run.forbidden_modules() == []
