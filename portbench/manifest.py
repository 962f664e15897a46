"""``BENCHMARK.json`` and the files it names.

Every piece is found by its name: a configuration's ``file``, the mix
``traffic/<traffic>.json`` and the loop ``kinds/<kind>.py`` it names, the
generator ``data/<generator>.py`` and the reader ``metrics/<metric>.py``.
A later cell, configuration, mix or metric is new files and new entries;
nothing here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


def load(root: str = ROOT) -> dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _named(entries, name, what):
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: str = ROOT) -> dict:
    entry = _named(bench["configs"], name, "configuration")
    with open(os.path.join(root, entry["file"])) as fh:
        return json.load(fh)


def mix(name: str) -> dict:
    with open(os.path.join(PKG, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones."""
    group = bench["per_layer" if trace else "end_to_end"]
    return [m for m in group if cell_name in m.get("workloads", [cell_name])]


def _load_module(path: str, tag: str):
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(PKG, "metrics", f"{name}.py")
    return _load_module(path, "metric_" + name.replace(".", "_").replace("-", "_")).read


def generator(name: str):
    """``generate(size, seed) -> bytes`` of ``data/<name>.py``."""
    path = os.path.join(PKG, "data", f"{name}.py")
    return _load_module(path, "data_" + name.replace(".", "_").replace("-", "_")).generate
