"""BENCHMARK.json against the benchmark's rules of form, and every piece it
names found by that name."""

import importlib.util
import json
import os
import re

import pytest

from portbench import manifest

from .helpers import BENCH, CELLS

ROOT = manifest.ROOT
PKG = manifest.PKG
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def problems(bench: dict, root: str = ROOT) -> list[str]:
    """What in the manifest breaks the benchmark's rules of form, as text."""
    out = []
    if set(bench) != TOP_KEYS:
        out.append(f"top-level keys {sorted(bench)}")

    def name_ok(n, what):
        if not isinstance(n, str) or not NAME.fullmatch(n):
            out.append(f"{what} {n!r} is not a valid name")

    def line_ok(s, what):
        if not isinstance(s, str) or not 1 <= len(s) <= 200 or "\n" in s or "\t" in s:
            out.append(f"{what} {s!r} is not one line of 1-200 characters")

    seen = set()
    for c in bench["configs"]:
        if set(c) != CONFIG_KEYS:
            out.append(f"config {c.get('name')} keys {sorted(c)}")
        name_ok(c["name"], "config")
        line_ok(c["source"], "source")
        line_ok(c["why"], "why")
        for k in c["reduced"]:
            name_ok(k, "reduced key")
        if not os.path.exists(os.path.join(root, c["file"])):
            out.append(f"config file {c['file']} is missing")
        seen.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        if set(w) != CELL_KEYS:
            out.append(f"workload {w.get('name')} keys {sorted(w)}")
        for k in ("name", "config", "traffic"):
            name_ok(w[k], f"workload {k}")
        line_ok(w["why"], "why")
        if w["config"] not in seen:
            out.append(f"workload {w['name']} names an unknown config")
        if not os.path.exists(os.path.join(PKG, "traffic", f"{w['traffic']}.json")):
            out.append(f"workload {w['name']} names a mix with no file")
        if w["chips"] not in (1, 4):
            out.append(f"workload {w['name']} asks for {w['chips']} chips")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"workload {w['name']} repeats a pair")
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in bench["workloads"]}
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for group, keys in (("end_to_end", METRIC_KEYS), ("per_layer", LAYER_KEYS)):
        for m in bench[group]:
            if set(m) - {"workloads"} != keys:
                out.append(f"metric {m.get('name')} keys {sorted(m)}")
            name_ok(m["name"], "metric")
            if not isinstance(m["unit"], str) or not UNIT.fullmatch(m["unit"]):
                out.append(f"metric {m['name']} unit {m['unit']!r}")
            if m["better"] not in ("lower", "higher"):
                out.append(f"metric {m['name']} better {m['better']!r}")
            for w in m.get("workloads", []):
                if w not in cells:
                    out.append(f"metric {m['name']} lists an unknown cell {w}")
            if not os.path.exists(os.path.join(PKG, "metrics", f"{m['name']}.py")):
                out.append(f"metric {m['name']} has no reader")
            if group == "end_to_end":
                if m["source"] not in ("host_clock", "device_trace"):
                    out.append(f"metric {m['name']} source {m['source']}")
                if not 0.01 <= m["bound"] <= 0.25:
                    out.append(f"metric {m['name']} bound {m['bound']}")
            else:
                line_ok(m["layer"], "layer")
                if m["source"] not in ("device_trace", "program_span", "program_counter",
                                       "host_clock"):
                    out.append(f"metric {m['name']} source {m['source']}")
                moved = e2e.get(m["moves"])
                if moved is None:
                    out.append(f"metric {m['name']} moves an unknown metric")
                    continue
                for w in m.get("workloads", cells):
                    if w not in moved.get("workloads", cells):
                        out.append(f"metric {m['name']} in {w}, where {m['moves']} is not")
    cfg_names = [c["name"] for c in bench["configs"]]
    if len(cfg_names) != len(set(cfg_names)):
        out.append("a configuration name repeats")
    for group in ("workloads", "end_to_end", "per_layer"):
        ns = [e["name"] for e in bench[group]]
        if len(ns) != len(set(ns)):
            out.append(f"repeated name in {group}")
    all_metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    if len(all_metrics) != len(set(all_metrics)):
        out.append("a metric name repeats")
    for w in cells:
        reported = [m for m in bench["end_to_end"] if w in m.get("workloads", cells)]
        if "setup_s" not in {m["name"] for m in reported} or len(reported) < 2:
            out.append(f"cell {w} lacks setup_s or another end-to-end metric")
        if not any(w in m.get("workloads", cells) for m in bench["per_layer"]):
            out.append(f"cell {w} has no per-layer metric")
    return out



def test_manifest_parses_and_keeps_the_rules():
    assert problems(BENCH) == []


def test_command_and_paths_stay_inside_the_benchmark():
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    assert BENCH["command"][1:] == ["-m", "portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    # A full check of 24 cells fits its time: 2 + 14 runs a cell, each with
    # the run's allowance, two compiles a cell, 1200 s spare.
    n = 24
    assert (2 + 14 * n) * (BENCH["run_seconds"] + 60) + n * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(BENCH)) <= 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_config_mix_and_metrics(name):
    cell = manifest.cell(BENCH, name)
    cfg = manifest.config(BENCH, cell["config"])
    mix = manifest.mix(cell["traffic"])
    assert cfg["name"] == cell["config"]
    assert callable(manifest.generator(cfg["data"]["generator"]))
    assert importlib.util.find_spec(f"portbench.kinds.{mix['kind']}") is not None
    for trace in (False, True):
        metrics = manifest.metrics_for(BENCH, name, trace)
        assert metrics
        for m in metrics:
            assert callable(manifest.reader(m["name"]))
    assert "setup_s" in {m["name"] for m in manifest.metrics_for(BENCH, name, False)}


@pytest.mark.parametrize("name", CELLS)
def test_each_per_layer_metric_moves_a_metric_its_cell_reports(name):
    reported = {m["name"] for m in manifest.metrics_for(BENCH, name, False)}
    for m in manifest.metrics_for(BENCH, name, True):
        assert m["moves"] in reported, (m["name"], name)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files_state_the_deployment(entry):
    with open(os.path.join(manifest.ROOT, entry["file"])) as fh:
        cfg = json.load(fh)
    assert cfg["name"] == entry["name"]
    assert cfg["reduced"] == entry["reduced"]
    # A cut of scale says what was cut and why.
    assert not cfg["reduced"] or cfg["cut"]
    for key in ("level", "frame_size", "checksum", "seek_table_format", "env", "data",
                "source", "assumed"):
        assert key in cfg
    assert all(k.startswith("ZEEKSTD_") for k in cfg["env"])


def test_the_rules_catch_a_bad_name_and_unit():
    bad = json.loads(json.dumps(BENCH))
    bad["per_layer"][0]["name"] = "has space"
    bad["end_to_end"][0]["unit"] = "tokens per second"
    found = problems(bad)
    assert any("has space" in p for p in found)
    assert any("unit" in p for p in found)
