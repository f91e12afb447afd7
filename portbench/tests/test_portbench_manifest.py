"""BENCHMARK.json against the benchmark's contract, and every file a name
in it leads to."""

import importlib
import json
import os
import re

import pytest

from portbench import cell as cells

ROOT = cells.ROOT
with open(os.path.join(ROOT, "BENCHMARK.json")) as _f:
    BENCH = json.load(_f)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["paths"]) <= 16 and len(BENCH["command"]) <= 32
    assert all(_line(w) for w in BENCH["command"])
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert not p.startswith("/") and os.path.isdir(os.path.join(ROOT, p))
        assert not p.endswith("_torch")
    script = BENCH["command"][1]
    assert any(script.startswith(p + "/") for p in BENCH["paths"])
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entry_keys_and_names():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for section, need in keys.items():
        entries = BENCH[section]
        names = [e["name"] for e in entries]
        assert len(names) == len(set(names)), section
        for e in entries:
            extra = set(e) - need
            assert set(e) >= need and extra <= {"workloads"}, e
            assert NAME.match(e["name"]), e["name"]
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in (
                    "lower", "higher") and e["source"] in SOURCES, e
            for k in ("why", "layer", "source"):
                if k in e and section in ("configs", "workloads",
                                          "per_layer"):
                    assert _line(e[k]), (k, e[k])
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in (
            "n_embd", "n_head", "n_inner", "num_filters", "expansion")
            for k in c["reduced"]), "reduced names a width"
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)


def test_configs_are_used_and_files_are_theirs():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert used == {c["name"] for c in BENCH["configs"]}
    assert len(files) == len(set(files))
    for f in files:
        assert any(f.startswith(p + "/") for p in BENCH["paths"])


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"][
        "bound"] <= 0.25


def test_per_layer_metrics_name_their_cells_and_moves():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    reports = {c: {m["name"] for m in BENCH["end_to_end"]
                   if c in m.get("workloads", CELLS)} for c in CELLS}
    for m in BENCH["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS), m
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
        # each cell it lists reports the metric it moves
        assert all(m["moves"] in reports[c]
                   for c in m.get("workloads", CELLS)), m
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    c = cells.load(name)
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2 and c.per_layer
    wire = {"wire_short"} if c.traffic["mode"] == "ps" else set()
    assert set(c.limits) == {"loss_gap", "grad_gap", "change_gap"} | wire
    for mod in (f"reference.{c.cfg['model']}", f"models.{c.cfg['model']}",
                f"inputs.{c.cfg['inputs']}",
                f"optimizers.{c.traffic['optimizer']['name']}"):
        importlib.import_module("portbench." + mod)
    assert c.traffic["mode"] in ("ps", "collective")
    assert c.traffic["warmup_steps"] >= 3


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    reader = importlib.import_module(
        "portbench.metrics." + name.replace(".", "_"))
    assert callable(reader.read)


def test_file_names_use_name_characters():
    for path in BENCH["paths"]:
        for d, _, files in os.walk(os.path.join(ROOT, path)):
            if "__pycache__" in d:
                continue
            for f in files:
                rel = os.path.relpath(os.path.join(d, f), ROOT)
                assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel
