"""A cell by name: its entry in ``BENCHMARK.json``, its configuration, its
traffic, its limits and the metrics it reports, all found by the names
the manifest gives, so that a new cell, configuration or metric is a new
file and no edit."""

from __future__ import annotations

import dataclasses
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict  # the configuration file
    traffic: dict  # portbench/traffic/<traffic>.json
    limits: dict  # portbench/limits/<cell>.json: {number: limit}
    end_to_end: list  # the manifest's entries this cell reports
    per_layer: list


def _load(path):
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, manifest: str = os.path.join(ROOT, "BENCHMARK.json")
         ) -> Cell:
    bench = _load(manifest)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no cell {name!r} in {manifest}: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _reports(m, name) and m["moves"] in names]
    return Cell(
        name=name, chips=w["chips"],
        cfg=_load(os.path.join(ROOT, cfg["file"])),
        traffic=_load(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
        limits=_load(os.path.join(HERE, "limits", name + ".json"))["limits"],
        end_to_end=e2e, per_layer=per_layer)
