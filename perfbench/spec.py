"""What the harness finds by name: a cell of BENCHMARK.json and its files.

- the configuration: the file the `configs` entry names;
- the traffic mix: perfbench/mixes/<traffic>.json;
- the comparison's limits: perfbench/limits/<cell>.json;
- the end-to-end metrics the cell reports: every `end_to_end` entry whose
  `workloads` (if any) lists it;
- the per-layer metrics: every `per_layer` entry whose `workloads` (if any)
  lists it, each read by perfbench/metrics/<name>.py.

A later cell, mix, configuration or metric is a new file and a new entry;
no file here changes for it.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
METRIC_KEYS = ("LAYER", "UNIT", "BETTER", "MOVES", "read")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    mix: dict
    limits: dict
    end_to_end: list
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: str = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json with its files loaded."""
    bench = benchmark(root)
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(cells: {', '.join(sorted(work))})")
    w = work[name]
    entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    return Cell(
        name, w, _load_json(os.path.join(root, entry["file"])),
        _load_json(os.path.join(root, "perfbench", "mixes",
                                w["traffic"] + ".json")),
        _load_json(os.path.join(root, "perfbench", "limits", name + ".json")),
        [m for m in bench["end_to_end"] if _applies(m, name)],
        [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str, root: str = ROOT):
    """perfbench/metrics/<name>.py, loaded as a module: it declares LAYER,
    UNIT, BETTER and MOVES and reads the metric with read(ctx)."""
    path = os.path.join(root, "perfbench", "metrics", name + ".py")
    modname = "perfbench_metric_" + "".join(
        c if c.isalnum() else "_" for c in name)
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not os.path.exists(path):
        raise FileNotFoundError(f"metric {name!r} has no reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    missing = [k for k in METRIC_KEYS if not hasattr(mod, k)]
    if missing:
        raise AttributeError(f"{path} lacks {', '.join(missing)}")
    return mod
