"""BENCHMARK.json against the benchmark's contract: its keys, names, units,
bounds and time budget, and each per-layer entry against the reader file
that declares the metric."""

import json
import os
import re

import pytest

from perfbench import spec

import perfbench_helpers as H

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def bench():
    path = os.path.join(H.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024
    return spec.benchmark()


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(bench["paths"]) <= 16
    assert all(PATH.match(p) and ".." not in p for p in bench["paths"])
    assert len(bench["command"]) <= 32 and all(map(_line, bench["command"]))
    assert bench["command"][1].startswith(tuple(bench["paths"]))
    rs = bench["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check with the 24 cells later changes may add
    assert 24 * 14 * (rs + 60) + 2 * (rs + 60) + 24 * 180 + 1200 <= 43200


def test_configs(bench):
    files = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert c["file"] not in files
        files.add(c["file"])
        data = H.load(c["file"])
        assert data["name"] == c["name"] and data["reduced"] == c["reduced"]
        assert data["source"] == c["source"] and data["dtype"] == "float32"
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])


def test_workloads(bench):
    names = [w["name"] for w in bench["workloads"]]
    assert 1 <= len(names) <= 24 and len(set(names)) == len(names)
    pairs = {(w["config"], w["traffic"]) for w in bench["workloads"]}
    assert len(pairs) == len(names)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(names) // 4)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        cell = spec.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_metrics(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    names = list(e2e) + [m["name"] for m in bench["per_layer"]]
    assert len(set(names)) == len(names) and all(map(NAME.match, names))
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert e2e["setup_s"]["bound"] == 0.25
    layers = {}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        reader = spec.metric_reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.BETTER, reader.MOVES) == (
            m["layer"], m["unit"], m["better"], m["moves"])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    assert any("mfu" in n for ns in layers.values() for n in ns)


def test_perf_md_names_every_layer(bench):
    with open(os.path.join(H.ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in bench["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]


def test_json_is_plain():
    with open(os.path.join(H.ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    json.loads(text)
    assert text.isascii()
