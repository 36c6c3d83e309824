"""Tiny cells for the CPU tests: a temporary checkout holding a copy of
perfbench/, the program linked beside it, and one small cell."""

from __future__ import annotations

import json
import os
import shutil

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

PORT = "speaker_recognition_tpu_torch"


def load(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


def dump(obj, path: str):
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


def tiny_checkout(tmp, config="tel8k-gmm32-s80", speakers=4, batch=6,
                  lengths=None, link_program=True, limits_of=None) -> str:
    """A checkout under tmp with perfbench/ copied, the program linked
    (unless not link_program) and a cell `tiny.cell` of `config` with
    `speakers` speakers, `batch` utterances a batch of `lengths` (a mix's
    lengths group; 0.5-2 s mixed by default) and the limits of the cell
    `limits_of` (tel8k-s80.fixed5s by default)."""
    root = os.path.join(str(tmp), "checkout")
    shutil.copytree(os.path.join(ROOT, "perfbench"),
                    os.path.join(root, "perfbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    if link_program:
        os.symlink(os.path.join(ROOT, PORT), os.path.join(root, PORT))
    bench = load("BENCHMARK.json")
    cfg = load(f"perfbench/configs/{config}.json")
    cfg["name"] = "tiny-config"
    cfg["bank"]["speakers"] = speakers
    dump(cfg, os.path.join(root, "perfbench/configs/tiny-config.json"))
    mix = load("perfbench/mixes/ragged.json")
    mix.update(name="tiny-mix", batch=batch)
    mix["lengths"] = lengths or {"kind": "mix",
                                 "seconds": [0.5, 0.8, 1.2, 2.0],
                                 "shares": [1, 1, 1, 1]}
    dump(mix, os.path.join(root, "perfbench/mixes/tiny-mix.json"))
    dump(load("perfbench/limits/"
              f"{limits_of or 'tel8k-s80.fixed5s'}.json"),
         os.path.join(root, "perfbench/limits/tiny.cell.json"))
    bench["configs"].append({"name": "tiny-config", "source": "test",
                             "file": "perfbench/configs/tiny-config.json",
                             "reduced": [], "why": "a CPU test"})
    bench["workloads"].append({"name": "tiny.cell", "config": "tiny-config",
                               "traffic": "tiny-mix", "chips": 1,
                               "why": "a CPU test"})
    for m in bench["per_layer"]:
        m.setdefault("workloads", []).append("tiny.cell")
    dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root
