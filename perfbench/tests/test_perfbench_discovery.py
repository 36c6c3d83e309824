"""The harness finds a new configuration, mix, limits and metric by name,
with no edit to any file it had; it refuses to run without a card or
without the program, and never falls back to the CPU."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import harness, spec

import perfbench_helpers as H

NEW_METRIC = '''"""A metric a later change adds: calls in the window."""

LAYER = "host"
UNIT = "calls"
BETTER = "higher"
MOVES = "audio_s_per_s"


def read(ctx):
    return float(ctx.batches)
'''


def _with_new_files(tmp_path):
    root = H.tiny_checkout(tmp_path)
    with open(os.path.join(root, "perfbench/metrics/new_calls.py"), "w") as f:
        f.write(NEW_METRIC)
    bench = json.load(open(os.path.join(root, "BENCHMARK.json")))
    bench["per_layer"].append({"name": "new_calls", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "host", "moves": "audio_s_per_s",
                               "workloads": ["tiny.cell"]})
    H.dump(bench, os.path.join(root, "BENCHMARK.json"))
    return root


def _tree(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "perfbench")):
        for name in files:
            if name.endswith((".py", ".json")):
                path = os.path.join(d, name)
                out[os.path.relpath(path, root)] = open(path).read()
    return out


def test_new_files_are_found_by_name(tmp_path):
    root = _with_new_files(tmp_path)
    before = _tree(H.ROOT)
    cell = spec.cell("tiny.cell", root)
    assert cell.config["name"] == "tiny-config"
    assert cell.mix["name"] == "tiny-mix"
    assert {m["name"] for m in cell.per_layer} >= {"new_calls",
                                                   "frontend_ms"}
    assert [m["name"] for m in cell.end_to_end] == [
        "audio_s_per_s", "batch_p95_ms", "setup_s"]
    traced = harness.run(cell, 2 ** 31 + 99, 0.5, True, "cpu", 0.0, root)
    assert traced["correct"], traced["checks"]
    assert traced["metrics"]["new_calls"]["value"] >= 1
    assert traced["metrics"]["host_enqueue_ms"]["value"] > 0
    plain = harness.run(cell, 2 ** 31 + 99, 2.0, False, "cpu", 0.0, root)
    assert plain["correct"], plain["checks"]
    assert set(plain["metrics"]) == {"audio_s_per_s", "batch_p95_ms",
                                     "setup_s"}
    assert list(plain)[-2:] == ["checks", "stderr_lines"]
    # no file the benchmark had was edited to find them
    after = {k: v for k, v in _tree(root).items() if k in before}
    assert after == {k: v for k, v in before.items() if k in after}


def _run_py(root, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "tiny.cell",
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0",
         *extra], capture_output=True, text=True, cwd=root, env=env,
        timeout=300)


@pytest.mark.parametrize("link_program", [True, False])
def test_no_card_or_no_program_no_result(tmp_path, link_program):
    root = H.tiny_checkout(tmp_path, link_program=link_program)
    out = _run_py(root)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA card" in out.stderr


def test_an_unknown_cell_is_refused(tmp_path):
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", H.tiny_checkout(tmp_path))
