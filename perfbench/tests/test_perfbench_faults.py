"""A run with the timed path broken underneath comes out not correct, once
for each fault a one-card inference cell can have; the same run unbroken
comes out correct. The harness's look for a card is skipped (the program
runs its plain versions on the CPU) and the rest of a run is driven."""

import pytest

from perfbench import faults, harness, spec

import perfbench_helpers as H

SEED = 2 ** 31 + 7


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    root = H.tiny_checkout(tmp_path_factory.mktemp("faults"))
    return spec.cell("tiny.cell", root), root


def test_sound_run_is_correct(tiny):
    cell, root = tiny
    res = harness.run(cell, SEED, 0.5, False, "cpu", 0.0, root)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0


@pytest.mark.parametrize("fault", faults.NAMES)
def test_fault_is_caught(tiny, fault):
    cell, root = tiny
    with faults.planted(fault):
        res = harness.run(cell, SEED, 0.5, False, "cpu", 0.0, root)
    assert not res["correct"], (fault, res["checks"])
