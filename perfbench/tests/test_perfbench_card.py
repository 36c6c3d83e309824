"""On the card, at each cell's own size: a short run of the program is
correct, and the control (the reference with TF32 products in the
program's place) fails the same limits. Skips without a card.

    python -m pytest perfbench/tests/test_perfbench_card.py -q
"""

import time

import pytest

from perfbench import calibrate, harness, spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_fails_at_size(card, name):
    cell = spec.cell(name)
    res = harness.run(cell, 2 ** 31 + 101, 1.0, False, card,
                      time.perf_counter())
    assert res["correct"], res["checks"]
    ctl = calibrate.control_readings(cell, 2 ** 31 + 101, card)
    assert ctl["score_err"] > cell.limits["score_err"], ctl
