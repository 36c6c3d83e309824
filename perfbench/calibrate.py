"""The readings the comparison's limits are set from, for one cell, in one
process on the card (not a part of the benchmark's runs):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults 1,2,3] [--seconds 1]

- the program: a run of the cell (a short window at the cell's own load,
  then the comparison) for each of --seeds;
- the control: the plain reference with TF32 products (the precision below
  the configuration's float32) in the program's place, compared by the
  same comparison, for each of --control-seeds;
- each planted fault (perfbench/faults.py) for each of --faults.

Prints one JSON line a reading: {"cell", "kind", "seed", "score_err",
"correct"}.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def _seeds(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def control_readings(cell, seed: int, device) -> dict:
    """The control's score_err on the cell's inputs of
    `seed`."""
    from perfbench import compare, harness, traffic
    params = harness.bank_params(cell.config, seed, device)
    pool = traffic.make_pool(cell.mix, int(cell.config["fs"]), seed, device)
    ref = compare.reference_scores(cell.config, pool, params, device)
    ctl = compare.reference_scores(cell.config, pool, params, device,
                                   tf32=True)
    return compare.readings(cell.config, pool, params, dict(enumerate(ctl)),
                            {p: c.argmax(axis=1)[None] for p, c
                             in enumerate(ctl)}, device, reference=ref)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_seeds, default=[])
    ap.add_argument("--control-seeds", type=_seeds, default=[])
    ap.add_argument("--faults", type=_seeds, default=[])
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench import compare, faults, harness, spec
    cell = spec.cell(args.workload, ROOT)
    limits = cell.limits

    def emit(kind, seed, r, correct=None):
        if correct is None:
            correct = compare.passed(compare.checks(r, limits, 0))
        print(json.dumps(compare.jsonable(
            {"cell": cell.name, "kind": kind, "seed": seed, **r,
             "correct": correct})), flush=True)

    runs = [("program", s, None) for s in args.seeds]
    runs += [(f"fault:{f}", s, f) for f in faults.NAMES for s in args.faults]
    for kind, seed, fault in runs:
        with faults.planted(fault) if fault else contextlib.nullcontext():
            res = harness.run(cell, seed, args.seconds, False, args.device,
                              time.perf_counter(), ROOT)
        emit(kind, seed, {k: v["value"] for k, v in res["checks"].items()
                          if k != "unlabelled"}, res["correct"])
    for seed in args.control_seeds:
        emit("control", seed, control_readings(cell, seed, args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
