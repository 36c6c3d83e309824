"""The benchmark of speaker_recognition_tpu_torch, one cell a run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the CUDA cards the cell
asks for. Prints the checks' numbers beside their limits as the last lines
of standard error, and one JSON object as the last line of standard
output: correct, attempted, failed, metrics (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), device (with --trace 1 also
busy_s and window_s), with --trace 1 breakdown, and the checks last. Exits
non-zero, and prints no result, without the cards, without the program
beside perfbench/, or when a module of JAX or of the JAX package has been
loaded by the end of the run. See perfbench/harness.py for the run itself.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    from perfbench import compare, spec
    cell = spec.cell(args.workload, ROOT)
    import torch
    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench import harness
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T_PROCESS, ROOT)
    found = harness.forbidden_modules()
    if found:
        print("perfbench: loaded modules of JAX or the JAX package: "
              + ", ".join(found), file=sys.stderr)
        return 3
    for line in result.pop("stderr_lines"):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(compare.jsonable(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
