#!/usr/bin/env python3
"""Run a function in n processes on localhost, each a rank of one process
group (parallel/multihost.initialize through a TCPStore that this process
hosts on a port it binds itself, the ranks its clients): the port's
counterpart of experiments/multiproc_cluster.py. gloo for
`--device cpu` (the CPU "cluster" the tests drive), NCCL for CUDA (one
card a rank).

    python -m speaker_recognition_tpu_torch.parallel.launch \\
        [--configs 1,2] [--device cuda|cpu] [--frames 32768] [--out rows.jsonl]

runs parallel/multihost.scaling_report at each process count in
`--configs` and prints one JSON line a configuration (rank 0's report).
`run(n, "module:function", kwargs)` is the library form: it returns every
rank's return value, and kills the processes of a run that outlives its
timeout (a rendezvous can hang).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def run(n: int, fn: str, kwargs: dict | None = None,
        device: str = "cuda", timeout: float = 120.0,
        path: list | None = None) -> list:
    """fn ("module:function") called with **kwargs on each of n processes,
    ranks 0..n-1 of one group on `device`; every rank's return value, in
    rank order. `path`: directories the processes import from besides the
    repo's root. Raises if a process fails or the run outlives
    `timeout` seconds."""
    from .multihost import host_store

    # the ranks' rendezvous, up before they start: no port is picked and
    # released for a rank to bind later, when another process may have it
    store = host_store(None)
    with tempfile.TemporaryDirectory() as tmp:
        spec = os.path.join(tmp, "spec.pkl")
        with open(spec, "wb") as f:
            pickle.dump({"fn": fn, "kwargs": kwargs or {}}, f)
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_REPO, *(path or []), os.environ.get("PYTHONPATH", "")]))
        if device == "cpu":  # n processes share the host's cores
            env.setdefault("OMP_NUM_THREADS", "2")
        port = store.port
        logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+")
                for r in range(n)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "speaker_recognition_tpu_torch.parallel."
             "launch", "--worker", str(r), "--num-processes", str(n),
             "--port", str(port), "--device", device, "--spec", spec,
             "--result", os.path.join(tmp, f"rank{r}.pkl")],
            env=env, cwd=_REPO, stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        deadline = time.monotonic() + timeout
        try:
            for p in procs:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        outs = []
        for f in logs:
            f.seek(0)
            outs.append(f.read())
            f.close()
        bad = [(r, p.returncode, o) for r, (p, o) in
               enumerate(zip(procs, outs)) if p.returncode != 0]
        if bad:
            raise RuntimeError("launch: ranks failed:\n" + "\n".join(
                f"rank {r} ({rc}):\n{o[-3000:]}" for r, rc, o in bad))
        results = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _worker(args):
    import torch.distributed as dist

    from . import multihost

    store = dist.TCPStore("localhost", args.port, None, False,
                          timeout=multihost.TIMEOUT)
    multihost.initialize(None, args.num_processes, args.worker,
                         device=args.device, store=store)
    try:
        with open(args.spec, "rb") as f:
            spec = pickle.load(f)
        mod, name = spec["fn"].split(":")
        out = getattr(importlib.import_module(mod), name)(**spec["kwargs"])
        with open(args.result, "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--configs", default="1,2",
                    help="comma list of process counts")
    ap.add_argument("--device", default="cuda", help="cuda (NCCL) or cpu "
                    "(gloo)")
    ap.add_argument("--frames", type=int, default=32768,
                    help="EM frames a process")
    ap.add_argument("--timeout", type=float, default=120.0)
    ap.add_argument("--out", default=None, help="append the rows here")
    ap.add_argument("--worker", type=int, default=None)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--spec", default=None)
    ap.add_argument("--result", default=None)
    args = ap.parse_args(argv)
    if args.worker is not None:
        _worker(args)
        return
    for n in (int(c) for c in args.configs.split(",")):
        row = run(n, "speaker_recognition_tpu_torch.parallel.multihost:"
                  "scaling_report",
                  {"frames_per_device": args.frames, "device": args.device},
                  device=args.device, timeout=args.timeout)[0]
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")


if __name__ == "__main__":
    main()
