"""Starting the process group, and the scaling measurement, as in
speaker_recognition_tpu/parallel/multihost.py.

`initialize` starts torch.distributed with the backend of the device: NCCL
for CUDA, gloo for the CPU, with no fallback between them. Nothing tells a
process of a cluster, so the caller gives the coordinator's address, the
number of processes and this one's rank, or a store that is already up
(parallel/launch hosts one and starts n processes on localhost as its
clients). One process by itself rendezvouses through a store that binds a
free localhost port itself: a port picked first and bound later could be
taken by another process in between. The ('data', 'bank') mesh of
parallel/mesh then spans the processes: the 'data' axis's all_reduce runs
once per EM iteration.

`scaling_report` measures audio-seconds/s over the current processes for
the EM and bank-scoring workloads, so that runs at 1, 2 or more processes
give comparable JSON rows.
"""

from __future__ import annotations

import json
import time
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["initialize", "scaling_report", "backend", "host_store"]

# how long a collective, or the rendezvous, waits for the other ranks
TIMEOUT = timedelta(seconds=120)


def host_store(world_size: int | None = 1):
    """A TCPStore server on a free localhost port that it binds itself, so
    no other process can take the port first; its port is `.port`. A
    server for one process waits for that one client (itself), a hosted
    one (world_size None) for none."""
    return dist.TCPStore("localhost", 0, world_size, True, timeout=TIMEOUT,
                         wait_for_workers=world_size is not None)


def backend(device: torch.device | str) -> str:
    """The collective backend of a device type: nccl for CUDA, gloo for
    the CPU; any other device raises."""
    kind = torch.device(device).type
    if kind == "cuda":
        return "nccl"
    if kind == "cpu":
        return "gloo"
    raise ValueError(f"no collective backend for device {kind}")


def initialize(coordinator_address: str | None = None,
               num_processes: int = 1, process_id: int = 0,
               device: torch.device | str = "cuda", store=None):
    """Start the process group of `num_processes` processes, this one rank
    `process_id`, with the backend of `device`: through `store` when one
    is given (a client of the store parallel/launch hosts), else over
    tcp://coordinator_address (host:port), else, for a single process,
    through a store of its own (host_store). A CUDA process takes the card
    of its rank (modulo the cards it sees). Returns torch.distributed."""
    rendezvous = {}
    if store is not None:
        rendezvous["store"] = store
    elif coordinator_address is not None:
        rendezvous["init_method"] = f"tcp://{coordinator_address}"
    elif num_processes != 1:
        raise ValueError("several processes need the coordinator's address "
                         "or a store")
    else:
        rendezvous["store"] = host_store()
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(process_id % torch.cuda.device_count())
    dist.init_process_group(backend(device), world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT, **rendezvous)
    return dist


def _elapsed_ms(fn, device: torch.device) -> float:
    """ms of one call of fn: CUDA events on the card, the host clock
    otherwise."""
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def scaling_report(frames_per_device: int = 262_144, mixtures: int = 32,
                   dim: int = 28, iters: int = 5, bank: int = 128,
                   seed: int = 0, device: torch.device | str = "cuda") -> dict:
    """One EM and one bank-scoring measurement over every process of the
    group: EM of `iters` iterations on frames_per_device frames a process
    sharded over 'data', then one utterance (at most 65536 frames) against
    a `bank`-speaker bank sharded over 'bank'. Each is timed warm, after
    one untimed call, with CUDA events on the card. Returns a JSON-able
    record with the processes and the audio-s/s (16 ms frame shift)."""
    from ..config import GmmConfig
    from . import mesh as pmesh

    n_proc = dist.get_world_size()
    em_mesh = pmesh.make_mesh(data=n_proc, bank=1, device=device)
    dev = pmesh.mesh_device(em_mesh)
    n = frames_per_device * n_proc
    rng = np.random.RandomState(seed)
    X = rng.randn(n, dim).astype(np.float32)
    mask = np.ones(n, bool)
    cfg = GmmConfig(n_mixtures=mixtures, n_iterations=iters, threshold=0.0)
    fit = pmesh.sharded_fit(em_mesh, cfg)
    fit(X, mask)
    em_ms = _elapsed_ms(lambda: fit(X, mask), dev)

    score = pmesh.sharded_bank_scores(pmesh.make_mesh(data=1, bank=n_proc,
                                                      device=device))
    w = rng.rand(bank, mixtures) + 0.1
    bank_p = (w / w.sum(1, keepdims=True),
              rng.randn(bank, mixtures, dim), 0.5 + rng.rand(bank, mixtures,
                                                             dim))
    n_score = min(n, 65536)
    Xs = torch.as_tensor(X[:n_score], device=dev)
    ms = torch.ones(n_score, dtype=torch.bool, device=dev)
    score(bank_p, Xs, ms)
    score_ms = _elapsed_ms(lambda: score(bank_p, Xs, ms), dev)
    return {
        "processes": n_proc,
        "backend": dist.get_backend(),
        "device": str(dev),
        "em_workload_frames": n,
        "em_ms": em_ms,
        "em_audio_s_per_s": n * 0.016 * iters / (em_ms / 1e3),
        "bank": bank,
        "score_frames": n_score,
        "score_ms": score_ms,
        "score_audio_s_per_s": n_score * 0.016 / (score_ms / 1e3),
    }


if __name__ == "__main__":
    initialize()
    print(json.dumps(scaling_report()))
    dist.destroy_process_group()
