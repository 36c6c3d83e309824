"""One run of one cell: set-up, the measured window, the comparison.

Set-up (counted in setup_s, from the process's start to the first timed
call): the cell's files, the program and its CUDA library (built on the
first run in a checkout), the bank and the pool of input batches made on
the device from the seed, then the window's own loop twice over the pool
(the cell's only shape, and the allocator's blocks for the batches in
flight). The set-up's objects are then frozen out of the collector's
way.

The window is a closed loop over the pool with `in_flight` batches in
flight: enqueue batch i + 1 (the program's predict_scores, the argmax on
the card, and the labels' copy into pinned host memory with an event after
it), then wait for batch i's event. The copy is enqueued with its own
batch: a `.cpu()` issued when batch i is awaited would queue behind batch
i + 1's kernels on the stream and leave one batch in flight. A batch's
latency runs from the start of its predict_scores call to its labels being
on the host; only batches whose labels arrive inside the window count in
audio_s_per_s and batch_p95_ms. Once the window closes, the batches still
in flight are waited for; their labels are checked with the others.

With trace on, an untraced pass of the same loop (TRACE_SECONDS) gives
the host's time in each call, and then the window (at most TRACE_SECONDS)
runs under torch.profiler; the per-layer metrics are read from the two
instead.

The comparison runs after the window, the peak memory read and the bank
freed: every pool batch through the plain reference; the program's scores
of one call per pool batch (drawn from the seed) against the reference's,
and every label the window produced against the reference's scores.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import gc
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from . import compare, spec, traffic
from .trace import Trace
from .yardstick import counts

TRACE_SECONDS = 2.0
WARMUP_ROUNDS = 2
# the modules the benchmark may not load, by top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "speaker_recognition_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is a forbidden one, compared
    whole (speaker_recognition_tpu_torch is not speaker_recognition_tpu)."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def feature_config(features: dict):
    """The program's FeatureConfig of a configuration file's `features`
    group, every field given."""
    from speaker_recognition_tpu_torch.config import (FeatureConfig,
                                                      LpcConfig, MfccConfig)

    def build(cls, values: dict):
        names = {f.name for f in dataclasses.fields(cls)}
        if set(values) != names:
            raise ValueError(f"{cls.__name__} fields {sorted(names)}, the "
                             f"file gives {sorted(values)}")
        return cls(**values)

    rest = {k: v for k, v in features.items() if k not in ("mfcc", "lpc")}
    return build(FeatureConfig, dict(rest, mfcc=build(MfccConfig,
                                                      features["mfcc"]),
                                     lpc=build(LpcConfig, features["lpc"])))


def bank_params(config: dict, seed: int, device) -> dict:
    """The bank's raw parameters from the seed, made on the device in three
    calls and handed over as float32 numpy: weights [S, K] (a softmax of
    Gaussians), means [S, K, d] (Gaussian, of std means_std), sigmas
    [S, K, d] (uniform in [sigma_min, sigma_max])."""
    b = config["bank"]
    S, K, d = b["speakers"], b["components"], b["dim"]
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.sub_seed(seed, 3))
    f32 = dict(generator=gen, device=device, dtype=torch.float32)
    weights = torch.softmax(torch.randn((S, K), **f32), dim=-1)
    means = torch.randn((S, K, d), **f32) * float(b["means_std"])
    sigmas = (float(b["sigma_min"]) + (float(b["sigma_max"])
                                      - float(b["sigma_min"]))
              * torch.rand((S, K, d), **f32))
    return {k: v.cpu().numpy() for k, v in
            (("weights", weights), ("means", means), ("sigmas", sigmas))}


@dataclasses.dataclass
class Call:
    pool_index: int
    t_start: float
    host_s: float = 0.0         # the host's time in predict_scores
    t_done: float = 0.0
    labels: np.ndarray | None = None


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip() or f"not read ({out.stderr.strip()})"


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, device,
        t_process: float, root: str = spec.ROOT) -> dict:
    """One run of `cell`: the result line's dict (its keys in order, the
    checks last) with `stderr_lines`, the checks' lines for the end of
    standard error."""
    from speaker_recognition_tpu_torch import _build
    from speaker_recognition_tpu_torch.api import fastpath
    from speaker_recognition_tpu_torch.models.gmm import GmmBank

    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    config, mix = cell.config, cell.mix
    if config.get("dtype", "float32") != "float32":
        raise ValueError("the harness drives the float32 program")
    if cuda:
        torch.cuda.set_device(device)
        _build.load()
    t_lib = time.perf_counter()
    fs = int(config["fs"])
    fcfg = feature_config(config["features"])
    params = bank_params(config, seed, device)
    bank = GmmBank.from_numpy(params["weights"], params["means"],
                              params["sigmas"], device=device)
    pool = traffic.make_pool(mix, fs, seed, device)

    B, S = len(pool[0].lengths_np), int(config["bank"]["speakers"])
    in_flight = int(mix["in_flight"])
    # pinned label buffers with their events, one more than the batches in
    # flight; one kept call's scores a pool batch, copied on the card
    ring = [(torch.empty(B, dtype=torch.int64, pin_memory=cuda),
             torch.cuda.Event() if cuda else None)
            for _ in range(in_flight + 1)]
    kept = [torch.empty((B, S), device=device) for _ in pool]
    profiler = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile
        profiler = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))

    profiling = False

    def span(name):
        if not profiling:
            return contextlib.nullcontext()
        return torch.profiler.record_function("perfbench." + name)

    def finish(c: Call, host, event):
        with span("wait"):
            if event is not None:
                event.synchronize()
            c.labels = host.numpy().copy()
        c.t_done = time.perf_counter()

    def closed_loop(stop, keep) -> list[Call]:
        """Calls of the program over the pool, `in_flight` in flight, until
        stop(calls made): each call's labels (and, where keep(pool index),
        its scores) copied out right behind it on the stream."""
        calls, queue = [], collections.deque()
        while not stop(len(calls)):
            p = len(calls) % len(pool)
            c = Call(p, time.perf_counter())
            with span("predict"):
                scores = fastpath.predict_scores(
                    pool[p].signals, pool[p].lengths, bank, fs, fcfg,
                    mm="f32")
            c.host_s = time.perf_counter() - c.t_start
            with span("argmax"):
                host, event = ring[len(calls) % len(ring)]
                labels = scores.argmax(dim=1)
                if keep(p):
                    kept[p].copy_(scores)
                if cuda:
                    host.copy_(labels, non_blocking=True)
                    event.record()
                else:
                    host = labels
            calls.append(c)
            queue.append((c, host, event))
            if len(queue) >= in_flight:
                finish(*queue.popleft())
        while queue:
            finish(*queue.popleft())
        return calls

    # warm-up: the window's own loop, twice over the pool
    t_inputs = time.perf_counter()
    closed_loop(lambda n: n >= WARMUP_ROUNDS * len(pool), lambda p: True)
    t_warm = time.perf_counter()
    untraced = []
    if trace:
        # the host's time a call, read without the profiler's own cost
        t_end = time.perf_counter() + TRACE_SECONDS
        untraced = closed_loop(lambda n: time.perf_counter() >= t_end,
                               lambda p: False)
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)

    window = min(seconds, TRACE_SECONDS) if trace else seconds
    pick = random.Random(traffic.sub_seed(seed, 4))
    seen = collections.Counter()

    def reservoir(p: int) -> bool:
        """Whether to keep this call's scores: each call of pool batch p is
        the kept one with the same chance."""
        seen[p] += 1
        return pick.random() * seen[p] < 1.0

    # the set-up's objects out of the collector's way, so that a full
    # collection inside the window walks only what the loop makes
    gc.collect()
    gc.freeze()
    profiling = trace
    with profiler as prof:
        setup_s = time.perf_counter() - t_process
        t_end = time.perf_counter() + window
        calls = closed_loop(lambda n: time.perf_counter() >= t_end,
                            reservoir)
        if cuda:
            torch.cuda.synchronize(device)
    profiling = False
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    done = [c for c in calls if c.t_done <= t_end]
    result = {"correct": False, "attempted": len(calls) * B,
              "failed": B * sum(c.labels is None for c in calls)}
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    lines = [f"set-up s: {t_lib - t_process:.3f} to the program's library "
             f"(imports, CUDA, the library loaded or built), "
             f"{t_inputs - t_lib:.3f} bank and pool, "
             f"{t_warm - t_inputs:.3f} warm-up"
             + (f", {t_process + setup_s - t_warm:.3f} the untraced pass "
                "and the profiler's start" if trace else "")]
    if trace:
        metrics, dev_extra, breakdown = _read_trace(
            prof, cell, pool, calls, untraced, root)
        dev.update(dev_extra)
        lines.append(f"card: {power_limit()}")
    else:
        metrics = _end_to_end(cell, pool, done, window, setup_s)
        breakdown = None
        lat = sorted((c.t_done - c.t_start) * 1e3 for c in done)
        if lat:
            q = {f"p{p}": lat[min(len(lat) - 1, int(p / 100 * len(lat)))]
                 for p in (50, 90, 99)}
            lines.append(f"latency ms over {len(lat)} batches: " + ", ".join(
                f"{k} {v:.3f}" for k, v in q.items()) + f", max {lat[-1]:.3f}")
    gc.unfreeze()

    # the comparison: the program's state freed, the peak read
    del bank
    scores_kept = {p: kept[p].cpu().numpy() for p in seen}
    labels = collections.defaultdict(list)
    for c in untraced + calls:
        if c.labels is not None:
            labels[c.pool_index].append(c.labels)
    del kept
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    readings = compare.readings(config, pool, params, scores_kept,
                                {p: np.stack(v) for p, v in labels.items()},
                                device)
    lines.append(f"comparison: {time.perf_counter() - t_ref:.3f} s, "
                 f"{len(untraced) + len(calls)} calls' labels, {len(scores_kept)} calls' "
                 "scores")
    checks = compare.checks(readings, cell.limits, result["failed"])
    result["correct"] = compare.passed(checks)
    result["metrics"] = metrics
    result["device"] = dev
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    lines += [f"check {k}: {v['value']!r} (limit {v['limit']!r})"
              for k, v in checks.items()]
    result["stderr_lines"] = lines
    return result


def _end_to_end(cell, pool, done, seconds, setup_s) -> dict:
    values = {}
    lat = [(c.t_done - c.t_start) * 1e3 for c in done]
    if done:
        values["audio_s_per_s"] = sum(pool[c.pool_index].audio_s
                                      for c in done) / seconds
    if len(lat) >= 2:
        values["batch_p95_ms"] = statistics.quantiles(lat, n=100)[94]
    values["setup_s"] = setup_s
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


@dataclasses.dataclass
class Reading:
    """What a per-layer metric's reader is given."""

    trace: Trace
    batches: int           # predict calls in the traced window
    host_s: list           # host seconds of each predict call of the
                           # untraced pass before the window
    least: dict            # least seconds a batch: frontend, score, predict
    cell: spec.Cell
    pool: list             # the window's input batches (traffic.Batch)
    root: str

    def reader(self, name: str):
        """Another per-layer metric's reader module."""
        return spec.metric_reader(name, self.root)

    def metric(self, name: str):
        """Another per-layer metric's value in this run (or None)."""
        return self.reader(name).read(self)


def least_times(cell: spec.Cell, pool) -> dict:
    """The yardstick's least seconds of one batch (the mean over the pool):
    the frontend, the scoring and the whole predict step."""
    cfg, fs = cell.config, int(cell.config["fs"])
    b = cfg["bank"]
    out = collections.defaultdict(float)
    for batch in pool:
        lens = batch.lengths_np
        frames = counts.valid_frames(fs, cfg["features"], lens)
        out["frontend"] += counts.frontend_work(
            fs, cfg["features"], lens).least_s() / len(pool)
        out["score"] += counts.score_work(
            frames, b["dim"], b["speakers"], b["components"],
            len(lens)).least_s() / len(pool)
        out["predict"] += counts.predict_work(
            fs, cfg["features"], lens, b["speakers"],
            b["components"]).least_s() / len(pool)
    return dict(out)


def _read_trace(prof, cell, pool, calls, untraced, root):
    fd, path = tempfile.mkstemp(suffix=".json", prefix="perfbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        tr = Trace.load(path)
    finally:
        os.remove(path)
    ctx = Reading(tr, len(calls), [c.host_s for c in untraced],
                  least_times(cell, pool), cell, pool, root)
    metrics = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"], root).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    return (metrics, {"busy_s": tr.busy_s, "window_s": tr.window_s},
            tr.breakdown())
