"""Tracing and profiling, as speaker_recognition_tpu/utils/profiling.py on
the card:

  * phase_timer: a context manager that times a phase with CUDA events
    around the work on the device's current stream (waiting for the end
    event, so asynchronous launches do not fake speed), or with the host
    clock on the CPU, and records a structured row into a registry
    (jsonl-able, SURVEY.md section 5);
  * trace: a torch.profiler scope that writes a Chrome trace of the host
    and the card;
  * roofline: the achieved share of the card's peak for one kernel, from
    its FLOPs, bytes and time.

The registry is an object a caller makes (`Metrics`); `metrics` is the
module's default one.
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import torch

__all__ = ["Metrics", "metrics", "phase_timer", "record_metric",
           "dump_metrics", "trace", "roofline", "CHIP_PEAKS", "CARD"]


class Metrics(list):
    """Structured metric rows ({"phase": ..., "seconds": ..., labels})."""

    def dump(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            for m in self:
                f.write(json.dumps(m) + "\n")


metrics = Metrics()


@contextlib.contextmanager
def phase_timer(name: str, device="cuda", registry: Metrics | None = None,
                **labels):
    """Time a phase on `device`: CUDA events on its current stream, the end
    event waited for before the row is written (`seconds`, plus `device`
    and the labels); the host clock for a CPU device. The row is yielded
    too, filled in when the block ends."""
    device = torch.device(device)
    reg = metrics if registry is None else registry
    row: dict = {"phase": name, "device": str(device), **labels}
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(torch.cuda.current_stream(device))
        try:
            yield row
        finally:
            end.record(torch.cuda.current_stream(device))
            end.synchronize()
            row["seconds"] = start.elapsed_time(end) / 1e3
            reg.append(row)
        return
    t0 = time.perf_counter()
    try:
        yield row
    finally:
        row["seconds"] = time.perf_counter() - t0
        reg.append(row)


def record_metric(name: str, registry: Metrics | None = None, **labels):
    """Append one structured row without timing anything."""
    (metrics if registry is None else registry).append({"phase": name,
                                                        **labels})


def dump_metrics(path: str, registry: Metrics | None = None):
    (metrics if registry is None else registry).dump(path)


@contextlib.contextmanager
def trace(logdir: str, device="cuda"):
    """torch.profiler over the block, host and (on a CUDA device) the card;
    the Chrome trace lands in logdir/trace.json. Yields the profiler
    (key_averages() for sums by kernel)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


# Datasheet peaks of the card the port targets (NVIDIA H100 SXM, dense,
# at its 700 W power limit; a card set below it runs slower under load):
# FP32 outside the tensor cores, TF32 and bf16 on them, HBM3. The figures
# chip_smoke.py's bounds use.
CARD = "NVIDIA H100 SXM (80 GB HBM3), 700 W"
CHIP_PEAKS = {
    "h100": {"f32_tflops": 67.0, "tf32_tflops": 495.0, "bf16_tflops": 989.0,
             "hbm_gbps": 3350.0},
}


def roofline(flops: float, bytes_moved: float, seconds: float,
             chip: str = "h100", dtype: str = "f32") -> dict:
    """Achieved share of the card's roofline for one kernel: FLOPs at the
    peak of `dtype` (f32: FP32 outside the tensor cores; tf32, bf16: on
    them) against bytes at the HBM rate. Raises if the share exceeds 1:
    that means the peak or the count is misapplied, and an impossible
    number must never be recorded."""
    peaks = CHIP_PEAKS[chip]
    peak_flops = peaks[f"{dtype}_tflops"] * 1e12
    peak_bw = peaks["hbm_gbps"] * 1e9
    intensity = flops / max(bytes_moved, 1.0)
    bound = "compute" if intensity >= peak_flops / peak_bw else "memory"
    limit = peak_flops if bound == "compute" else peak_bw * intensity
    achieved = flops / seconds
    fraction = achieved / limit
    if fraction > 1.0:
        raise ValueError(
            f"impossible fraction_of_roofline {fraction:.3f} (> 1): "
            f"flops={flops:.3g}, bytes={bytes_moved:.3g}, t={seconds:.3g}s, "
            f"peak={peak_flops / 1e12:.0f} TF ({dtype}) - the cost model or "
            "the peak selection is wrong")
    return {"achieved_tflops": achieved / 1e12,
            "intensity_flops_per_byte": intensity, "bound": bound,
            "fraction_of_roofline": fraction,
            "peak_tflops": peak_flops / 1e12, "dtype": dtype, "card": CARD}
