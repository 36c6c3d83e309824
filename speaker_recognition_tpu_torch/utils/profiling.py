"""Tracing: the program's spans and the operator's trace exporter.

  * span(name): a torch.profiler range around a stage of the program
    (`srt.predict`, `srt.frontend.glue`, `srt.frontend.kernel`,
    `srt.score` on the serving path). While the profiler records it is
    `record_function(name)`, which lands in the Chrome trace as a
    `user_annotation` on the clock of the card's kernels, so a kernel
    links by its launch's correlation id to the innermost span that
    launched it. Otherwise it is one shared null context: a span costs a
    check of the profiler's state when tracing is off. A span neither
    synchronises the device nor reads the host clock.
  * trace(logdir): torch.profiler over a block, host and (on a CUDA
    device) the card; its Chrome trace carries the program's spans.
"""

from __future__ import annotations

import contextlib
import os

import torch

__all__ = ["span", "trace"]

_OFF = contextlib.nullcontext()


def span(name: str):
    """A profiler range named `name` while the profiler records, else the
    module's shared null context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


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
