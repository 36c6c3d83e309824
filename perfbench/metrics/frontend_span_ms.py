"""Device time of the frontend's kernels a batch, by the program's own span:
the kernels launched inside `srt.frontend.kernel` (ops/gpu_frontend's
entry points: K1 or K5 from the signals, and cmvn_kernel), summed over the
traced window and divided by its batches. The twin of frontend_ms, which
matches kernel names instead.

Also the attribution the other span readers share: a device event links by
its correlation id to the runtime call that launched it, and that call to
the program's `srt.*` spans (user_annotation events) that held it. The
three stage spans (`srt.frontend.glue`, `srt.frontend.kernel`,
`srt.score`) must hold every kernel launched inside `srt.predict`: where
one lies in none of them, the three span readers return nothing, so a
`--trace 1` run lacks their metrics instead of losing that kernel's time
unseen.
"""

from __future__ import annotations

import bisect

LAYER = "frontend"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"

PREFIX = "srt."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STAGES = ("srt.frontend.glue", "srt.frontend.kernel", "srt.score")


class Attribution:
    """The program's spans of a trace (perfbench/trace.Trace) and the
    launch of each device event."""

    def __init__(self, trace):
        self.launches = {e.corr: e for e in trace.host
                         if e.cat in LAUNCH_CATS and e.corr is not None}
        self.spans = sorted((e for e in trace.host
                             if e.cat == "user_annotation"
                             and e.name.startswith(PREFIX)),
                            key=lambda e: e.start)
        self._starts = [e.start for e in self.spans]
        self._longest = max((e.dur for e in self.spans), default=0.0)

    def launch(self, ev):
        """The runtime call that launched device event `ev`, or None where
        the trace does not link it."""
        return self.launches.get(ev.corr)

    def spans_at(self, ts: float) -> list[str]:
        """The names of the program's spans that hold host time `ts`,
        innermost first."""
        out = []
        for i in range(bisect.bisect_right(self._starts, ts) - 1, -1, -1):
            s = self.spans[i]
            if ts - s.start > self._longest:
                break
            if s.end >= ts:
                out.append(s.name)
        return out

    def spans_of(self, ev) -> list[str]:
        """The program's spans that held the launch of device event `ev`,
        innermost first ([] where the trace does not link it)."""
        launch = self.launch(ev)
        return [] if launch is None else self.spans_at(launch.start)


def unattributed(att: Attribution, kernels) -> list:
    """The kernels launched inside `srt.predict` whose innermost program
    span is no stage span."""
    out = []
    for e in kernels:
        held = att.spans_of(e)
        if "srt.predict" in held and held[0] not in STAGES:
            out.append(e)
    return out


def device_ms(ctx, span: str):
    """Device ms a batch of the kernels whose launch's innermost program
    span is `span`, or None where there are none, or where a kernel of
    `srt.predict` lies outside the stage spans."""
    att = Attribution(ctx.trace)
    if unattributed(att, ctx.trace.kernels):
        return None
    us = sum(e.dur for e in ctx.trace.kernels
             if att.spans_of(e)[:1] == [span])
    if not us or not ctx.batches:
        return None
    return us / 1e3 / ctx.batches


def read(ctx):
    return device_ms(ctx, "srt.frontend.kernel")
