"""The share of the traced window that the device idled because the host
launched late: an idle gap between device activity counts when the
operation that ends it was launched after the gap began, from inside one
of the program's `srt.*` spans. A gap whose closing operation was already
queued when the gap began is the device's own bubble, and does not count;
nor does the window's last gap, which nothing closes.

An upper bound: it is read under torch.profiler, whose own host cost
(each launch and each `srt.*` range recorded) makes the host later than
it is untraced, and it follows the shared host's speed from run to run.
Alone it does not say that host-side work would move the untraced rate;
set it beside the untraced pass's host seconds a call (`host_enqueue_ms`)
against the device's seconds a batch (`busy_s` over the batches)."""

import bisect
import collections

LAYER = "device"
UNIT = "%"
BETTER = "lower"
MOVES = "audio_s_per_s"


def late_gaps(ctx):
    """[(the innermost program span that held the late launch, seconds)]
    of each gap the host caused, or None where the trace holds none of the
    program's spans."""
    tr = ctx.trace
    att = ctx.reader("frontend_span_ms").Attribution(tr)
    if not att.spans:
        return None
    ops = sorted(tr.device, key=lambda e: e.start)
    starts = [e.start for e in ops]
    out, prev = [], tr.t0
    for s, e in tr.busy_intervals():
        if s > prev:
            closing = ops[bisect.bisect_left(starts, s):
                          bisect.bisect_right(starts, s)]
            launches = [c for c in map(att.launch, closing) if c is not None]
            if launches:
                first = min(launches, key=lambda c: c.start)
                held = att.spans_at(first.start)
                if first.start > prev and held:
                    out.append((held[0], (s - prev) * 1e-6))
        prev = max(prev, e)
    return out


def by_span(ctx) -> dict:
    """Seconds of late-launch idle by the innermost program span that held
    the late launch."""
    out = collections.Counter()
    for name, s in late_gaps(ctx) or []:
        out[name] += s
    return dict(out)


def read(ctx):
    window = ctx.trace.window_s
    gaps = late_gaps(ctx)
    if window <= 0 or not ctx.trace.device or gaps is None:
        return None
    return 100.0 * sum(s for _, s in gaps) / window
