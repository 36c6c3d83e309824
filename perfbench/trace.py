"""The traced window: torch.profiler's Chrome trace, reduced to what the
per-layer readers take.

The harness marks its own host spans with torch.profiler.record_function:
`perfbench.predict` around each call of the program, `perfbench.argmax`
around the labels' argmax on the card and `perfbench.wait` around their
copy to the host. From the trace come:

- the device's kernels and copies (name, start, duration in us);
- which harness span launched each kernel (by the launch's correlation id,
  where the trace links it to a host runtime call);
- the traced window, from the first harness span's start to the last
  device or harness event's end, and the union of device activity in it;
- the idle gaps between device activity, each with what the host was
  doing at its middle (the innermost host event there, under its harness
  span).
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import json

SPAN_PREFIX = "perfbench."
DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset"}
HOST_CATS = {"cpu_op", "user_annotation", "cuda_runtime", "cuda_driver",
             "python_function"}


@dataclasses.dataclass
class Event:
    name: str
    start: float        # us
    dur: float          # us
    cat: str
    corr: int | None = None

    @property
    def end(self) -> float:
        return self.start + self.dur


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without its return type, anonymous namespace and
    arguments, cut to `width` characters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            name = name[:i]
            break
    return name[:width]


def _merge(intervals):
    """Sorted, disjoint unions of (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """A Chrome trace (the dict torch.profiler's export_chrome_trace
    writes) as device events, host events and harness spans."""

    def __init__(self, chrome: dict):
        self.device: list[Event] = []
        self.host: list[Event] = []
        launch_ts: dict[int, float] = {}
        for ev in chrome.get("traceEvents", []):
            if ev.get("ph") != "X" or "dur" not in ev:
                continue
            cat = str(ev.get("cat", "")).lower()
            args = ev.get("args") or {}
            corr = args.get("correlation")
            e = Event(str(ev.get("name", "")), float(ev["ts"]),
                      float(ev["dur"]), cat, corr)
            if cat in DEVICE_CATS:
                self.device.append(e)
            elif cat in HOST_CATS:
                self.host.append(e)
                if cat in ("cuda_runtime", "cuda_driver") and corr is not None:
                    launch_ts[corr] = e.start
        self.spans = sorted((e for e in self.host
                             if e.cat == "user_annotation"
                             and e.name.startswith(SPAN_PREFIX)),
                            key=lambda e: e.start)
        self.host.sort(key=lambda e: e.start)
        self._host_starts = [e.start for e in self.host]
        self._span_starts = [e.start for e in self.spans]
        self._launch_ts = launch_ts
        ends = [e.end for e in self.device] + [e.end for e in self.spans]
        self.t0 = self.spans[0].start if self.spans else 0.0
        self.t1 = max(ends) if ends else self.t0
        self.device = [e for e in self.device if e.end > self.t0]

    @classmethod
    def load(cls, path: str) -> "Trace":
        with open(path) as f:
            return cls(json.load(f))

    @property
    def kernels(self) -> list[Event]:
        return [e for e in self.device if e.cat == "kernel"]

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self):
        return _merge((max(e.start, self.t0), min(e.end, self.t1))
                      for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def _span_at(self, ts: float) -> Event | None:
        i = bisect.bisect_right(self._span_starts, ts) - 1
        while i >= 0:
            s = self.spans[i]
            if s.start <= ts <= s.end:
                return s
            if ts - s.start > 1e6:
                break
            i -= 1
        return None

    def launched_in(self, ev: Event) -> str | None:
        """The harness span (without its prefix) whose host time holds the
        launch of device event `ev`, or None where the trace does not link
        it."""
        ts = self._launch_ts.get(ev.corr)
        span = None if ts is None else self._span_at(ts)
        return None if span is None else span.name[len(SPAN_PREFIX):]

    def _host_at(self, ts: float) -> str:
        """The innermost host event at time ts, under its harness span."""
        j = bisect.bisect_right(self._host_starts, ts)
        inner = None
        for e in self.host[max(0, j - 64):j]:
            if e.end >= ts and (inner is None or e.dur < inner.dur):
                inner = e
        span = self._span_at(ts)
        where = span.name if span is not None else "outside the harness spans"
        if inner is None or inner is span:
            return where
        return f"{where} > {short_name(inner.name, 64)}"

    def idle_gaps(self):
        """[(host activity, seconds)] of each gap between device activity
        inside the window, its ends included."""
        gaps, prev = [], self.t0
        for s, e in self.busy_intervals():
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        if self.t1 > prev:
            gaps.append((prev, self.t1))
        return [(self._host_at(0.5 * (s + e)), (e - s) * 1e-6)
                for s, e in gaps]

    def breakdown(self, n: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each the `n` largest, in seconds."""
        ops = collections.Counter()
        for e in self.device:
            ops[short_name(e.name)] += e.dur * 1e-6
        idle = collections.Counter()
        for what, s in self.idle_gaps():
            idle[what] += s
        return {"device_ops": [[k, v] for k, v in ops.most_common(n)],
                "idle_gaps": [[k, v] for k, v in idle.most_common(n)]}
