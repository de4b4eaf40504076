"""The traced window: ``torch.profiler`` over whole jobs, read in memory.

``Capture`` records host and device activity; ``Trace`` reduces it to what
the per-layer metrics read:

- device operations (kernels, copies, fills): every device event that is
  not a ``record_function`` range; ``busy_s`` is the length of their union
  inside the window (the harness's ``window`` range), ``window_s`` that
  window's length;
- ``op_seconds(pattern)``: the summed device time of the operations whose
  name matches a regular expression;
- ``range_seconds(name)``: the summed device-side span of a host range
  (from the first to the last device operation it launched): the range's
  device annotation where the profiler gives one, else the operations whose
  launch calls lie inside the host range, by correlation id;
- ``breakdown()``: the ten device operations that took most time, and the
  idle time inside the window by the innermost harness or program range
  open on the host at each instant of it.
"""

from __future__ import annotations

import bisect
import dataclasses
import re
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

WINDOW = "window"


@dataclasses.dataclass(frozen=True)
class Event:
    name: str
    on_device: bool
    start: int          # ns, the profiler's clock
    end: int
    corr: int = 0
    kind: str = ""     # the profiler's activity type, where it gives one


def _call(e, *names):
    for n in names:
        f = getattr(e, n, None)
        if f is not None:
            try:
                return f()
            except (RuntimeError, TypeError):
                continue
    return None


def from_kineto(events) -> List[Event]:
    """``Event``s of a profiler's raw (kineto) events."""
    out = []
    for e in events:
        start = _call(e, "start_ns")
        dur = _call(e, "duration_ns")
        if start is None:
            start, dur = _call(e, "start_us") * 1000, _call(e, "duration_us") * 1000
        kind = _call(e, "activity_type")
        out.append(Event(str(_call(e, "name")), "CUDA" in str(_call(e, "device_type")),
                         int(start), int(start + dur), int(_call(e, "correlation_id") or 0),
                         str(kind or "")))
    return out


class Capture:
    """``with Capture() as cap:`` profiles host and device; ``cap.events``."""

    def __enter__(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        self.events = from_kineto(self.prof.profiler.kineto_results.events())
        return False


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def short(name: str) -> str:
    """A device operation's name without its return type and arguments."""
    name = re.sub(r"^void\s+", "", name.strip()).replace("(anonymous namespace)::", "")
    return name.split("(")[0].strip()[:96]


class Trace:
    """The reduction of a capture; ``ranges`` names the host ranges of the
    harness and the program (every other event name is an operation)."""

    def __init__(self, events: Sequence[Event], ranges: Sequence[str]):
        self.ranges = set(ranges) | {WINDOW}
        host = [e for e in events if not e.on_device and e.name in self.ranges]
        windows = [e for e in host if e.name == WINDOW]
        if not windows:
            raise ValueError("the capture holds no window range")
        self.w0, self.w1 = windows[0].start, windows[-1].end
        self.host_ranges = [e for e in host if e.name != WINDOW]
        self.device_ranges = [e for e in events if e.on_device and e.name in self.ranges]
        self.ops = [e for e in events if e.on_device and e.name not in self.ranges
                    and "annotation" not in e.kind]
        self.launches = [e for e in events if not e.on_device and e.corr
                         and e.name.startswith("cu")]
        self.busy = merge((max(e.start, self.w0), min(e.end, self.w1)) for e in self.ops
                          if e.end > self.w0 and e.start < self.w1)

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) / 1e9

    def op_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(min(e.end, self.w1) - max(e.start, self.w0) for e in self.ops
                   if rx.search(e.name) and e.end > self.w0 and e.start < self.w1) / 1e9

    def range_seconds(self, name: str) -> Optional[float]:
        spans = [(e.start, e.end) for e in self.device_ranges if e.name == name]
        if not spans:
            spans = []
            for r in (h for h in self.host_ranges if h.name == name):
                corr = {c.corr for c in self.launches if r.start <= c.start <= r.end}
                mine = [(o.start, o.end) for o in self.ops if o.corr in corr]
                if mine:
                    spans.append((min(s for s, _ in mine), max(e for _, e in mine)))
        if not spans:
            return None
        return sum(e - s for s, e in merge(spans)) / 1e9

    def label(self, t: int) -> str:
        """The innermost host range open at ``t`` (the latest begun)."""
        open_ = [h for h in self.host_ranges if h.start <= t < h.end]
        return max(open_, key=lambda h: h.start).name if open_ else "harness"

    def breakdown(self, top: int = 10) -> dict:
        by_op: Dict[str, float] = defaultdict(float)
        for e in self.ops:
            by_op[short(e.name)] += (e.end - e.start) / 1e9
        idle: Dict[str, float] = defaultdict(float)
        # the host ranges cut the window into segments, each with one label
        bounds = sorted({self.w0, self.w1} | {t for h in self.host_ranges
                                               for t in (h.start, h.end)
                                               if self.w0 < t < self.w1})
        labels = [self.label(t) for t in bounds[:-1]]
        edges = [self.w0] + [t for s, e in self.busy for t in (s, e)] + [self.w1]
        for s, e in zip(edges[0::2], edges[1::2]):
            i = bisect.bisect_right(bounds, s) - 1
            while s < e:
                cut = min(e, bounds[i + 1])
                idle[labels[i]] += (cut - s) / 1e9
                s, i = cut, i + 1
        def rank(d):
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": rank(by_op), "idle_gaps": rank(idle)}
