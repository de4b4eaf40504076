"""Tracing/profiling hooks (SURVEY.md §5.1: the reference has none; timing is
first-class here because the headline metric is full-cohort wall-clock).

- ``span(name)``: the program's one named range.  It opens a range on the
  ``torch.profiler`` timeline, on the clock of the card's kernels and
  copies, and adds one call and its host seconds to the process's totals
  by name (``report``, ``counts``).  Off the profiler it costs one range
  enter and exit and two clock reads.
- ``stage(name)``: a span of a pipeline stage, with a log line.
- ``trace(dir, device)``: optional ``torch.profiler`` trace around a region,
  written as a Chrome trace (view in Perfetto or chrome://tracing).
- ``device_ms(fn)``: the card's time per call of ``fn``, from CUDA events.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

from torch._C._profiler import _RecordFunctionFast
from torch.profiler import record_function

from .logging import get_logger

log = get_logger("prof")

_SECONDS: Dict[str, float] = defaultdict(float)
_CALLS: Dict[str, int] = defaultdict(int)


@contextlib.contextmanager
def span(name: str, device_range: bool = False):
    """A named range: on the profiler's host timeline, and one call and its
    host seconds in the totals.

    ``device_range``: a user range (``record_function``), which the
    profiler also draws on the device from the first to the last kernel it
    launched.  The profiler gives each kernel to the innermost user range
    open at its launch, so a user range opened inside another takes the
    outer one's kernels.  A span is therefore a host-only range unless it
    names a launch whose device time is read (``fleet_train``,
    ``member_summary``), and nothing inside those opens a user range."""
    t0 = time.perf_counter()
    try:
        with (record_function(name) if device_range else _RecordFunctionFast(name)):
            yield
    finally:
        _SECONDS[name] += time.perf_counter() - t0
        _CALLS[name] += 1


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        log.info("[stage] %s: %.2fs", name, time.perf_counter() - t0)


def report() -> Dict[str, float]:
    """Host seconds by span name since the last ``reset``."""
    return dict(_SECONDS)


def counts() -> Dict[str, int]:
    """Calls by span name since the last ``reset``."""
    return dict(_CALLS)


def reset() -> None:
    _SECONDS.clear()
    _CALLS.clear()


def device_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` of the device time per call of ``inner``
    back-to-back calls of ``fn`` between two CUDA events.  A sleep kernel
    queued first lets the host enqueue all the calls (and their output
    allocations) before the device reaches them, so the host's launch cost
    does not enter the time.  The first call is a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


@contextlib.contextmanager
def trace(log_dir: str = "lesionvae_trace", device: str = "cuda"):
    """torch.profiler trace around a region → ``log_dir/trace.json``.

    Records host activity always and the card's kernels when ``device`` is a
    CUDA device."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(str(out / "trace.json"))
        log.info("profiler trace written to %s", out / "trace.json")
