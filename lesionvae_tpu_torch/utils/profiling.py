"""Tracing/profiling hooks (SURVEY.md §5.1: the reference has none; timing is
first-class here because the headline metric is full-cohort wall-clock).

- ``stage(name)``: context manager recording wall-clock per pipeline stage
  into a process-global report (and the log).
- ``trace(dir, device)``: optional ``torch.profiler`` trace around a region,
  written as a Chrome trace (view in Perfetto or chrome://tracing).
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Tuple

from .logging import get_logger

log = get_logger("prof")

_STAGES: List[Tuple[str, float]] = []


@contextlib.contextmanager
def stage(name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        _STAGES.append((name, dt))
        log.info("[stage] %s: %.2fs", name, dt)


def report() -> Dict[str, float]:
    """Aggregate wall-clock per stage name."""
    out: Dict[str, float] = {}
    for name, dt in _STAGES:
        out[name] = out.get(name, 0.0) + dt
    return out


def reset() -> None:
    _STAGES.clear()


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
