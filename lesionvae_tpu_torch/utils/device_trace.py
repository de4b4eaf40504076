"""On-device execution time from a ``torch.profiler`` trace (the port of
lesionvae_tpu/utils/device_trace.py).

``utils/profiling.trace`` writes a Chrome trace (``trace.json``).  On the
card its ``record_function`` ranges appear twice: on the host
(``user_annotation``) and on the device (``gpu_user_annotation``, from the
first to the last kernel the range launched).  The device ranges play the
JAX trace's "XLA Modules" line: the port names one range a launch after the
JAX program it replaces (``fleet_train``, ``member_summary``,
``streamline_metrics``, ``sh_fit``, ``score_fleet``), so the JAX stage rules
apply.  The port's other spans (``utils.profiling.span``: the launches'
draws, upload, state and fetch, ``vae_train``, each epoch) are host ranges,
so their kernels count under the device range around them.  Device ranges
may nest (``models.fleet.LAYER_RANGES``'s layer ranges, a range of the
caller's around a launch): a device second goes to the innermost range open
on the device then, once.  A trace without such ranges falls back to its kernels
by name, as the JAX reader falls back to a plane's busiest line; a
host-only trace (the CPU's) gives nothing.
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Tuple


def device_exec_by_module(trace_dir: str) -> Dict[str, float]:
    """Seconds of device execution per range name (or, with no device
    range, per kernel name) in the newest Chrome trace under
    ``trace_dir``.  Where ranges nest, each second is the innermost
    range's, so no second is counted twice."""
    files = sorted(Path(trace_dir).rglob("*.json"), key=lambda p: p.stat().st_mtime)
    if not files:
        return {}
    events = json.loads(files[-1].read_text()).get("traceEvents", [])
    ranges = [(float(ev.get("ts", 0)), float(ev.get("ts", 0)) + float(ev.get("dur", 0)),
               _clean(ev.get("name", ""))) for ev in events
              if ev.get("cat") == "gpu_user_annotation" and ev.get("ph") == "X"]
    if ranges:
        return _innermost_seconds(ranges)
    per_name: Dict[str, float] = defaultdict(float)
    for ev in events:
        if ev.get("cat") == "kernel" and ev.get("ph") == "X":
            per_name[_clean(ev.get("name", ""))] += float(ev.get("dur", 0)) / 1e6
    return dict(per_name)


def _innermost_seconds(ranges: List[Tuple[float, float, str]]) -> Dict[str, float]:
    """Seconds by name of ranges (start, end in microseconds, name): each
    instant goes to the latest begun of the ranges open then."""
    per_name: Dict[str, float] = {name: 0.0 for _s, _e, name in ranges}
    marks = sorted([(s, 1, i) for i, (s, _e, _n) in enumerate(ranges)]
                   + [(e, 0, i) for i, (_s, e, _n) in enumerate(ranges)])
    open_, last = set(), 0.0
    for t, opens, i in marks:
        if open_ and t > last:
            inner = max(open_, key=lambda k: (ranges[k][0], k))
            per_name[ranges[inner][2]] += (t - last) / 1e6
        last = t
        if opens:
            open_.add(i)
        else:
            open_.discard(i)
    return per_name


def _clean(name: str) -> str:
    # "fn(shapes)" and "fn.N" variants aggregate under "fn"
    return re.sub(r"\.\d+$", "", name.split("(")[0])


_STAGE_RULES = (
    ("geometry", ("streamline_metrics",)),
    ("sh", ("sh_fit", "radius", "sph", "legendre")),
    ("fleet", ("fleet_train", "train_one", "vae_train", "program.", "layer:")),
    ("launch", ("fleet.", "fetch.", "vae.init", "vae.upload")),
    ("normative", ("member_summary", "normative", "score")),
)


def stage_breakdown(per_module: Dict[str, float]) -> Dict[str, float]:
    """Fold per-range execution seconds (disjoint, as
    ``device_exec_by_module`` gives them) into the pipeline's stages: the
    training ranges and the ranges inside them into ``fleet``, the launches'
    set-up and fetch (weights, draws, upload, normalization, state, fetch)
    into ``launch``, where a trace carries them as device ranges."""
    out = {stage: 0.0 for stage, _ in _STAGE_RULES}
    out["other"] = 0.0
    for name, secs in per_module.items():
        low = name.lower()
        for stage, keys in _STAGE_RULES:
            if any(k in low for k in keys):
                out[stage] += secs
                break
        else:
            out["other"] += secs
    out["total"] = sum(out.values())
    return {k: round(v, 3) for k, v in out.items()}
