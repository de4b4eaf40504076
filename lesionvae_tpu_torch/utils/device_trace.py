"""On-device execution time from a ``torch.profiler`` trace (the port of
lesionvae_tpu/utils/device_trace.py).

``utils/profiling.trace`` writes a Chrome trace (``trace.json``).  On the
card its ``record_function`` ranges appear twice: on the host
(``user_annotation``) and on the device (``gpu_user_annotation``, from the
first to the last kernel the range launched).  The device ranges play the
JAX trace's "XLA Modules" line: the port names one range a launch after the
JAX program it replaces (``fleet_train``, ``member_summary``,
``streamline_metrics``, ``sh_fit``, ``score_fleet``), so the JAX stage rules
apply.  A trace without such ranges falls back to its kernels by name, as
the JAX reader falls back to a plane's busiest line; a host-only trace (the
CPU's) gives nothing.
"""

from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path
from typing import Dict


def device_exec_by_module(trace_dir: str) -> Dict[str, float]:
    """Seconds of device execution per range name (or, with no device
    range, per kernel name) in the newest Chrome trace under
    ``trace_dir``."""
    files = sorted(Path(trace_dir).rglob("*.json"), key=lambda p: p.stat().st_mtime)
    if not files:
        return {}
    events = json.loads(files[-1].read_text()).get("traceEvents", [])
    for cat in ("gpu_user_annotation", "kernel"):
        per_name: Dict[str, float] = defaultdict(float)
        for ev in events:
            if ev.get("cat") == cat and ev.get("ph") == "X":
                per_name[_clean(ev.get("name", ""))] += float(ev.get("dur", 0)) / 1e6
        if per_name:
            return dict(per_name)
    return {}


def _clean(name: str) -> str:
    # "fn(shapes)" and "fn.N" variants aggregate under "fn"
    return name.split("(")[0].split(".")[0]


_STAGE_RULES = (
    ("geometry", ("streamline_metrics",)),
    ("sh", ("sh_fit", "radius", "sph", "legendre")),
    ("fleet", ("fleet_train", "train_one")),
    ("normative", ("member_summary", "normative", "score")),
)


def stage_breakdown(per_module: Dict[str, float]) -> Dict[str, float]:
    """Fold per-range execution seconds into the pipeline's stages."""
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
