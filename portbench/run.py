"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed and runs one cold job of the
cell's shapes (it builds the kernels and captures the training program's
graph); ``setup_s`` runs from the process's start to the window's opening.
The window then runs whole jobs back to back, each started while less than
``--seconds`` have passed since it opened, and closes when the last job's
outputs are on the host: ``train_rows_per_s`` is the real rows those jobs
trained (members x rows x epochs) over the window.  With ``--trace 1`` the
window holds at most the mix's ``trace_jobs`` jobs under ``torch.profiler``
and the line carries the cell's per-layer metrics instead.

After the window one job, drawn from the seed, is checked against the
plain reference (``portbench.check``); ``correct`` is whether every gap is
within its limit (``limits/<cell>.json``) and every job's outputs are
finite.  The gaps and limits are the last lines on standard error and the
last key of the result line.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import types
from pathlib import Path
from typing import Optional

ROOT = Path(__file__).resolve().parents[1]
#: top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "lesionvae_tpu")


def process_start() -> float:
    """This process's start on the wall clock (``time.time()``)."""
    try:
        ticks = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in open("/proc/stat")
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Kernel caches at fixed paths inside the checkout (the program builds
    its own libraries into ``lesionvae_tpu_torch/_build/``)."""
    cache = root / ".portbench" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(cache / sub)


def smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,power.draw,clocks.sm,clocks.max.sm,"
             "temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_start: Optional[float] = None, log=print) -> dict:
    """One run of cell ``name``; returns the result line as a dict."""
    import numpy as np
    import torch
    from torch.profiler import record_function

    from . import inputs
    from .cost import counts
    from .jobs.common import finite, program_counts
    from .trace import WINDOW, Capture, Trace

    t_start = time.time() if t_start is None else t_start
    cell = bench.cell(name)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    limits = bench.limits(name)
    kind = bench.job(config["job"])
    cuda = torch.device(device).type == "cuda"

    parts = {"imports_s": time.time() - t_start}
    t = time.time()
    job = kind.Job(config, traffic, seed, device)
    parts["inputs_s"] = time.time() - t
    t = time.time()
    job.run(inputs.job_seed(seed, -1))
    sync(device)
    parts["cold_job_s"] = time.time() - t
    job.check_precision()
    job.take_spans()
    before = program_counts()
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    outs, ends, spans = [], [], []
    cap = Capture() if trace else None
    max_jobs = int(traffic["trace_jobs"]) if trace else None
    if cap is not None:
        cap.__enter__()
    setup_s = time.time() - t_start
    t_open = time.perf_counter()
    try:
        with record_function(WINDOW):
            while True:
                outs.append(job.run(inputs.job_seed(seed, len(outs))))
                ends.append(time.perf_counter() - t_open)
                spans.append(job.take_spans())
                if ends[-1] >= seconds:
                    break
                if max_jobs is not None and len(outs) >= max_jobs:
                    break
        window_s = time.perf_counter() - t_open
    finally:
        if cap is not None:
            cap.__exit__(None, None, None)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    after = program_counts()
    log(f"[setup] setup_s={setup_s} " + " ".join(f"{k}={v}" for k, v in parts.items())
        + f" torch_threads={torch.get_num_threads()} cpus={len(os.sched_getaffinity(0))}")
    log(f"[window] jobs={len(outs)} window_s={window_s} job_s={np.diff([0.0] + ends).tolist()} "
        f"spans_s={spans} memory_peak_bytes={peak} "
        f"program_counts_before={before} after={after}")
    if cuda:
        log(f"[card] {smi()}")

    result = {"correct": None, "attempted": len(outs),
              "failed": sum(not finite(o) for o in outs), "metrics": {}}
    work = job.work()
    if trace:
        tr = Trace(cap.events, kind.RANGES)
        kinds = {}
        for e in cap.events:
            key = ("device " if e.on_device else "host ") + (e.kind or "?")
            kinds[key] = kinds.get(key, 0) + 1
        log(f"[trace] events={len(cap.events)} by_kind={kinds} ops={len(tr.ops)} "
            f"device_ranges={sorted({e.name for e in tr.device_ranges})} "
            f"launch_calls={len(tr.launches)} busy_s={tr.busy_s} window_s={tr.window_s} "
            f"ops_a_step={len(tr.ops) / (len(outs) * work['train_steps'])} "
            f"launch_calls_a_step={len(tr.launches) / (len(outs) * work['train_steps'])}")
        ctx = types.SimpleNamespace(trace=tr, work=work, jobs=len(outs), rows=job.rows(),
                                    config=config, traffic=traffic, cost=counts)
        for m in bench.metrics(name, "per_layer"):
            value = bench.reader(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["breakdown"] = tr.breakdown()
    else:
        known = {"train_rows_per_s": job.rows() * len(outs) / window_s, "setup_s": setup_s}
        for m in bench.metrics(name, "end_to_end"):
            result["metrics"][m["name"]] = {"value": float(known[m["name"]]), "unit": m["unit"]}
    result["device"] = {"platform": "gpu" if cuda else "cpu",
                        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                        "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        del cap, tr

    # the check: one job drawn from the seed, after the program's state is freed
    pick = inputs.sample(seed, len(outs), 1, salt=1)[0]
    kept = outs[pick]
    del outs
    job.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.time()
    readings = job.readings(kept, inputs.job_seed(seed, pick))
    log(f"[check] job={pick} reference_s={time.time() - t} not compared: "
        + " ".join(f"{k}={v!r}" for k, v in readings.items() if k not in limits))
    checks = {k: {"value": float(readings[k]), "limit": limits[k]} for k in limits}
    result["correct"] = result["failed"] == 0 and all(
        c["value"] <= c["limit"] for c in checks.values())
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    from .spec import Bench

    bench = Bench(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 3
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      "cuda", t_start)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 4
    sys.stdout.flush()
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
