"""Readings for the limits of a cell's check, outside any measured window.

    python3 -m portbench.control --workload <cell> --program-seeds 1,2,... \
        [--control-seeds 7,8,9] [--faults tf32,half_batch,frozen,altered]

For each program seed: the cell's inputs from that seed, one job of the
program (after one cold job in the process), and its gaps from the plain
reference (``Job.readings``), as the benchmark's check reads them: the
lower readings.  For each control seed and fault: the reference put in the
program's place, computed in TF32 ("tf32", the precision below the
configuration's float32) or with a fault planted in float32 ("half_batch":
half of every batch left out, the means over the rest; "frozen": a step that
returns the parameters unchanged; "altered": one answer altered where it is
produced), read the same way: the upper readings.  One JSON line a reading.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import inputs
from .run import ROOT, cache_dirs


def seeds(text: str):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=seeds, default=[])
    ap.add_argument("--control-seeds", type=seeds, default=[])
    ap.add_argument("--faults", default="tf32")
    args = ap.parse_args(argv)
    cache_dirs(ROOT)

    from .spec import Bench

    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    kind = bench.job(config["job"])
    cold = False
    for seed in args.program_seeds:
        job = kind.Job(config, traffic, seed)
        if not cold:
            job.run(inputs.job_seed(seed, -1))
            cold = True
        js = inputs.job_seed(seed, 0)
        t = time.time()
        out = job.run(js)
        t_job = time.time() - t
        r = job.readings(out, js)
        print(json.dumps({"side": "program", "seed": seed, "job_s": t_job,
                          "readings": r}), flush=True)
    if args.program_seeds:
        job.release()
    for fault in [f for f in args.faults.split(",") if f]:
        mode, planted = ("tf32", None) if fault == "tf32" else ("float32", fault)
        for seed in args.control_seeds:
            job = kind.Job(config, traffic, seed)
            js = inputs.job_seed(seed, 0)
            r = job.readings(job.reference(js, mode, planted), js)
            print(json.dumps({"side": fault, "seed": seed, "readings": r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
