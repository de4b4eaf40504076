#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lesionvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. environment: torch/CUDA versions, the card's name and power limit, and a
   build of every kernel from the sources in this checkout (timed);
2. every kernel against its plain PyTorch version on the card, float32, at
   the test shapes and at the full-scale shape (B=104, D=2000, N=2000);
3. the main path: the ``lesion`` CLI stage on ``cuda`` over the full-scale
   synthetic cohort (26 TBI/PTE subjects x 4 timepoints, 48^3 volumes,
   2000 directions, L=6), with each kernel's launch count reset before and
   read after; its CSV checked and held against a CPU float32 run;
4. kernel timings (CUDA events) at the shapes the main path gave each kernel,
   beside each kernel's bound, printed as one ``{"kernels": [...]}`` line.

The last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# NVIDIA H100 SXM data sheet, dense: FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-5     # |kernel - plain| <= KERNEL_TOL * max(1, |plain|)
PATH_TOL = 1e-4       # cuda vs cpu float32 stage, same form
SEED = 0
NUM_SAMPLES, MAX_L, VOLUME = 2000, 6, 48


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- radius kernel
def radius_case(D: int, N: int, B: int, seed: int):
    """Float32 inputs on the card: surfaces, counts in [0, N] covering 0,
    partial and full, centroids, Fibonacci directions."""
    from lesionvae_tpu_torch.ops.sh import fibonacci_sphere

    g = np.random.default_rng(seed)
    counts = g.integers(0, N + 1, size=B).astype(np.int32)
    counts[0] = N
    if B > 1:
        counts[1] = 0
    if B > 2:
        counts[2] = max(N // 2, 1)
    dev = torch.device("cuda")
    return (torch.from_numpy(g.normal(size=(B, N, 3)).astype(np.float32)).to(dev),
            torch.from_numpy(counts).to(dev),
            torch.from_numpy(g.normal(scale=0.3, size=(B, 3)).astype(np.float32)).to(dev),
            fibonacci_sphere(D, dtype=torch.float32, device=dev)[0].contiguous())


def radius_error(inputs) -> float:
    """Max |kernel - plain| on the same inputs; fails past the tolerance."""
    from lesionvae_tpu_torch.ops import radius

    got = radius.sample_radii(*inputs)
    want = radius.sample_radii_plain(*inputs)
    torch.cuda.synchronize()
    err = (got - want).abs()
    if not bool(torch.isfinite(got).all()) or bool(
            (err > KERNEL_TOL * want.abs().clamp(min=1.0)).any()):
        fail(f"radius kernel disagrees with its plain version at "
             f"B,N,D={tuple(inputs[0].shape[:2]) + (inputs[3].shape[0],)}: "
             f"max err {float(err.max()):.3e}")
    return float(err.max())


def radius_bound_ms(inputs) -> tuple[float, str]:
    """Least time for this run's work: Σ_b min(count_b, N)·D pairs of 3 FMA
    + 1 max (7 FP32 operations) against the bytes each input and output
    needs once (only the counted surface rows)."""
    surface, counts, _c, directions = inputs
    B, N, _ = surface.shape
    D = directions.shape[0]
    n_pts = int(counts.clamp(0, N).sum())
    ops = 7.0 * n_pts * D
    nbytes = 12 * n_pts + 4 * B + 12 * B + 12 * D + 4 * B * D
    t_ops, t_bytes = ops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def device_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Median over ``reps`` of the device time per call of ``inner``
    back-to-back calls between two CUDA events.  A sleep kernel queued first
    lets the host enqueue all the calls before the device reaches them, so
    the host's launch cost does not enter the time."""
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


# ---------------------------------------------------------------- the path
LENIENT_COLS = (
    ["subject_id", "timepoint", "original_volume_mm3", "brain_volume_mm3",
     "lesion_brain_ratio", "scale_factor", "centroid_x", "centroid_y",
     "centroid_z", "num_surface_points"]
    + [c for l in range(7) for c in (f"P{l}", f"P{l}_raw", f"c{l}_0")]
    + ["reconstruction_r", "group", "heme_mean", "heme_std", "heme_total",
       "heme_max", "heme_95percentile", "heme_volume_mm3"]
)


def main_path_radius_inputs(cfg, data_dir: Path):
    """The radius kernel's inputs on the main path, rebuilt the way
    ``launch_all_lesions`` builds them (same lesion order, same seeded
    surface subsampling)."""
    from lesionvae_tpu_torch.ops.sh import cached_basis
    from lesionvae_tpu_torch.pipeline import lesion_run

    rng = np.random.default_rng(SEED)
    prepared = []
    subjects = sorted(s for subs in cfg.subjects_by_group(only=("TBI", "PTE")).values()
                      for s in subs)
    for sid in subjects:
        for tp in cfg.timepoints:
            p, _ = lesion_run.prepare_lesion(
                data_dir / sid / tp / "lesion_cleaned.nii.gz", NUM_SAMPLES, rng=rng)
            if p is not None:
                prepared.append(p)
    surface, counts, cens = lesion_run.radius_inputs(prepared, torch.float32, "cuda")
    directions = cached_basis(MAX_L, NUM_SAMPLES, dtype=torch.float32,
                              device="cuda")[0]
    return surface, counts, cens, directions


def check_path(root: Path):
    """Run the CLI's lesion stage on cuda, check it, hold it against a CPU
    float32 run; returns (radius launches, main-path radius inputs)."""
    import pandas as pd

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.core.config import load_config
    from lesionvae_tpu_torch.ops import radius
    from lesionvae_tpu_torch.pipeline import lesion_run
    from lesionvae_tpu_torch.utils import profiling

    profiling.reset()
    radius.sample_radii.launches = 0
    rc = cli.main(["lesion", "--base-path", str(root), "--seed", str(SEED),
                   "--num-samples", str(NUM_SAMPLES), "--max-l", str(MAX_L),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    launches = radius.sample_radii.launches
    stages = profiling.report()
    if rc != 0:
        fail(f"lesion stage exited {rc}")
    if launches < 1:
        fail("the lesion stage on cuda never launched the radius kernel")

    csv = root / "results" / "lesion_sh_heme_comprehensive" / "lesion_sh_heme_comprehensive.csv"
    df = pd.read_csv(csv)
    if len(df) != 104 or list(df.columns) != LENIENT_COLS:
        fail(f"{csv.name}: {len(df)} rows, columns {list(df.columns)}")
    real = df[df["original_volume_mm3"] > 0]
    psum = real[[f"P{l}" for l in range(MAX_L + 1)]].sum(axis=1).to_numpy()
    if len(real) != 78 or np.abs(psum - 1).max() > 1e-5:
        fail(f"{len(real)} real lesions, max |ΣP - 1| = {np.abs(psum - 1).max():.2e}")
    if not (real["reconstruction_r"] > 0.9).all():
        fail(f"reconstruction_r min {real['reconstruction_r'].min():.4f} <= 0.9")

    cfg = load_config()
    cpu = lesion_run.run_lesion_analysis(
        cfg, data_dir=root / "data", output_dir=root / "results_cpu",
        max_l=MAX_L, num_samples=NUM_SAMPLES, seed=SEED, device="cpu",
        dtype=torch.float32)
    num = [c for c in LENIENT_COLS if pd.api.types.is_numeric_dtype(cpu[c])]
    a, b = df[num].to_numpy(float), cpu[num].to_numpy(float)
    rel = np.abs(a - b) / np.maximum(1.0, np.abs(b))
    if list(cpu.columns) != LENIENT_COLS or not np.all(rel <= PATH_TOL):
        worst = num[int(np.nanargmax(rel.max(axis=0)))]
        fail(f"cuda vs cpu float32 stage: max rel err {np.nanmax(rel):.3e} in {worst}")
    print(f"[path] lesion stage on cuda: 104 rows, 78 lesions, radius launches "
          f"{launches}; cuda vs cpu float32 max rel err {np.nanmax(rel):.3e}")
    print("[path] stage wall-clock on cuda (s): " + json.dumps(stages))
    return launches, main_path_radius_inputs(cfg, root / "data")


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from lesionvae_tpu_torch.io.synth import generate_cohort
    from lesionvae_tpu_torch.core.config import load_config
    from lesionvae_tpu_torch.ops import cuda_build, radius

    # 1. environment + build
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, card {kind}, devices {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {card}")
    t0 = time.perf_counter()
    built = cuda_build.build(["radius"])
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f}s")

    # 2. kernels against their plain versions
    shapes = [(D, N, B) for D in (256, 512, 2000) for N in (1, 200, 333)
              for B in (1, 3, 13)] + [(2000, 2000, 104)]
    errs = [radius_error(radius_case(D, N, B, seed=i))
            for i, (D, N, B) in enumerate(shapes)]
    full = radius_case(2000, 2000, 104, seed=1234)
    full_ms = device_ms(lambda: radius.sample_radii(*full))
    full_plain_ms = device_ms(lambda: radius.sample_radii_plain(*full))
    full_bound, full_by = radius_bound_ms(full)
    print(f"[kernels] radius vs plain at {len(shapes)} shapes: max abs err "
          f"{max(errs):.3e} (tol {KERNEL_TOL} x max(1,|plain|))")
    print("[kernels] radius full-scale B=104 D=2000 N=2000 counts~U[0,2000]: "
          + json.dumps({"ms": full_ms, "plain_ms": full_plain_ms,
                        "bound_ms": full_bound, "bound_by": full_by,
                        "pairs": int(full[1].clamp(0, 2000).sum()) * 2000}))

    # 3. the main path
    cfg = load_config()
    with tempfile.TemporaryDirectory(prefix="lesionvae_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        generate_cohort(root, cfg, seed=SEED, volume_shape=(VOLUME,) * 3,
                        subjects=cfg.subjects_by_group(only=("TBI", "PTE")))
        print(f"[path] synthetic cohort written in {time.perf_counter() - t0:.1f}s")
        launches, path_inputs = check_path(root)

    # 4. kernel timings at the main path's shapes
    err = radius_error(path_inputs)
    ms = device_ms(lambda: radius.sample_radii(*path_inputs))
    plain_ms = device_ms(lambda: radius.sample_radii_plain(*path_inputs))
    bound, by = radius_bound_ms(path_inputs)
    surface, counts, _c, directions = path_inputs
    print(f"[kernels] main-path radius inputs: B={surface.shape[0]} "
          f"N={surface.shape[1]} D={directions.shape[0]} "
          f"points={int(counts.sum())}")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "radius", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/radius.cu",
        "replaces": "lesionvae_tpu/ops/pallas_radius.py:29",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
