#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lesionvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--skip-vae]

Phases; any failure exits non-zero before the result line is printed:

1. environment: torch/CUDA versions, the card's name and power limit, a
   build of every kernel from the sources in this checkout (one ``nvcc``
   per source, all started together; timed), and one ``[sass]`` line per
   kernel function: the instructions of its hot loop by class, per
   element-step or per point-direction pair, counted in the machine code;
2. every kernel against its plain PyTorch version on the card:
   - radius, float32, at the test shapes, at N, counts and D on and beside
     the kernel's chunk and tile edges, the full-scale shape (B=104,
     D=2000, N=2000), two NaN cases (a counted NaN point gives NaN, a
     NaN pad row changes nothing), and the same bits on repeated calls;
   - resident Adam, bf16, in the IEEE and the fast-math form, at ragged
     totals (not multiples of 8), at zero, subnormal, huge, infinite and
     NaN values and from the probe's m = v = 0, K in {0, 1, 3, 30}:
     bit-equal in p, m and v (the two round at the same places);
3. the main paths, each with every kernel's launch count set to 0 just
   before it and read just after:
   a. the ``lesion`` CLI stage on ``cuda`` over the full-scale synthetic
      cohort (26 TBI/PTE subjects x 4 timepoints, 48^3 volumes, 2000
      directions, L=6); its CSV checked and held against a CPU float32 run;
   b. the optimizer probe (``benchmarks/opt_probe.py``) at its full size,
      T=64 members x P=2,867,200 bf16 parameters, K in {1, 10, 30}, in both
      forms: the kernel's whole output bit-equal to the plain loop's, and
      both timed;
   c. the ``vae`` CLI stage on ``cuda`` at full width (seq 100, 13 + 3
      channels, latent 10, batch 64, 40 epochs) over a full-scale profiles
      cohort for one tract (37 subjects x 4 timepoints, 925 rows each); the
      eval forward, z-scores and a 2-epoch training run held against the CPU
      in float32, and the same three again with TF32 on as a control that
      must exceed every one of those bounds; then the
      ``score`` CLI stage on ``cuda`` serving a saved model, held against a
      CPU float32 ``score_subjects``;
4. kernel timings (CUDA events) at the shapes the main paths gave each
   kernel, beside each kernel's bound, printed as one ``{"kernels": [...]}``
   line (the resident kernel per K and form, with the nominal bound and
   the bound that counts the instructions the card must issue).

The last line of stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from lesionvae_tpu_torch.io.synth import generate_cohort
from lesionvae_tpu_torch.utils.profiling import device_ms

# NVIDIA H100 SXM data sheet, dense: FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-5     # |kernel - plain| <= KERNEL_TOL * max(1, |plain|)
PATH_TOL = 1e-4       # cuda vs cpu float32 stage, same form
SEED = 0
NUM_SAMPLES, MAX_L, VOLUME = 2000, 6, 48
RESIDENT_KS = [0, 1, 3, 30]
RESIDENT_TOTALS = [1, 7, 9, 4096, 65539, 1_000_003]   # all but one ragged
PROBE_KS = [1, 10, 30]
# the VAE path: configs/tract_config.json model_params; the cohort of
# bench.py:66-74 (n_streamlines=100 -> 25 profile streamlines a subject)
VAE_EPOCHS, VAE_BATCH, VAE_LATENT, VAE_SEED = 40, 64, 10, 42
VAE_STREAMLINES, VAE_ROWS = 100, 925
# cuda vs cpu float32, 2-epoch history: sound runs read 1.1e-4 (cuDNN and
# the CPU sum convolutions in other orders and 30 Adam steps carry it), the
# TF32 control 4.3e-4 (see tf32_control)
HIST_TOL = 2e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------- machine code
# per kernel: the instruction that occurs once per unit of work in its hot
# loop, and what that unit is
SASS_UNITS = {"radius": (r"^FMNMX", "pair"),
              "resident_adam": (r"^MUFU\.RSQ", "element-step")}


def short_name(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled symbol;
    the resident kernel's one argument is its form."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[a-z]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
    if m.group(1) == "resident_adam_kernel" and args in (["0"], ["1"]):
        args = ["fastmath" if args == ["1"] else "ieee"]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_lines() -> None:
    """One ``[sass]`` line per kernel function: the instructions of its hot
    loop (the K-step body of resident Adam, the point loop of radius) by
    class, per element-step or per pair, counted in the machine code that
    ``cuobjdump -sass`` shows.  The count is static: a slow path that sits
    inside the loop counts whether or not it is taken."""
    from lesionvae_tpu_torch.ops import cuda_build

    for name, (unit, what) in SASS_UNITS.items():
        loops = cuda_build.inner_loops(cuda_build.sass(name), unit)
        if not any(f["units"] for f in loops.values()):
            fail(f"no {unit} instruction in the machine code of {name}")
        for fn, f in loops.items():
            if not f["units"]:
                continue
            print(f"[sass] {name}:{short_name(fn)} per {what} ({'loop' if f['loop'] else 'whole function'}"
                  f" of {f['instructions']} instructions, {f['units']} {what}s): "
                  + json.dumps({k: round(v, 3) for k, v in f["per_unit"].items()})
                  + " opcodes " + json.dumps(f["opcodes"]))


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
    if B > 4:       # a count on a chunk edge of the kernel and one beyond it
        from lesionvae_tpu_torch.ops.radius import CHUNK
        counts[3], counts[4] = min(CHUNK, N), min(CHUNK + 1, N)
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


def radius_same_bits(inputs) -> None:
    """The chunks' partial maxima are merged with atomics in whatever order
    the blocks arrive; max is exact, so every call must give the same bits."""
    from lesionvae_tpu_torch.ops import radius

    first = radius.sample_radii(*inputs)
    for _ in range(5):
        if not torch.equal(radius.sample_radii(*inputs), first):
            fail("radius: two calls on the same inputs gave different bits")
    print("[kernels] radius: 6 calls on the same inputs (B=104, D=2000, N=2000) "
          "gave the same bits")


def radius_nan_check() -> None:
    """A NaN surface point that is counted gives NaN in every direction, as
    jnp.max does; a NaN in a pad row (beyond the count) changes nothing."""
    from lesionvae_tpu_torch.ops import radius

    surface, counts, cens, dirs = radius_case(512, 200, 3, seed=99)
    counts[:] = torch.tensor([200, 120, 0], dtype=torch.int32)
    clean = radius.sample_radii(surface, counts, cens, dirs)
    surface[0, 57, 1] = float("nan")      # counted
    surface[1, 150, :] = float("nan")     # pad row of lesion 1
    surface[2, 0, 0] = float("nan")       # lesion 2 counts none
    got = radius.sample_radii(surface, counts, cens, dirs)
    want = radius.sample_radii_plain(surface, counts, cens, dirs)
    torch.cuda.synchronize()
    if not (bool(torch.isnan(got[0]).all()) and bool(torch.isnan(want[0]).all())):
        fail("radius: a counted NaN point does not give NaN")
    if not (torch.equal(got[1], clean[1]) and bool((got[2] == 0).all())):
        fail("radius: a NaN pad row changed the result")
    if float((got[1:] - want[1:]).abs().max()) > KERNEL_TOL * float(want[1].abs().max()):
        fail("radius: kernel and plain version disagree beside NaN rows")
    print("[kernels] radius NaN cases: counted NaN -> NaN in all 512 directions; "
          "NaN pad row and NaN in an empty lesion ignored")


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


# ---------------------------------------------------------------- resident Adam
def resident_case(n: int, seed: int):
    """bf16 (p, m, v) on the card: p ~ 0.02 N(0,1), m ~ 1e-3 N(0,1),
    v ~ 1e-6 |N(0,1)|."""
    g = np.random.default_rng(seed)
    return tuple(torch.from_numpy(x).to("cuda").to(torch.bfloat16) for x in (
        g.normal(size=n) * 0.02, g.normal(size=n) * 1e-3,
        np.abs(g.normal(size=n)) * 1e-6))


def resident_special_case(n: int = 4099):
    """bf16 (p, m, v) holding what the in-range quotient and root of the IEEE
    form do not take, scattered among ordinary values so that some threads
    hold one special element and others none: v = 0 (with m = 0: the probe's
    own starting state), a subnormal v, a huge v, inf and NaN in p, an
    infinite m, and a p for which the gradient cancels to zero."""
    p, m, v = (t.float() for t in resident_case(n, seed=77))
    v[0::13] = 0.0
    m[0::13] = 0.0
    v[3::29] = 1e-39                # subnormal in float32 and in bf16
    v[5::31] = 3e38
    p[7::37] = float("inf")
    p[11::41] = float("nan")
    m[17::43] = float("-inf")
    p[19::47] = -1.0 / 0.999 * 1e-3   # GA*p + c ~ 0: m' and v' tiny or zero
    v[23::53] = 1e-30               # below 2^-63, above the subnormals
    return tuple(t.to(torch.bfloat16) for t in (p, m, v))


def resident_errors() -> dict:
    """The kernel against its plain version at every (total, K), in both
    forms, and at the special values.  Both forms round at the same places
    as the plain loop, and the fast-math form's rsqrt is the card's
    special-function unit in the kernel as in ``torch.rsqrt``, so every
    element of p, m and v must be equal (two NaNs are equal).  The JAX
    probe's rtol/atol is printed beside, as the probe checks."""
    from lesionvae_tpu_torch.benchmarks import opt_probe
    from lesionvae_tpu_torch.ops import resident_adam as ra

    worst = {"max_abs_err": 0.0, "share_differing": 0.0}
    cases = [(f"n={n}", resident_case(n, seed=i))
             for i, n in enumerate(RESIDENT_TOTALS)]
    cases += [("special values n=4099", resident_special_case(4099)),
              ("special values n=8", resident_special_case(8)),
              ("probe start n=4099", (resident_case(4099, seed=5)[0],
                                      torch.zeros(4099, dtype=torch.bfloat16, device="cuda"),
                                      torch.zeros(4099, dtype=torch.bfloat16, device="cuda")))]
    for form in ra.FORMS:
        for label, (p, m, v) in cases:
            for k in RESIDENT_KS:
                agree = opt_probe.compare(
                    ra.resident_adam(p, m, v, k, opt_probe.GC, form),
                    ra.resident_adam_plain(p, m, v, k, opt_probe.GC, form))
                if agree["share_differing"] != 0:
                    fail(f"resident Adam kernel ({form}) differs from its plain "
                         f"version at {label} K={k} in a share "
                         f"{agree['share_differing']:.3e} of elements: max abs err "
                         f"{agree['max_abs_err']:.3e}, {agree['max_ulps']:.2f} bf16 ulps")
                for key in worst:
                    worst[key] = max(worst[key], agree[key])
    print(f"[kernels] resident Adam vs plain, forms {list(ra.FORMS)}, at totals "
          f"{RESIDENT_TOTALS}, at zero, subnormal, huge, infinite and NaN values "
          f"and from m = v = 0, x K {RESIDENT_KS}: bit-equal in p, m and v (NaN = "
          f"NaN; max abs err {worst['max_abs_err']:.3e}; also within the probe's "
          f"rtol={opt_probe.RTOL}, atol={opt_probe.ATOL})")
    return worst


def check_probe():
    """The probe path at full size, in both forms; returns its per-K
    results (IEEE first) and the kernel's launches."""
    from lesionvae_tpu_torch.benchmarks import opt_probe
    from lesionvae_tpu_torch.ops import radius, resident_adam as ra

    radius.sample_radii.launches = ra.resident_adam.launches = 0
    results = opt_probe.main(PROBE_KS) + opt_probe.main(PROBE_KS, form="fastmath")
    torch.cuda.synchronize()
    launches = ra.resident_adam.launches
    if launches < 1 or sum(r["launches"] for r in results) != launches:
        fail(f"the probe path launched the resident kernel {launches} times")
    for r in results:
        if r["share_differing"] != 0:
            fail(f"probe ({r['form']}) at K={r['k']}: the kernel differs from the "
                 f"plain loop in a share {r['share_differing']:.3e} of elements, "
                 f"at most {r['max_ulps']:.2f} bf16 ulps")
    print(f"[path] optimizer probe on cuda: resident launches {launches}; kernel "
          f"bit-equal to the plain loop at K {PROBE_KS} in both forms")
    return results, launches


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
    from lesionvae_tpu_torch.ops import radius, resident_adam as ra
    from lesionvae_tpu_torch.pipeline import lesion_run
    from lesionvae_tpu_torch.utils import profiling

    profiling.reset()
    radius.sample_radii.launches = ra.resident_adam.launches = 0
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


# ---------------------------------------------------------------- the VAE path
def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / np.maximum(1.0, np.abs(want))))


def z_scaled_err(z_g, z_c, std_c) -> float:
    """z is the residual X - xh - mean over the Sham std (floored at 1e-6):
    where that std is below 1 the residual's float32 error grows by 1/std,
    so z is held to the tolerance in units of max(1, std)."""
    return float(np.max(np.abs(z_g - z_c) * np.minimum(1.0, std_c)[None]
                        / np.maximum(1.0, np.abs(z_c))))


def train_2_epochs(Xz, Xl, device) -> np.ndarray:
    """The history of a 2-epoch training run from ``VAE_SEED``."""
    from lesionvae_tpu_torch.train.trainer import train_lesion_vae

    return train_lesion_vae(Xz, Xl, latent_dim=VAE_LATENT, epochs=2,
                            batch_size=VAE_BATCH, seed=VAE_SEED,
                            device=device)[1].to_numpy()


def tf32_control(model, Xz, Xl, sham, eps, cpu) -> None:
    """Control for the cuda-vs-cpu bounds: the eval forward, z-scores and
    2-epoch training on the card again with TF32 on for cuDNN and cuBLAS,
    against the same CPU float32 results ``cpu`` = (forward, z, Sham std,
    history).  Lower precision must exceed every bound a sound run is held
    to, or the bound could not tell it from float32."""
    from lesionvae_tpu_torch.train import trainer
    from lesionvae_tpu_torch.train.normative import normative_zscores_fused

    def tf32(_device) -> None:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    fwd_c, z_c, std_c, h_c = cpu
    sound = trainer.full_fp32
    trainer.full_fp32 = tf32     # every VAE entry point calls it first
    try:
        fwd = max(rel_err(a.cpu(), b) for a, b in zip(model.apply(Xz, Xl, eps=eps), fwd_c))
        z_err = z_scaled_err(normative_zscores_fused(model, Xz, Xl, sham,
                                                     seed=VAE_SEED)[2], z_c, std_c)
        hist_err = rel_err(train_2_epochs(Xz, Xl, "cuda"), h_c)
    finally:
        trainer.full_fp32 = sound
        sound("cuda")
    line = (f"forward max rel err {fwd:.3e} (bound {PATH_TOL}), Z scaled by "
            f"min(1, std) {z_err:.3e} (bound {PATH_TOL}), 2-epoch history "
            f"{hist_err:.3e} (bound {HIST_TOL})")
    if fwd <= PATH_TOL or z_err <= PATH_TOL or hist_err <= HIST_TOL:
        fail(f"a cuda-vs-cpu bound does not catch TF32: {line}")
    print(f"[control] TF32 on for the card's convolutions and products, against "
          f"the same cpu float32 results, exceeds every bound: {line}")


def check_vae(root: Path, cfg, tract: str) -> None:
    """``vae`` then ``score`` through the CLI on cuda, each held against the
    CPU in float32."""
    import pandas as pd

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.ops import radius, resident_adam as ra
    from lesionvae_tpu_torch.pipeline.infer import load_normative, score_subjects
    from lesionvae_tpu_torch.train import data as vdata
    from lesionvae_tpu_torch.train.checkpoint import load_vae, save_vae
    from lesionvae_tpu_torch.train.normative import normative_zscores_fused
    from lesionvae_tpu_torch.train.trainer import train_lesion_vae
    from lesionvae_tpu_torch.utils import profiling

    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    common = ["--config", str(cfg_path), "--base-path", str(root),
              "--seed", str(VAE_SEED), "--device", "cuda"]
    profiling.reset()
    radius.sample_radii.launches = ra.resident_adam.launches = 0
    t0 = time.perf_counter()
    rc = cli.main(["vae", "--tract", tract, "--epochs", str(VAE_EPOCHS),
                   "--batch-size", str(VAE_BATCH), "--latent-dim",
                   str(VAE_LATENT), "--no-plots", *common])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    spans = profiling.report()
    if rc != 0:
        fail(f"vae stage exited {rc}")
    out = root / "results" / "vae_analysis" / tract
    keys = ["Z", "magnitude", "subj_ids", "group_labels", "latents",
            "lesion_burden", "norm_mean", "norm_std"]
    for tp in cfg.timepoints:
        hist = pd.read_csv(out / f"training_history_{tp}.csv")
        if (len(hist) != VAE_EPOCHS or not np.isfinite(hist.to_numpy()).all()
                or not hist["loss"].iloc[-1] < hist["loss"].iloc[0]):
            fail(f"training_history_{tp}.csv: {len(hist)} rows, loss "
                 f"{hist['loss'].iloc[0]:.4f} -> {hist['loss'].iloc[-1]:.4f}")
        z = np.load(out / f"zscores_{tp}.npz", allow_pickle=True)
        if (z.files != keys or z["Z"].shape != (VAE_ROWS, 100, 13)
                or not np.isfinite(z["Z"]).all()):
            fail(f"zscores_{tp}.npz: keys {z.files}, Z {z['Z'].shape}")
    steps = len(cfg.timepoints) * VAE_EPOCHS * -(-VAE_ROWS // VAE_BATCH)
    print(f"[path] vae stage on cuda: {len(cfg.timepoints)} timepoints x "
          f"{VAE_ROWS} rows, {VAE_EPOCHS} epochs, {steps} train steps in "
          f"{spans['vae.train']:.2f}s ({steps / spans['vae.train']:.1f} steps/s); "
          f"stage {wall:.2f}s; kernel launches radius "
          f"{radius.sample_radii.launches}, resident {ra.resident_adam.launches}")
    print("[path] vae spans on cuda (s): " + json.dumps(spans))

    # one model of the path, trained again on cuda for the comparisons and
    # saved with its normalization stats for serving
    groups = {g: list(s) for g, s in cfg.subjects_by_group().items()}
    subjects = [s for subs in groups.values() for s in subs]
    Xm, Xl, _sids, glabels, _ = vdata.build_tensor_with_lesion_context(
        root, tract, "9d", subjects, cfg.microstructure_features,
        cfg.lesion_features, groups)
    stats = vdata.fit_normalization_stats(Xm, Xl, cfg.microstructure_features)
    Xz, Xl = vdata.apply_normalization(Xm, Xl, stats)
    model, _ = train_lesion_vae(Xz, Xl, latent_dim=VAE_LATENT, epochs=VAE_EPOCHS,
                                batch_size=VAE_BATCH, seed=VAE_SEED, device="cuda")
    save_vae(root / "ckpt", model, stats)
    cpu_model, _ = load_vae(root / "ckpt", device="cpu")

    # eval forward and z-scores: same weights, same noise
    sham = glabels == "Sham"
    eps = torch.randn((len(Xz), VAE_LATENT), generator=torch.Generator().manual_seed(7))
    fwd_c = cpu_model.apply(Xz, Xl, eps=eps)
    fwd = [rel_err(a.cpu(), b) for a, b in zip(model.apply(Xz, Xl, eps=eps), fwd_c)]
    mean_g, std_g, z_g, mag_g = normative_zscores_fused(model, Xz, Xl, sham,
                                                        seed=VAE_SEED)
    mean_c, std_c, z_c, mag_c = normative_zscores_fused(cpu_model, Xz, Xl, sham,
                                                        seed=VAE_SEED)
    stats_err = [rel_err(mean_g, mean_c), rel_err(std_g, std_c), rel_err(mag_g, mag_c)]
    z_err = z_scaled_err(z_g, z_c, std_c)
    if max(fwd + stats_err + [z_err]) > PATH_TOL:
        fail(f"cuda vs cpu float32 eval: forward (xh, mu, logv) {fwd}, normative "
             f"(mean, std, magnitude) {stats_err}, Z scaled by min(1, std) {z_err}")
    print(f"[path] cuda vs cpu float32, one trained model: forward (xh, mu, logv) "
          f"max rel err {max(fwd):.3e}; normative mean, std, magnitude "
          f"{max(stats_err):.3e}; Z {rel_err(z_g, z_c):.3e} raw, {z_err:.3e} "
          f"scaled by min(1, std) (Sham std min {float(std_c.min()):.3e}) "
          f"(tol {PATH_TOL} x max(1,|x|))")

    # a short training run from the same seed on both
    h_cpu = train_2_epochs(Xz, Xl, "cpu")
    hist_err = rel_err(train_2_epochs(Xz, Xl, "cuda"), h_cpu)
    if hist_err > HIST_TOL:
        fail(f"cuda vs cpu float32 2-epoch history: max rel err {hist_err:.3e}")
    print(f"[path] cuda vs cpu float32, 2-epoch training from one seed: history "
          f"max rel err {hist_err:.3e} (tol {HIST_TOL})")
    tf32_control(model, Xz, Xl, sham, eps, (fwd_c, z_c, std_c, h_cpu))

    # serving on cuda through the CLI, against the CPU
    norm = load_normative(out / "zscores_9d.npz")
    profiling.reset()
    rc = cli.main(["score", "--checkpoint", str(root / "ckpt"), "--normative",
                   str(out / "zscores_9d.npz"), "--tract", tract,
                   "--timepoint", "1mo", *common])
    if rc != 0:
        fail(f"score stage exited {rc}")
    served = pd.read_csv(root / "results" / "serving" / f"scores_{tract}_1mo.csv")
    cpu = score_subjects(root / "ckpt", norm["mean"], norm["std"], root, tract,
                         "1mo", subjects, config=cfg, seed=VAE_SEED, device="cpu")
    cols = ["mean", "std", "max", "count"]
    score_err = rel_err(served[cols].to_numpy(float), cpu[cols].to_numpy(float))
    if (list(served.columns) != ["subject_id", "group"] + cols
            or len(served) != len(subjects) or score_err > PATH_TOL
            or not served["subject_id"].astype(str).equals(cpu["subject_id"].astype(str))):
        fail(f"score on cuda: {len(served)} rows, max rel err vs cpu {score_err:.3e}")
    print(f"[path] score stage on cuda: {len(served)} subjects; cuda vs cpu "
          f"float32 max rel err {score_err:.3e}")


def run_vae_paths(cfg) -> None:
    with tempfile.TemporaryDirectory(prefix="lesionvae_vae_smoke_") as tmp:
        root = Path(tmp)
        tract = cfg.tracts[0]
        t0 = time.perf_counter()
        generate_cohort(root, cfg, seed=SEED, volume_shape=(8,) * 3,
                        with_profiles=True, n_streamlines=VAE_STREAMLINES,
                        tracts=[tract])
        print(f"[path] profiles cohort ({tract}, 37 subjects x 4 timepoints) "
              f"written in {time.perf_counter() - t0:.1f}s")
        check_vae(root, cfg, tract)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-vae", action="store_true",
                    help="leave out the vae and score paths (a shorter run "
                         "while working on a kernel; not the full check)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from lesionvae_tpu_torch.core.config import load_config
    from lesionvae_tpu_torch.ops import cuda_build, radius

    # 1. environment + build
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, card {kind}, devices {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {card}")
    t0 = time.perf_counter()
    built = cuda_build.build(["radius", "resident_adam"])
    print(f"[build] {sorted(built)} in {time.perf_counter() - t0:.2f}s")
    sass_lines()

    # 2. kernels against their plain versions
    shapes = [(D, N, B) for D in (256, 512, 2000) for N in (1, 200, 333)
              for B in (1, 3, 13)] + [(2000, 2000, 104)]
    # N and counts on and beside the kernel's chunk of points, D on and beside
    # its tile of directions
    chunk = radius.CHUNK
    shapes += [(D, N, 5) for D in (1023, 1024, 1025)
               for N in (chunk - 1, chunk, chunk + 1, 2 * chunk, 3 * chunk + 7)]
    errs = [radius_error(radius_case(D, N, B, seed=i))
            for i, (D, N, B) in enumerate(shapes)]
    full = radius_case(2000, 2000, 104, seed=1234)
    radius_same_bits(full)
    full_ms = device_ms(lambda: radius.sample_radii(*full))
    full_plain_ms = device_ms(lambda: radius.sample_radii_plain(*full))
    full_bound, full_by = radius_bound_ms(full)
    print(f"[kernels] radius vs plain at {len(shapes)} shapes: max abs err "
          f"{max(errs):.3e} (tol {KERNEL_TOL} x max(1,|plain|))")
    radius_nan_check()
    resident_worst = resident_errors()
    print("[kernels] radius full-scale B=104 D=2000 N=2000 counts~U[0,2000]: "
          + json.dumps({"ms": full_ms, "plain_ms": full_plain_ms,
                        "bound_ms": full_bound, "bound_by": full_by,
                        "pairs": int(full[1].clamp(0, 2000).sum()) * 2000}))

    # 3. the main paths
    cfg = load_config()
    with tempfile.TemporaryDirectory(prefix="lesionvae_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        generate_cohort(root, cfg, seed=SEED, volume_shape=(VOLUME,) * 3,
                        subjects=cfg.subjects_by_group(only=("TBI", "PTE")))
        print(f"[path] synthetic cohort written in {time.perf_counter() - t0:.1f}s")
        launches, path_inputs = check_path(root)
    probe, probe_launches = check_probe()
    if args.skip_vae:
        print("[path] vae and score paths skipped (--skip-vae)")
    else:
        run_vae_paths(cfg)

    # 4. kernel timings at the main paths' shapes
    err = radius_error(path_inputs)
    ms = device_ms(lambda: radius.sample_radii(*path_inputs))
    plain_ms = device_ms(lambda: radius.sample_radii_plain(*path_inputs))
    bound, by = radius_bound_ms(path_inputs)
    surface, counts, _c, directions = path_inputs
    print(f"[kernels] main-path radius inputs: B={surface.shape[0]} "
          f"N={surface.shape[1]} D={directions.shape[0]} "
          f"points={int(counts.sum())}")
    per_k = [{key: r[key] for key in ("k", "form", "launches", "max_abs_err",
                                      "share_differing", "bound_ms", "bound_by",
                                      "issue_bound_ms")}
             | {"ms": r["resident_ms"], "plain_ms": r["plain_ms"]} for r in probe]
    k1 = per_k[0]
    print(card)
    print(json.dumps({"kernels": [{
        "name": "radius", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/radius.cu",
        "replaces": "lesionvae_tpu/ops/pallas_radius.py:29",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound, "bound_by": by,
        "library_ms": None}, {
        "name": "resident_adam", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/resident_adam.cu",
        "replaces": "benchmarks/pallas_opt_probe.py:118",
        "launches": probe_launches,
        "max_abs_err": max([resident_worst["max_abs_err"]]
                           + [r["max_abs_err"] for r in per_k]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None, "k": k1["k"],
        "per_k": per_k}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
