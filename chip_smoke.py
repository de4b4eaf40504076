#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lesionvae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py [--skip-vae]      (--skip-vae leaves out 3d-3g, 3h's c-d, 3i)

Phases; any failure exits non-zero before the result line is printed:

1. environment: torch/CUDA versions, the card's name and power limit, a
   build of every kernel from the sources in this checkout (one ``nvcc``
   per source, all started together; timed), and one ``[sass]`` line per
   kernel function: the instructions of its hot loop by class, per
   element-step or per point-direction pair, counted in the machine code.
   Worker processes write the bundle cohort of 3c (and the profiles of 3d
   and 3e) meanwhile (host work only) and have ended before the first timed
   call and the first path;
2. every kernel against its plain PyTorch version on the card:
   - radius, float32, at the test shapes, at N, counts and D on and beside
     the kernel's chunk and tile edges, the full-scale shape (B=104,
     D=2000, N=2000), two NaN cases (a counted NaN point gives NaN, a
     NaN pad row changes nothing), and the same bits on repeated calls;
   - resident Adam, bf16, in the IEEE and the fast-math form, at ragged
     totals (not multiples of 8), at zero, subnormal, huge, infinite and
     NaN values and from the probe's m = v = 0, K in {0, 1, 3, 30}:
     bit-equal in p, m and v (the two round at the same places);
   - stochastic-rounding Adam (the fleet's bf16-storage optimizer pass),
     at ragged row lengths, T in {1, 3, 64}, a member that skips, gradient
     norms above and below the clip, values that saturate at bf16-max, inf
     and NaN gradients, zero moments, step counts 1 and large: bit-equal in
     p, m and v (float32 IEEE in the same order, integer rounding), with a
     random index table and with the flat one's first entries; and again,
     in phase 4, at the cohort path's shape (64 members x the weight
     elements of a full-width member, the model's own index table and the
     flat one of the JAX package's FlatLowmemOptimizer);
   - the geometry kernel, both modes (float32 points, u16 delta codes), at
     P in {32, 48, 64, 128, 256} with S = 1 and S on and beside the block's
     streamline count, at 32,768 x 64, on adversarial rows (straight lines,
     planar circles, duplicate points, n = 1..4, a zero-length curve, spectra
     either side of the certificate's gates) and on the design's edge rows
     (n = 1..4 and P, n at the lanes a streamline and twice that -1/+0/+1,
     non-finite curvature and torsion, coordinates at 1e25, 1e18 and 1e-25,
     NaN and inf coordinates, signed zeros): every element bit-equal to the
     plain version (NaN for NaN; the differing elements of every case are
     printed), the verdict columns (valid, eigen_ok, the two inf gates)
     equal in every row, and the same bits on repeated calls;
   - the fleet's masked BatchNorm + ReLU (the cluster route: one forward
     and one backward kernel a layer; the general route: statistics, apply,
     gradient sums, gradient; eval: apply), at the seven layers' shapes of
     the cohort path's step (64 members x batch 64 x L x C: the cluster
     route) and of the single VAE's (one member x batch 64 x L x C), at
     the cluster route's edges (a cluster of 16 blocks, batch
     128 x 64 x 64, and of one, batch 8 x 37 x 8) and at shapes that take
     the general route (batch 512, and a row
     of 5 channels, no whole 16-byte vector), float32 and bf16, training
     with pad rows (an all-pad member and a NaN member where there are
     three members or more), and eval: y, mean,
     var, the running statistics, dx, dweight and dbias bit-equal to the
     plain version (NaN for NaN; the sums have one fixed order), and
     a second call the same bits;
   - the optimizer's gradient gather with each member's norm and its
     float32-storage update (``ops/csrc/adam.cu``), at the paths' shapes:
     the 36 leaf gradients of a real 64-member full-width step as autograd
     returns them (float32, and bf16 weight gradients), the single VAE's
     one-member step's, and ``train_loop``'s flat gradient as a one-leaf
     table; float32 rows of 64 and of 1 x 2,741,153 and x 1,088, and
     1 x 2,742,241; members over, under and
     near the clip, a skipping member, NaN and inf gradients; the gather
     also at its alignment edges (every load and store route, destinations
     at even and odd elements, odd member strides, columns off 8,
     transposed rows off 32, one-row bf16 leaves): packed rows, sums of
     squares, norms and p, m, v bit-equal (NaN for NaN), a second call the
     same bits, with one ``[sass]`` line and the registers of each of its
     kernel functions and the gather's blocks an SM (``[occupancy]``);
   - the fleet's convolutions (``ops/csrc/conv1d.cu``: the forward, dx and
     dw with db), at the eight layers' shapes of the cohort path's step (64
     members x batch 64, inputs laid out as the step lays them; member 0
     alone too, as the single VAE runs a layer: y and dh bit-equal to its
     64-member launch, dw and db to the tolerance; members 0-1 and 0-7
     alone, y and dh bit-equal: together every float32 forward tile) and at
     four
     edge shapes, float32 and bf16: each output's error against the float64
     product at most CONV_PLAIN_RATIO times the plain version's, and in
     float32 within KERNEL_TOL (see CONV_PLAIN_RATIO), a second call the
     same bits, NaN through; one ``[sass]`` line a kernel function and an
     ``[occupancy]`` line; their launches a step are held on the
     ``vae-cohort``, ``score-cohort`` and ``all`` paths;
3. the main paths, each with every kernel's launch count set to 0 just
   before it and read just after:
   a. the ``lesion`` CLI stage on ``cuda`` over the full-scale synthetic
      cohort (26 TBI/PTE subjects x 4 timepoints, 48^3 volumes, 2000
      directions, L=6); its CSV checked and held against a CPU float32 run;
   b. the optimizer probe (``benchmarks/opt_probe.py``) at its full size,
      T=64 members x P=2,867,200 bf16 parameters, K in {1, 10, 30}, in both
      forms: the kernel's whole output bit-equal to the plain loop's, and
      both timed;
   c. the geometry stage (``launch_geometry``, as ``run_geometry`` and the
      ``geometry`` CLI stage run it) on ``cuda`` over the full-scale bundle
      cohort (37 subjects x 4 timepoints x 16 tracts = 2,368 bundles of 100
      streamlines, 236,800 streamlines); its three CSVs checked and held
      against a CPU float32 run of the port, and the ``u16d`` upload held
      against ``f32`` (per streamline and per bundle);
   d. the ``vae`` CLI stage on ``cuda`` at full width (seq 100, 13 + 3
      channels, latent 10, batch 64; 10 epochs, a quarter of the config's
      depth) over the first tract of the full-scale profiles cohort (37
      subjects x 4 timepoints, 925 rows each); the
      eval forward, z-scores and a 2-epoch training run held against the CPU
      in float32, and the same three again with TF32 on as a control that
      must exceed every one of those bounds; then the
      ``score`` CLI stage on ``cuda`` serving a saved model, held against a
      CPU float32 ``score_subjects``; the training (a fleet of one member)
      must launch the gather and norm once a step, the update twice
      (weights, BatchNorm leaves), the convolution kernels 14 + 8 times
      (each conv_fwd on a tile smaller than the full one:
      ``conv_fwd_small_tiles`` 14 a step, 0 on the ``vae-cohort`` path) and
      the masked BatchNorm's cluster kernels seven times each (the kernels
      line's ``launches_by_path`` gives them under ``vae``);
   e. the cohort fleet at full width: a profiles cohort for the 16 geometry
      tracts (37 subjects x 4 timepoints, 925 rows a member), the
      ``vae-cohort`` CLI stage on ``cuda`` with bf16 storage (64 members
      trained as one program, 40 epochs = 600 fleet steps, each one launch
      of the stochastic-rounding Adam kernel, one of the gather and norm,
      one of the float32 update (the BatchNorm leaves) and 14 of the masked BatchNorm
      kernels, the cluster route's forward and backward for each of the
      seven layers) and ``score-cohort`` over
      the saved members (the apply kernel alone: eval); then, at full width and small depth, the float32 fleet
      held against the CPU (normalization, a 1-epoch history, the normative
      summary, serving), one member of the fleet and the same member trained
      alone by ``train_module`` (its one-member fleet program) against that
      member trained alone by the module's eager route (``train_loop``) on
      the card, and a uint16-upload and a bf16-compute run; last, the
      64 members' initial weights on this host by the native pass and by
      the plain version, timed, the rows bit-equal (an ``[init]`` line);
   f. the whole pipeline (``all --with-vae --no-plots --device cuda`` through
      ``cli.main``): geometry (100 streamlines a bundle) -> lesion (2000
      directions over the cohort's 48^3 volumes) -> the float32 fleet (64
      members x 40 epochs x batch 64, a step one launch of the gather and
      norm and two of the float32 update, no SR Adam) -> classify ->
      correlate, on the
      cohort of 3c-3e; where scikit-learn is missing (an import check
      decides), ``all`` must refuse before its first stage and the phase
      runs ``geometry``, ``lesion``, ``vae-cohort`` and ``correlate`` in
      that order.  Radius must launch once and geometry 9 times; the
      geometry and lesion CSVs must equal, bit for bit, the phase's own
      standalone runs; the fleet writes vae-cohort's files with finite
      summaries; correlate (and classify) are held against the same host
      stages on the CPU float32 CSVs of 3a and 3c (r and p within
      CORR_TOL, pairs in one set only within P_BAND of p = 0.05; moved
      classification rows explained by their features); the host encoder
      and CSV reader loaded are printed;
   g. chunked and split fleet launches at full width and small depth (64
      members x 2 epochs): ``upload_chunks=1`` against "auto" (8 chunks) and
      against two blocks with the canonical draws (``member_draws``), each
      timed, bit-equal or within tests/test_upload_chunks.py's bounds;
   h. the parallel paths (``check_parallel``): (a) one rank over NCCL,
      ``make_mesh(1)`` and a full-size chunk (32,768 x 64) through
      ``launch_bundle_metrics(mesh=)``, bit-equal to the unsharded call;
      then two gloo ranks sharing the card: (b) the geometry stage over 3c's
      cohort, bundles read once and handed over, its three CSVs byte-equal
      to 3c's; (c) the member-sharded fleet (64 members at full width,
      bf16 storage, normalization and summary, 2 epochs, 32 a rank), no
      collective in training, bit-equal to the same two blocks launched in
      one process and within ALONE_TOL of the one 64-member launch in
      history, the next member as control; (d) ``dryrun_flagship(2)`` at
      the full widths and ``dryrun_train_step(2, model_parallel=2)`` with
      their own assertions.  Every rank must launch geometry (b) and SR Adam
      (c); a rank that exits non-zero fails the script ((a) and (b) only
      with --skip-vae);
   i. the programs (``check_programs``): training runs as one device
      program on the card, each epoch one replay of a captured CUDA graph
      (train/program.py), and so do paths 3d-3h above (their lines print
      the captures and replays; 3e's SR Adam count is one a fleet step at
      the replays plus one a step of the epoch run before the capture; 3g's
      chunks replay one program).  (a) The single VAE (one member's rows of
      the chunked case, 2 epochs) and the bf16-storage 64-member fleet (2
      epochs) at full width, graph against eager (``train_loop``,
      ``train_fleet``) on the same inputs: two eager runs are read first;
      where they agree bit for bit the fleet's graph must too, else it is
      held to the larger of that reading and ALONE_TOL / ALONE_MOVE, to
      which the single VAE's graph (its one-member fleet program: the
      fleet's kernels) is held against the module's eager route (cuDNN,
      ``MaskedBatchNorm``); the single VAE's graph must repeat bit for bit
      and equal ``train_fleet`` at one member bit for bit; (b) the fleet's SR
      Adam launches counted at each replay; (c) ``warm_compile``: a fleet
      launch (one capture) and then the real launch with no new capture,
      and the geometry kernel launched at every chunk shape of 3c's plan
      with no row refined; (d) ``torch.cuda.max_memory_allocated``.  A
      step's readout by layer is ``benchmarks/vae_step_profile.py``'s;
4. kernel timings (CUDA events) at the shapes the main paths gave each
   kernel, beside each kernel's bound, printed as one ``{"kernels": [...]}``
   line (the resident kernel per K and form, with the nominal bound and
   the bound that counts the instructions the card must issue, as radius,
   SR Adam and the geometry kernel have one too; the geometry kernel at the
   path's largest chunk, 32,768 x 64, in both modes, and summed over the
   stage's launches; the masked BatchNorm kernels each over the seven
   layers of one 64-member step and the seven layers' forward and
   backward by route, float32 and bf16, beside the plain version and, as a
   yardstick the port never calls, ``F.batch_norm`` + ReLU unmasked,
   replayed from a CUDA graph; the optimizer's gather and norm and float32
   update at the paths' shapes with their plain versions and bounds, and
   the fleet's whole optimizer step against the chain it replaced, in
   turns, the gather replayed from a CUDA graph as the training program
   runs it, beside the leaves' copies alone as an informative floor:
   ``benchmarks/adam_timing.py``).

Each phase ends in a ``[time] <phase> <seconds>`` line (``1_build`` to
``4_conv1d``), the run in ``[time] chip_smoke.py wall``.  The last line of
stdout is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import json
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from lesionvae_tpu_torch.io.synth import generate_cohort
from lesionvae_tpu_torch.utils.cost_model import kernel_bound_ms
from lesionvae_tpu_torch.utils.profiling import device_ms

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
# the single-tract path runs at a quarter of the depth since the cohort path
# (3d) joined the script; the cohort path keeps all 40 epochs
SINGLE_EPOCHS = 10
VAE_STREAMLINES, VAE_ROWS = 100, 925
# cuda vs cpu float32, 2-epoch history: sound runs read 1.1e-4 (cuDNN and
# the CPU sum convolutions in other orders and 30 Adam steps carry it), the
# TF32 control 4.3e-4 (see tf32_control)
HIST_TOL = 2e-4
# the cohort path: 16 tracts x 4 timepoints, rows padded 925 -> 960
COHORT_MEMBERS, COHORT_PAD, COHORT_STEPS = 64, 960, 40 * 15
# a member of the float32 fleet against the same member trained alone on the
# card by the module's eager route (``train_loop``), same weights and draws, 2
# epochs (30 steps).  The stacked model's convolutions are the port's
# kernels, the module's run in cuDNN, so the two sum in other orders.  Adam
# divides every gradient by its own running size: where a gradient is of the size of its rounding error the
# step is ±lr on either side, and BatchNorm's running statistics follow such
# weights (a convolution's bias ahead of a BatchNorm has no gradient at all
# but for rounding, and moves by it alone).  So single elements are not
# held; each tensor is held, in L2, to ALONE_MOVE of the distance it moved
# from its start (read 5.1e-2 and 4.4e-4 for the worst tensor in two runs:
# some backward kernels sum with atomics, so runs differ), the history to
# ALONE_TOL (read 1.8e-4 and 6.0e-8; on the CPU in float64 the two agree to
# 1e-10), and another member of the same fleet must lie outside both (read
# 7.8e-2 and 79)
ALONE_TOL, ALONE_MOVE = 5e-4, 0.2
# stochastic-rounding Adam: rows (ragged but for 4096) x members
SR_ROWS = [1, 7, 9, 4096, 65539, 1_000_003]
SR_MEMBERS = [1, 3, 64]
# the geometry path: the config's 16 geometry tracts over bench.py's cohort
# (37 subjects x 4 timepoints), the CLI's --max-streamlines 100
GEO_STREAMLINES, GEO_BUNDLES = 100, 37 * 4 * 16
GEO_P = [32, 48, 64, 128, 256]
GEO_COLS = ["n_streamlines", "length_mean", "tortuosity_mean", "curv_mean_avg",
            "curv_energy_mean", "torsion_mean_avg", "bend_angle_mean_avg",
            "elongation_ratio_mean", "planarity_ratio_mean", "anisotropy_ratio_mean",
            "ang_dispersion_mean", "centroid_x_mean", "centroid_y_mean",
            "centroid_z_mean", "subject_id", "timepoint", "tract", "group"]
GEO_CSVS = ("comprehensive_tract_geometry_metrics.csv",
            "summary_statistics_by_group_timepoint.csv",
            "summary_statistics_by_tract_group.csv")
# u16d against f32: per streamline, p99 of |u16d - f32| / max(|f32|, 1e-12)
# over every column but torsion (the JAX package's probe read <= 3e-4), but
# curvature energy, a sum of squared curvatures, at 4e-4: the JAX package's
# own decode reads 3.06e-4 there on 20,000 49-60-point synth streamlines
# (the port's 3.12e-4; a CPU run of both).  Per bundle, the band
# tests/test_geo_codec.py pins, rtol 2e-3 and atol 1e-6, but curvature
# energy and torsion (host float64 against the card's float32) at 1e-2: on
# this cohort the JAX package's own u16d run moves their bundle means by up
# to 4.04e-3 and 5.3e-3 (the port's: 4.04e-3 and 4.9e-3; a CPU run of both)
CODEC_P99, CODEC_P99_ENERGY, CODEC_RTOL, CODEC_ATOL = 3e-4, 4e-4, 2e-3, 1e-6
CODEC_RTOL_WIDE = 1e-2


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def reset_launches() -> None:
    """Every kernel's launch count to 0, just before a main path runs."""
    from lesionvae_tpu_torch.ops import (adam, conv1d, geometry, masked_bn, radius,
                                         resident_adam, sr_adam)

    from lesionvae_tpu_torch.train import program

    radius.sample_radii.launches = 0
    resident_adam.resident_adam.launches = 0
    sr_adam.sr_adam_step.launches = 0
    geometry.streamline_metrics_stacked.launches = 0
    for wrapper in masked_bn.WRAPPERS + adam.WRAPPERS + conv1d.WRAPPERS:
        wrapper.launches = 0
    program.reset_counts()


def hold_adam_launches(path: str, steps: int, per_step: dict) -> dict:
    """The gather-and-norm and update kernels' launches since the last
    reset, held to ``per_step`` times the path's ``steps`` training steps
    (its graph replays' and its warm-up epochs'), or the script fails."""
    from lesionvae_tpu_torch.ops import adam

    got = {w.__name__: w.launches for w in adam.WRAPPERS}
    want = {k: v * steps for k, v in per_step.items()}
    if got != want:
        fail(f"{path}: the optimizer kernels launched {got} times in {steps} training "
             f"steps, {want} expected")
    return got


def masked_bn_launches() -> dict:
    """Launches of each masked BatchNorm kernel since the last reset."""
    from lesionvae_tpu_torch.ops import masked_bn

    return {w.__name__: w.launches for w in masked_bn.WRAPPERS}


def conv1d_launches() -> dict:
    """Launches of each convolution kernel since the last reset."""
    from lesionvae_tpu_torch.ops import conv1d

    return {w.__name__: w.launches for w in conv1d.WRAPPERS}


# a training step of the fleet runs its eight convolutions through the
# kernels: conv_fwd eight times forward and six times backward (dh; micro_c1
# and lesion_c1 take the input data), conv_wgrad eight times; an eval
# forward (the normative summary's, serving's) conv_fwd eight times and the
# masked BatchNorm apply kernel seven times
CONV_A_STEP = {"conv_fwd": 14, "conv_wgrad": 8}
# the single VAE trains as a fleet of one member: a step launches the same
# convolution kernels and the masked BatchNorm's cluster route, one launch
# forward and one backward a layer, nothing of its general route
SINGLE_A_STEP = {**CONV_A_STEP, "bn_cluster_forward": 7, "bn_cluster_backward": 7}


def eval_forwards(path: str, bn: dict) -> int:
    """The fleet's eval forwards since the last reset, read off the masked
    BatchNorm launches ``bn``: seven applies each, beside the general
    route's training applies (one a pair of statistics launches)."""
    applies = bn["bn_apply"] - bn["bn_stats"] // 2
    if applies <= 0 or applies % 7:
        fail(f"{path}: {applies} eval applies of the masked BatchNorm kernel ({bn}), "
             "seven an eval forward expected")
    return applies // 7


def hold_conv_launches(path: str, steps: int, bn: dict) -> dict:
    """The convolution kernels' launches since the last reset, held to
    CONV_A_STEP a training step of the path's ``steps`` and eight conv_fwd
    launches an eval forward, the eval forwards counted by the masked
    BatchNorm launches ``bn``, or the script fails.  ``a_step`` is each
    kernel's count less the eval forwards' over ``steps``, as measured."""
    got = conv1d_launches()
    evals = eval_forwards(path, bn)
    a_step = {"conv_fwd": (got["conv_fwd"] - 8 * evals) / steps,
              "conv_wgrad": got["conv_wgrad"] / steps}
    if a_step != CONV_A_STEP:
        fail(f"{path}: the convolution kernels launched {got} times in {steps} training "
             f"steps and {evals} eval forwards, {a_step} a step; {CONV_A_STEP} a step and "
             "8 conv_fwd an eval forward expected")
    return {**got, "eval_forwards": evals, "a_step": a_step}


def hold_small_tiles(path: str, want: int) -> None:
    """The float32 conv_fwd launches on a tile smaller than the full one
    since the last reset (``train.program.COUNTS``) held to ``want``, or the
    script fails."""
    from lesionvae_tpu_torch.train import program

    got = program.COUNTS["conv_fwd_small_tiles"]
    if got != want:
        fail(f"{path}: {got} conv_fwd launches on a smaller tile, {want} expected")


def graph_counts() -> str:
    """The training graphs' captures and replays since the last reset."""
    from lesionvae_tpu_torch.train import program

    return f"graph captures {program.COUNTS['captures']}, replays {program.COUNTS['replays']}"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


@contextlib.contextmanager
def phase(name: str):
    """Prints ``[time] <name> <seconds>`` when the phase ends."""
    t0 = time.perf_counter()
    yield
    print(f"[time] {name} {time.perf_counter() - t0:.1f}", flush=True)


# ---------------------------------------------------------------- machine code
# per kernel: an instruction of its hot loop, what unit of work the loop
# body does, and how often the instruction occurs in it per unit (geometry:
# the pass-1 round loop takes one point a lane and holds two warp ballots,
# the finite curvature and torsion counts)
SASS_UNITS = {"radius": (r"^FMNMX", "pair", 1),
              "resident_adam": (r"^MUFU\.RSQ", "element-step", 1),
              "sr_adam": (r"^MUFU\.RSQ", "element", 1),
              "geometry": (r"^VOTE", "point", 2)}


def short_name(mangled: str) -> str:
    """A kernel's name and template arguments out of its mangled symbol;
    the resident kernel's one argument is its form, the geometry kernel's
    are its lanes a streamline and its mode."""
    m = re.search(r"\d+([a-z_]+_kernel)(?:I((?:L[a-z]\d+E)+)E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[a-z](\d+)E", m.group(2) or "")
    if m.group(1) == "resident_adam_kernel" and args in (["0"], ["1"]):
        args = ["fastmath" if args == ["1"] else "ieee"]
    if m.group(1) == "geometry_kernel" and len(args) == 2:
        args = [f"{args[0]} lanes", "u16" if args[1] == "1" else "f32"]
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def sass_lines() -> None:
    """One ``[sass]`` line per kernel function: the instructions of its hot
    loop (the K-step body of resident Adam, the point loop of radius, the
    pass-1 round loop of geometry) by class, per element-step, pair or
    point, counted in the machine code that ``cuobjdump -sass`` shows.  The
    count is static: a slow path that sits inside the loop counts whether or
    not it is taken."""
    from lesionvae_tpu_torch.ops import cuda_build

    for name, (unit, what, per) in SASS_UNITS.items():
        loops = cuda_build.inner_loops(cuda_build.sass(name), unit)
        if not any(f["units"] for f in loops.values()):
            fail(f"no {unit} instruction in the machine code of {name}")
        for fn, f in loops.items():
            if not f["units"]:
                continue
            units = f["units"] / per
            print(f"[sass] {name}:{short_name(fn)} per {what} ({'loop' if f['loop'] else 'whole function'}"
                  f" of {f['instructions']} instructions, {units:g} {what}s): "
                  + json.dumps({k: round(v * per, 3) for k, v in f["per_unit"].items()})
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


def radius_bound_ms(inputs) -> dict:
    """Least time for this run's work (``utils.cost_model.kernel_bound_ms``):
    Σ_b min(count_b, N)·D pairs of 3 FMA + 1 max (7 FP32 operations; 4
    instructions: a multiply, two FMAs, a max) against the bytes each input
    and output needs once (only the counted surface rows)."""
    surface, counts, _c, directions = inputs
    B, N, _ = surface.shape
    D = directions.shape[0]
    n_pts = int(counts.clamp(0, N).sum())
    nbytes = 12 * n_pts + 4 * B + 12 * B + 12 * D + 4 * B * D
    return kernel_bound_ms(nbytes, 7.0 * n_pts * D, 4 * n_pts * D)


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

    reset_launches()
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


# ---------------------------------------------------------------- SR Adam
def sr_case(members: int, n: int, seed: int, special: bool):
    """Inputs of one stochastic-rounding Adam step on the card: bf16 p ~
    0.02 N(0,1), m ~ 1e-3 N(0,1), v ~ 1e-6 |N(0,1)|, g ~ 1e-2 N(0,1) in the
    kernel's row layout; a random index table; per member a gradient norm
    below (0.5) or above (7) the clip of 2, a step count of 1 or 123,457, a
    salt near 2^32, and member 1 skipping.  ``special`` scatters zero
    moments, ±bf16-max in p, m and g together (m' then lies between bf16-max
    and the float32 maximum, so its rounding carries into the infinity
    pattern and must saturate), and ±inf and NaN gradients."""
    from lesionvae_tpu_torch.ops import sr_adam

    g = np.random.default_rng(seed)
    big = sr_adam.BF16_MAX
    rows = [g.normal(size=(members, n)) * 0.02, g.normal(size=(members, n)) * 1e-3,
            np.abs(g.normal(size=(members, n))) * 1e-6,
            g.normal(size=(members, n)) * 1e-2]
    if special:
        p, m, v, gr = rows
        m[:, 0::13] = 0.0
        v[:, 0::13] = 0.0
        for x in (p, m, gr):
            x[:, 3::29] = big
            x[:, 5::31] = -big
        gr[:, 7::37] = np.inf
        gr[:, 11::41] = -np.inf
        gr[:, 17::43] = np.nan
    tensors = []
    for x in rows:
        t = sr_adam.alloc_rows(members, n, torch.bfloat16, "cuda")
        t.copy_(torch.from_numpy(x))
        tensors.append(t)
    count = torch.tensor([1 if t % 2 == 0 else 123_457 for t in range(members)],
                         dtype=torch.float32, device="cuda")
    scalars = (
        torch.tensor([0.5 if t % 3 else 7.0 for t in range(members)],
                     dtype=torch.float32, device="cuda"),
        1 - torch.pow(torch.tensor(0.9, device="cuda"), count),
        1 - torch.pow(torch.tensor(0.999, device="cuda"), count),
        torch.from_numpy(g.integers(2 ** 32 - 1000, 2 ** 32, size=members)).to("cuda"),
        torch.tensor([t != 1 for t in range(members)], device="cuda"))
    base = torch.from_numpy(g.integers(-2 ** 31, 2 ** 31, size=n).astype(np.int32)).to("cuda")
    return tensors, base, scalars


def sr_same_bits(got, plain, before, where: str) -> float:
    """Fails unless p, m and v of the kernel (``got``) are the plain
    version's bits (two NaNs count as equal) and member 1, which skips,
    kept its bits.  Returns the largest |kernel - plain|."""
    worst = 0.0
    for name, g, want, old in zip("pmv", got, plain, before):
        same = ((g.view(torch.int16) == want.view(torch.int16))
                | (torch.isnan(g) & torch.isnan(want)))
        if not bool(same.all()):
            fail(f"SR Adam kernel differs from its plain version in {name} at "
                 f"{where}: {int((~same).sum())} of {same.numel()} elements")
        if g.shape[0] > 1 and not torch.equal(g[1].view(torch.int16),
                                              old[1].view(torch.int16)):
            fail(f"SR Adam kernel wrote {name} of a member that skips at {where}")
        d = torch.nan_to_num((g.float() - want.float()).abs(), nan=0.0, posinf=0.0)
        worst = max(worst, float(d.max()))
    return worst


def sr_adam_errors() -> float:
    """The kernel against its plain version at every small case: every bf16
    of p, m and v must be the same bits, and a skipping member must keep its
    bits.  Returns the largest |kernel - plain|."""
    from lesionvae_tpu_torch.ops import sr_adam

    from lesionvae_tpu_torch.models.fleet import layout
    from lesionvae_tpu_torch.train.lowmem import sr_index_table

    c = sr_adam.consts(2e-4, 1e-3, 2.0)
    flat = sr_index_table(layout(100, 13, 3, VAE_LATENT), flat=True).to("cuda")
    worst, cases = 0.0, 0
    for members in SR_MEMBERS:
        for i, n in enumerate(SR_ROWS):
            if members * n > 8_000_000:
                continue
            for special, table in ((False, "random"), (True, "random"), (False, "flat"),
                                   (True, "flat")):
                (p, m, v, gr), base, scalars = sr_case(members, n, 100 * members + i,
                                                       special)
                if table == "flat":     # the flat index table's first n entries
                    base = flat[:n]
                before = [t.clone() for t in (p, m, v)]
                plain = [t.clone() for t in (p, m, v)]
                sr_adam.sr_adam_step(p, m, v, gr, base, *scalars, c)
                sr_adam.sr_adam_step_plain(*plain, gr, base, *scalars, c)
                torch.cuda.synchronize()
                worst = max(worst, sr_same_bits(
                    (p, m, v), plain, before,
                    f"T={members} n={n} special={special} table={table}"))
                # member 2 is below the clip: at elements 3 and 5 its m'
                # lies above bf16-max and must come back as ±bf16-max
                if (special and members > 2 and n > 5
                        and m[2, [3, 5]].float().tolist()
                        != [sr_adam.BF16_MAX, -sr_adam.BF16_MAX]):
                    fail(f"SR Adam: m' above bf16-max did not saturate: "
                         f"{m[2, [3, 5]].float().tolist()}")
                cases += 1
    print(f"[kernels] SR Adam vs plain at T {SR_MEMBERS} x rows {SR_ROWS}, plain and "
          f"with zero moments, ±bf16-max, ±inf and NaN gradients; norms above and "
          f"below the clip, counts 1 and 123457, one member skipping; each with a "
          f"random index table and with the flat table's first n entries "
          f"(train.lowmem.sr_index_table(flat=True)) ({cases} cases): bit-equal in "
          f"p, m and v; max abs err {worst:.3e}")
    return worst


def sr_adam_at_path_shape(members: int, lay) -> dict:
    """The kernel at the cohort path's shape, ``members`` rows of the weight
    elements of one full-width member with the model's own index table:
    first held against its plain version bit for bit in p, m and v, with the
    special values and without (norms above and below the clip, counts 1 and
    123457, one member skipping), then both timed on the ordinary values,
    beside the bounds of ``ops.sr_adam.bound_ms``."""
    from lesionvae_tpu_torch.ops import sr_adam
    from lesionvae_tpu_torch.train.lowmem import sr_index_table

    n = lay.n_weights
    c = sr_adam.consts(2e-4, 1e-3, 2.0)
    worst = 0.0
    # the flat table first, the path's (per-leaf) table last; the special
    # values last but one: the timed calls below go on from the ordinary case
    # with the path's table (infinities and NaNs take the quotient's slow
    # paths)
    for flat in (True, False):
        base = sr_index_table(lay, flat=flat).to("cuda")
        for special in (True, False):
            (p, m, v, gr), _random_table, scalars = sr_case(members, n, 7, special)
            before = [t.clone() for t in (p, m, v)]
            plain = [t.clone() for t in (p, m, v)]
            sr_adam.sr_adam_step(p, m, v, gr, base, *scalars, c)
            sr_adam.sr_adam_step_plain(*plain, gr, base, *scalars, c)
            torch.cuda.synchronize()
            worst = max(worst, sr_same_bits(
                (p, m, v), plain, before, f"the cohort path's shape T={members} "
                f"n={n} special={special} flat={flat}"))
            del before, plain
    print(f"[kernels] SR Adam vs plain at the cohort path's shape, T={members} x "
          f"n={n} (row stride {p.stride(0)}) with the model's index table and with "
          f"the flat one (the JAX FlatLowmemOptimizer's noise), plain and special "
          f"values: bit-equal in p, m and v; max abs err {worst:.3e}")
    scalars = scalars[:4] + (torch.ones(members, dtype=torch.bool, device="cuda"),)
    ms = device_ms(lambda: sr_adam.sr_adam_step(p, m, v, gr, base, *scalars, c))
    plain_ms = device_ms(lambda: sr_adam.sr_adam_step_plain(p, m, v, gr, base,
                                                            *scalars, c),
                         reps=3, inner=2)
    return {"ms": ms, "plain_ms": plain_ms, **sr_adam.bound_ms(members * n),
            "members": members, "row": n, "max_abs_err": worst}



# ---------------------------------------------------------------- the optimizer's kernels
# the gradient gather with each member's norm and the float32-storage update
# (ops/csrc/adam.cu) at the paths' shapes: the 36 leaf gradients of one real
# 64-member full-width fleet step (as autograd returns them, float32 and
# bf16 weight gradients; the single VAE's of one member, and train_loop's
# flat gradient as a one-leaf table), and float32 rows of 64 x 2,741,153
# (the fleet's weights), 64 x 1,088 (its BatchNorm leaves), 1 x 2,741,153
# and 1 x 1,088 (the single VAE's, a fleet of one member) and 1 x 2,742,241
# (train_loop's flat buffer).  Member t's gradients are scaled to a norm
# of 2 * 3^(t % 5 - 2), so members lie on both sides of the clip and near it;
# one member holds a NaN and one an infinite gradient
ADAM_ROWS = ((COHORT_MEMBERS, 2_741_153), (COHORT_MEMBERS, 1_088), (1, 2_742_241),
             (1, 2_741_153), (1, 1_088))


def same_bits_nan(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, a NaN for a NaN."""
    return bits_differ(got, want) == 0


def norm_outputs(opt) -> list:
    """What ``grad_sq_norm`` wrote for ``opt`` (a fleet or single optimizer):
    its packed rows (or none), sums of squares and norms, cloned."""
    rows = [opt.g_w, opt.g_a] if hasattr(opt, "g_w") else [opt.g]
    return [t.clone() for t in rows + [opt.sq, opt.g_norm]]


def adam_norm_errors() -> dict:
    """``grad_sq_norm`` against its plain version at the paths' shapes: the
    fleet's 36 leaves of 64 members in both storages, the single VAE's 36
    leaves of its one-member fleet step (float32 storage, as autograd
    returns them at one member), member 0 of the 64-member leaves into
    ``train_loop``'s flat buffer and that buffer (a one-leaf table, no
    destination): packed rows, sums of squares and norms bit-equal (NaN for
    NaN), a second call the same bits, the members on both sides of the
    clip, the NaN and the infinite member's norm NaN and inf."""
    from lesionvae_tpu_torch.benchmarks.adam_timing import norm_args, path_grads
    from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
    from lesionvae_tpu_torch.ops import adam
    from lesionvae_tpu_torch.train.lowmem import LowmemOptimizer
    from lesionvae_tpu_torch.train.trainer import ClipDecayAdam

    cases, seen = 0, {}
    for label, members, store in (("f32", COHORT_MEMBERS, None),
                                  ("bf16", COHORT_MEMBERS, torch.bfloat16),
                                  ("f32 one member", 1, None)):
        state, grads = path_grads(members, store)
        T = state.members
        raw = torch.sqrt(sum((x.double() ** 2).flatten(1).sum(1) for x in grads.values()))
        scale = 2.0 * 3.0 ** (torch.arange(T, device="cuda") % 5 - 2) / raw
        for x in grads.values():
            x.mul_(scale.view(-1, *[1] * (x.dim() - 1)).to(x.dtype))
        if T > 5:
            grads["fc_dec.weight"][3, 7, 11] = float("nan")
            grads["micro_b1.bias"][5, 2] = float("inf")
        seen[label] = {n: list(x.stride()) for n, x in grads.items() if not x.is_contiguous()}
        opts = [LowmemOptimizer(state, 2e-4, 1e-3, 2.0) for _ in range(2)]
        adam.grad_sq_norm(*norm_args(opts[0], grads))
        got = norm_outputs(opts[0])
        adam.grad_sq_norm(*norm_args(opts[0], grads))
        again = norm_outputs(opts[0])
        adam.grad_sq_norm_plain(*norm_args(opts[1], grads))
        torch.cuda.synchronize()
        want = norm_outputs(opts[1])
        for what, g, w, a in zip(("g_w", "g_a", "sq", "g_norm"), got, want, again):
            if not same_bits_nan(g, w) or not same_bits_nan(g, a):
                fail(f"gradient norm kernel vs plain at {T} x 36 leaves, {label}: {what} "
                     f"differs in {bits_differ(g, w)} elements (second call "
                     f"{bits_differ(g, a)})")
        norm = got[3]
        # one member: 2 * 3^-2 of the clip, finite
        ok = (torch.isnan(norm[3]) and torch.isinf(norm[5]) and bool((norm < 2.0).any())
              and bool((norm[6:] > 2.0).any())) if T > 5 else bool((norm < 2.0).all())
        if not ok:
            fail(f"gradient norm at {T} x 36 leaves, {label}: norms {norm[:8].tolist()}")
        cases += 1
        if label == "f32":
            # train_loop's optimizer (the module route, which the mesh
            # runs): member 0's gradients into its flat buffer's views, then
            # that buffer as a one-leaf table
            with torch.device("meta"):
                module = LesionConditionedVAE(100, 13, 3, 10)
            single = [ClipDecayAdam(module.to_empty(device="cuda"), 2e-4, 1e-3, 2.0)
                      for _ in range(2)]
            leaves = [grads[n][:1] for n in opts[0]._names]
            outs = []
            for fn, opt in zip((adam.grad_sq_norm, adam.grad_sq_norm_plain), single):
                fn(leaves, opt._dsts, opt._work, opt.sq, opt.g_norm)
                outs.append(norm_outputs(opt))
            flat = single[0].g.clone()
            for fn, opt in zip((adam.grad_sq_norm, adam.grad_sq_norm_plain), single):
                fn([flat[None]], [None], opt._work_flat, opt.sq, opt.g_norm)
                outs.append(norm_outputs(opt)[1:])
            torch.cuda.synchronize()
            for i, (g, w) in enumerate(zip(outs[0] + outs[2], outs[1] + outs[3])):
                if not same_bits_nan(g, w):
                    fail(f"gradient norm kernel vs plain, train_loop's flat buffer "
                         f"(output {i}): {bits_differ(g, w)} elements differ")
            cases += 2
        del state, grads, opts
        torch.cuda.empty_cache()
    edges = norm_edge_cases()
    print(f"[kernels] gradient norm (grad_sq_norm) vs plain at 64 members x the 36 leaves "
          f"of a full-width step, float32 and bf16 weight gradients, non-contiguous leaves "
          f"as autograd returned them {json.dumps(seen['f32'])}; the single VAE's one "
          f"member x 36 leaves, float32 {json.dumps(seen['f32 one member'])}; member 0's "
          f"36 leaves into train_loop's flat buffer and that buffer as a one-leaf "
          f"table ({cases} cases): packed rows, "
          f"sums of squares and norms bit-equal (NaN for NaN), a second call the same "
          f"bits, members over and under the clip, a NaN member's norm NaN, an inf "
          f"member's inf; alignment edges ({edges} cases: every route, destinations at "
          f"even and odd elements, odd member strides, columns off 8, transposed rows "
          f"off 32, one-row bf16 leaves) bit-equal; max abs err 0")
    return {"cases": cases + edges, "max_abs_err": 0.0}


def norm_edge_leaves(gen, T: int, dtype: torch.dtype) -> list:
    """Gradients (T, *shape) of ``dtype`` on the card that take every route
    of the gather (``ops.adam.leaf_route``) at its edges: transposed
    matrices read down their rows element by element (70 and 37 rows) and
    in 16-byte copies (40 and 72 rows, past a row-tile edge; 19 and 100
    columns), vectors of 104 (16-byte copies, the last row zero-filled), 100
    and 1,001 (unaligned), a convolution weight whose columns take two
    strides, row-major matrices of 13, 33 and 64 columns, one-row leaves of
    50 and 64, a view one element into its storage (no 16-byte copy), and a
    transposed 300 x 200 matrix of several tiles a warp."""
    def normal(*shape):
        return torch.randn((T, *shape), generator=gen, device="cuda").to(dtype)

    def rows_fast(x):
        return x.transpose(1, 2).contiguous().transpose(1, 2)

    conv = normal(6, 5, 3).permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
    shifted = torch.randn((T * 130 + 1,), generator=gen, device="cuda").to(dtype)
    return [rows_fast(normal(70, 40)), rows_fast(normal(37, 24)),
            rows_fast(normal(40, 70)), rows_fast(normal(72, 19)),
            rows_fast(normal(48, 100)), normal(104), normal(100), normal(1001), conv,
            normal(5, 13), normal(9, 33), normal(3, 64), normal(1, 50), normal(1, 64),
            shifted[1:].view(T, 130), rows_fast(normal(300, 200))]


def norm_edge_cases() -> int:
    """``grad_sq_norm`` against its plain version on ``norm_edge_leaves`` in
    float32 and bf16, 3 and 1 members, destinations packed at an even and at
    an odd element with an odd member stride, and without destinations; a
    NaN and an inf element in member 0: packed rows, sums of squares and
    norms bit-equal (NaN for NaN), a second call the same bits.  Returns
    the cases held."""
    from lesionvae_tpu_torch.ops import adam

    gen = torch.Generator(device="cuda").manual_seed(14)
    cases = 0
    for dtype in (torch.float32, torch.bfloat16):
        for T, offset, stride_pad in ((3, 0, 2), (3, 1, 1), (1, 3, 0), (3, None, 0)):
            grads = norm_edge_leaves(gen, T, dtype)
            grads[2][0, 5, 7] = float("nan")
            grads[5][0, 77] = float("inf")
            outs = []
            for fn in (adam.grad_sq_norm, adam.grad_sq_norm, adam.grad_sq_norm_plain):
                dsts = []
                for x in grads:
                    if offset is None:
                        dsts.append(None)
                        continue
                    n = x[0].numel()
                    buf = torch.zeros((T, offset + n + stride_pad), dtype=dtype, device="cuda")
                    dsts.append(buf[:, offset:offset + n].view(x.shape))
                work = adam.norm_work([x.shape[1:] for x in grads], T, "cuda")
                sq = torch.zeros(T, device="cuda")
                norm = torch.zeros(T, device="cuda")
                fn(grads, dsts, work, sq, norm)
                outs.append([d for d in dsts if d is not None] + [sq, norm])
            torch.cuda.synchronize()
            routes = sorted({(e.rows_fast, e.src_vec, e.dst_vec)
                             for e in adam.norm_table(grads, dsts, work, sq, norm)})
            where = (f"{str(dtype)[6:]} T={T} destination offset {offset} member "
                     f"stride +{stride_pad}, routes {routes}")
            for i, (got, again, want) in enumerate(zip(*outs)):
                if not same_bits_nan(got, want) or not same_bits_nan(got, again):
                    fail(f"gradient norm kernel vs plain at the alignment edges, {where}: "
                         f"output {i} differs in {bits_differ(got, want)} elements "
                         f"(second call {bits_differ(got, again)})")
            if not torch.isnan(outs[0][-1][0]):
                fail(f"gradient norm at the alignment edges, {where}: member 0's norm "
                     f"{float(outs[0][-1][0])} is not NaN")
            cases += 1
    return cases


def adam_step_errors() -> dict:
    """``adam_step`` against its plain version at ADAM_ROWS: every bit of p,
    m and v (NaN for NaN), members below and above the clip, counts 1 and
    123,457, a member with ``finite`` false kept bit for bit, a member with
    a NaN and an inf gradient; each one-member row (the single VAE's two,
    train_loop's flat one) below and above the clip and skipped."""
    from lesionvae_tpu_torch.benchmarks.adam_timing import update_rows
    from lesionvae_tpu_torch.ops import adam

    hyper = adam.Hyper(2e-4, 1e-3, 2.0)
    cases = 0
    for i, (T, n) in enumerate(ADAM_ROWS):
        variants = ([{}] if T > 1 else
                    [{"norm": 0.5}, {"norm": 7.0}, {"norm": 7.0, "skip": True}])
        for var in variants:
            p, m, v, g, g_norm, bc1, bc2, finite = update_rows(T, n, 10 + i)
            count = torch.tensor([1.0 if t % 2 == 0 else 123_457.0 for t in range(T)],
                                 device="cuda")
            bc1.copy_(1 - torch.pow(torch.tensor(0.9, device="cuda"), count))
            bc2.copy_(1 - torch.pow(torch.tensor(0.999, device="cuda"), count))
            g_norm.copy_(torch.tensor([var.get("norm", 0.5 if t % 3 else 7.0)
                                       for t in range(T)], device="cuda"))
            if T > 2:
                finite[1] = False
                g[2, 3], g[2, 5] = float("nan"), float("inf")
            if var.get("skip"):
                finite[0] = False
            before = [t.clone() for t in (p, m, v)]
            plain = [t.clone() for t in (p, m, v)]
            adam.adam_step(p, m, v, g, g_norm, bc1, bc2, finite, hyper)
            adam.adam_step_plain(*plain, g, g_norm, bc1, bc2, finite, hyper)
            torch.cuda.synchronize()
            where = f"T={T} n={n} {json.dumps(var)}"
            for name, got, want, old in zip("pmv", (p, m, v), plain, before):
                if not same_bits_nan(got, want):
                    fail(f"Adam kernel vs plain at {where}: {name} differs in "
                         f"{bits_differ(got, want)} elements")
                for t in range(T):
                    if not bool(finite[t]) and not same_bits_nan(got[t], old[t]):
                        fail(f"Adam kernel wrote {name} of skipping member {t} at {where}")
            if T > 2 and not (torch.isnan(p[2, 3]) and torch.isnan(p[2, 5])):
                fail(f"Adam kernel at {where}: a NaN or inf gradient did not give NaN")
            cases += 1
            del p, m, v, g, before, plain
        torch.cuda.empty_cache()
    print(f"[kernels] Adam update (adam_step) vs plain at {[list(r) for r in ADAM_ROWS]} "
          f"float32 rows, norms over and under the clip, counts 1 and 123457, a skipping "
          f"member kept bit for bit, a NaN and an inf gradient; each one-member row "
          f"under and over the clip and skipped ({cases} cases): p, m, v bit-equal (NaN "
          f"for NaN); max abs err 0")
    return {"cases": cases, "max_abs_err": 0.0}


def adam_sass_lines() -> dict:
    """One ``[sass]`` line per function of csrc/adam.cu with its registers
    (``ops.adam.kernel_attributes``): the update's hot loop per element (its
    16-byte body holds four elements, one root each), the gather's whole
    function per element of its unit of work, the 64 elements a lane takes
    of a tile (both dtypes' and every route's code count), the finishing
    kernel whole; and one ``[occupancy]`` line: the gather's blocks an SM."""
    from lesionvae_tpu_torch.ops import adam, cuda_build

    text = cuda_build.sass("adam")
    loops = cuda_build.inner_loops(text, r"^MUFU\.RSQ")
    attrs = adam.kernel_attributes()
    lane_tile = adam.TILE_ROWS * adam.TILE_COLS // 32
    out = {}
    for fn, code in cuda_build.sass_functions(text).items():
        name = next((k for k in adam.KERNELS if k in fn), fn)
        if name == "adam_kernel":
            f = loops[fn]
            per, what = f["per_unit"], f"element (loop of {f['instructions']} instructions)"
        else:
            counts = {c: 0 for c in cuda_build.SASS_CLASSES}
            for _addr, op, _full, _operands in code:
                counts[cuda_build.sass_class(op)] += 1
            unit = lane_tile if name == "norm_tiles_kernel" else 1
            per = {k: v / unit for k, v in counts.items()}
            per["total"] = len(code) / unit
            what = (f"element (whole function of {len(code)} instructions over the {unit} "
                    "elements a lane takes of a tile)" if unit > 1
                    else "block (whole function)")
        out[name] = {"per": {k: round(v, 3) for k, v in per.items()}, **attrs.get(name, {})}
        print(f"[sass] adam:{name} per {what}: {json.dumps(out[name]['per'])}; "
              f"registers {attrs[name]['registers']}, local bytes "
              f"{attrs[name]['local_bytes']}, shared bytes {attrs[name]['shared_bytes']}")
    blocks = adam.norm_blocks_per_sm()
    out["norm_tiles_kernel"]["occupancy"] = {"blocks_per_sm": blocks,
                                             "warps_per_sm": blocks * adam.WARPS}
    print(f"[occupancy] adam:norm_tiles_kernel ({adam.WARPS} warps a block, a tile a "
          f"warp): {blocks} blocks, {blocks * adam.WARPS} tiles an SM at once")
    return out


# ---------------------------------------------------------------- geometry kernel
def curve_with_spectrum(rng, n: int, lam) -> np.ndarray:
    """n points whose ddof-1 covariance has the eigenvalues ``lam`` (in a
    random orientation), about the origin."""
    z = rng.normal(size=(n, 3))
    q, _ = np.linalg.qr(z - z.mean(axis=0))
    rot, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    return (q * np.sqrt(np.asarray(lam) * (n - 1))) @ rot.T


def geometry_adversarial(P: int, seed: int):
    """Rows that sit on the metrics' edges, each with the eigen certificate
    it must get (None: whatever it gets): straight lines (λ2 = λ3 = 0, both
    ratios inf), planar circles (λ3 = 0), duplicate consecutive points, n = 1
    to 4, a zero-length curve (not valid), and spectra 2% either side of
    EIGEN_SAFE_REL·λ1 (in λ3) and of EIGEN_SAFE_ABS (in λ1)."""
    from lesionvae_tpu_torch.ops.geometry import EIGEN_SAFE_ABS, EIGEN_SAFE_REL

    rng = np.random.default_rng(seed)
    n = min(P, 40)
    t = np.linspace(0, 1, n)
    dup = np.cumsum(rng.normal(size=(n, 3)), axis=0)
    dup[3:6] = dup[2]
    rows = [(np.stack([10 * t, 0 * t, 0 * t], 1), False),
            (np.stack([4 * t, 4 * t, 4 * t], 1), False),
            (np.stack([3 * np.cos(6 * t), 3 * np.sin(6 * t), 0 * t], 1), False),
            (dup, None), (np.full((n, 3), 2.5), False)]
    rows += [(rng.normal(size=(k, 3)) * 3, None) for k in (1, 2, 3, 4)]
    for side in (1.02, 0.98):
        rows.append((curve_with_spectrum(rng, n, [4.0, 0.4, 4.0 * EIGEN_SAFE_REL * side]),
                     side > 1))
        rows.append((curve_with_spectrum(rng, n, [EIGEN_SAFE_ABS * side, 0.3 * EIGEN_SAFE_ABS,
                                                  0.1 * EIGEN_SAFE_ABS]), side > 1))
    return [r for r, _ in rows], [e for _, e in rows]


def geometry_edge_rows(P: int, lanes: int, seed: int):
    """Rows at the edges of the kernel's design: n in {1, 2, 3, 4} and n = P
    beside padded rows; n at the lanes a streamline and twice that, -1, +0
    and +1 (a round's edge); rows whose curvature or torsion is not finite
    or whose quotients and roots leave the fast paths' range (coordinates at
    1e25, 1e18 and 1e-25, a NaN and an inf coordinate mid-curve); and a row
    of signed zeros (the bounding box's max and min of -0 and +0)."""
    rng = np.random.default_rng(seed)

    def walk(k, step=1.0):
        return np.cumsum(rng.normal(size=(k, 3)) * step, axis=0)

    ns = {1, 2, 3, 4, P} | {k for m in (lanes, 2 * lanes) for k in (m - 1, m, m + 1)}
    rows = [walk(k) for k in sorted(k for k in ns if 1 <= k <= P)]
    k = min(P, 24)
    rows += [walk(k, 1e25), walk(k, 1e18), walk(k, 1e-25)]
    for bad in (np.nan, np.inf):
        r = walk(k)
        r[k // 2, 1] = bad
        rows.append(r)
    z = np.zeros((min(P, 9), 3))
    z[1::2, 0] = -0.0
    z[::3, 2] = -0.0
    z[:, 1] = np.arange(len(z), dtype=np.float64) % 2 * -0.0
    rows.append(z)
    return rows


def geometry_inputs(sls, P: int):
    """The kernel's inputs in both modes on the card: ((points, lengths),
    (codes, p0, lo, sc, lengths)) of the float32 padded bundle."""
    from lesionvae_tpu_torch.ops.geo_codec import encode_u16_delta
    from lesionvae_tpu_torch.ops.padding import pad_streamlines

    pts, lens = pad_streamlines(sls, max_points=P)
    codes, p0, lo, sc = encode_u16_delta(pts, lens)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to("cuda")  # noqa: E731
    return ((dev(pts), dev(lens)),
            (dev(codes.view(np.int16)), dev(p0), dev(lo), dev(sc), dev(lens)))


def geometry_compare(got, want, where: str) -> tuple[float, int]:
    """Fails unless the kernel's (19, S) output is within KERNEL_TOL x
    max(1, |plain|) of the plain version's with inf and NaN in the same
    places, and the verdict columns (valid, eigen_ok, the inf gates of
    elongation and planarity) are equal in every row.  Returns (largest
    |kernel - plain|, elements whose bits differ)."""
    from lesionvae_tpu_torch.ops.geometry import STACKED_NAMES

    torch.cuda.synchronize()
    for k in ("valid", "eigen_ok"):
        r = STACKED_NAMES.index(k)
        if not torch.equal(got[r], want[r]):
            fail(f"geometry kernel: {k} differs from the plain version in "
                 f"{int((got[r] != want[r]).sum())} rows at {where}")
    for k in ("elongation_ratio", "planarity_ratio"):
        r = STACKED_NAMES.index(k)
        if not torch.equal(torch.isinf(got[r]), torch.isinf(want[r])):
            fail(f"geometry kernel: the inf gate of {k} differs from the plain "
                 f"version at {where}")
    if not (torch.equal(torch.isnan(got), torch.isnan(want))
            and torch.equal(torch.isinf(got), torch.isinf(want))):
        fail(f"geometry kernel: inf or NaN in other places than the plain version at {where}")
    fin = torch.isfinite(want)
    err = torch.where(fin, (got - want).abs(), torch.zeros_like(got))
    if bool((err > KERNEL_TOL * want.abs().clamp(min=1.0)).any()):
        r = int(err.max(dim=1).values.argmax())
        fail(f"geometry kernel disagrees with its plain version at {where}: "
             f"{STACKED_NAMES[r]} off by {float(err[r].max()):.3e}")
    differ = (got.view(torch.int32) != want.view(torch.int32)) & ~(
        torch.isnan(got) & torch.isnan(want))
    return float(err.max()), int(differ.sum())


def geometry_errors() -> float:
    """The kernel against its plain version in both modes: random bundles at
    every P of GEO_P with S = 1 and S on and beside the block's streamline
    count, adversarial rows at every P (their eigen certificates as
    designed), the rows of ``geometry_edge_rows`` at every P, and the full
    chunk 32,768 x 64.  Every element must be bit-equal (NaN for NaN), and
    6 calls on the edge rows and on the full chunk must give the same bits.
    Prints the differing elements of every case.  Returns the largest
    |kernel - plain|."""
    from lesionvae_tpu_torch.io.synth import make_bundle
    from lesionvae_tpu_torch.ops import geometry as g

    worst, elements, per_case = 0.0, 0, {}
    rng = np.random.default_rng(55)

    def random_rows(S, P):
        sls = []
        while len(sls) < S:
            sls += make_bundle(rng, min(100, S - len(sls)), min_pts=3, max_pts=P)
        return sls

    def same_bits(f32, u16, where):
        for name, fn, args in (("f32", g.streamline_metrics_stacked, f32),
                               ("u16", g.streamline_metrics_stacked_u16, u16)):
            first = fn(*args)
            for _ in range(5):
                again = fn(*args)
                if not torch.equal(again.view(torch.int32), first.view(torch.int32)):
                    fail(f"geometry kernel ({name}) at {where}: two calls on the same "
                         "inputs gave different bits")

    def check(sls, P, where, expect=None):
        nonlocal worst, elements
        f32, u16 = geometry_inputs(sls, P)
        for mode, fn, plain, args in (
                ("f32", g.streamline_metrics_stacked, g.streamline_metrics_stacked_plain, f32),
                ("u16", g.streamline_metrics_stacked_u16,
                 g.streamline_metrics_stacked_u16_plain, u16)):
            got, want = fn(*args), plain(*args)
            e, d = geometry_compare(got, want, f"{where} {mode}")
            worst, elements = max(worst, e), elements + got.numel()
            per_case[f"{where} {mode}"] = d
            if expect is not None and mode == "f32":
                ok = want[g.STACKED_NAMES.index("eigen_ok")].cpu().numpy() > 0.5
                for i, x in enumerate(expect):
                    if x is not None and ok[i] != x:
                        fail(f"geometry: adversarial row {i} at P={P} got eigen_ok "
                             f"{ok[i]}, built for {x}")
        return f32, u16

    for P in GEO_P:
        lanes, spb, _ = g.block_streamlines(P)
        for S in sorted({1, spb - 1, spb, spb + 1, 3 * spb + 5} - {0}):
            check(random_rows(S, P), P, f"S={S} P={P}")
        adv, expect = geometry_adversarial(P, seed=P)
        check(adv + random_rows(7, P), P, f"adversarial rows P={P}", expect + [None] * 7)
        edge = geometry_edge_rows(P, lanes, seed=1000 + P)
        same_bits(*check(edge + random_rows(5, P), P, f"edge rows P={P}"),
                  f"the edge rows at P={P}")
    same_bits(*check(random_rows(32768, 64), 64, "S=32768 P=64"), "32768 x 64")
    differ = sum(per_case.values())
    print("[kernels] geometry elements differing from the plain version, by case: "
          + json.dumps(per_case))
    print(f"[kernels] geometry vs plain, f32 points and u16 codes, at P {GEO_P} with S = 1 "
          f"and S on and beside the block's streamline count, adversarial rows (lines, "
          f"circles, duplicate points, n = 1..4, zero length, spectra 2% either side of "
          f"both certificate gates), edge rows (n = 1..4, P, the lanes and twice them "
          f"-1/+0/+1, non-finite curvature and torsion, 1e25/1e18/1e-25 scales, NaN and "
          f"inf coordinates, signed zeros) and 32768 x 64 ({len(per_case)} cases): verdict "
          f"columns equal in every row, max abs err {worst:.3e}, {differ} of {elements} "
          "elements differ in any bit; 6 calls on the edge rows and at 32768 x 64 gave the "
          "same bits in both modes")
    if differ:
        fail(f"geometry kernel: {differ} elements differ from the plain version")
    return worst


# ---------------------------------------------------------------- masked BatchNorm + ReLU
# the fleet step's seven BatchNorm + ReLU layers at the cohort path's shape:
# 64 members x batch 64 x (L, C) of utils/cost_model.bn_layers; inputs, runs
# and timings from benchmarks/masked_bn_timing.py
def bits_differ(a: torch.Tensor, b: torch.Tensor) -> int:
    """Elements whose bits differ, NaN for NaN (payloads aside); -1 for a
    shape or dtype mismatch."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return -1
    na, nb = torch.isnan(a), torch.isnan(b)
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    ai, bi = a.contiguous().view(ints), b.contiguous().view(ints)
    return int(((na != nb) | (~na & (ai != bi))).sum())


# shapes (members, batch, L, C) that only the general route takes: a member
# too long for one cluster, and a row that is no whole 16-byte vector
GENERAL_BN_SHAPES = ((4, 512, 100, 64), (3, 8, 37, 5))
# the cluster route's edges: a member of 8,192 rows (the largest cluster,
# MAX_CLUSTER blocks) and one of 296 rows (a cluster of one block)
EDGE_BN_SHAPES = ((4, 128, 64, 64), (3, 8, 37, 8))


def masked_bn_errors() -> float:
    """The kernels against their plain versions, float32 and bf16,
    training (pad rows; with three members or more an all-pad member and a
    NaN member) and eval, by ``route``: at the seven layers' shapes, of 64
    members (the fleet's step) and of one member (the single VAE's), and
    at EDGE_BN_SHAPES (the cluster route) and at GENERAL_BN_SHAPES (the
    general route): every output (y, the statistics, dx, dweight, dbias)
    bit-equal, NaN for NaN, and a second call the same bits.  Returns the
    largest |kernel - plain| (0 when bit-equal)."""
    from lesionvae_tpu_torch.benchmarks.masked_bn_timing import OUTPUTS, bn_case, bn_run
    from lesionvae_tpu_torch.ops import masked_bn
    from lesionvae_tpu_torch.utils.cost_model import bn_layers

    shapes = [(name, (64, 64, L, C)) for name, (L, C) in bn_layers().items()]
    shapes += [("edge", shape) for shape in EDGE_BN_SHAPES]
    shapes += [("general", shape) for shape in GENERAL_BN_SHAPES]
    shapes += [(name, (1, 64, L, C)) for name, (L, C) in bn_layers().items()]
    edges = sorted(masked_bn.cluster_size(N, L) for _T, N, L, _C in EDGE_BN_SHAPES)
    if edges != [1, masked_bn.MAX_CLUSTER]:
        fail(f"masked BatchNorm edge shapes take clusters of {edges} blocks")
    cases, worst, routes = 0, 0.0, {}
    for i, (name, (T, N, L, C)) in enumerate(shapes):
        for dtype in (torch.float32, torch.bfloat16):
            path = masked_bn.route(N, L, C, dtype, True)
            if (name == "general") != (path == "general"):
                fail(f"masked BatchNorm route of {name} {(T, N, L, C)} {dtype}: {path}")
            routes[path] = routes.get(path, 0) + 2
            special = T >= 3
            for training in (True, False):
                case = bn_case(L, C, dtype, 100 + i, training, special, members=T,
                               batch=N)
                got, want = bn_run(case, training, True), bn_run(case, training, False)
                again = bn_run(case, training, True)
                torch.cuda.synchronize()
                where = (f"{name} ({T} x {N} x {L} x {C}) {dtype} training={training} "
                         f"{path} route")
                for out, g, w, a in zip(OUTPUTS, got, want, again):
                    differ = bits_differ(g, w)
                    if differ:
                        fail(f"masked BatchNorm kernel vs plain at {where}: {out}: "
                             f"{differ} elements differ")
                    if bits_differ(g, a):
                        fail(f"masked BatchNorm kernel at {where}: {out}: two calls "
                             "differ")
                    ok = ~torch.isnan(w)
                    worst = max(worst, float((g.float() - w.float())[ok].abs().max()))
                cases += 1
                if not special:
                    continue
                y, dx = got[0], got[5]
                nan_channel = (y[2, ..., C // 3] if training
                               else y[2, min(5, N - 1), L // 2, C // 3])
                if not torch.isnan(nan_channel).all() or (
                        training and not torch.isnan(dx[2, ..., C // 3]).all()):
                    fail(f"masked BatchNorm at {where}: the NaN did not stay NaN")
                if training and (got[1][1].any() or got[2][1].any()):
                    fail(f"masked BatchNorm at {where}: the all-pad member's statistics "
                         "are not 0 (its count clamps to 1)")
    print(f"[kernels] masked BatchNorm + ReLU vs plain at the seven layers' shapes "
          f"(64 members x batch 64, and one member x batch 64 as the single VAE trains), "
          f"at the cluster route's edges "
          f"{[list(s) for s in EDGE_BN_SHAPES]} (clusters of {edges} blocks) and at "
          f"{[list(s) for s in GENERAL_BN_SHAPES]}, "
          f"float32 and bf16, training with pad rows (an all-pad member and a NaN member "
          f"where there are three or more), "
          f"and eval ({cases} cases; training layers by route {json.dumps(routes)}, their "
          f"eval forward the apply kernel, their backward the same route): y, mean, var, "
          f"running statistics, dx, dweight, dbias bit-equal (NaN for NaN), a second call "
          f"the same bits; max abs err {worst:.3e}")
    return worst


def masked_bn_sass_lines() -> None:
    """One ``[sass]`` line per function of csrc/masked_bn.cu: its
    instructions by class per element, the whole function counted (a
    thread's rows are unrolled, so no loop holds the element's work; the
    full-chunk and ragged-chunk instances, both branches of a training/eval
    switch and the chunk-combining loop count whether taken or not) over
    the elements a thread takes (its 8 rows of one vector: 4 float32 or 8
    bf16 channels, or one channel where the template's width is 1)."""
    from lesionvae_tpu_torch.ops import cuda_build
    from lesionvae_tpu_torch.ops.masked_bn import ELEMENTS_A_THREAD, ROWS_A_LANE

    for fn, code in cuda_build.sass_functions(cuda_build.sass("masked_bn")).items():
        counts = {c: 0 for c in cuda_build.SASS_CLASSES}
        for _addr, op, _full, _operands in code:
            counts[cuda_build.sass_class(op)] += 1
        m = re.search(r"\d+([a-z_]+_kernel)I(?:f|13__nv_bfloat16)(?:Li(\d+)E)?", fn)
        kind = "bf16" if "bfloat16" in fn else "f32"
        width = m.group(2) if m else None
        per_thread = (ROWS_A_LANE * int(width) if width
                      else ELEMENTS_A_THREAD[torch.bfloat16 if kind == "bf16" else torch.float32])
        per = {k: round(v / per_thread, 3) for k, v in counts.items()}
        per["total"] = round(len(code) / per_thread, 3)
        label = f"{kind},{width}" if width else kind
        print(f"[sass] masked_bn:{m.group(1) if m else fn}<{label}> per element (whole "
              f"function of {len(code)} instructions, {per_thread} elements a thread): "
              + json.dumps(per))
    # the cluster kernels' residency at the seven layers' cluster sizes and
    # at the route's edges, one block and MAX_CLUSTER
    from lesionvae_tpu_torch.ops.masked_bn import MAX_CLUSTER, active_clusters, cluster_size
    from lesionvae_tpu_torch.utils.cost_model import bn_layers

    sizes = sorted({cluster_size(64, L) for L, _C in bn_layers().values()} | {1, MAX_CLUSTER})
    held = {f"{name}_{dt}": {q: active_clusters(dtype, backward, q) for q in sizes}
            for name, backward in (("forward", False), ("backward", True))
            for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    print("[occupancy] masked_bn cluster kernels: clusters the card holds at once by "
          f"blocks a cluster (cudaOccupancyMaxActiveClusters): {json.dumps(held)}")


# ---------------------------------------------------------------- the fleet's convolutions
# the step's eight convolutions at the cohort path's shape, 64 members x
# batch 64 x (L, C_in, C_out) of utils/cost_model.conv_layers, inputs laid
# out as the step lays them (benchmarks/conv_timing.py::conv_case), and
# shapes at the kernels' edges, (members, batch, L, C_in, C_out,
# transposed): one-row samples, input channels past eight staged chunks and
# output channels past one tile, both ragged, an odd length, a bias of 17
EDGE_CONV_SHAPES = ((3, 40, 1, 3, 3, False), (2, 7, 12, 130, 70, True),
                    (3, 5, 37, 13, 13, False), (2, 3, 25, 64, 17, True))
# The tolerance, against the float64 product of the same inputs: an
# output's error is max |out - ref| / max(1, |ref|).  The kernel's may be at
# most CONV_PLAIN_RATIO times the plain version's (cuBLAS's products,
# PyTorch's sum) in both dtypes, and in float32 at most KERNEL_TOL (1e-5)
# for y and dh (sums of 5 C_in <= 640 terms).  dw and db sum a member's N L
# <= 6,400 rows: there the float32 bound is KERNEL_TOL x max(1, |ref|,
# sqrt(sum of the terms' squares)), the size of the rounding a float32 sum
# of those terms carries in any order.  Against max(1, |ref|) alone, the
# measure written for float32 outputs, dw reads up to 4.6e-5 at these
# unit-scale inputs and the plain version up to 3.6e-4: the kernel's float32
# dw is held there to CONV_DW_LITERAL_TOL, set from those readings (db is
# summed in float64 and meets 1e-5 either way)
CONV_PLAIN_RATIO = 2.0
CONV_DW_LITERAL_TOL = 1e-4
# members of the cases held bit-equal to the same members of the 64-member
# launch: at the eight layers' shapes they take every float32 forward tile
FEW_MEMBERS = (1, 2, 8)
# timed groups of 20 graph replays a reading in the script's timings (the
# benchmark's own default is 25, and it also reads each layer)
CONV_TIMING_REPS = 5


def conv_error(got: torch.Tensor, ref: torch.Tensor, scale=None) -> float:
    """max |got - ref| / max(1, |ref|[, scale]) over the elements."""
    den = ref.abs() if scale is None else torch.maximum(ref.abs(), scale)
    return float(((got.double() - ref).abs() / den.clamp(min=1.0)).max())


def conv1d_nan_check(dtype) -> None:
    """A NaN in h reaches y at the five rows it touches and dw at its input
    channel; a NaN in dy reaches dh at five rows and dw and db at its output
    channel; the other members stay finite."""
    from lesionvae_tpu_torch.benchmarks.conv_timing import conv_case, kernel_run

    c = conv_case("micro_c2", dtype, 77, members=4, batch=8)
    c["h"][2, 5, 10, 3] = float("nan")
    c["dy"][1, 3, 7, 2] = float("nan")
    y, dh, dw, db = kernel_run(c)
    torch.cuda.synchronize()
    nan = torch.isnan
    ok = (nan(y[2, 5, 8:13]).all() and not nan(y[2, 5, :8]).any()
          and not nan(y[2, 5, 13:]).any() and not nan(y[0]).any()
          and nan(dh[1, 3, 5:10]).all() and not nan(dh[1, 3, :5]).any()
          and not nan(dh[0]).any() and nan(dw[2, :, 3]).all() and nan(dw[1, 2]).all()
          and not nan(dw[0]).any() and bool(nan(db[1, 2])) and not nan(db[0]).any())
    if not ok:
        fail(f"conv1d kernels, {dtype}: a NaN did not pass through as the convolution "
             "carries it")


def conv1d_errors() -> dict:
    """The kernels (forward, dh, dw and db) against their plain versions and
    the float64 product at the eight layers' shapes (64 members: the
    fleet's step) and EDGE_CONV_SHAPES, float32 and bf16, to the tolerance
    above; a second call the same bits; NaN through.  Each layer's member 0
    also alone, as the single VAE (a fleet of one member) runs it, and its
    first FEW_MEMBERS members: the float32 forward and dh take a smaller
    tile where the grid of few members is small (``fwd_f32_tile``), and
    every tile sums an output in the same order, so they must repeat those
    members' bits at 64 members, and the cases must take every tile; dw and
    db split the rows by the member count, and are held to the tolerance at
    one member.  Returns the largest |kernel - float64| and the readings."""
    from lesionvae_tpu_torch.benchmarks.conv_timing import (OUTPUTS, conv_case, kernel_run,
                                                             plain_run)
    from lesionvae_tpu_torch.ops import conv1d
    from lesionvae_tpu_torch.utils.cost_model import conv_layers
    from lesionvae_tpu_torch.utils.precision import full_fp32

    full_fp32(torch.device("cuda"))
    cases = [(name, {}) for name in conv_layers()]
    cases += [("edge", {"members": T, "batch": N, "shape": (L, ci, co, t)})
              for T, N, L, ci, co, t in EDGE_CONV_SHAPES]
    acc = {"worst": 0.0, "ratio": 0.0, "bounded": 0.0, "literal_dw": 0.0, "plain_dw": 0.0}
    tiles = set()

    def hold(c, where, outs=OUTPUTS) -> list:
        """The kernels' outputs ``outs`` of case ``c`` held to the tolerance;
        returns every output."""
        got, again, plain = kernel_run(c), kernel_run(c), plain_run(c)
        ref = plain_run(c, torch.float64)
        scale = {}
        if c["h"].dtype == torch.float32:
            _dh, dw2, db2 = conv1d.conv1d_backward_plain(
                c["h"].double() ** 2, c["w"].double(), c["dy"].double() ** 2,
                c["transposed"], False)
            scale = {"dw": dw2.sqrt(), "db": db2.sqrt()}
        torch.cuda.synchronize()
        for out, g, a, p, r in zip(OUTPUTS, got, again, plain, ref):
            if g is None or out not in outs:
                continue
            if bits_differ(g, a):
                fail(f"conv1d kernel at {where}: {out}: two calls differ")
            kernel, base = conv_error(g, r), conv_error(p, r)
            if kernel > CONV_PLAIN_RATIO * base:
                fail(f"conv1d kernel at {where}: {out} error {kernel:.3e}, more than "
                     f"{CONV_PLAIN_RATIO} x the plain version's {base:.3e}")
            acc["ratio"] = max(acc["ratio"], kernel / base)
            if c["h"].dtype == torch.float32:
                held = conv_error(g, r, scale.get(out))
                if held > KERNEL_TOL:
                    fail(f"conv1d kernel at {where}: {out} error {held:.3e} above "
                         f"{KERNEL_TOL}")
                acc["bounded"] = max(acc["bounded"], held)
                if out == "dw":
                    if kernel > CONV_DW_LITERAL_TOL:
                        fail(f"conv1d kernel at {where}: dw error {kernel:.3e} against "
                             f"max(1, |ref|) above {CONV_DW_LITERAL_TOL}")
                    acc["literal_dw"] = max(acc["literal_dw"], kernel)
                    acc["plain_dw"] = max(acc["plain_dw"], base)
            acc["worst"] = max(acc["worst"], float((g.double() - r).abs().max()))
        return got

    for i, (name, kw) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            c = conv_case(name, dtype, 500 + i, **kw)
            where = (f"{name} {list(c['h'].shape)} -> {c['dy'].shape[3]} channels "
                     f"{'transposed ' if c['transposed'] else ''}{dtype}")
            got = hold(c, where)
            if kw:
                continue
            one = {k: v[:1] if torch.is_tensor(v) else v for k, v in c.items()}
            alone = hold(one, f"{where}, member 0 alone", ("dw", "db"))
            for T in (64, *FEW_MEMBERS):
                if T == 1:
                    mine = alone
                elif T < 64:
                    f = {k: v[:T] if torch.is_tensor(v) else v for k, v in c.items()}
                    mine = [conv1d.conv_fwd(f["h"], f["w"], f["b"], f["transposed"]),
                            conv1d.conv_fwd(f["dy"], f["w"], None, not f["transposed"])
                            if f["need_dh"] else None]
                else:
                    mine = got
                for out, g, g64 in zip(OUTPUTS[:2], mine, got):
                    if g is None:
                        continue
                    if dtype == torch.float32:
                        tiles.add(conv1d.fwd_f32_tile(T, g.shape[1] * g.shape[2], g.shape[3]))
                    if bits_differ(g, g64[:T]):
                        fail(f"conv1d kernel at {where}: {out} of members 0-{T - 1} alone "
                             f"differs from its 64-member launch in "
                             f"{bits_differ(g, g64[:T])} elements")
    want = {t for c in (16, 32, 64) for t in conv1d.fwd_f32_tiles(c)}
    if tiles != want:
        fail(f"conv1d kernel: the few-member cases took the float32 tiles {sorted(tiles)}, "
             f"not every tile {sorted(want)}")
    for dtype in (torch.float32, torch.bfloat16):
        conv1d_nan_check(dtype)
    worst, ratio, bounded = acc["worst"], acc["ratio"], acc["bounded"]
    literal_dw, plain_dw = acc["literal_dw"], acc["plain_dw"]
    print(f"[kernels] conv1d vs plain and the float64 product at the eight layers' shapes "
          f"(64 members x batch 64) and at {[list(s) for s in EDGE_CONV_SHAPES]}, float32 "
          f"and bf16 ({2 * len(cases)} cases): y, dh, dw, db within {CONV_PLAIN_RATIO} x the "
          f"plain version's error (largest ratio {ratio:.3f}), float32 within {KERNEL_TOL} "
          f"(largest {bounded:.3e}; dw against max(1, |ref|) alone {literal_dw:.3e} within "
          f"{CONV_DW_LITERAL_TOL}, the plain version's {plain_dw:.3e}), a second call the "
          f"same bits, NaN through; each layer's first {list(FEW_MEMBERS)} members alone "
          f"(x batch 64; one member as the single VAE trains): y and dh bit-equal to their "
          f"64-member launch on the float32 tiles {sorted(tiles)} (rows, channels, threads), "
          f"dw and db of member 0 held as above; max abs err {worst:.3e}")
    return {"max_abs_err": worst, "largest_ratio_to_plain": ratio,
            "f32_forward_tiles": sorted(tiles),
            "largest_f32_error": bounded, "f32_dw_error_against_ref_alone": literal_dw,
            "f32_dw_plain_error_against_ref_alone": plain_dw}


def conv1d_sass_lines() -> dict:
    """One ``[sass]`` line per kernel function of csrc/conv1d.cu with a
    product in its hot loop: the loop's instructions by class per FMA
    (float32) or per mma.sync (bf16); and one ``[occupancy]`` line: each
    function's registers and blocks an SM at each layer length of the step
    (``ops.conv1d.attributes``)."""
    from lesionvae_tpu_torch.ops import conv1d, cuda_build
    from lesionvae_tpu_torch.utils.cost_model import conv_layers

    text = cuda_build.sass("conv1d")
    out = {}
    for unit, what in ((r"^FFMA", "FMA"), (r"^HMMA", "mma.sync")):
        for fn, f in cuda_build.inner_loops(text, unit).items():
            if not f["units"]:
                continue
            m = re.search(r"(conv_(?:fwd|wgrad)_[a-z0-9]+)(?:I((?:Li\d+E)+)E)?", fn)
            args = re.findall(r"Li(\d+)E", (m.group(2) or "") if m else "")
            name = (m.group(1) + (f"<{','.join(args)}>" if args else "")) if m else fn
            out[name] = {k: round(v, 3) for k, v in f["per_unit"].items()}
            print(f"[sass] conv1d:{name} per {what} ({'loop' if f['loop'] else 'whole function'}"
                  f" of {f['instructions']} instructions, {f['units']} {what}s): "
                  + json.dumps(out[name]))
    lengths = sorted({L for L, *_ in conv_layers().values()})
    occ = {L: conv1d.attributes(L) for L in lengths}
    table = {name: {"registers": occ[lengths[0]][name]["registers"],
                    "local_bytes": occ[lengths[0]][name]["local_bytes"],
                    "blocks_an_sm": {L: occ[L][name]["blocks_an_sm"] for L in lengths}}
             for name in conv1d.KERNEL_FUNCTIONS}
    print("[occupancy] conv1d kernels: registers and blocks an SM holds at each layer "
          "length (cudaOccupancyMaxActiveBlocksPerMultiprocessor): " + json.dumps(table))
    return {"sass": out, "occupancy": table}


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
    reset_launches()
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



# ---------------------------------------------------------------- the geometry path
def read_bundles(cfg, data_dir: Path):
    """The path's bundles in the order ``launch_all_tracts`` reads them."""
    from lesionvae_tpu_torch.io.vtk import read_streamlines
    from lesionvae_tpu_torch.pipeline import geometry_run as gr

    return [read_streamlines(gr.decompress_vtk_if_needed(
        gr.bundle_path(data_dir, sid, tp, tract)), max_streamlines=GEO_STREAMLINES)
        for sids in cfg.subjects_by_group().values() for sid in sorted(sids)
        for tp in cfg.timepoints for tract in cfg.geometry_tracts]


def compare_frames(got, want, tol: float, where: str) -> float:
    """Columns and text cells equal, inf and NaN in the same places, numeric
    cells within ``tol`` x max(1, |want|); returns the largest such error."""
    import pandas as pd

    if list(got.columns) != list(want.columns) or len(got) != len(want):
        fail(f"{where}: columns {list(got.columns)} x {len(got)} rows against "
             f"{list(want.columns)} x {len(want)}")
    worst, worst_col = 0.0, None
    for col in want.columns:
        if not pd.api.types.is_numeric_dtype(want[col]):
            if list(got[col].astype(str)) != list(want[col].astype(str)):
                fail(f"{where}: column {col} differs")
            continue
        g, w = got[col].to_numpy(float), want[col].to_numpy(float)
        if not (np.array_equal(np.isinf(g), np.isinf(w)) and np.array_equal(
                np.isnan(g), np.isnan(w))):
            fail(f"{where}: inf or NaN of {col} in other places")
        fin = np.isfinite(w)
        if fin.any():
            err = float(np.max(np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))))
            if err > tol:
                fail(f"{where}: {col} off by {err:.3e} (tol {tol})")
            if err > worst:
                worst, worst_col = err, col
    print(f"[path] {where}: worst column {worst_col}, {worst:.3e}")
    return worst


def check_geometry(root: Path, cfg) -> dict:
    """The geometry stage on cuda over the full-scale bundle cohort under
    ``root``, through ``launch_geometry`` (what ``run_geometry`` and the CLI
    run); its CSVs checked, then held against a CPU float32 run and the
    ``u16d`` upload against ``f32``.  Returns the kernel's launches on the
    path and its inputs there (for the timings of phase 4)."""
    import pandas as pd

    from lesionvae_tpu_torch.ops import geometry as g
    from lesionvae_tpu_torch.pipeline import geometry_run as gr
    from lesionvae_tpu_torch.utils import profiling

    data = root / "data"
    out = {dev: root / "results" / f"geometry_{dev}" for dev in ("cuda", "cpu", "u16d")}
    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    with profiling.stage("geometry"):
        finish = gr.launch_geometry(cfg, data_dir=data, output_dir=out["cuda"],
                                    max_streamlines=GEO_STREAMLINES, device="cuda")
        df = finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = g.streamline_metrics_stacked.launches
    spans = profiling.report()
    num = df.select_dtypes("number")
    if (len(df) != GEO_BUNDLES or list(df.columns) != GEO_COLS
            or not (df["n_streamlines"] == GEO_STREAMLINES).all()
            or not np.isfinite(num.to_numpy(float)).all()):
        fail(f"geometry on cuda: {len(df)} rows, columns {list(df.columns)}, "
             f"n_streamlines {sorted(set(df['n_streamlines']))}")
    if launches < 1 or launches != finish.metrics.launches:
        fail(f"the geometry stage on cuda launched the kernel {launches} times "
             f"({finish.metrics.launches} chunks)")
    print(f"[path] geometry stage on cuda: {len(df)} bundles, "
          f"{finish.metrics.streamlines} streamlines, kernel launches {launches}, "
          f"{finish.metrics.refined} rows refined in f64; stage {wall:.2f}s")
    print("[path] geometry spans on cuda (s): " + json.dumps(spans))

    # a CPU float32 run of the port on the same bundles
    t0 = time.perf_counter()
    gr.run_geometry(cfg, data_dir=data, output_dir=out["cpu"],
                    max_streamlines=GEO_STREAMLINES, device="cpu", dtype=torch.float32)
    cpu_s = time.perf_counter() - t0
    errs = [compare_frames(pd.read_csv(out["cuda"] / f), pd.read_csv(out["cpu"] / f),
                           PATH_TOL, f"geometry cuda vs cpu float32, {f}") for f in GEO_CSVS]
    print(f"[path] geometry cuda vs cpu float32 ({cpu_s:.1f}s on the cpu): the three "
          f"CSVs' numeric cells max rel err {max(errs):.3e} (tol {PATH_TOL} x "
          f"max(1,|x|)), inf and NaN in the same places")

    # the u16 delta upload: against a CPU float32 run of the same upload
    # (torsion comes from the host's float64 on both sides: equal), then per
    # bundle against the f32 run
    t0 = time.perf_counter()
    before = g.streamline_metrics_stacked.launches
    u16 = gr.launch_geometry(cfg, data_dir=data, output_dir=out["u16d"],
                             max_streamlines=GEO_STREAMLINES, upload="u16d",
                             device="cuda")()
    u16_s = time.perf_counter() - t0
    u16_launches = g.streamline_metrics_stacked.launches - before
    u16_cpu = gr.launch_geometry(cfg, data_dir=data, output_dir=root / "results" / "u16d_cpu",
                                 max_streamlines=GEO_STREAMLINES, upload="u16d",
                                 device="cpu", dtype=torch.float32)()
    u16_err = compare_frames(u16, u16_cpu, PATH_TOL, "geometry u16d cuda vs cpu float32")
    if not np.array_equal(u16["torsion_mean_avg"], u16_cpu["torsion_mean_avg"]):
        fail("geometry u16d: the host float64 torsion differs between the cuda and cpu runs")
    worst = {}
    for col in GEO_COLS[1:14]:
        a, b = df[col].to_numpy(float), u16[col].to_numpy(float)
        rtol = (CODEC_RTOL_WIDE if col in ("curv_energy_mean", "torsion_mean_avg")
                else CODEC_RTOL)
        if not np.array_equal(np.isinf(a), np.isinf(b)) or bool(
                (np.abs(a - b) > CODEC_ATOL + rtol * np.abs(a)).any()):
            bad = np.abs(a - b) / np.maximum(np.abs(a), 1e-12)
            fail(f"geometry u16d vs f32: bundle column {col} off by {bad.max():.3e} "
                 f"(rtol {rtol}, atol {CODEC_ATOL})")
        worst[col] = float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12)))
    if not u16[GEO_COLS[14:]].equals(df[GEO_COLS[14:]]) or (
            u16["n_streamlines"] != df["n_streamlines"]).any():
        fail("geometry u16d vs f32: other bundles or counts")

    # and per streamline, chunk by chunk as the path launched them
    bundles = read_bundles(cfg, data)
    plan = gr.chunk_plan(bundles)
    shifts = {k: [] for k in g.STACKED_NAMES[:17] if k != "torsion_mean"}
    flagged = [0, 0]
    chunks = []
    for P, chunk, S_pad in plan:
        sls = [sl for _, sl in chunk]
        sls = sls + [sls[-1]] * (S_pad - len(sls))
        f32_in, u16_in = geometry_inputs(sls, P)
        chunks.append((P, f32_in, u16_in, f32_in[1].cpu().numpy()))
        a = g.streamline_metrics_stacked(*f32_in)[:, :len(chunk)].cpu().numpy()
        b = g.streamline_metrics_stacked_u16(*u16_in)[:, :len(chunk)].cpu().numpy()
        ok = g.STACKED_NAMES.index("eigen_ok")
        flagged[0] += int((a[ok] < 0.5).sum())
        flagged[1] += int((b[ok] < 0.5).sum())
        for k in shifts:
            r = g.STACKED_NAMES.index(k)
            fin = np.isfinite(a[r]) & np.isfinite(b[r])
            shifts[k].append(np.abs(b[r][fin] - a[r][fin]) / np.maximum(np.abs(a[r][fin]), 1e-12))
    p99 = {k: float(np.percentile(np.concatenate(v), 99)) for k, v in shifts.items()}
    if any(v > (CODEC_P99_ENERGY if k == "curv_energy" else CODEC_P99)
           for k, v in p99.items()):
        fail(f"geometry u16d vs f32 per streamline: p99 shift {p99}")
    print(f"[path] geometry u16d upload on cuda: stage {u16_s:.2f}s, {u16_launches} "
          f"launches; against a cpu float32 u16d run max rel err {u16_err:.3e} (tol "
          f"{PATH_TOL}), torsion equal; against f32, bundle columns within rtol "
          f"{CODEC_RTOL} (curv_energy and torsion {CODEC_RTOL_WIDE}); per streamline p99 shift "
          f"{max(p99.values()):.3e} ({max(p99, key=p99.get)}; tol {CODEC_P99}, curv_energy "
          f"{CODEC_P99_ENERGY}), "
          f"eigen-ambiguous rows f32 {flagged[0]} / u16d {flagged[1]}")
    print("[path] geometry u16d per-streamline p99 shifts: " + json.dumps(p99))
    print("[path] geometry u16d vs f32 bundle columns, max rel: " + json.dumps(worst))
    return {"launches": launches, "chunks": chunks, "wall": wall, "spans": spans}


def geometry_timings(chunks) -> dict:
    """The kernel at the path's largest chunk (32,768 x 64 when the P = 64
    bucket fills one) in both modes, held against its plain version first,
    and summed over every launch of the stage, beside ``ops.geometry.bound_ms``."""
    from lesionvae_tpu_torch.ops import geometry as g

    P, f32_in, u16_in, lens = max(chunks, key=lambda c: (c[1][0].shape[0] * c[0], c[0]))
    where = f"the path's chunk {tuple(f32_in[0].shape[:2])}"
    err, differ = geometry_compare(g.streamline_metrics_stacked(*f32_in),
                                   g.streamline_metrics_stacked_plain(*f32_in), where)
    err16, differ16 = geometry_compare(g.streamline_metrics_stacked_u16(*u16_in),
                                       g.streamline_metrics_stacked_u16_plain(*u16_in),
                                       where + " u16")
    if differ or differ16:
        fail(f"geometry kernel: {differ} (f32) and {differ16} (u16) elements differ from "
             f"the plain version at {where}")
    ms = device_ms(lambda: g.streamline_metrics_stacked(*f32_in))
    plain_ms = device_ms(lambda: g.streamline_metrics_stacked_plain(*f32_in), reps=3, inner=2)
    u16_ms = device_ms(lambda: g.streamline_metrics_stacked_u16(*u16_in))
    stage_ms = sum(device_ms(lambda c=c: g.streamline_metrics_stacked(*c[1]), reps=5, inner=10)
                   for c in chunks)
    u16 = g.bound_ms(lens, P, u16=True)
    stage = [g.bound_ms(c[3], c[0]) for c in chunks]
    return {"S": int(f32_in[0].shape[0]), "P": P, "lanes": g.block_streamlines(P)[0],
            "ms": ms, "plain_ms": plain_ms, "u16_ms": u16_ms, **g.bound_ms(lens, P),
            "u16_bound_ms": u16["bound_ms"], "u16_issue_bound_ms": u16["issue_bound_ms"],
            "stage_ms": stage_ms, "stage_bound_ms": sum(b["bound_ms"] for b in stage),
            "stage_issue_bound_ms": sum(b["issue_bound_ms"] for b in stage),
            "launches_timed": len(chunks), "max_abs_err": max(err, err16),
            "bits_differ": differ + differ16}


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
    from lesionvae_tpu_torch.models import lesion_vae
    from lesionvae_tpu_torch.train import trainer
    from lesionvae_tpu_torch.train.normative import normative_zscores_fused

    def tf32(_device) -> None:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.set_float32_matmul_precision("high")

    fwd_c, z_c, std_c, h_c = cpu
    sound = trainer.full_fp32
    # every VAE entry point calls it first: the trainer's, and the trained
    # model's eval forwards (``TrainedVAE``)
    owners = (trainer, lesion_vae)
    for owner in owners:
        owner.full_fp32 = tf32
    try:
        fwd = max(rel_err(a.cpu(), b) for a, b in zip(model.apply(Xz, Xl, eps=eps), fwd_c))
        z_err = z_scaled_err(normative_zscores_fused(model, Xz, Xl, sham,
                                                     seed=VAE_SEED)[2], z_c, std_c)
        hist_err = rel_err(train_2_epochs(Xz, Xl, "cuda"), h_c)
    finally:
        for owner in owners:
            owner.full_fp32 = sound
        sound("cuda")
    line = (f"forward max rel err {fwd:.3e} (bound {PATH_TOL}), Z scaled by "
            f"min(1, std) {z_err:.3e} (bound {PATH_TOL}), 2-epoch history "
            f"{hist_err:.3e} (bound {HIST_TOL})")
    if fwd <= PATH_TOL or z_err <= PATH_TOL or hist_err <= HIST_TOL:
        fail(f"a cuda-vs-cpu bound does not catch TF32: {line}")
    print(f"[control] TF32 on for the card's convolutions and products, against "
          f"the same cpu float32 results, exceeds every bound: {line}")


def check_vae(root: Path, cfg, tract: str) -> dict:
    """``vae`` then ``score`` through the CLI on cuda, each held against the
    CPU in float32; returns the launches in ``vae`` of the optimizer
    kernels, the masked BatchNorm kernels and the convolution kernels."""
    import pandas as pd

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.ops import radius, resident_adam as ra
    from lesionvae_tpu_torch.pipeline.infer import load_normative, score_subjects
    from lesionvae_tpu_torch.train import data as vdata
    from lesionvae_tpu_torch.train import program
    from lesionvae_tpu_torch.train.checkpoint import load_vae, save_vae
    from lesionvae_tpu_torch.train.normative import normative_zscores_fused
    from lesionvae_tpu_torch.train.trainer import train_lesion_vae
    from lesionvae_tpu_torch.utils import profiling

    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    common = ["--config", str(cfg_path), "--base-path", str(root),
              "--seed", str(VAE_SEED), "--device", "cuda"]
    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["vae", "--tract", tract, "--epochs", str(SINGLE_EPOCHS),
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
        if (len(hist) != SINGLE_EPOCHS or not np.isfinite(hist.to_numpy()).all()
                or not hist["loss"].iloc[-1] < hist["loss"].iloc[0]):
            fail(f"training_history_{tp}.csv: {len(hist)} rows, loss "
                 f"{hist['loss'].iloc[0]:.4f} -> {hist['loss'].iloc[-1]:.4f}")
        z = np.load(out / f"zscores_{tp}.npz", allow_pickle=True)
        if (z.files != keys or z["Z"].shape != (VAE_ROWS, 100, 13)
                or not np.isfinite(z["Z"]).all()):
            fail(f"zscores_{tp}.npz: keys {z.files}, Z {z['Z'].shape}")
    steps = len(cfg.timepoints) * SINGLE_EPOCHS * -(-VAE_ROWS // VAE_BATCH)
    # the one-member fleet program: a training step's kernels, at the
    # replays and in the epoch run before each capture (the gather once, the
    # update on the weights and on the BatchNorm leaves); the eval forwards
    # of the normative pass run the module
    run_steps = steps + -(-VAE_ROWS // VAE_BATCH) * program.COUNTS["captures"]
    opt = hold_adam_launches("vae", run_steps, {"grad_sq_norm": 1, "adam_step": 2})
    bn, conv = masked_bn_launches(), conv1d_launches()
    fleet_kernels = {**bn, **conv}
    want = {k: SINGLE_A_STEP.get(k, 0) * run_steps for k in fleet_kernels}
    if fleet_kernels != want:
        fail(f"vae: the fleet's kernels launched {fleet_kernels} times in {run_steps} "
             f"training steps, {want} expected")
    hold_small_tiles("vae", CONV_A_STEP["conv_fwd"] * run_steps)
    print(f"[path] vae stage on cuda: {len(cfg.timepoints)} timepoints x "
          f"{VAE_ROWS} rows, {SINGLE_EPOCHS} epochs, {steps} train steps in "
          f"{spans['vae.train']:.2f}s ({steps / spans['vae.train']:.1f} steps/s); "
          f"stage {wall:.2f}s; kernel launches {json.dumps({**opt, **fleet_kernels})}, radius "
          f"{radius.sample_radii.launches}, resident {ra.resident_adam.launches}; "
          f"{graph_counts()} (an epoch a replay)")
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
    model, _ = train_lesion_vae(Xz, Xl, latent_dim=VAE_LATENT, epochs=SINGLE_EPOCHS,
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
    return {"optimizer": opt, "masked_bn": bn,
            "conv1d": {**conv, "a_step": {k: v / run_steps for k, v in conv.items()}}}


# ---------------------------------------------------------------- the cohort fleet
COHORT_NPZ_KEYS = ["magnitude", "subj_ids", "group_labels", "norm_mean",
                   "norm_std", "subj_profile", "subj_order"]


def check_cohort_cli(root: Path, cfg, common) -> tuple:
    """``vae-cohort`` (bf16 storage, 64 members, 40 epochs) then
    ``score-cohort`` through the CLI on cuda; returns the SR Adam kernel's
    launches on that path, the masked BatchNorm kernels' by stage, their
    launches a training step, the optimizer kernels' launches and the
    convolution kernels' by stage."""
    import pandas as pd

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.ops import radius, resident_adam as ra, sr_adam
    from lesionvae_tpu_torch.utils import profiling

    from lesionvae_tpu_torch.train import program

    profiling.reset()
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rc = cli.main(["vae-cohort", "--store", "bf16", "--dtype", "f32",
                   "--save-checkpoints", "--epochs", str(VAE_EPOCHS),
                   "--batch-size", str(VAE_BATCH), "--latent-dim",
                   str(VAE_LATENT), *common])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = sr_adam.sr_adam_step.launches
    bn = {"vae-cohort": masked_bn_launches()}
    conv = {}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    spans = profiling.report()
    if rc != 0:
        fail(f"vae-cohort stage exited {rc}")
    # one a fleet step, counted at each replay of an epoch's graph, and one
    # a step of the epoch run eagerly before a capture (train/program.py)
    captures, replays = program.COUNTS["captures"], program.COUNTS["replays"]
    warm_up = COHORT_STEPS // VAE_EPOCHS * captures
    if launches != COHORT_STEPS + warm_up or captures > 1 or replays != VAE_EPOCHS:
        fail(f"vae-cohort with bf16 storage launched the SR Adam kernel {launches} "
             f"times in {COHORT_STEPS} fleet steps, {graph_counts()}")
    # bf16 storage: the gather and norm, and the update of the BatchNorm leaves
    opt = hold_adam_launches("vae-cohort", COHORT_STEPS + warm_up,
                             {"grad_sq_norm": 1, "adam_step": 1})
    # seven BatchNorm layers a step, each on the cluster route: one forward
    # and one backward launch a layer; the apply kernel only in the eval
    # forwards of the normative summary
    steps = COHORT_STEPS + warm_up
    want = {"bn_cluster_forward": 7 * steps, "bn_cluster_backward": 7 * steps,
            "bn_stats": 0, "bn_grad_sums": 0, "bn_grad_apply": 0}
    got = bn["vae-cohort"]
    if any(got[k] != v for k, v in want.items()) or got["bn_apply"] <= 0:
        fail(f"vae-cohort launched the masked BatchNorm kernels {got} times in {steps} "
             f"fleet steps (want {want} and the summary's applies)")
    # a training step's launches as counted: every launch but the applies,
    # and of those the general route's training applies, one a pair of
    # statistics launches (the others are the summary's eval forwards)
    bn_a_step = (sum(v for k, v in got.items() if k != "bn_apply")
                 + got["bn_stats"] // 2) / steps
    conv["vae-cohort"] = hold_conv_launches("vae-cohort", steps, got)
    hold_small_tiles("vae-cohort", 0)
    out = root / "results" / "vae_cohort"
    members = [(t, tp) for t in cfg.geometry_tracts for tp in cfg.timepoints]
    for tract, tp in members:
        hist = pd.read_csv(out / f"training_history_{tract}_{tp}.csv")
        if (len(hist) != VAE_EPOCHS or not np.isfinite(hist.to_numpy()).all()
                or not hist["loss"].iloc[-1] < hist["loss"].iloc[0]):
            fail(f"training_history_{tract}_{tp}.csv: {len(hist)} rows, loss "
                 f"{hist['loss'].iloc[0]:.4f} -> {hist['loss'].iloc[-1]:.4f}")
        z = np.load(out / f"zscores_{tract}_{tp}.npz", allow_pickle=True)
        if (z.files != COHORT_NPZ_KEYS or z["magnitude"].shape != (VAE_ROWS,)
                or z["subj_profile"].shape != (37, 100)
                or not np.isfinite(z["magnitude"]).all()
                or not np.isfinite(z["subj_profile"]).all()):
            fail(f"zscores_{tract}_{tp}.npz: keys {z.files}, magnitude "
                 f"{z['magnitude'].shape}, profile {z['subj_profile'].shape}")
        if not (out / "checkpoints" / f"{tract}_{tp}" / "state.pt").exists():
            fail(f"no checkpoint for {tract}_{tp}")
    print(f"[path] vae-cohort stage on cuda, bf16 storage: {len(members)} members x "
          f"{VAE_ROWS} rows (padded {COHORT_PAD}), {VAE_EPOCHS} epochs, "
          f"{COHORT_STEPS} fleet steps in {spans['vae_cohort.train']:.2f}s "
          f"({COHORT_STEPS / spans['vae_cohort.train']:.2f} fleet steps/s, upload, "
          f"normalization and summary included); stage {wall:.2f}s; kernel "
          f"launches sr_adam {launches} ({COHORT_STEPS} in {replays} epoch replays, "
          f"{warm_up} in the epoch run before the capture), {json.dumps(opt)}, masked BatchNorm "
          f"{json.dumps(bn['vae-cohort'])} ({bn_a_step} a training step), convolutions "
          f"{json.dumps(conv['vae-cohort'])}, radius "
          f"{radius.sample_radii.launches}, resident {ra.resident_adam.launches}; "
          f"{graph_counts()}; max_memory_allocated {peak_gb:.2f} GB")
    print("[path] vae-cohort spans on cuda (s): " + json.dumps(spans))

    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    rc = cli.main(["score-cohort", *common])
    torch.cuda.synchronize()
    if rc != 0:
        fail(f"score-cohort stage exited {rc}")
    served = pd.read_csv(root / "results" / "serving" / "cohort_scores.csv")
    cols = ["tract", "timepoint", "subject_id", "group", "mean", "std", "max", "count"]
    if (list(served.columns) != cols or len(served) != len(members) * 37
            or not np.isfinite(served[["mean", "std", "max"]].to_numpy()).all()
            or served.groupby(["tract", "timepoint"]).ngroups != len(members)):
        fail(f"cohort_scores.csv: {len(served)} rows, columns {list(served.columns)}")
    bn["score-cohort"] = masked_bn_launches()
    if bn["score-cohort"]["bn_apply"] <= 0 or any(
            v for k, v in bn["score-cohort"].items() if k != "bn_apply"):
        fail(f"score-cohort launched the masked BatchNorm kernels {bn['score-cohort']} "
             "times: the eval forward applies only")
    conv["score-cohort"] = conv1d_launches()
    evals = eval_forwards("score-cohort", bn["score-cohort"])
    if conv["score-cohort"] != {"conv_fwd": 8 * evals, "conv_wgrad": 0}:
        fail(f"score-cohort launched the convolution kernels {conv['score-cohort']} times "
             f"in {evals} eval forwards: eight forward launches each, no weight gradient")
    conv["score-cohort"]["eval_forwards"] = evals
    print(f"[path] score-cohort stage on cuda: {len(served)} rows = {len(members)} "
          f"members x 37 subjects in {time.perf_counter() - t0:.2f}s; masked BatchNorm "
          f"{json.dumps(bn['score-cohort'])}, convolutions {json.dumps(conv['score-cohort'])}")
    return launches, bn, bn_a_step, opt, conv


def check_cohort_against_cpu(root: Path, cfg) -> None:
    """The fleet at full width and small depth: four members (four tracts at
    9d) in float32, cuda against cpu and against the eager module route
    (``train_loop``), as is the single trainer's one-member program."""
    from lesionvae_tpu_torch.models.fleet import FleetState, layout
    from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
    from lesionvae_tpu_torch.pipeline.infer import score_cohort
    from lesionvae_tpu_torch.train import batched, data as vdata, normative
    from lesionvae_tpu_torch.train.checkpoint import load_vae
    from lesionvae_tpu_torch.train.trainer import train_loop, train_module

    groups = {g: list(s) for g, s in cfg.subjects_by_group().items()}
    subjects = [s for subs in groups.values() for s in subs]
    tracts, tp = list(cfg.geometry_tracts[:4]), "9d"
    cache: dict = {}
    built = [vdata.build_tensor_with_lesion_context(
        root, t, tp, subjects, cfg.microstructure_features, cfg.lesion_features,
        groups, csv_cache=cache) for t in tracts]
    Xm, Xl, n_real = batched.pad_datasets([(b[0], b[1]) for b in built], VAE_BATCH)
    T, n_pad = Xm.shape[:2]
    sham = np.zeros((T, n_pad), np.float32)
    seg = np.full((T, n_pad), 37, np.int64)
    for i, b in enumerate(built):
        sham[i, :n_real[i]] = b[3] == "Sham"
        seg[i, :n_real[i]] = np.searchsorted(np.unique(b[2]), b[2])

    # (iii) normalization on the device, cuda vs cpu
    norm = {}
    for dev in ("cuda", "cpu"):
        norm[dev] = vdata.normalize_on_device(
            torch.from_numpy(Xm).to(dev), torch.from_numpy(Xl).to(dev),
            torch.from_numpy(n_real.astype(np.int64)).to(dev))
    err = max([rel_err(norm["cuda"][0].cpu(), norm["cpu"][0])]
              + [rel_err(norm["cuda"][2][k].cpu(), norm["cpu"][2][k])
                 for k in ("median", "mean", "std")])
    if err > PATH_TOL:
        fail(f"normalize_on_device cuda vs cpu: max rel err {err:.3e}")
    print(f"[path] normalize_on_device, {T} members x {n_pad} rows, cuda vs cpu "
          f"float32: stats and normalized block max rel err {err:.3e} (tol {PATH_TOL})")

    # (i) one epoch of the float32 fleet from one seed, cuda vs cpu
    kw = dict(latent_dim=VAE_LATENT, batch_size=VAE_BATCH, seed=VAE_SEED,
              normalize_on_device=True)
    hist = {dev: batched.launch_many_vaes(Xm, Xl, n_real, epochs=1, device=dev,
                                          **kw).fetch()[1] for dev in ("cuda", "cpu")}
    err = rel_err(hist["cuda"], hist["cpu"])
    if err > HIST_TOL or not np.isfinite(hist["cuda"]).all():
        fail(f"float32 fleet, 1 epoch, cuda vs cpu: history max rel err {err:.3e}")
    print(f"[path] float32 fleet, {T} members x 1 epoch from one seed, cuda vs cpu: "
          f"history max rel err {err:.3e} (tol {HIST_TOL})")

    # (ii) a member of the cuda fleet, and the same member trained alone by
    # the single trainer (its one-member fleet program), against the member
    # trained alone by the eager module route (cuDNN, MaskedBatchNorm)
    lay = layout(100, 13, 3, VAE_LATENT)
    sds = batched.init_state_dicts(T, lay.hyper, VAE_SEED)
    perms, noise = batched.draw_fleet(T, n_pad, 2, VAE_BATCH, VAE_LATENT,
                                      torch.Generator().manual_seed(VAE_SEED))
    handle = batched.launch_many_vaes(Xm, Xl, n_real, epochs=2, device="cuda",
                                      state_dicts=sds, perms=perms, noise=noise, **kw)
    models, h_fleet = handle.fetch()
    i = 2

    def member_alone(train):
        module = LesionConditionedVAE(**lay.hyper)
        module.load_state_dict(sds[i])
        module.to("cuda")
        hist = train(module, handle.Xm[i], handle.Xl[i], int(n_real[i]), perms[i],
                     noise[i], 2, VAE_BATCH, 2e-4, 1e-3, 2.0)
        return module, hist

    alone, h_alone = member_alone(train_loop)
    route, h_route = member_alone(train_module)

    def off(member):
        """(largest L2 distance of a tensor of ``member`` from the member
        trained alone over the distance that tensor moved from its start,
        that tensor's name)."""
        return max((float((a.cpu() - b.cpu()).norm()) / float((b.cpu() - s0).norm()),
                    name)
                   for (name, a), b, s0 in zip(member.state_dict().items(),
                                               alone.state_dict().values(),
                                               sds[i].values()))

    readings = {"fleet": (rel_err(h_fleet[i], h_alone), *off(models[i].module)),
                "train_module": (rel_err(h_route, h_alone), *off(route))}
    other = (i + 1) % T
    control = (rel_err(h_fleet[other], h_alone), off(models[other].module)[0])
    if (any(h > ALONE_TOL or w > ALONE_MOVE for h, w, _n in readings.values())
            or control[0] <= ALONE_TOL or control[1] <= ALONE_MOVE):
        fail(f"member {i} of the fleet and trained alone by train_module vs the same "
             f"member trained alone by train_loop on cuda, 2 epochs (history, tensors' "
             f"offset of their movement, worst tensor): {readings} (tol {ALONE_TOL}, "
             f"{ALONE_MOVE}); member {other} as a control: {control[0]:.3e}, "
             f"{control[1]:.3e}")
    for label, (h_err, w_err, w_name) in readings.items():
        print(f"[path] member {i}, {label} (the fleet's kernels) vs train_loop alone (the "
              f"module's cuDNN convolutions and MaskedBatchNorm) on cuda, same weights, "
              f"permutations and noise, 2 epochs: history max rel err {h_err:.3e} (tol "
              f"{ALONE_TOL}), weights and BatchNorm statistics off by at most "
              f"{w_err:.3e} of the distance each moved ({w_name}; tol {ALONE_MOVE})")
    print(f"[control] member {other} of the same fleet against that train_loop run "
          f"exceeds both: history {control[0]:.3e}, tensors {control[1]:.3e}")

    # (iii) the normative summary of four trained members of the path, and
    # serving them, cuda vs cpu
    ckpt = root / "results" / "vae_cohort" / "checkpoints"
    trained = [load_vae(ckpt / f"{t}_{tp}", device="cpu")[0].module.state_dict()
               for t in tracts]
    summ = {}
    for dev in ("cuda", "cpu"):
        state = FleetState.from_state_dicts(trained, lay, device=dev)
        summ[dev] = normative.member_summary(
            state, norm[dev][0], norm[dev][1], torch.from_numpy(sham).to(dev),
            torch.from_numpy(seg).to(dev), 38, seed=VAE_SEED)
    errs = [rel_err(a.cpu(), b) for a, b in zip(summ["cuda"], summ["cpu"])]
    if max(errs) > PATH_TOL:
        fail(f"member_summary cuda vs cpu (mean, std, magnitude, profile, counts): {errs}")
    keys = [(t, tp) for t in tracts]
    served = {dev: score_cohort(root / "results" / "vae_cohort", root, subjects,
                                config=cfg, keys=keys, seed=VAE_SEED, device=dev)
              for dev in ("cuda", "cpu")}
    cols = ["mean", "std", "max", "count"]
    s_err = rel_err(served["cuda"][cols].to_numpy(float),
                    served["cpu"][cols].to_numpy(float))
    if s_err > PATH_TOL or len(served["cuda"]) != T * 37:
        fail(f"score_cohort cuda vs cpu: {len(served['cuda'])} rows, max rel err {s_err:.3e}")
    print(f"[path] {T} trained members of the path, cuda vs cpu float32: "
          f"member_summary (mean, std, magnitude, profile, counts) max rel err "
          f"{max(errs):.3e}; score_cohort {s_err:.3e} (tol {PATH_TOL})")

    # (iv) the uint16 upload and bf16 compute, 3 epochs each
    ref = batched.launch_many_vaes(Xm, Xl, n_real, epochs=3, device="cuda", **kw)
    for label, extra in (("uint16 upload", dict(quantize_upload=True)),
                         ("bf16 compute", dict(compute_dtype=torch.bfloat16))):
        run = batched.launch_many_vaes(Xm, Xl, n_real, epochs=3, device="cuda",
                                       **kw, **extra)
        h = run.fetch()[1]
        block = float((run.Xm - ref.Xm).abs().max())
        if (not np.isfinite(h).all() or not (h[:, -1, 0] < h[:, 0, 0]).all()
                or block > 1e-3):
            fail(f"fleet with {label}: loss {h[:, 0, 0]} -> {h[:, -1, 0]}, normalized "
                 f"block off the float32 upload's by {block:.3e}")
        print(f"[path] float32-storage fleet with {label}, {T} members x 3 epochs on "
              f"cuda: loss {h[:, 0, 0].mean():.4f} -> {h[:, -1, 0].mean():.4f} (float32 "
              f"run {ref.fetch()[1][:, -1, 0].mean():.4f}); normalized block within "
              f"{block:.3e} of the float32 upload's (tol 1e-3)")


# ---------------------------------------------------------------- the whole pipeline
# correlate on the card's CSVs against correlate on the CPU float32 CSVs: the
# inputs differ by <= 1e-4 x max(1, |x|) (the stages' own bounds; read 8.7e-5
# in a ratio column, ~1e-7 elsewhere), so r and p of a pair move by far less
# than CORR_TOL, and a pair can enter or leave the p < 0.05 set only with p
# within P_BAND of the cut on both sides
CORR_TOL, P_BAND = 1e-3, 1e-3
# classify: a moved summary row is explained by the subject-mean features of
# its timepoint, held to the geometry path's bound
CLF_FEATURE_TOL = PATH_TOL
# upload_chunks and the split launch against one launch, 64 members x 2
# epochs at full width: bit-equal, or tests/test_upload_chunks.py:46-67's
# bounds, or else the card's bounds for one member computed two ways
# (ALONE_TOL, ALONE_MOVE): at other member counts cuBLAS and the reductions
# may sum in other orders, and Adam turns a rounding-sized gradient into a
# step of ±lr (on an H100 80GB HBM3 at 64 members x 2 epochs: histories
# 3.4e-5 apart, weights beyond atol 1e-4), so which one held is printed
CHUNK_HIST = dict(rtol=1e-5, atol=1e-6)
CHUNK_WEIGHTS = dict(rtol=1e-3, atol=1e-4)
CHUNK_EPOCHS = 2


def geometry_launches() -> int:
    from lesionvae_tpu_torch.ops import geometry

    return geometry.streamline_metrics_stacked.launches


def host_code_lines() -> None:
    """Which host encoder and which profile-CSV reader this machine loads."""
    from lesionvae_tpu_torch.io import profiles_native
    from lesionvae_tpu_torch.train import quantize

    enc = quantize.encoder()
    print(f"[host] uint16 upload encoder: {enc}"
          + (" (native/quantize.cpp)" if enc == "native" else ""))
    if enc != "native":
        print("[host] the native encoder (make -C native libquantize.so) could not be "
              "built or loaded here: the numpy encoder runs, same codes")
    if profiles_native.available():
        print("[host] profile-CSV reader: native (native/csv_parser.cpp) available")
    else:
        print("[host] the native profile-CSV reader (make -C native libcsvparser.so) "
              "could not be built or loaded here: pandas reads the profile CSVs")


def compare_correlations(got, want, merged_got, merged_want) -> dict:
    """``got`` and ``want``: significant_correlations frames; the merged
    frames they came from, for the p of a pair on the side where it is not
    significant.  r and p within CORR_TOL for every pair in both, n equal; a
    pair in one set only must have p within P_BAND of 0.05 on both sides."""
    from scipy.stats import pearsonr

    from lesionvae_tpu_torch.pipeline.correlation import P_CUT, pair_values

    key = ["group", "timepoint", "sh_feature", "tract_feature"]
    both = got.merge(want, on=key, suffixes=("", "_cpu"))
    dr = float((both["r"] - both["r_cpu"]).abs().max()) if len(both) else 0.0
    dp = float((both["p"] - both["p_cpu"]).abs().max()) if len(both) else 0.0
    if dr > CORR_TOL or dp > CORR_TOL or not (both["n"] == both["n_cpu"]).all():
        fail(f"correlate on the card's CSVs vs the CPU float32 CSVs: |dr| {dr:.3e}, "
             f"|dp| {dp:.3e} (tol {CORR_TOL}), n equal {bool((both['n'] == both['n_cpu']).all())}")
    moved = []
    for side, frame, other in (("card only", got, want), ("cpu only", want, got)):
        only = frame.merge(other[key], on=key, how="left", indicator=True)
        for _, row in only[only["_merge"] == "left_only"].iterrows():
            ps = [pearsonr(*pair_values(m, *row[key]))[1] if pair_values(m, *row[key])
                  else float("nan") for m in (merged_got, merged_want)]
            if not all(abs(p - P_CUT) <= P_BAND for p in ps):
                fail(f"correlation {tuple(row[key])} is significant on the {side} side; "
                     f"p card {ps[0]:.6f}, cpu {ps[1]:.6f}: outside {P_CUT} ± {P_BAND}")
            moved.append((side, tuple(row[key]), ps))
    for side, pair, ps in moved:
        print(f"[all] correlation {pair} significant on the {side} side: p card "
              f"{ps[0]:.6f}, cpu {ps[1]:.6f} (within {P_CUT} ± {P_BAND})")
    return {"pairs_both": len(both), "pairs_moved": len(moved), "max_dr": dr,
            "max_dp": dp}


def compare_classification(got_csv, want_csv, geo_got, geo_want) -> dict:
    """The summary rows equal, or each moved row printed beside the largest
    relative difference of its timepoint's subject-mean features, which is
    held to CLF_FEATURE_TOL."""
    import pandas as pd

    from lesionvae_tpu_torch.pipeline import classification as clf

    got, want = pd.read_csv(got_csv), pd.read_csv(want_csv)
    if list(got.columns) != list(want.columns) or len(got) != len(want) or not (
            got[["timepoint", "model"]].equals(want[["timepoint", "model"]])):
        fail(f"classification_summary.csv: {len(got)} rows against {len(want)}")
    dfs = [clf.load_and_prepare_data(f) for f in (geo_got, geo_want)]
    cols = clf.get_feature_columns(dfs[1])
    metrics = ["accuracy", "auc", "sensitivity", "specificity"]
    moved = 0
    for i in range(len(want)):
        a, b = got.loc[i, metrics].to_numpy(float), want.loc[i, metrics].to_numpy(float)
        if np.array_equal(a, b):
            continue
        tp = want.loc[i, "timepoint"]
        xa, xb = (clf.aggregate_features_per_subject(d, tp, cols)[cols].to_numpy(float)
                  for d in dfs)
        feat = float(np.nanmax(np.abs(xa - xb) / np.maximum(1.0, np.abs(xb))))
        print(f"[all] classification row {tp} {want.loc[i, 'model']} moved by "
              f"{np.abs(a - b).max():.4f}; its subject-mean features differ by at most "
              f"{feat:.3e} (tol {CLF_FEATURE_TOL})")
        if feat > CLF_FEATURE_TOL:
            fail(f"classification row {tp} {want.loc[i, 'model']} moved and its "
                 f"features differ by {feat:.3e}")
        moved += 1
    return {"rows": len(want), "rows_moved": moved}


def check_all(root: Path, cohort_out: Path, cpu_geo: Path, cpu_lesion: Path,
              own: dict) -> dict:
    """The ``all`` phase on the full-scale cohort under ``root``: geometry
    (100 streamlines a bundle) -> lesion (2000 directions, 48^3 volumes) ->
    the float32 fleet (64 members x 40 epochs x batch 64) -> classify ->
    correlate, on the card through ``cli.main``.  Where scikit-learn is not
    installed (an import check decides) ``all`` must refuse before its first
    stage, and the phase runs its device stages through ``geometry``,
    ``lesion`` and ``vae-cohort`` and then ``correlate``, in that order.
    Returns the kernels' launches in the phase and its spans."""
    import importlib.util
    import pandas as pd

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.ops import radius, sr_adam
    from lesionvae_tpu_torch.pipeline import correlation
    from lesionvae_tpu_torch.train import program
    from lesionvae_tpu_torch.utils import profiling

    have_sklearn = importlib.util.find_spec("sklearn") is not None
    out = root / "results_all"
    common = ["--config", str(root / "config.json"), "--base-path", str(root),
              "--seed", str(SEED), "--device", "cuda", "--output-dir", str(out)]
    geo_flags = ["--max-streamlines", str(GEO_STREAMLINES)]
    les_flags = ["--num-samples", str(NUM_SAMPLES)]
    if not have_sklearn:
        # the refusal: before any stage, naming the package, nothing written
        try:
            cli.main(["all", *common, *geo_flags, *les_flags, "--with-vae",
                      "--epochs", str(VAE_EPOCHS), "--no-plots"])
        except ImportError as e:
            refusal = e
        else:
            fail("all ran on a machine without scikit-learn")
        if refusal.name != "sklearn" or out.exists():
            fail(f"all without scikit-learn: {refusal!r}, output written {out.exists()}")
    profiling.reset()
    reset_launches()
    t0 = time.perf_counter()
    if have_sklearn:
        runs = [["all", *common, *geo_flags, *les_flags, "--with-vae", "--epochs",
                 str(VAE_EPOCHS), "--no-plots"]]
    else:
        runs = [["geometry", *common, *geo_flags], ["lesion", *common, *les_flags],
                ["vae-cohort", *common, "--epochs", str(VAE_EPOCHS)],
                ["correlate", *common, "--no-plots"]]
    for argv in runs:
        rc = cli.main(argv)
        if rc != 0:
            fail(f"{argv[0]} exited {rc} in the all phase")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"radius": radius.sample_radii.launches, "geometry": geometry_launches()}
    spans = profiling.report()
    if launches != {"radius": 1, "geometry": 9}:
        fail(f"the all phase launched {launches}; radius 1 and geometry 9 expected")
    # the float32 fleet: the gather and norm once a step, the update twice
    # (weights and BatchNorm leaves), no SR Adam
    steps = COHORT_STEPS + COHORT_STEPS // VAE_EPOCHS * program.COUNTS["captures"]
    launches.update(hold_adam_launches("all", steps, {"grad_sq_norm": 1, "adam_step": 2}))
    launches["conv1d"] = hold_conv_launches("all", steps, masked_bn_launches())
    launches["sr_adam"] = sr_adam.sr_adam_step.launches
    if launches["sr_adam"]:
        fail(f"the all phase's float32 fleet launched SR Adam {launches['sr_adam']} times")

    # its geometry and lesion CSVs: the bits of the phase's own geometry and
    # lesion runs on the same cohort (and of path 3a's lesion CSV, written
    # from the same volumes)
    for argv in (["geometry", *common[:-1], str(root / "results_own"), *geo_flags],
                 ["lesion", *common[:-1], str(root / "results_own"), *les_flags]):
        if cli.main(argv) != 0:
            fail(f"{argv[0]} exited non-zero in the all phase")
    geo_dir = "comprehensive_tract_geometry"
    les = Path("lesion_sh_heme_comprehensive") / "lesion_sh_heme_comprehensive.csv"
    pairs = [(Path(geo_dir) / f, Path(geo_dir) / f) for f in GEO_CSVS] + [(les, les)]
    for rel, _ in pairs:
        if (out / rel).read_bytes() != (root / "results_own" / rel).read_bytes():
            fail(f"the all phase's {rel} differs from its own standalone run")
    if (out / les).read_bytes() != own["lesion_cuda"].read_bytes():
        fail("the all phase's lesion CSV differs from path 3a's on the same volumes")

    # the fleet: vae-cohort's file names at the same flags, finite summaries
    fleet = out / "vae_cohort"
    names = sorted(p.name for p in fleet.iterdir())
    want_names = sorted(p.name for p in cohort_out.iterdir() if p.is_file())
    if names != want_names or len(names) != 2 * COHORT_MEMBERS:
        fail(f"the all phase's fleet wrote {len(names)} files, vae-cohort "
             f"{len(want_names)}: {sorted(set(names) ^ set(want_names))[:6]}")
    for name in names:
        if name.endswith(".npz"):
            z = np.load(fleet / name, allow_pickle=True)
            for k in ("magnitude", "norm_mean", "norm_std", "subj_profile"):
                if not np.isfinite(z[k]).all():
                    fail(f"the all phase's {name}: {k} not finite")
        else:
            hist = pd.read_csv(fleet / name)
            if (len(hist) != VAE_EPOCHS or not np.isfinite(hist.to_numpy()).all()
                    or not hist["loss"].iloc[-1] < hist["loss"].iloc[0]):
                fail(f"the all phase's {name}: {len(hist)} epochs, not finite or not "
                     f"falling")

    # the host stages against the same stages on the CPU float32 CSVs
    ref = root / "results_all_cpu_inputs"
    card_geo = out / geo_dir / GEO_CSVS[0]
    corr_csv = Path("lesion_tract_correlations") / "significant_correlations.csv"
    correlation.run_correlation(cpu_lesion, cpu_geo, ref / corr_csv.parent,
                                make_plots=False)
    merged = [correlation.merge_lesion_tract_data(*correlation.load_data(lc, gc))
              for lc, gc in ((out / les, card_geo), (cpu_lesion, cpu_geo))]
    corr = compare_correlations(pd.read_csv(out / corr_csv), pd.read_csv(ref / corr_csv),
                                *merged)
    clf = None
    if have_sklearn:
        from lesionvae_tpu_torch.pipeline.classification import run_classification
        summ = Path("tbi_pte_classification") / "classification_summary.csv"
        run_classification(cpu_geo, ref / summ.parent, make_plots=False)
        clf = compare_classification(out / summ, ref / summ, card_geo, cpu_geo)
    host_code_lines()
    card = card_line()
    note = ("classify ran: " + json.dumps(clf) if have_sklearn else
            f"classify could not run here: scikit-learn is not installed on this "
            f"machine (an import check; `all` refused before its first stage: "
            f"{refusal}); its device stages ran as geometry -> lesion -> vae-cohort, "
            f"then correlate")
    print(f"[all] {'all --with-vae' if have_sklearn else 'the all phase'} on cuda: "
          f"{wall:.2f}s; launches {json.dumps(launches)}; geometry and lesion CSVs "
          f"bit-equal to the phase's own runs; fleet {len(names)} files, summaries "
          f"finite, {graph_counts()}; correlate vs the CPU float32 CSVs "
          f"{json.dumps(corr)} (r, p tol "
          f"{CORR_TOL}, band {P_BAND}); {note}; spans {json.dumps(spans)}; {card}")
    return {"launches": launches, "spans": spans, "wall": wall}


def fleet_tensors(arrays: dict, lay) -> dict:
    """name -> (T, elements) of a fleet's parameters and running statistics
    from its ``parallel.ranks.state_arrays`` form (views of the buffers)."""
    T = arrays["weights"].shape[0]
    out = {}
    for name, (which, off, shape) in lay.leaves.items():
        out[name] = arrays[which][:, off:off + int(np.prod(shape))]
    out.update({k: arrays[f"stats.{k}"].reshape(T, -1) for k in lay.stats})
    return out


def movement_by_tensor(got: dict, ref: dict, start: dict, shift: int = 0) -> dict:
    """Per tensor, the largest L2 distance of a member's tensor in ``got``
    from the same tensor of member (i + shift) % T in ``ref``, over the
    distance that tensor moved in ``ref`` from its start."""
    out = {}
    for name, r in ref.items():
        a = got[name].astype(np.float64)
        b = np.roll(r, -shift, 0).astype(np.float64)
        s0 = np.roll(start[name], -shift, 0).astype(np.float64)
        ratio = np.linalg.norm(a - b, axis=1) / np.maximum(
            np.linalg.norm(b - s0, axis=1), 1e-30)
        out[name] = float(ratio.max())
    return out


def off_of_movement(got: dict, ref: dict, start: dict, shift: int = 0) -> float:
    """The largest of ``movement_by_tensor``."""
    return max(movement_by_tensor(got, ref, start, shift).values())


def fleet_case():
    """64 members of 925-960 random rows at full width (pad rows zero), a
    Sham set and 37 subjects: the raw blocks of the chunked and the parallel
    fleet checks.  Returns (Xm, Xl, n_real, sham, seg)."""
    T, n_pad, L = COHORT_MEMBERS, COHORT_PAD, 100
    g = np.random.default_rng(SEED)
    Xm = g.normal(size=(T, n_pad, L, 13)).astype(np.float32)
    Xl = g.uniform(size=(T, n_pad, L, 3)).astype(np.float32)
    n_real = g.integers(900, n_pad + 1, size=T).astype(np.int32)
    for i, n in enumerate(n_real):
        Xm[i, n:] = Xl[i, n:] = 0
    sham = (np.arange(n_pad)[None, :] < 300).astype(np.float32).repeat(T, 0)
    seg = np.tile(np.arange(n_pad) % 37, (T, 1))
    return Xm, Xl, n_real, sham, seg


def check_chunks() -> dict:
    """upload_chunks=1 against "auto" (8 chunks) and against two blocks
    launched with the canonical draws, 64 members x CHUNK_EPOCHS epochs at
    full width on the card, with the normative summary; each launch timed."""
    from lesionvae_tpu_torch.models.fleet import FleetState, layout
    from lesionvae_tpu_torch.parallel.ranks import fleet_arrays, state_arrays
    from lesionvae_tpu_torch.train import batched, program

    T, n_pad, L = COHORT_MEMBERS, COHORT_PAD, 100
    Xm, Xl, n_real, sham, seg = fleet_case()
    kw = dict(latent_dim=VAE_LATENT, epochs=CHUNK_EPOCHS, batch_size=VAE_BATCH,
              seed=VAE_SEED, normalize_on_device=True, device="cuda",
              summary_spec=(sham, seg, 38, VAE_SEED))
    # the canonical draws, made before the clock starts for all three forms
    hyper = layout(L, 13, 3, VAE_LATENT).hyper
    full = batched.member_draws(T, n_pad, hyper, CHUNK_EPOCHS, VAE_BATCH, VAE_SEED)
    blocks = [slice(0, T // 2), slice(T // 2, T)]
    draws = [batched.member_draws(T, n_pad, hyper, CHUNK_EPOCHS, VAE_BATCH, VAE_SEED,
                                  block=b) for b in blocks]

    graphs = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        program.reset_counts()
        t0 = time.perf_counter()
        h = fn()
        torch.cuda.synchronize()
        graphs[label] = dict(program.COUNTS)
        return h, time.perf_counter() - t0

    one, s1 = timed("single", lambda: batched.launch_many_vaes(Xm, Xl, n_real, **kw,
                                                                 **full))
    auto, s8 = timed("auto", lambda: batched.launch_many_vaes(
        Xm, Xl, n_real, upload_chunks="auto", **kw, **full))
    split, s2 = timed("two_blocks", lambda: batched.cat_handles([
        batched.launch_many_vaes(Xm[b], Xl[b], n_real[b], **dict(
            kw, summary_spec=(sham[b], seg[b], 38, VAE_SEED)), **d)
        for b, d in zip(blocks, draws)]))
    chunks = batched.resolve_chunks("auto", T)
    # every chunk (and block) of a launch replays one cached program
    if (graphs["auto"]["captures"] > 1 or graphs["two_blocks"]["captures"] > 1
            or graphs["auto"]["replays"] != chunks * CHUNK_EPOCHS
            or graphs["two_blocks"]["replays"] != 2 * CHUNK_EPOCHS):
        fail(f"chunked launches' graphs: {json.dumps(graphs)}")
    out = {"members": T, "epochs": CHUNK_EPOCHS, "single_s": s1, "auto_s": s8,
           "auto_chunks": chunks, "two_blocks_s": s2, "graphs": graphs}
    print(f"[chunks] times: {json.dumps(out)}")
    s0 = FleetState.from_state_dicts(full["state_dicts"], one.state.layout, device="cuda")
    lay = one.state.layout
    start, ref = (fleet_tensors(state_arrays(s0), lay),
                  fleet_tensors(fleet_arrays(one), lay))

    def moved(h, shift=0) -> float:
        return off_of_movement(fleet_tensors(fleet_arrays(h), lay), ref, start, shift)

    def hist_rel(a, b) -> float:
        return rel_err(a.cpu(), b.cpu())

    for label, h in (("auto", auto), ("two_blocks", split)):
        bits = all(torch.equal(getattr(h.state, b), getattr(one.state, b))
                   for b in ("weights", "affine")) and torch.equal(h.hist, one.hist)
        readings = {
            "history_max_abs": float((h.hist - one.hist).abs().max()),
            "history_max_rel": hist_rel(h.hist, one.hist),
            "weights_max_abs": float((h.state.weights - one.state.weights).abs().max()),
            "test_bounds_hold": bool(
                torch.allclose(h.hist, one.hist, **CHUNK_HIST) and all(
                    torch.allclose(getattr(h.state, b), getattr(one.state, b),
                                   **CHUNK_WEIGHTS) for b in ("weights", "affine"))),
            "tensor_off_of_movement": moved(h),
            "control_next_member": [hist_rel(h.hist, torch.roll(one.hist, -1, 0)),
                                    moved(h, shift=1)]}
        if bits:
            held = "bit-equal"
        elif readings["test_bounds_hold"]:
            held = "tests/test_upload_chunks.py's bounds"
        elif (readings["history_max_rel"] <= ALONE_TOL
              and readings["tensor_off_of_movement"] <= ALONE_MOVE):
            held = (f"the card's member-against-alone bounds (history {ALONE_TOL}, "
                    f"tensors {ALONE_MOVE} of their movement in L2)")
        else:
            held = None
        control = readings["control_next_member"]
        if held is None or control[0] <= ALONE_TOL or control[1] <= ALONE_MOVE:
            fail(f"fleet {label} vs one launch: {json.dumps(readings)}")
        out[label] = {"held": held, **readings}
    print(f"[chunks] {json.dumps(out)}")
    return out


# ---------------------------------------------------------------- the parallel paths
# two ranks share the one card over gloo (NCCL refuses two ranks on one
# device; gloo takes CUDA tensors for broadcast, all_reduce and barrier, all
# that parallel.mesh uses); NCCL runs at world size 1.  The fleet of (c) is
# not held to ALONE_MOVE against the one 64-member launch, only printed
# beside it: with bf16 storage a tensor that moves a few bf16 steps in 30
# steps (fc_logv's bias) is moved a large share by one stochastic rounding
# that flips when cuBLAS sums a 32-member batch in another order (0.284 on an
# H100 80GB HBM3, the same for the split launch in one process);
# bit-equality with that split launch holds instead
PARALLEL_RANKS = 2


def same_bits(got, want) -> bool:
    """Equal bit for bit (NaN payloads and signed zeros included)."""
    got, want = np.asarray(got), np.asarray(want)
    return got.shape == want.shape and got.dtype == want.dtype and \
        got.tobytes() == want.tobytes()


def summary_bits(got, want) -> bool:
    """Two lists of bundle summaries, bit for bit."""
    return len(got) == len(want) and all(
        g.keys() == w.keys() and same_bits(np.array(list(g.values()), np.float64),
                                           np.array(list(w.values()), np.float64))
        for g, w in zip(got, want))


def parallel_nccl() -> dict:
    """(a) One rank over NCCL: ``make_mesh(1)`` and one full-size chunk (32,768
    streamlines of 49-64 points, P = 64) through ``sharded_streamline_metrics``
    and ``launch_bundle_metrics(mesh=)`` (512 bundles of 64): bit-equal to
    the unsharded calls."""
    from lesionvae_tpu_torch.ops.geometry import streamline_metrics_stacked, unstack_metrics
    from lesionvae_tpu_torch.ops.padding import pad_streamlines
    from lesionvae_tpu_torch.parallel import mesh, ranks
    from lesionvae_tpu_torch.pipeline import geometry_run as gr

    g = np.random.default_rng(SEED + 8)
    sls = [np.cumsum(g.normal(size=(int(n), 3)), axis=0)
           for n in g.integers(49, 65, size=32768)]
    pts, lens = pad_streamlines(sls, max_points=64)
    bundles = [sls[i:i + 64] for i in range(0, len(sls), 64)]
    t0 = time.perf_counter()
    (per_sl, c1), (per_bundle, c2) = mesh.spawn(ranks.run, 1, "nccl", "cuda", [
        ("streamlines", 1, dict(points=pts, lengths=lens)),
        ("bundle_metrics", 1, dict(bundles=bundles))])[0]
    wall = time.perf_counter() - t0
    want = unstack_metrics(streamline_metrics_stacked(
        torch.from_numpy(pts).cuda(), torch.from_numpy(lens).cuda()).cpu().numpy())
    if per_sl.keys() != want.keys() or not all(same_bits(per_sl[k], want[k]) for k in want):
        fail("parallel (a): sharded_streamline_metrics over NCCL differs from the "
             "unsharded kernel")
    summaries, launches = per_bundle
    if launches != 1 or not summary_bits(summaries, gr.batched_bundle_metrics(bundles)):
        fail(f"parallel (a): launch_bundle_metrics(mesh=) over NCCL ({launches} launches) "
             "differs from the unsharded call")
    return {"wall_s": wall, "streamlines": len(sls), "bit_equal": True,
            "launches": {"geometry": [c1["geometry"] + c2["geometry"]]},
            "collectives": c1["collectives"] + c2["collectives"]}


def parallel_fleet_reference(Xm, Xl, n_real, sham, seg, kw) -> tuple:
    """What (c) is held to, in this process: the 64-member launch, the same
    fleet launched as the ranks' two blocks of members with the canonical
    draws (``member_draws``; the split launch of path 3g), and the fleet's starting
    weights, as ``parallel.ranks`` arrays; and the single launch's seconds."""
    from lesionvae_tpu_torch.models.fleet import FleetState, layout
    from lesionvae_tpu_torch.parallel.ranks import fleet_arrays, state_arrays
    from lesionvae_tpu_torch.train import batched, program

    kw = dict(kw)
    n_seg, norm_seed = kw.pop("n_seg"), kw.pop("norm_seed")
    T, n_pad = Xm.shape[:2]
    lay = layout(100, 13, 3, VAE_LATENT)
    t0 = time.perf_counter()
    one = batched.launch_many_vaes(Xm, Xl, n_real, summary_spec=(sham, seg, n_seg, norm_seed),
                                   device="cuda", **kw)
    one.fetch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    blocks = [slice(r * T // PARALLEL_RANKS, (r + 1) * T // PARALLEL_RANKS)
              for r in range(PARALLEL_RANKS)]
    split = batched.cat_handles([batched.launch_many_vaes(
        Xm[b], Xl[b], n_real[b], summary_spec=(sham[b], seg[b], n_seg, norm_seed),
        device="cuda", **kw, **batched.member_draws(T, n_pad, lay.hyper, kw["epochs"],
                                                    kw["batch_size"], kw["seed"], block=b))
        for b in blocks])
    split.fetch()
    start = FleetState.from_state_dicts(
        batched.init_state_dicts(T, lay.hyper, kw["seed"]), lay,
        store_dtype=kw["store_dtype"], device="cuda")
    out = fleet_arrays(one), fleet_arrays(split), state_arrays(start), wall
    del one, split, start
    torch.cuda.empty_cache()
    return out


def check_parallel(cohort_root: Path, cfg, with_vae: bool) -> dict:
    """The parallel phase, after the paths above (README, the port's
    section): (a) NCCL at world size 1; then two gloo ranks on the card in
    one start: (b) the geometry stage over the cohort of 3c, its bundles
    read once here and handed over, the three CSVs byte-equal to 3c's; (c)
    the member-sharded fleet, 64 members at full width with bf16 storage,
    normalization and the summary, CHUNK_EPOCHS epochs, 32 members a rank,
    no collective between upload and fetch, bit-equal to the same two
    blocks launched in this process (each rank's block is such a launch),
    and against the one 64-member launch: history within ALONE_TOL, the
    next member outside ALONE_TOL and ALONE_MOVE (see PARALLEL_RANKS);
    (d) ``dryrun_flagship(2)`` at the full widths and
    ``dryrun_train_step(2, model_parallel=2)``, with their own assertions.
    Every rank must launch the geometry kernel (b) and SR Adam (c)."""
    import pickle

    from lesionvae_tpu_torch.models.fleet import layout
    from lesionvae_tpu_torch.parallel import mesh, ranks, sharded

    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    out = {"a_nccl": parallel_nccl()}
    work = cohort_root / "parallel"
    work.mkdir()
    bundles = read_bundles(cfg, cohort_root / "data")
    meta = [dict(subject_id=sid, timepoint=tp, tract=tract, group=group)
            for group, sids in cfg.subjects_by_group().items() for sid in sorted(sids)
            for tp in cfg.timepoints for tract in cfg.geometry_tracts]
    with open(work / "bundles.pkl", "wb") as f:
        pickle.dump((bundles, meta), f, protocol=pickle.HIGHEST_PROTOCOL)
    jobs = [("geometry_csvs", 1, dict(bundles_file=str(work / "bundles.pkl"),
                                      output_dir=str(work / "geometry")))]
    if with_vae:
        Xm, Xl, n_real, sham, seg = fleet_case()
        np.savez(work / "fleet.npz", Xm=Xm, Xl=Xl, n_real=n_real, sham=sham, subj=seg)
        fleet_kw = dict(latent_dim=VAE_LATENT, epochs=CHUNK_EPOCHS, batch_size=VAE_BATCH,
                        seed=VAE_SEED, normalize_on_device=True,
                        store_dtype=torch.bfloat16, n_seg=38, norm_seed=VAE_SEED)
        ref, split, start, ref_s = parallel_fleet_reference(Xm, Xl, n_real, sham, seg,
                                                            fleet_kw)
        del Xm, Xl
        jobs.append(("fleet", 1, dict(data=str(work / "fleet.npz"), kwargs=fleet_kw,
                                      out=str(work / "fleet_out.npz"))))
    t0 = time.perf_counter()
    per_rank = mesh.spawn(ranks.run, PARALLEL_RANKS, "gloo", "cuda", jobs)
    gloo_s = time.perf_counter() - t0
    geo = [r[0] for r in per_rank]
    csv_equal = {f: (work / "geometry" / f).read_bytes()
                 == (cohort_root / "results" / "geometry_cuda" / f).read_bytes()
                 for f in GEO_CSVS}
    if not all(csv_equal.values()):
        fail(f"parallel (b): the two-rank geometry CSVs differ from path 3c's: {csv_equal}")
    launches = {"geometry": [counts["geometry"] for _res, counts in geo]}
    out["b_geometry"] = {"bundles": len(bundles), "csvs_byte_equal": True,
                         "launches_by_rank": launches["geometry"],
                         "seconds_by_rank": [c["seconds"] for _r, c in geo]}
    if with_vae:
        fl = [r[1] for r in per_rank]
        lay = layout(100, 13, 3, VAE_LATENT)
        got = dict(np.load(work / "fleet_out.npz"))
        got_t, ref_t, start_t = (fleet_tensors(a, lay) for a in (got, ref, start))
        readings = {
            "bit_equal_to_split_launch": got.keys() == split.keys() and all(
                same_bits(got[k], split[k]) for k in split),
            "history_max_rel": rel_err(got["hist"], ref["hist"]),
            "tensor_off_of_movement": off_of_movement(got_t, ref_t, start_t),
            "worst_tensors": sorted(movement_by_tensor(got_t, ref_t, start_t).items(),
                                    key=lambda kv: -kv[1])[:3],
            "summary_max_rel": max(rel_err(got[f"summary.{i}"], ref[f"summary.{i}"])
                                   for i in range(5)),
            "control_next_member": [rel_err(got["hist"], np.roll(ref["hist"], -1, 0)),
                                    off_of_movement(got_t, ref_t, start_t, shift=1)],
            "collectives_in_training": [res[1]["collectives"] for res, _c in fl],
            "ledger_members": [[s[0].shape[0] for _n, s in res[1]["ledger"]]
                               for res, _c in fl]}
        launches["sr_adam"] = [counts["sr_adam"] for _res, counts in fl]
        control = readings["control_next_member"]
        if (not readings["bit_equal_to_split_launch"]
                or readings["history_max_rel"] > ALONE_TOL
                or control[0] <= ALONE_TOL or control[1] <= ALONE_MOVE
                or any(readings["collectives_in_training"])
                or readings["ledger_members"] != [[COHORT_MEMBERS // PARALLEL_RANKS]] * 2):
            fail(f"parallel (c): the member-sharded fleet against one launch: "
                 f"{json.dumps(readings)}")
        out["c_fleet"] = {"members": COHORT_MEMBERS, "epochs": CHUNK_EPOCHS,
                          "one_process_s": ref_s,
                          "seconds_by_rank": [c["seconds"] for _r, c in fl],
                          "bounds": {"history": ALONE_TOL, "tensor": ALONE_MOVE},
                          **readings}
        t0 = time.perf_counter()
        flag = sharded.dryrun_flagship(PARALLEL_RANKS, verbose=True)
        flag_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loss, delta = sharded.dryrun_train_step(PARALLEL_RANKS, model_parallel=2)
        out["d_dryruns"] = {"flagship": flag, "flagship_s": flag_s,
                            "train_step": {"loss": loss, "delta": delta,
                                           "seconds": time.perf_counter() - t0}}
    for name, counts in launches.items():
        if len(counts) != PARALLEL_RANKS or min(counts) < 1:
            fail(f"parallel: a rank did not launch {name}: {counts}")
    out["gloo_spawn_s"] = gloo_s
    out["launches_by_rank"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"[parallel] {json.dumps(out)}; {card_line()}")
    return out


# ---------------------------------------------------------------- the programs
# training as one device program (train/program.py): each epoch one replay
# of a captured CUDA graph, against the same epochs as eager launches
# (train_loop, train_fleet) on the same inputs, PROGRAM_EPOCHS epochs at
# full width.  Two eager runs are read against each other first: where they
# agree bit for bit the graph must too, else the graph is held to the larger
# of that reading and the member-against-alone bounds (ALONE_TOL in history,
# ALONE_MOVE of each tensor's movement in L2)
PROGRAM_EPOCHS = 2


def run_readings(got, ref, start) -> dict:
    """``got`` against ``ref``, each (history, {name: tensor}) on the host,
    from the tensors ``start``."""
    moved = {k: float((ref[1][k].double() - start[k].double()).norm()) for k in ref[1]}
    off = {k: float((got[1][k].double() - ref[1][k].double()).norm()) / max(moved[k], 1e-30)
           for k in ref[1]}
    worst = max(off, key=off.get)
    return {"bit_equal": bool(torch.equal(got[0], ref[0]) and all(
                torch.equal(got[1][k], ref[1][k]) for k in ref[1])),
            "history_max_rel": rel_err(got[0], ref[0]),
            "tensor_off_of_movement": off[worst], "worst_tensor": worst}


def hold_graph(label: str, graph: dict, eager: dict) -> str:
    """The graph-against-eager reading held as the phase's rule says."""
    if eager["bit_equal"]:
        if not graph["bit_equal"]:
            fail(f"{label}: two eager runs agree bit for bit, the graph does not: "
                 f"{json.dumps(graph)}")
        return "bit-equal, as eager against eager"
    return hold_near(label, graph, eager)


def hold_near(label: str, got: dict, eager: dict) -> str:
    """A reading of other kernels against the eager runs held to the larger
    of the eager runs' own reading and ALONE_TOL / ALONE_MOVE."""
    tol = max(ALONE_TOL, eager["history_max_rel"])
    move = max(ALONE_MOVE, eager["tensor_off_of_movement"])
    if got["history_max_rel"] > tol or got["tensor_off_of_movement"] > move:
        fail(f"{label}: against eager {json.dumps(got)} beyond history {tol} "
             f"and tensors {move} (eager against eager {json.dumps(eager)})")
    return f"within history {tol:.3e} and tensors {move:.3e} of their movement"


def check_programs(cohort_root: Path, cfg) -> dict:
    """Phase 3i: (a) the single VAE and the bf16-storage 64-member fleet,
    PROGRAM_EPOCHS epochs at full width, graph against eager; (b) the SR
    Adam kernel counted at each replay; (c) ``warm_compile`` launches, then
    the real launch with no new capture; (d) peak memory."""
    from lesionvae_tpu_torch.models.fleet import FleetState, layout
    from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
    from lesionvae_tpu_torch.ops import geometry, sr_adam
    from lesionvae_tpu_torch.pipeline import geometry_run as gr
    from lesionvae_tpu_torch.train import batched, data as vdata, program, trainer
    from lesionvae_tpu_torch.train.lowmem import LowmemOptimizer

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {}
    lay = layout(100, 13, 3, VAE_LATENT)
    Xm, Xl, n_real, sham, seg = fleet_case()
    T, n_pad = Xm.shape[:2]
    n_d = torch.from_numpy(n_real.astype(np.int64)).cuda()
    Xz, Xlz, _ = vdata.normalize_on_device(torch.from_numpy(Xm).cuda(),
                                           torch.from_numpy(Xl).cuda(), n_d)
    opt_args = (2e-4, 1e-3, 2.0)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = fn()
        torch.cuda.synchronize()
        return r, time.perf_counter() - t0

    # (a) the single VAE: member 0's rows
    n0 = int(n_real[0])
    gen = torch.Generator().manual_seed(VAE_SEED)
    perms, noise = trainer.draw_run(n0, n_pad, PROGRAM_EPOCHS, VAE_BATCH, VAE_LATENT, gen)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(VAE_SEED)
        sd0 = LesionConditionedVAE(**lay.hyper).state_dict()

    def single(train):
        module = LesionConditionedVAE(**lay.hyper).cuda()
        module.load_state_dict(sd0)
        hist = train(module, Xz[0], Xlz[0], n0, perms, noise, PROGRAM_EPOCHS, VAE_BATCH,
                     *opt_args)
        return (torch.from_numpy(np.asarray(hist)),
                {k: v.detach().cpu() for k, v in module.state_dict().items()})

    def member_eager():
        # the one-member fleet's own eager form: its step as launches
        state = FleetState.from_state_dicts([sd0], lay, torch.float32, None, "cuda")
        hist = batched.train_fleet(state, LowmemOptimizer(state, *opt_args), Xz[:1],
                                   Xlz[:1], n_d[:1], perms.cuda()[None],
                                   noise.cuda()[None], PROGRAM_EPOCHS, VAE_BATCH)
        return hist[0].cpu(), {k: v.cpu() for k, v in state.state_dict(0).items()}

    program.reset_counts()
    (e1, s_e1), (e2, s_e2) = timed(lambda: single(trainer.train_loop)), \
        timed(lambda: single(trainer.train_loop))
    g1, s_g1 = timed(lambda: single(trainer.train_module))
    g2, s_g2 = timed(lambda: single(trainer.train_module))
    counts = dict(program.COUNTS)
    m1, s_m1 = timed(member_eager)
    eager = run_readings(e2, e1, sd0)
    graph = run_readings(g1, e1, sd0)
    again = run_readings(g2, g1, sd0)
    member = run_readings(g1, m1, sd0)
    # the graph is the one-member fleet program: the fleet's kernels against
    # the module's eager route (cuDNN's backward differs run to run), and
    # bit for bit against itself and its own eager launches
    held = hold_near("single VAE", graph, eager)
    for label, reading in (("graph against graph", again),
                           ("graph against the one-member fleet eager", member)):
        if not reading["bit_equal"]:
            fail(f"single VAE, {label}: not bit-equal {json.dumps(reading)}")
    if counts["captures"] > 1 or counts["replays"] != 2 * PROGRAM_EPOCHS:
        fail(f"single VAE: {graph_counts()}")
    out["single"] = {"eager_vs_eager": eager, "graph_vs_eager": graph, "held": held,
                     "graph_vs_graph": again, "graph_vs_member_eager": member,
                     "eager_s": [s_e1, s_e2], "graph_s": [s_g1, s_g2],
                     "member_eager_s": s_m1, "graphs": counts}
    print(f"[programs] single VAE, {n0} rows x {PROGRAM_EPOCHS} epochs at full width, "
          f"graph against eager: {json.dumps(out['single'])}")

    # (a) and (b) the 64-member fleet, bf16 storage
    draws = batched.member_draws(T, n_pad, lay.hyper, PROGRAM_EPOCHS, VAE_BATCH, VAE_SEED)
    start = FleetState.from_state_dicts(draws["state_dicts"], lay, torch.float32,
                                        torch.bfloat16, "cpu")

    def tensors(state):
        return {"weights": state.weights.detach().cpu(), "affine": state.affine.cpu(),
                **{k: v.cpu() for k, v in state.stats.items()}}

    def fleet(form):
        state = FleetState.from_state_dicts(draws["state_dicts"], lay, torch.float32,
                                            torch.bfloat16, "cuda")
        if form == "eager":
            opt = LowmemOptimizer(state, *opt_args, salts=draws["salts"])
            hist = batched.train_fleet(state, opt, Xz, Xlz, n_d, draws["perms"].cuda(),
                                       draws["noise"].cuda(), PROGRAM_EPOCHS, VAE_BATCH)
        else:
            prog_ = batched.fleet_program(lay, T, n_pad, PROGRAM_EPOCHS, VAE_BATCH,
                                          *opt_args, torch.bfloat16, None, False, "cuda",
                                          torch.float32)
            hist = prog_.run(state, draws["salts"], Xz, Xlz, n_d, draws["perms"],
                             draws["noise"])
        return hist.cpu(), tensors(state)

    (f1, t_e1), (f2, t_e2) = timed(lambda: fleet("eager")), timed(lambda: fleet("eager"))
    program.reset_counts()
    sr_adam.sr_adam_step.launches = 0
    fg, t_g = timed(lambda: fleet("graph"))
    steps = PROGRAM_EPOCHS * (n_pad // VAE_BATCH)
    captures = program.COUNTS["captures"]
    launches = sr_adam.sr_adam_step.launches
    if (launches != steps + captures * (n_pad // VAE_BATCH)
            or program.COUNTS["replays"] != PROGRAM_EPOCHS):
        fail(f"fleet graph: SR Adam launched {launches} times in {steps} steps, "
             f"{graph_counts()}")
    eager = run_readings(f2, f1, tensors(start))
    graph = run_readings(fg, f1, tensors(start))
    held = hold_graph("bf16 fleet", graph, eager)
    out["fleet"] = {"members": T, "eager_vs_eager": eager, "graph_vs_eager": graph,
                    "held": held, "eager_s": [t_e1, t_e2], "graph_s": t_g,
                    "sr_adam_launches": launches, "steps": steps,
                    "graphs": dict(program.COUNTS)}
    print(f"[programs] fleet, {T} members bf16 storage x {PROGRAM_EPOCHS} epochs, graph "
          f"against eager: {json.dumps(out['fleet'])}; SR Adam {launches} launches = "
          f"{steps} counted at the replays + {launches - steps} in the epoch run before "
          f"a capture")
    del Xz, Xlz
    torch.cuda.empty_cache()

    # (c) warm_compile, then the real launch: no new capture
    batched.PROGRAMS.clear()
    kw = dict(latent_dim=VAE_LATENT, epochs=PROGRAM_EPOCHS, batch_size=VAE_BATCH,
              seed=VAE_SEED, normalize_on_device=True, store_dtype=torch.bfloat16,
              summary_spec=(sham, seg, 38, VAE_SEED), device="cuda")
    program.reset_counts()
    warm, t_warm = timed(lambda: batched.launch_many_vaes(Xm, Xl, n_real,
                                                          warm_compile=True, **kw))
    warm_counts = dict(program.COUNTS)
    h_warm = warm.hist.cpu().numpy()
    mag = warm.summary[2].cpu().numpy()
    if (h_warm.shape != (T, PROGRAM_EPOCHS, 4) or not np.isfinite(h_warm).all()
            or mag.shape[0] != T or not np.isfinite(mag).all()
            or warm_counts["captures"] != 1):
        fail(f"warm fleet launch: history {h_warm.shape} finite "
             f"{np.isfinite(h_warm).all()}, magnitude {mag.shape}, {graph_counts()}")
    del warm
    program.reset_counts()
    real, t_real = timed(lambda: batched.launch_many_vaes(Xm, Xl, n_real, **kw))
    if (program.COUNTS["captures"], program.COUNTS["replays"]) != (0, PROGRAM_EPOCHS):
        fail(f"the real launch after a warm one: {graph_counts()}")
    if not np.isfinite(real.hist.cpu().numpy()).all():
        fail("the real launch after a warm one: history not finite")
    del real
    bundles = read_bundles(cfg, cohort_root / "data")
    geometry.streamline_metrics_stacked.launches = 0
    finish, t_geo = timed(lambda: gr.launch_bundle_metrics(bundles, warm_compile=True))
    summaries = finish()
    plan = gr.chunk_plan(bundles)
    geo_launches = geometry.streamline_metrics_stacked.launches
    if (geo_launches != len(plan) or finish.refined != 0
            or not all(x["n_streamlines"] > 0 for x in summaries)):
        fail(f"warm geometry: {geo_launches} launches for {len(plan)} chunks, "
             f"{finish.refined} rows refined")
    out["warm_compile"] = {
        "fleet_warm_s": t_warm, "fleet_warm_graphs": warm_counts,
        "fleet_real_s": t_real, "fleet_real_graphs": {"captures": 0,
                                                      "replays": PROGRAM_EPOCHS},
        "geometry_warm_s": t_geo, "geometry_launches": geo_launches,
        "geometry_chunks": sorted({(S, P) for P, _c, S in plan}), "refined": 0}
    print(f"[programs] warm_compile: {json.dumps(out['warm_compile'])}")
    batched.PROGRAMS.clear()
    trainer.PROGRAMS.clear()
    out["max_memory_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"[programs] max_memory_allocated {out['max_memory_allocated_gb']:.2f} GB; "
          f"phase {out['phase_s']:.1f}s; {card_line()}")
    return out


def start_cohort(root: Path, cfg, pool, profiles: bool):
    """Write the full-scale cohort of paths 3c-3f under ``root`` (16 tracts,
    37 subjects x 4 timepoints: the volumes at the lesion path's 48^3, so
    that every lesion of the ``all`` phase is real, bundles of 100
    streamlines and, with ``profiles``, the profile CSVs), one subject a
    task on ``pool``.  A subject's files depend on the seed, the subject and
    the timepoint alone, so the cohort is the one a single call writes, and
    its TBI/PTE volumes are those of path 3a."""
    return [pool.submit(generate_cohort, root, cfg, seed=SEED, volume_shape=(VOLUME,) * 3,
                        subjects={group: [sid]}, with_profiles=profiles,
                        with_bundles=True, n_streamlines=VAE_STREAMLINES)
            for group, sids in cfg.subjects_by_group().items() for sid in sids]


def check_init_draws(members: int = 64) -> None:
    """The cohort fleet's initial weights (``train.batched.draw_init``) on
    this host, the launch's way (into pinned rows touched before): the
    native pass (timed three times, a launch's draw each) and the plain loop
    of torch's init calls (once), the rows bit-equal; one ``[init]`` line
    with the seconds and the counters of the weights each route drew."""
    from lesionvae_tpu_torch.models.fleet import layout
    from lesionvae_tpu_torch.train import batched
    from lesionvae_tpu_torch.train.program import COUNTS

    lay = layout(100, 13, 3, VAE_LATENT)
    if batched.init_library() is None:
        fail("the native pass of the initial weights did not build on this host")
    keys = ("init_draws_native", "init_draws_plain")
    before = {k: COUNTS[k] for k in keys}
    rows, seconds = {}, {"native": [], "plain": []}
    for route, draw in (("native", batched.draw_init_native),) * 3 + (
            ("plain", batched.draw_init_plain),):
        out = torch.empty((members, lay.width), pin_memory=True).fill_(1.0)
        t0 = time.perf_counter()
        rows[route] = draw(lay, members, VAE_SEED, out)
        seconds[route].append(round(time.perf_counter() - t0, 4))
    same = torch.equal(rows["native"].view(torch.int32), rows["plain"].view(torch.int32))
    counts = {k: COUNTS[k] - before[k] for k in keys}
    print(f"[init] members={members} draws={members * lay.n_weights} "
          f"native_s={seconds['native']} plain_s={seconds['plain']} "
          f"bit_equal={same} counts={counts}", flush=True)
    if not same:
        fail("the native initial weights differ from the plain version's")
    if counts != {"init_draws_native": 3 * members * lay.n_weights,
                  "init_draws_plain": members * lay.n_weights}:
        fail(f"init counters {counts}")


def run_vae_paths(root: Path, cfg) -> tuple:
    """Paths 3d and 3e over the profiles cohort under ``root``; returns the
    SR Adam kernel's launches on the cohort path, the masked BatchNorm
    kernels' by stage, their launches a training step of the cohort path,
    the optimizer kernels' launches by path and the convolution kernels' by
    stage."""
    with phase("3d_vae"):
        single = check_vae(root, cfg, cfg.tracts[0])
    common = ["--config", str(root / "config.json"), "--base-path", str(root),
              "--seed", str(VAE_SEED), "--device", "cuda"]
    with phase("3e_vae_cohort"):
        sr, bn, bn_a_step, cohort, conv = check_cohort_cli(root, cfg, common)
        check_cohort_against_cpu(root, cfg)
        check_init_draws()
    torch.cuda.empty_cache()
    bn = {"vae": single["masked_bn"], **bn}
    conv = {"vae": single["conv1d"], **conv}
    return sr, bn, bn_a_step, {"vae": single["optimizer"], "vae-cohort": cohort}, conv


def main(argv=None) -> int:
    t_script = time.perf_counter()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--skip-vae", action="store_true",
                    help="leave out the vae, score and all paths (a shorter run "
                         "while working on a kernel; not the full check)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script needs an NVIDIA card")
    from lesionvae_tpu_torch.core.config import load_config
    from lesionvae_tpu_torch.ops import cuda_build, radius

    # 1. environment + build.  The cohort of paths 3c-3e is host work only
    # (~4 minutes on one core): worker processes write it beside the build
    # and the kernel checks, which time nothing, and are waited for before
    # the first timing, so that no timed call and no path shares the host
    # with them.
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}, card {kind}, devices {torch.cuda.device_count()}")
    print(f"[env] nvidia-smi: {card}")
    cfg = load_config()
    with contextlib.ExitStack() as stack:
        cohort_root = Path(stack.enter_context(
            tempfile.TemporaryDirectory(prefix="lesionvae_cohort_smoke_")))
        pool = stack.enter_context(concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")))
        t_cohort = time.perf_counter()
        writers = start_cohort(cohort_root, cfg, pool, profiles=not args.skip_vae)
        with phase("1_build"):
            print(f"[build] {sorted(cuda_build.build(cuda_build.SOURCES))}")
        with phase("1_sass"):
            sass_lines()
            masked_bn_sass_lines()
            adam_sass = adam_sass_lines()
            conv_sass = conv1d_sass_lines()

        # 2. kernels against their plain versions
        with phase("2_radius"):
            shapes = [(D, N, B) for D in (256, 512, 2000) for N in (1, 200, 333)
                      for B in (1, 3, 13)] + [(2000, 2000, 104)]
            # N and counts on and beside the kernel's chunk of points, D on
            # and beside its tile of directions
            chunk = radius.CHUNK
            shapes += [(D, N, 5) for D in (1023, 1024, 1025)
                       for N in (chunk - 1, chunk, chunk + 1, 2 * chunk, 3 * chunk + 7)]
            errs = [radius_error(radius_case(D, N, B, seed=i))
                    for i, (D, N, B) in enumerate(shapes)]
            full = radius_case(2000, 2000, 104, seed=1234)
            radius_same_bits(full)
            print(f"[kernels] radius vs plain at {len(shapes)} shapes: max abs err "
                  f"{max(errs):.3e} (tol {KERNEL_TOL} x max(1,|plain|))")
            radius_nan_check()
        with phase("2_resident_adam"):
            resident_worst = resident_errors()
        with phase("2_sr_adam"):
            sr_worst = sr_adam_errors()
        with phase("2_geometry"):
            geo_worst = geometry_errors()
        with phase("2_masked_bn"):
            bn_worst = masked_bn_errors()
        with phase("2_adam"):
            adam_checks = {"grad_sq_norm": adam_norm_errors(),
                           "adam_step": adam_step_errors()}
        with phase("2_conv1d"):
            conv_checks = conv1d_errors()
        with phase("2_cohort_wait"):
            for w in writers:
                w.result()
            pool.shutdown()
        print(f"[path] {'bundle' if args.skip_vae else 'bundle and profiles'} cohort "
              f"({len(cfg.geometry_tracts)} tracts, 37 subjects x 4 timepoints) written "
              f"by {len(writers)} tasks, done {time.perf_counter() - t_cohort:.1f}s "
              "after their start")
        with phase("2_radius_full_scale"):
            full_ms = device_ms(lambda: radius.sample_radii(*full))
            full_plain_ms = device_ms(lambda: radius.sample_radii_plain(*full))
            print("[kernels] radius full-scale B=104 D=2000 N=2000 counts~U[0,2000]: "
                  + json.dumps({"ms": full_ms, "plain_ms": full_plain_ms,
                                **radius_bound_ms(full),
                                "pairs": int(full[1].clamp(0, 2000).sum()) * 2000}))

        # 3. the main paths
        with phase("3a_lesion"), \
                tempfile.TemporaryDirectory(prefix="lesionvae_smoke_") as tmp:
            root = Path(tmp)
            t0 = time.perf_counter()
            generate_cohort(root, cfg, seed=SEED, volume_shape=(VOLUME,) * 3,
                            subjects=cfg.subjects_by_group(only=("TBI", "PTE")))
            print(f"[path] synthetic cohort written in {time.perf_counter() - t0:.1f}s")
            launches, path_inputs = check_path(root)
            # path 3a's CSVs for the all phase: its volumes are the cohort's
            own = {"lesion_cuda": cohort_root / "lesion_3a_cuda.csv",
                   "lesion_cpu": cohort_root / "lesion_3a_cpu_f32.csv"}
            les = "lesion_sh_heme_comprehensive.csv"
            shutil.copy(root / "results" / "lesion_sh_heme_comprehensive" / les,
                        own["lesion_cuda"])
            shutil.copy(root / "results_cpu" / les, own["lesion_cpu"])
        with phase("3b_probe"):
            probe, probe_launches = check_probe()
        with phase("3c_geometry"):
            geo = check_geometry(cohort_root, cfg)
        sr_launches, bn_launches, bn_a_step, opt_launches, conv_launches = 0, {}, None, {}, {}
        all_phase = {"launches": {"radius": 0, "geometry": 0}}
        if args.skip_vae:
            print("[path] vae, score, vae-cohort, score-cohort and all paths skipped "
                  "(--skip-vae)")
        else:
            (sr_launches, bn_launches, bn_a_step, opt_launches,
             conv_launches) = run_vae_paths(cohort_root, cfg)
            with phase("3f_all"):
                all_phase = check_all(
                    cohort_root, cohort_root / "results" / "vae_cohort",
                    cohort_root / "results" / "geometry_cpu" / GEO_CSVS[0],
                    own["lesion_cpu"], own)
            opt_launches["all"] = {k: all_phase["launches"][k]
                                   for k in ("grad_sq_norm", "adam_step")}
            conv_launches["all"] = all_phase["launches"]["conv1d"]
            with phase("3g_chunks"):
                check_chunks()
            torch.cuda.empty_cache()
        with phase("3h_parallel"):
            check_parallel(cohort_root, cfg, with_vae=not args.skip_vae)
        if not args.skip_vae:
            with phase("3i_programs"):
                check_programs(cohort_root, cfg)

    # 4. kernel timings at the main paths' shapes
    with phase("4_radius"):
        err = radius_error(path_inputs)
        ms = device_ms(lambda: radius.sample_radii(*path_inputs))
        plain_ms = device_ms(lambda: radius.sample_radii_plain(*path_inputs))
    surface, counts, _c, directions = path_inputs
    print(f"[kernels] main-path radius inputs: B={surface.shape[0]} "
          f"N={surface.shape[1]} D={directions.shape[0]} "
          f"points={int(counts.sum())}")
    per_k = [{key: r[key] for key in ("k", "form", "launches", "max_abs_err",
                                      "share_differing", "bound_ms", "bound_by",
                                      "issue_bound_ms")}
             | {"ms": r["resident_ms"], "plain_ms": r["plain_ms"]} for r in probe]
    k1 = per_k[0]
    # the fleet's optimizer pass at the cohort path's shape: 64 members x the
    # weight elements of one member
    from lesionvae_tpu_torch.models.fleet import layout
    with phase("4_sr_adam"):
        sr = sr_adam_at_path_shape(COHORT_MEMBERS, layout(100, 13, 3, VAE_LATENT))
    print("[kernels] SR Adam at the cohort path's shape: " + json.dumps(sr))
    # the geometry kernel at the path's largest chunk and over all its chunks
    with phase("4_geometry"):
        gt = geometry_timings(geo["chunks"])
    print("[kernels] geometry at the path's largest chunk and over the stage's "
          "launches: " + json.dumps(gt))
    # the fleet step's seven BatchNorm + ReLU layers, float32 and bf16
    # activations
    from lesionvae_tpu_torch.benchmarks import masked_bn_timing

    with phase("4_masked_bn"):
        bn_t = {"f32": masked_bn_timing.timings(torch.float32),
                "bf16": masked_bn_timing.timings(torch.bfloat16)}
    print("[kernels] masked BatchNorm + ReLU over the seven layers of a 64-member fleet "
          f"step (ms; bounds by ops.masked_bn.bound_ms): {json.dumps(bn_t)}; {card}")
    bn_f32 = bn_t["f32"]
    # the optimizer's gather and norm and its float32 update at the paths'
    # shapes, and the fleet's optimizer step against the parent's chain
    from lesionvae_tpu_torch.benchmarks import adam_timing

    with phase("4_adam"):
        opt_t = adam_timing.timings()
    print("[kernels] optimizer kernels (ms; bounds by ops.adam): " + json.dumps(opt_t))
    norm_t, upd_t = opt_t["grad_sq_norm_f32"], opt_t["adam_step_weights"]
    # the fleet step's eight convolutions, float32 and bf16: the kernels
    # graph-replayed, in turns with the chain they replaced and F.conv1d
    from lesionvae_tpu_torch.benchmarks import conv_timing

    with phase("4_conv1d"):
        conv_short = {dt: {k: v for k, v in conv_timing.timings(
                          dtype, reps=CONV_TIMING_REPS, by_layer=False).items()
                          if k not in ("bound", "bound_by_layer")}
                      for dt, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16))}
    print("[kernels] conv1d over the eight convolutions of a 64-member fleet step (ms, "
          "replayed from CUDA graphs in turns with the replaced chain and F.conv1d; bounds "
          "by utils.cost_model.conv_bound_ms; per layer: benchmarks/conv_timing.py): "
          + json.dumps(conv_short) + f"; {card}")
    conv_f32 = conv_short["f32"]
    no_library = ("no single PyTorch call computes it: ")
    print(card)
    print(json.dumps({"kernels": [{
        "name": "radius", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/radius.cu",
        "replaces": "lesionvae_tpu/ops/pallas_radius.py:29",
        "launches": launches + all_phase["launches"]["radius"],
        "launches_by_path": {"lesion": launches, "all": all_phase["launches"]["radius"]},
        "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, **radius_bound_ms(path_inputs), "library_ms": None}, {
        "name": "resident_adam", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/resident_adam.cu",
        "replaces": "benchmarks/pallas_opt_probe.py:118",
        "launches": probe_launches,
        "max_abs_err": max([resident_worst["max_abs_err"]]
                           + [r["max_abs_err"] for r in per_k]),
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": k1["bound_by"], "library_ms": None, "k": k1["k"],
        "per_k": per_k}, {
        "name": "sr_adam", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/sr_adam.cu",
        "replaces": "lesionvae_tpu/train/lowmem.py:91 (XLA fusion, no Pallas kernel)",
        "launches": sr_launches,
        "max_abs_err": max(sr_worst, sr["max_abs_err"]), "ms": sr["ms"],
        "plain_ms": sr["plain_ms"], "bound_ms": sr["bound_ms"],
        "bound_by": sr["bound_by"], "issue_bound_ms": sr["issue_bound_ms"],
        "library_ms": None}, {
        "name": "geometry", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/geometry.cu",
        "replaces": "lesionvae_tpu/ops/geometry.py:347 (XLA fusion, no Pallas kernel)",
        "launches": geo["launches"] + all_phase["launches"]["geometry"],
        "launches_by_path": {"geometry": geo["launches"],
                             "all": all_phase["launches"]["geometry"]},
        "max_abs_err": max(geo_worst, gt["max_abs_err"]),
        "ms": gt["ms"], "plain_ms": gt["plain_ms"], "bound_ms": gt["bound_ms"],
        "bound_by": gt["bound_by"], "issue_bound_ms": gt["issue_bound_ms"],
        "library_ms": None, "shape": [gt["S"], gt["P"]],
        "u16_ms": gt["u16_ms"], "u16_issue_bound_ms": gt["u16_issue_bound_ms"],
        "stage_ms": gt["stage_ms"], "stage_bound_ms": gt["stage_bound_ms"],
        "stage_issue_bound_ms": gt["stage_issue_bound_ms"]}, {
        "name": "masked_bn", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/masked_bn.cu",
        "replaces": "lesionvae_tpu/models/layers.py:41 + nn.relu in the vmapped fleet step "
                    "lesionvae_tpu/train/batched.py:241 (XLA fusion, no Pallas kernel)",
        "launches": sum(sum(v.values()) for v in bn_launches.values()),
        "launches_by_path": bn_launches, "max_abs_err": bn_worst,
        "ms": bn_f32["ms"], "plain_ms": bn_f32["plain_ms"], "bound_ms": bn_f32["bound_ms"],
        "bound_by": bn_f32["bound_by"], "issue_bound_ms": bn_f32["issue_bound_ms"],
        "library_ms": bn_f32["library_ms"],
        "per_kernel_ms": {k: bn_f32[f"{k}_ms"] for k in (
            "cluster_forward", "cluster_backward", "stats", "apply", "apply_eval",
            "grad_sums", "grad_apply", "forward", "backward")},
        "per_route": bn_f32["per_route"], "launches_a_step": bn_a_step,
        "bf16": {k: bn_t["bf16"][k] for k in ("ms", "plain_ms", "bound_ms",
                                               "issue_bound_ms", "library_ms",
                                               "per_route")}}, {
        "name": "grad_sq_norm", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/adam.cu",
        "replaces": "lesionvae_tpu/train/lowmem.py:132 (the global norm over the leaves; "
                    "XLA fusion, no Pallas kernel)",
        "launches": sum(v["grad_sq_norm"] for v in opt_launches.values()),
        "launches_by_path": {k: v["grad_sq_norm"] for k, v in opt_launches.items()},
        "max_abs_err": adam_checks["grad_sq_norm"]["max_abs_err"],
        "ms": norm_t["ms"], "plain_ms": norm_t["plain_ms"], "bound_ms": norm_t["bound_ms"],
        "bound_by": norm_t["bound_by"], "issue_bound_ms": norm_t["issue_bound_ms"],
        "library_ms": None,
        "library_note": no_library + "the gather of 36 strided leaves into packed rows "
                        "with a norm a member (the leaves' copies alone, graph-replayed: "
                        "copy_floor_informative_ms)",
        "copy_floor_informative_ms": norm_t["copy_floor_informative_ms"],
        "eager_ms": norm_t["eager_ms"], "by_kernel_us": norm_t["by_kernel_us"],
        "bf16": opt_t["grad_sq_norm_bf16"], "step_f32": opt_t["step_f32"],
        "step_bf16": opt_t["step_bf16"],
        "registers": {k: adam_sass[k]["registers"] for k in ("norm_tiles_kernel",
                                                             "norm_finish_kernel")},
        "occupancy": adam_sass["norm_tiles_kernel"]["occupancy"],
        "sass_per_element": adam_sass["norm_tiles_kernel"]["per"]}, {
        "name": "conv1d", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/conv1d.cu",
        "replaces": "lesionvae_tpu/models/layers.py:165 (Conv1d; ConvTranspose1d :189: nn.Conv "
                    "under the fleet step's jax.vmap, lesionvae_tpu/train/batched.py:241; an "
                    "XLA convolution, no Pallas kernel)",
        "launches": sum(v["conv_fwd"] + v["conv_wgrad"] for v in conv_launches.values()),
        "launches_by_path": conv_launches,
        "launches_a_step": conv_launches.get("vae-cohort", {}).get("a_step"),
        "max_abs_err": conv_checks["max_abs_err"], "ms": conv_f32["ms"],
        "plain_ms": conv_f32["plain_ms"], "bound_ms": conv_f32["bound_ms"],
        "bound_by": conv_f32["bound_by"], "library_ms": conv_f32["library_ms"],
        "library_note": "F.conv1d(groups=T) over the members' channels side by side and "
                        "its backward (cuDNN, TF32 off), graph-replayed",
        "chain_ms": conv_f32["chain_ms"], "forward_ms": conv_f32["forward_ms"],
        "backward_ms": conv_f32["backward_ms"], "share_of_bound": conv_f32["share_of_bound"],
        "bf16": {k: conv_short["bf16"][k] for k in ("ms", "forward_ms", "backward_ms",
                                                    "chain_ms", "library_ms", "plain_ms",
                                                    "bound_ms", "bound_by", "share_of_bound")},
        "tolerance": {k: v for k, v in conv_checks.items() if k != "max_abs_err"},
        "sass_per_product": conv_sass["sass"],
        "registers": {k: v["registers"] for k, v in conv_sass["occupancy"].items()}}, {
        "name": "adam_step", "route": "cuda",
        "source": "lesionvae_tpu_torch/ops/csrc/adam.cu",
        "replaces": "lesionvae_tpu/train/lowmem.py:97 (_fused_update's float32 branch; "
                    "XLA fusion, no Pallas kernel)",
        "launches": sum(v["adam_step"] for v in opt_launches.values()),
        "launches_by_path": {k: v["adam_step"] for k, v in opt_launches.items()},
        "max_abs_err": adam_checks["adam_step"]["max_abs_err"],
        "ms": upd_t["ms"], "plain_ms": upd_t["plain_ms"], "bound_ms": upd_t["bound_ms"],
        "bound_by": upd_t["bound_by"], "issue_bound_ms": upd_t["issue_bound_ms"],
        "library_ms": None,
        "library_note": no_library + "torch.optim.Adam(fused=True) neither clips by a "
                        "member's norm nor keeps a step count a member (timed as "
                        "fused_adam_informative_ms)",
        "fused_adam_informative_ms": opt_t["fused_adam_informative_ms"],
        "affine": opt_t["adam_step_affine"],
        "single": {"weights": opt_t["adam_step_single_weights"],
                   "affine": opt_t["adam_step_single_affine"],
                   "launches_by_path": {
                       "vae": opt_launches.get("vae", {}).get("adam_step")}},
        "registers": adam_sass["adam_kernel"]["registers"],
        "sass_per_element": adam_sass["adam_kernel"]["per"]}]}))
    print(f"[time] chip_smoke.py wall {time.perf_counter() - t_script:.1f}s; {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
