"""Where a training step of the full-width VAE spends its time on the card.

    python -m lesionvae_tpu_torch.benchmarks.vae_step_profile [--members 64] \
        [--store {f32,bf16}] [--dtype {f32,bf16}] [--steps 20]

Reads the step as the package trains it on the card: ``--members`` VAEs of
the slice's width (seq 100, 13 + 3 channels, latent 10, about 2.74 M
parameters each) at batch 64 on random data, inside the training program
(``train.batched.FleetProgram``), with float32 or bfloat16 storage of
weights and moments and float32 or bfloat16 compute.  ``--members 1`` is
the single VAE: the ``vae`` stage trains the one-member program.  An epoch
of ``EPOCH_STEPS`` steps is captured once as a CUDA graph and replayed, one
``cudaGraphLaunch`` an epoch; the steps read are rounded up to whole
epochs, and the first epoch of the warm-up holds the capture.  It reports:

- the host wall-clock per step over ``--steps`` steps, ending in a
  synchronise;
- under ``torch.profiler``: the device time per step (the sum of kernel
  times), the device's busy share of the wall-clock, the kernels run per
  step, the host's launch calls per step (kernel launches, copies and
  graph launches) and the kernels that take the most device time;
- the step's device time by layer: ``models.fleet.LAYER_RANGES`` names a
  ``record_function`` range after each layer of ``fleet_forward`` (conv,
  bn_relu, pool, resize, dense), each phase of ``fleet_step`` (loss,
  backward, optimizer) and the convolutions' backward inside ``backward``
  (conv_backward).  A graph replay carries no ranges, so one eager run of
  the program's epoch body is profiled first, every device event (kernel,
  copy, memset) given the range that was open when the host launched it,
  and each replayed event is given the range of the eager event at its
  place in the epoch (matched by name); ``other`` is the rest (the batch
  gather, the step's bookkeeping).  One ``[layers]`` line prints device ms
  a step by range.

One JSON line closes the output.
"""

from __future__ import annotations

import argparse
import bisect
import json
import os
import tempfile
import time
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..models import fleet
from ..models.fleet import FleetState, layout
from ..ops import sr_adam
from ..train import program as tprog
from ..train.batched import FleetProgram, init_state_dicts
from ..utils.precision import full_fp32

BATCH, SEQ, MICRO, LESION, LATENT = 64, 100, 13, 3, 10
# steps an epoch: the paths' 925-960 rows at batch 64
EPOCH_STEPS = 15
# the host's calls that put work on the device: a kernel launch each, or a
# whole graph
HOST_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync"}


# the ranges of models.fleet.layer_range, in the order of the [layers] line
LAYER_KINDS = ("conv", "bn_relu", "pool", "resize", "dense", "loss", "backward",
               "conv_backward", "optimizer")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def trace_events(prof) -> list:
    """The Chrome trace events of a finished ``torch.profiler`` profile."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def _complete(events, cats) -> list:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def _correlation(e):
    return (e.get("args") or {}).get("correlation")


def device_sequence(events) -> List[dict]:
    """The device events (kernels, copies, memsets) in the order they ran."""
    return sorted(_complete(events, DEVICE_CATS), key=lambda e: float(e["ts"]))


def launch_kinds(events) -> Dict[int, str]:
    """{correlation id: layer kind} of every host launch made inside a
    ``layer:<kind>`` range, the innermost one open at the launch (the
    convolutions' ``layer:conv_backward`` ranges open inside
    ``layer:backward``; no other range nests).  A range is matched by time,
    not thread: the backward's launches come from autograd's device thread
    while the calling thread holds ``layer:backward``."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][6:])
                   for e in _complete(events, ("user_annotation",))
                   if e["name"].startswith("layer:"))
    starts = [s[0] for s in spans]
    out = {}
    for e in _complete(events, LAUNCH_CATS):
        ts = float(e["ts"])
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ts > spans[i][1]:
            i -= 1
        if i >= 0 and _correlation(e) is not None:
            out[_correlation(e)] = spans[i][2]
    return out


def layer_ms(labelled: Sequence[Tuple[str, float]], steps: int) -> Dict[str, float]:
    """Device ms a step by kind from (kind, duration in us) pairs."""
    out = {k: 0.0 for k in LAYER_KINDS + ("other",)}
    for kind, dur in labelled:
        out[kind if kind in out else "other"] += dur / 1e3 / steps
    out["total"] = sum(out.values())
    return out


def eager_layers(events) -> List[Tuple[str, str, float]]:
    """(kernel name, kind, duration us) of each device event of an eager
    profile, in the order they ran."""
    kinds = launch_kinds(events)
    return [(e["name"], kinds.get(_correlation(e), "other"), float(e["dur"]))
            for e in device_sequence(events)]


def replay_layers(eager: Sequence[Tuple[str, str, float]], events,
                  window: int = 64) -> List[Tuple[str, str, float]]:
    """Each device event of the graph replays in ``events`` given the kind of
    the event at its place in ``eager`` (one eager run of the captured
    body): the replayed events are walked in order against the eager ones,
    epoch after epoch, matched by name; an event whose name does not come
    within ``window`` places of the walk is ``other`` (an eager launch
    between replays)."""
    out, j, n = [], 0, len(eager)
    for e in device_sequence(events):
        k = next((k for k in range(j, j + min(window, n)) if eager[k % n][0] == e["name"]),
                 None)
        if k is None:
            out.append((e["name"], "other", float(e["dur"])))
        else:
            j = k + 1
            out.append((e["name"], eager[k % n][1], float(e["dur"])))
    return out


def _readout(program, steps: int, warm: int, eager) -> dict:
    """Times ``steps`` steps of a loaded program on the host's clock and
    again under the profiler, each run replaying whole epochs from epoch 0
    (the draws of ``_epochs_of(steps)`` epochs) after ``warm`` steps of
    warm-up; the profiled device events are labelled by layer against
    ``eager`` (``_epoch_layers``) for ``layer_ms_per_step``."""
    from torch.profiler import ProfilerActivity, profile

    def run(n: int) -> None:
        program.ep.zero_()
        program.graph.run(n // EPOCH_STEPS)

    steps, warm = EPOCH_STEPS * _epochs_of(steps), EPOCH_STEPS * _epochs_of(warm)
    tprog.reset_counts()
    run(warm)   # warm-up: the capture, the allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    labelled = replay_layers(eager, trace_events(prof))
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    calls = sum(e.count for e in events if e.key in HOST_LAUNCH_CALLS)
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    return {"device": torch.cuda.get_device_name(0), "steps": steps,
            "host_ms_per_step": host_ms,
            "profiled_wall_ms_per_step": 1e3 * wall / steps,
            "device_ms_per_step": dev_us / 1e3 / steps,
            "device_busy_share": dev_us / 1e6 / wall,
            "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
            "host_launch_calls_per_step": calls / steps,
            "top_kernels": [{"name": e.key[:90], "calls_per_step": e.count / steps,
                             "us_per_step": e.self_device_time_total / steps}
                            for e in top],
            "layer_ms_per_step": layer_ms([(k, d) for _n, k, d in labelled], steps),
            "epoch_steps": EPOCH_STEPS, "graph_captures": tprog.COUNTS["captures"],
            "graph_replays": tprog.COUNTS["replays"]}


def _epochs_of(steps: int) -> int:
    return -(-steps // EPOCH_STEPS)


def _epoch_layers(program) -> List[Tuple[str, str, float]]:
    """``eager_layers`` of one eager run of a fleet program's epoch body
    (it advances the program's state; the epoch counter is reset)."""
    from torch.profiler import ProfilerActivity, profile

    fleet.LAYER_RANGES = True
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            program.epoch()
            torch.cuda.synchronize()
    finally:
        fleet.LAYER_RANGES = False
    program.ep.zero_()
    return eager_layers(trace_events(prof))


def _draws(device, epochs: int, members: int):
    """Random permutations and noise of ``members`` x ``epochs`` epochs of
    EPOCH_STEPS batches."""
    n_pad = EPOCH_STEPS * BATCH
    perms = torch.rand((members, epochs, n_pad)).argsort(dim=-1)
    noise = torch.randn((members, epochs, EPOCH_STEPS, BATCH, LATENT))
    return perms.to(device), noise.to(device)


def main(members: int = 64, store: str = "f32", dtype: str = "f32",
         steps: int = 20) -> dict:
    """The readout of ``members`` VAEs' training program; prints the
    ``[layers]`` line and the JSON line."""
    device = torch.device("cuda")
    full_fp32(device)
    lay = layout(SEQ, MICRO, LESION, LATENT)
    bf16 = {"f32": None, "bf16": torch.bfloat16}
    state = FleetState.from_state_dicts(
        init_state_dicts(members, lay.hyper, 0), lay, torch.float32, bf16[store],
        device)
    warm = 3
    n_pad = EPOCH_STEPS * BATCH
    epochs = _epochs_of(max(steps, warm))
    program = FleetProgram(lay, members, n_pad, epochs, BATCH, 2e-4, 1e-3, 2.0,
                           bf16[store], bf16[dtype], False, device, torch.float32)
    g = np.random.default_rng(0)
    Xm, Xl = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        g.normal(size=(members, n_pad, SEQ, MICRO)),
        g.uniform(size=(members, n_pad, SEQ, LESION))))
    program.load(state, torch.arange(members), Xm, Xl,
                 torch.full((members,), n_pad, device=device),
                 *_draws(device, epochs, members))
    eager = _epoch_layers(program)
    sr_adam.sr_adam_step.launches = 0   # count only the epochs of ``calls``
    out = _readout(program, steps, warm, eager)
    # steps replayed, and the epoch run eagerly before each capture
    calls = EPOCH_STEPS * (_epochs_of(warm) + 2 * _epochs_of(steps) + out["graph_captures"])
    out.update(members=members, store=store, dtype=dtype,
               params_per_member=lay.n_weights + lay.n_affine,
               sr_adam_launches_per_step=sr_adam.sr_adam_step.launches / calls,
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"[layers] {members} members, store {store}, compute {dtype}: device ms a "
          "step by range "
          + json.dumps({k: round(v, 4) for k, v in out["layer_ms_per_step"].items()})
          + f"; {out['device']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--members", type=int, default=64,
                    help="VAEs trained as one program; 1 is the single VAE")
    ap.add_argument("--store", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--steps", type=int, default=20)
    a = ap.parse_args()
    main(a.members, a.store, a.dtype, a.steps)
