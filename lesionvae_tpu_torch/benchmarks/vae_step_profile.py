"""Where a training step of the full-width VAE spends its time.

    python -m lesionvae_tpu_torch.benchmarks.vae_step_profile [--steps 100] \
        [--route {bmm,graph}]
    python -m lesionvae_tpu_torch.benchmarks.vae_step_profile --fleet \
        [--members 64] [--store {f32,bf16}] [--dtype {f32,bf16}] [--steps 20] \
        [--route {bmm,grouped,vmap,graph}]

Trains the slice's model (seq 100, 13 + 3 channels, latent 10, about
2.74 M parameters) at batch 64 on random data with ``train_step``, the
step of ``train_lesion_vae``, on the card, and reports:

- the host wall-clock per step over ``--steps`` steps, ending in a
  synchronise (what a user of ``vae.train`` waits for);
- under ``torch.profiler``: the device time per step (the sum of kernel
  times), the device's busy share of the wall-clock, the kernels run per
  step, the host's launch calls per step (kernel launches, copies and
  graph launches) and the kernels that take the most device time.

With ``--fleet`` the step is ``fleet_step``, the step of
``launch_many_vaes``: ``--members`` models of that size trained as one
program, with float32 or bfloat16 storage of weights and moments and float32
or bfloat16 compute; the same readout, so that the launches of a fleet step
can be held against the single step's and 64 members as one program against
64 single steps.

``--route`` reads the same step with the members batched another way, to
hold the route the package uses (``bmm``: every convolution one batched
matrix product, ``models/fleet.py``) against the two it does not:
``grouped`` swaps each convolution of the stacked model for one cuDNN
convolution with a group a member; ``vmap`` takes the gradients as
``torch.func.vmap(torch.func.grad(...))`` over ``functional_call`` of the
single-member module with parameters and running statistics stacked (float32
storage and compute only).  All three train the same members with the same
optimizer and agree on the CPU (tests/test_torch_fleet.py).

``--route graph`` reads the form the package trains with on the card: the
step inside the training program (``train.trainer.TrainProgram``,
``train.batched.FleetProgram``), an epoch of ``EPOCH_STEPS`` steps captured
once as a CUDA graph and replayed, one ``cudaGraphLaunch`` an epoch; the
steps read are rounded up to whole epochs, and the first epoch of the
warm-up holds the capture.  ``bmm`` (the default) is the step as a Python
call of eager launches, as ``train_loop`` / ``train_fleet`` run it.

With ``--fleet`` the profiled steps also read the step's device time by
layer: ``models.fleet.LAYER_RANGES`` names a ``record_function`` range
after each layer of ``fleet_forward`` (conv, bn_relu, pool, resize, dense)
and each phase of ``fleet_step`` (loss, backward, optimizer), and every
device event (kernel, copy, memset) is given the range that was open when
the host launched it; ``other`` is the rest (the batch gather, the step's
bookkeeping).  A graph replay carries no ranges, so ``--route graph`` first
profiles one eager run of the program's epoch body and gives each replayed
event the range of the eager event at its place in the epoch (matched by
name).  One ``[layers]`` line prints device ms a step by range.

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
import torch.nn.functional as F

from ..models import fleet
from ..models.elbo import elbo
from ..models.fleet import FleetState, layout
from ..models.layers import KERNEL, PADDING
from ..models.lesion_vae import LesionConditionedVAE
from ..ops import sr_adam
from ..train import program as tprog
from ..train.batched import FleetProgram, fleet_step, init_state_dicts
from ..train.lowmem import LowmemOptimizer
from ..train.trainer import ClipDecayAdam, TrainProgram, train_step
from ..utils.precision import full_fp32

BATCH, SEQ, MICRO, LESION, LATENT = 64, 100, 13, 3, 10
# steps an epoch of the graph route: the paths' 925-960 rows at batch 64
EPOCH_STEPS = 15
# the host's calls that put work on the device: a kernel launch each, or a
# whole graph
HOST_LAUNCH_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                     "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                     "cudaMemsetAsync"}


# the ranges of models.fleet.layer_range, in the order of the [layers] line
LAYER_KINDS = ("conv", "bn_relu", "pool", "resize", "dense", "loss", "backward",
               "optimizer")
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
    ``layer:<kind>`` range.  A range is matched by time, not thread: the
    backward's launches come from autograd's device thread while the
    calling thread holds ``layer:backward``.  The layer ranges do not nest."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"][6:])
                   for e in _complete(events, ("user_annotation",))
                   if e["name"].startswith("layer:"))
    starts = [s[0] for s in spans]
    out = {}
    for e in _complete(events, LAUNCH_CATS):
        i = bisect.bisect_right(starts, float(e["ts"])) - 1
        if i >= 0 and float(e["ts"]) <= spans[i][1] and _correlation(e) is not None:
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


def _steps(module, opt, data, n: int) -> None:
    xm, xl, mask, eps = data
    for _ in range(n):
        train_step(module, opt, xm, xl, mask, eps, 1.0)


def _readout(run, steps: int, warm: int, layers=None) -> dict:
    """``run(n)`` takes n steps; times ``steps`` of them on the host's clock
    and again under the profiler.  ``layers(trace events)``, if given,
    labels the profiled device events by layer (``eager_layers``,
    ``replay_layers``): the profiled run opens the layer ranges and the
    readout gains ``layer_ms_per_step``."""
    from torch.profiler import ProfilerActivity, profile

    run(warm)   # warm-up: cuDNN heuristics, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(steps)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps

    fleet.LAYER_RANGES = layers is not None
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run(steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        fleet.LAYER_RANGES = False
    by_layer = {} if layers is None else {
        "layer_ms_per_step": layer_ms([(k, d) for _n, k, d in layers(trace_events(prof))],
                                      steps)}
    events = prof.key_averages()
    # the layer ranges' device spans are not kernels
    kernels = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.key.startswith("layer:")]
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
                            for e in top], **by_layer}


def _data(device, members: int = 0):
    """Random (xm, xl, mask, eps) for one step; with ``members`` a leading
    member axis."""
    lead = (members,) if members else ()
    g = np.random.default_rng(0)
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        g.normal(size=lead + (BATCH, SEQ, MICRO)),
        g.uniform(size=lead + (BATCH, SEQ, LESION)),
        np.ones(lead + (BATCH,)), g.normal(size=lead + (BATCH, LATENT))))


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


def _graph_readout(program, steps: int, warm: int, layers=None) -> dict:
    """``_readout`` of a loaded program: ``run(n)`` replays n / EPOCH_STEPS
    epochs from epoch 0 (the draws of ``_epochs_of(steps)`` epochs)."""
    def run(n: int) -> None:
        program.ep.zero_()
        program.graph.run(n // EPOCH_STEPS)

    tprog.reset_counts()
    out = _readout(run, EPOCH_STEPS * _epochs_of(steps), EPOCH_STEPS * _epochs_of(warm),
                   layers)
    out.update(epoch_steps=EPOCH_STEPS, graph_captures=tprog.COUNTS["captures"],
               graph_replays=tprog.COUNTS["replays"])
    return out


def _draws(device, epochs: int, members: int = 0):
    """Random permutations and noise of ``epochs`` epochs of EPOCH_STEPS
    batches; with ``members`` a leading member axis."""
    lead = (members,) if members else ()
    n_pad = EPOCH_STEPS * BATCH
    perms = torch.rand(lead + (epochs, n_pad)).argsort(dim=-1)
    noise = torch.randn(lead + (epochs, EPOCH_STEPS, BATCH, LATENT))
    return perms.to(device), noise.to(device)


def main(steps: int = 100, route: str = "bmm") -> dict:
    if route not in ("bmm", "graph"):
        raise ValueError("the single VAE reads --route bmm (eager) or graph")
    device = torch.device("cuda")
    full_fp32(device)
    torch.manual_seed(0)
    module = LesionConditionedVAE(SEQ, MICRO, LESION, LATENT).to(device)
    if route == "graph":
        n_pad = EPOCH_STEPS * BATCH
        epochs = _epochs_of(max(steps, 10))
        program = TrainProgram(n_pad, n_pad, tuple(sorted(module.hyperparameters().items())),
                               None, epochs, BATCH, 2e-4, 1e-3, 2.0, device, torch.float32)
        g = np.random.default_rng(0)
        Xm, Xl = (torch.from_numpy(a.astype(np.float32)).to(device) for a in (
            g.normal(size=(n_pad, SEQ, MICRO)), g.uniform(size=(n_pad, SEQ, LESION))))
        program.load(module, Xm, Xl, *_draws(device, epochs))
        out = _graph_readout(program, steps, warm=10)
    else:
        opt = ClipDecayAdam(module, 2e-4, 1e-3, 2.0)
        data = _data(device)
        out = _readout(lambda n: _steps(module, opt, data, n), steps, warm=10)
    out.update(route=route, params=sum(p.numel() for p in module.parameters()),
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(json.dumps(out))
    return out


def conv_grouped(h: torch.Tensor, leaves, name: str, cd, transpose=False
                 ) -> torch.Tensor:
    """``models.fleet._conv`` as one convolution with a group a member: the
    members' channels side by side, (N, T*C_in, L), and their kernels
    stacked, (T*C_out, C_in, k)."""
    w = fleet._widen(leaves[f"{name}.weight"], cd)
    b = fleet._widen(leaves[f"{name}.bias"], cd)
    T, N, L, C = h.shape
    if transpose:
        # (T, in, out, k) -> (T, out, in, k), reversed along k
        w = w.flip(3).transpose(1, 2)
    assert w.shape[3] == KERNEL
    x = h.permute(1, 0, 3, 2).reshape(N, T * C, L)
    y = F.conv1d(x, w.reshape(-1, C, KERNEL), b.reshape(-1), padding=PADDING,
                 groups=T)
    return y.view(N, T, -1, L).permute(1, 0, 3, 2)


def fleet_step_vmap(state: FleetState, opt: LowmemOptimizer,
                    module: LesionConditionedVAE, xm, xl, mask, eps,
                    beta: float) -> torch.Tensor:
    """``train.batched.fleet_step`` with the members batched by
    ``torch.func.vmap``: ``module`` (in train mode) gives the function of one
    member; each member's BatchNorm writes its own row of the stacked
    running statistics.  Returns the members' losses."""
    from torch.func import functional_call, grad, vmap

    def loss_fn(params, stats, xm, xl, mask, eps):
        xh, mu, logv = functional_call(module, (params, stats), (xm, xl, mask, eps))
        loss = elbo(xh, xm, mu, logv, beta, mask)[0]
        return loss, loss

    params = {name: t.detach() for name, t in state.leaves.items()}
    grads, loss = vmap(grad(loss_fn, has_aux=True))(params, state.stats, xm, xl,
                                                    mask, eps)
    opt.step(grads, torch.isfinite(loss))
    return loss


def main_fleet(members: int = 64, store: str = "f32", dtype: str = "f32",
               steps: int = 20, route: str = "bmm") -> dict:
    if route == "vmap" and (store, dtype) != ("f32", "f32"):
        raise ValueError("--route vmap reads float32 storage and compute only")
    device = torch.device("cuda")
    full_fp32(device)
    lay = layout(SEQ, MICRO, LESION, LATENT)
    bf16 = {"f32": None, "bf16": torch.bfloat16}
    state = FleetState.from_state_dicts(
        init_state_dicts(members, lay.hyper, 0), lay, torch.float32, bf16[store],
        device)
    warm = 3
    sr_adam.sr_adam_step.launches = 0
    if route == "graph":
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
        out = _graph_readout(program, steps, warm,
                             lambda events: replay_layers(eager, events))
        # steps replayed, and the epoch run eagerly before each capture
        calls = EPOCH_STEPS * (_epochs_of(warm) + 2 * _epochs_of(steps)
                               + out["graph_captures"])
        out.update(members=members, store=store, dtype=dtype, route=route,
                   params_per_member=lay.n_weights + lay.n_affine,
                   sr_adam_launches_per_step=sr_adam.sr_adam_step.launches / calls,
                   peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
        return _print_fleet(out)
    opt = LowmemOptimizer(state, 2e-4, 1e-3, 2.0)
    xm, xl, mask, eps = _data(device, members)

    module = LesionConditionedVAE(**lay.hyper).to(device).train()

    def run(n: int) -> None:
        for _ in range(n):
            if route == "vmap":
                fleet_step_vmap(state, opt, module, xm, xl, mask, eps, 1.0)
            else:
                fleet_step(state, opt, xm, xl, mask, eps, 1.0, bf16[dtype])

    conv = fleet._conv
    if route == "grouped":
        fleet._conv = conv_grouped
    try:
        out = _readout(run, steps, warm, eager_layers)
    finally:
        fleet._conv = conv
    out.update(members=members, store=store, dtype=dtype, route=route,
               params_per_member=lay.n_weights + lay.n_affine,
               sr_adam_launches_per_step=sr_adam.sr_adam_step.launches
               / (warm + 2 * steps),
               peak_device_gb=torch.cuda.max_memory_allocated() / 1e9)
    return _print_fleet(out)


def _print_fleet(out: dict) -> dict:
    """The ``[layers]`` line, then the readout's JSON line."""
    print(f"[layers] {out['members']} members, store {out['store']}, compute "
          f"{out['dtype']}, route {out['route']}: device ms a step by range "
          + json.dumps({k: round(v, 4) for k, v in out["layer_ms_per_step"].items()})
          + f"; {out['device']}")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--fleet", action="store_true")
    ap.add_argument("--members", type=int, default=64)
    ap.add_argument("--store", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--dtype", choices=["f32", "bf16"], default="f32")
    ap.add_argument("--route", choices=["bmm", "grouped", "vmap", "graph"],
                    default="bmm",
                    help="bmm: the step as eager launches; graph: inside the "
                         "training program, an epoch a graph replay (the form "
                         "the package trains with on the card); with --fleet, "
                         "grouped and vmap batch the members the two ways the "
                         "package does not use")
    a = ap.parse_args()
    if a.fleet:
        main_fleet(a.members, a.store, a.dtype, a.steps or 20, a.route)
    else:
        main(a.steps or 100, a.route)
