"""Where a training step of the full-width VAE spends its time.

    python -m lesionvae_tpu_torch.benchmarks.vae_step_profile [--steps 100]

Trains the slice's model (seq 100, 13 + 3 channels, latent 10, about
2.74 M parameters) at batch 64 on random data with ``train_step``, the
step of ``train_lesion_vae``, on the card, and reports:

- the host wall-clock per step over ``--steps`` steps, ending in a
  synchronise (what a user of ``vae.train`` waits for);
- under ``torch.profiler``: the device time per step (the sum of kernel
  times), the device's busy share of the wall-clock, the kernel launches
  per step and the kernels that take the most device time.

One JSON line closes the output.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..models.lesion_vae import LesionConditionedVAE
from ..train.trainer import ClipDecayAdam, train_step
from ..utils.precision import full_fp32

BATCH, SEQ, MICRO, LESION, LATENT = 64, 100, 13, 3, 10


def _steps(module, opt, data, n: int) -> None:
    xm, xl, mask, eps = data
    for _ in range(n):
        train_step(module, opt, xm, xl, mask, eps, 1.0)


def main(steps: int = 100) -> dict:
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda")
    full_fp32(device)
    torch.manual_seed(0)
    module = LesionConditionedVAE(SEQ, MICRO, LESION, LATENT).to(device)
    opt = ClipDecayAdam(module, 2e-4, 1e-3, 2.0)
    g = np.random.default_rng(0)
    data = tuple(torch.from_numpy(a.astype(np.float32)).to(device) for a in (
        g.normal(size=(BATCH, SEQ, MICRO)), g.uniform(size=(BATCH, SEQ, LESION)),
        np.ones(BATCH), g.normal(size=(BATCH, LATENT))))

    _steps(module, opt, data, 10)   # warm-up: cuDNN heuristics, allocator
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _steps(module, opt, data, steps)
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0) / steps

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _steps(module, opt, data, steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    dev_us = sum(e.self_device_time_total for e in kernels)
    top = sorted(kernels, key=lambda e: e.self_device_time_total, reverse=True)[:12]
    out = {"device": torch.cuda.get_device_name(device), "steps": steps,
           "params": sum(p.numel() for p in module.parameters()),
           "host_ms_per_step": host_ms,
           "profiled_wall_ms_per_step": 1e3 * wall / steps,
           "device_ms_per_step": dev_us / 1e3 / steps,
           "device_busy_share": dev_us / 1e6 / wall,
           "kernel_launches_per_step": sum(e.count for e in kernels) / steps,
           "top_kernels": [{"name": e.key[:90], "calls_per_step": e.count / steps,
                            "us_per_step": e.self_device_time_total / steps}
                           for e in top]}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=100)
    main(ap.parse_args().steps)
