"""Optimizer probe: what does keeping p/m/v resident buy the VAE fleet's
optimizer on one card?

    python -m lesionvae_tpu_torch.benchmarks.opt_probe [K ...]      (default K = 1 10 30)

The counterpart of ``benchmarks/pallas_opt_probe.py::main``.  Both arms run
K Adam steps over T members x P parameters stored as bf16, with the
synthetic gradient ``g = 0.999*p + c`` and p/m/v rounded to bf16 after every
step (the fleet's bf16-storage semantics):

  plain     ``resident_adam_plain``: a PyTorch loop whose every step streams
            p/m/v through device memory (the probe's "xla" arm);
  resident  ``resident_adam``: the CUDA kernel, which reads p/m/v once, runs
            the K steps in registers and writes them once (the "residency
            ceiling": real training cannot block the parameter axis like
            this, since gradients need the whole member's forward/backward).

Each arm returns the float32 checksum of p and its first row, as the JAX
probe does; ``main`` holds the kernel's whole output against the plain
loop's and prints ms per call, ms per step and GB/s for both arms, timed
on the card with CUDA events (``utils.profiling.device_ms``).  It times the
K steps alone: the JAX probe's times include the checksum, its completion
barrier over a remote link, which a CUDA event makes needless.
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.resident_adam import resident_adam, resident_adam_plain
from ..utils.profiling import device_ms

T_MEMBERS = 64
P_PARAMS = 2800 * 1024   # ~ the VAE's 2.74 M parameters
GC = 1e-3                # the synthetic gradient's constant
LANES = 256              # width of the "first row" the arms return
RTOL, ATOL = 1e-2, 1e-4  # the JAX probe's own check (pallas_opt_probe.py:176)
# FP32 operations per element-step: 14 arithmetic (GA*p + c: 2; m': 3;
# v': 4; p': sqrt, +EPS, /, *LR, -: 5) and 6 bf16<->f32 conversions
OPS_PER_ELEMENT_STEP = 20
BYTES_PER_ELEMENT = 12   # p, m, v as bf16, each read once and written once
# NVIDIA H100 SXM data sheet: FP32 outside the tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def make_inputs(T: int, P: int, device="cuda"):
    """p ~ 0.02*N(0, 1), m = v = 0, bf16, from ``default_rng(0)`` as at
    pallas_opt_probe.py:163-166."""
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.normal(size=(T, P)) * 0.02).to(device)
    p0 = p0.to(torch.bfloat16)
    return p0, torch.zeros_like(p0), torch.zeros_like(p0)


def run_plain(p0, m0, v0, k: int, c: float = GC):
    p, _m, _v = resident_adam_plain(p0, m0, v0, k, c)
    return p.float().sum(), p[:1, :LANES]


def run_resident(p0, m0, v0, k: int, c: float = GC):
    p, _m, _v = resident_adam(p0, m0, v0, k, c)
    return p.float().sum(), p[:1, :LANES]


def bound_ms(n: int, k: int):
    """Least time for K steps over n elements on an H100 SXM: the larger of
    12 bytes an element once over 3.35 TB/s and 20 FP32 operations an
    element-step over 67 TFLOP/s.  Returns (ms, "bytes" or "operations")."""
    t_bytes = BYTES_PER_ELEMENT * n / PEAK_BYTES_PER_S
    t_ops = OPS_PER_ELEMENT_STEP * n * k / PEAK_FP32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes")


def compare(got, want) -> Dict[str, float]:
    """Whole-output agreement of two (p, m, v) triples: the largest
    |got - want|, the share of elements that differ at all, and whether
    every element is within the probe's rtol/atol."""
    err, differ, ok, total = 0.0, 0, True, 0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        d = (a - b).abs()
        err = max(err, float(d.max())) if d.numel() else err
        differ += int((a != b).sum())
        total += a.numel()
        ok &= bool((d <= ATOL + RTOL * b.abs()).all())
    return {"max_abs_err": err, "share_differing": differ / max(total, 1),
            "within_tol": ok}


def check_k(p0, m0, v0, k: int) -> dict:
    """Both arms at K on the same inputs: the kernel's whole output against
    the plain loop's (``compare``) and each arm's checksum, as the JAX
    probe returns it.  Raises if the output leaves the probe's tolerance."""
    agree = compare(resident_adam(p0, m0, v0, k, GC),
                    resident_adam_plain(p0, m0, v0, k, GC))
    if not agree["within_tol"]:
        raise AssertionError(
            f"resident kernel vs plain loop at K={k}: max abs err "
            f"{agree['max_abs_err']:.3e} outside rtol={RTOL}, atol={ATOL}")
    return {"k": k, **agree,
            "checksum_plain": float(run_plain(p0, m0, v0, k)[0]),
            "checksum_resident": float(run_resident(p0, m0, v0, k)[0])}


def main(ks: Optional[Sequence[int]] = None, T: int = T_MEMBERS,
         P: int = P_PARAMS) -> List[dict]:
    """Run both arms at every K on the card and time them; raise if the
    kernel's output leaves the probe's tolerance anywhere.  Returns one dict
    per K, with the kernel's launches at that K."""
    ks = list(ks) if ks else [1, 10, 30]
    n = T * P
    print(f"[opt_probe] {torch.cuda.get_device_name()}: T={T} P={P} "
          f"({n / 1e6:.1f}M params, {3 * n * 2 / 1e9:.2f} GB p+m+v bf16)", flush=True)
    p0, m0, v0 = make_inputs(T, P, "cuda")
    gb_per_step = 6 * n * 2 / 1e9   # p/m/v read + write, bf16
    out = []
    for k in ks:
        launched = resident_adam.launches
        res = {"T": T, "P": P, **check_k(p0, m0, v0, k)}
        # the plain loop takes 10 ms a step: fewer, single calls suffice
        res["plain_ms"] = device_ms(lambda: resident_adam_plain(p0, m0, v0, k, GC),
                                    reps=5, inner=1)
        res["resident_ms"] = device_ms(lambda: resident_adam(p0, m0, v0, k, GC))
        for name in ("plain", "resident"):
            ms = res[f"{name}_ms"]
            res[f"{name}_ms_per_step"] = ms / max(k, 1)
            res[f"{name}_gbps"] = gb_per_step * k / (ms / 1e3)
        res["bound_ms"], res["bound_by"] = bound_ms(n, k)
        res["launches"] = resident_adam.launches - launched
        print(f"[opt_probe K={k:3d}] plain {res['plain_ms']:9.3f} ms "
              f"({res['plain_ms_per_step']:.3f} ms/step, "
              f"{res['plain_gbps']:.0f} GB/s) | resident {res['resident_ms']:9.3f} ms "
              f"({res['resident_ms_per_step']:.3f} ms/step, "
              f"{res['resident_gbps']:.0f} GB/s stream-equivalent) | ratio "
              f"{res['plain_ms'] / res['resident_ms']:.2f}x | bound "
              f"{res['bound_ms']:.3f} ms ({res['bound_by']}) | max abs err "
              f"{res['max_abs_err']:.3e}, {100 * res['share_differing']:.4f}% "
              f"of elements differ | checksums {res['checksum_plain']:.6f} / "
              f"{res['checksum_resident']:.6f}", flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or None)
