"""Optimizer probe: what does keeping p/m/v resident buy the VAE fleet's
optimizer on one card?

    python -m lesionvae_tpu_torch.benchmarks.opt_probe [--fastmath] [K ...]   (default K = 1 10 30)

The counterpart of ``benchmarks/pallas_opt_probe.py::main``.  Both arms run
K Adam steps over T members x P parameters stored as bf16, with the
synthetic gradient ``g = 0.999*p + c`` and p/m/v rounded to bf16 after every
step (the fleet's bf16-storage semantics).  ``--fastmath`` takes the JAX
probe's ``PROBE_FASTMATH`` form of the step, eps inside one rsqrt, which
asks how much of a resident step is the divide/sqrt chain:

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

import argparse
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..ops.resident_adam import FORMS, resident_adam, resident_adam_plain
from ..utils.cost_model import kernel_bound_ms
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
# Special-function operations an element-step: the reciprocal seed of the
# quotient and the rsqrt seed of the root; the fast-math form's one rsqrt.
SFU_PER_ELEMENT_STEP = {"ieee": 2, "fastmath": 1}
# The least instructions an element-step that either form can be written in
# (one issue slot each; nothing is dual-issued on this card).
#   ieee: 12 plain FP32 operations (GA*p, +c; B1*m, (1-B1)*g, +; B2*v,
#     (1-B2)*g, *g, +; +EPS, *LR, p-), none of which may fuse into an FMA
#     because each rounds on its own; a correctly rounded quotient in 6 (the
#     reciprocal seed, one Newton step on it in 2 FMAs, the quotient, its
#     exact residual, the correction: with a seed good to 1 ulp nothing
#     shorter rounds correctly in every case); a correctly rounded root in 5
#     (the rsqrt seed, s = v*r, h = r/2, the exact residual v - s*s, the
#     correction); and the three roundings to bf16 in 4.5 (one convert for
#     two values, one shift or mask a value to read it back as float32).
#     12 + 6 + 5 + 4.5 = 27.5, the range tests of quotient and root not
#     counted.
#   fastmath: 13 plain FP32 operations (as above without +EPS, with v'+EPS^2
#     and a second product in place of the quotient), one rsqrt, and the same
#     4.5 for the roundings: 18.5.
MIN_INSTRUCTIONS_PER_ELEMENT_STEP = {"ieee": 27.5, "fastmath": 18.5}
assert set(FORMS) == set(SFU_PER_ELEMENT_STEP) == set(MIN_INSTRUCTIONS_PER_ELEMENT_STEP)


def make_inputs(T: int, P: int, device="cuda"):
    """p ~ 0.02*N(0, 1), m = v = 0, bf16, from ``default_rng(0)`` as at
    pallas_opt_probe.py:163-166."""
    rng = np.random.default_rng(0)
    p0 = torch.from_numpy(rng.normal(size=(T, P)) * 0.02).to(device)
    p0 = p0.to(torch.bfloat16)
    return p0, torch.zeros_like(p0), torch.zeros_like(p0)


def run_plain(p0, m0, v0, k: int, c: float = GC, form: str = "ieee"):
    p, _m, _v = resident_adam_plain(p0, m0, v0, k, c, form)
    return p.float().sum(), p[:1, :LANES]


def run_resident(p0, m0, v0, k: int, c: float = GC, form: str = "ieee"):
    p, _m, _v = resident_adam(p0, m0, v0, k, c, form)
    return p.float().sum(), p[:1, :LANES]


def bound_ms(n: int, k: int, form: str = "ieee") -> dict:
    """Least time for K steps over n elements on the card
    (``utils.cost_model.kernel_bound_ms``): 12 bytes an element once, 20
    FP32 operations an element-step (the same for both forms, so that rows
    compare), and the form's least instructions and special-function
    operations an element-step for the issue bound."""
    return kernel_bound_ms(BYTES_PER_ELEMENT * n, OPS_PER_ELEMENT_STEP * n * k,
                           MIN_INSTRUCTIONS_PER_ELEMENT_STEP[form] * n * k,
                           SFU_PER_ELEMENT_STEP[form] * n * k)


def compare(got, want) -> Dict[str, float]:
    """Whole-output agreement of two (p, m, v) triples: the largest
    |got - want|, the share of elements that differ at all, the largest
    difference in bf16 ulps of the larger magnitude, and whether every
    element is within the probe's rtol/atol.  Two NaNs, and two infinities
    of one sign, agree."""
    err, ulps, differ, ok, total = 0.0, 0.0, 0, True, 0
    for a, b in zip(got, want):
        a, b = a.float(), b.float()
        same = (a == b) | (a.isnan() & b.isnan())
        d = torch.where(same, torch.zeros_like(a), (a - b).abs())
        if d.numel():
            err = max(err, float(d.max()))
            # one bf16 ulp at x is 2^(floor(log2 |x|) - 7)
            mag = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -126)
            u = d / torch.exp2(torch.floor(torch.log2(mag)) - 7)
            ulps = max(ulps, float(torch.where(same, torch.zeros_like(a),
                                               u.nan_to_num(nan=float("inf"))).max()))
        differ += int((~same).sum())
        total += a.numel()
        ok &= bool((d <= ATOL + RTOL * b.abs()).all())
    return {"max_abs_err": err, "share_differing": differ / max(total, 1),
            "max_ulps": ulps, "within_tol": ok}


def check_k(p0, m0, v0, k: int, form: str = "ieee") -> dict:
    """Both arms at K on the same inputs: the kernel's whole output against
    the plain loop's (``compare``) and each arm's checksum, as the JAX
    probe returns it.  Raises if the output leaves the probe's tolerance."""
    agree = compare(resident_adam(p0, m0, v0, k, GC, form),
                    resident_adam_plain(p0, m0, v0, k, GC, form))
    if not agree["within_tol"]:
        raise AssertionError(
            f"resident kernel vs plain loop ({form}) at K={k}: max abs err "
            f"{agree['max_abs_err']:.3e} outside rtol={RTOL}, atol={ATOL}")
    return {"k": k, "form": form, **agree,
            "checksum_plain": float(run_plain(p0, m0, v0, k, GC, form)[0]),
            "checksum_resident": float(run_resident(p0, m0, v0, k, GC, form)[0])}


def main(ks: Optional[Sequence[int]] = None, T: int = T_MEMBERS,
         P: int = P_PARAMS, form: str = "ieee") -> List[dict]:
    """Run both arms at every K on the card, in the IEEE or the fast-math
    form, and time them; raise if the kernel's output leaves the probe's
    tolerance anywhere.  Returns one dict per K, with the kernel's launches
    at that K."""
    ks = list(ks) if ks else [1, 10, 30]
    n = T * P
    print(f"[opt_probe] {torch.cuda.get_device_name()}: form {form}, T={T} P={P} "
          f"({n / 1e6:.1f}M params, {3 * n * 2 / 1e9:.2f} GB p+m+v bf16)", flush=True)
    p0, m0, v0 = make_inputs(T, P, "cuda")
    gb_per_step = 6 * n * 2 / 1e9   # p/m/v read + write, bf16
    out = []
    for k in ks:
        launched = resident_adam.launches
        res = {"T": T, "P": P, **check_k(p0, m0, v0, k, form)}
        # the plain loop takes 10 ms a step: fewer, single calls suffice
        res["plain_ms"] = device_ms(
            lambda: resident_adam_plain(p0, m0, v0, k, GC, form),
            reps=5, inner=1)
        res["resident_ms"] = device_ms(lambda: resident_adam(p0, m0, v0, k, GC, form))
        for name in ("plain", "resident"):
            ms = res[f"{name}_ms"]
            res[f"{name}_ms_per_step"] = ms / max(k, 1)
            res[f"{name}_gbps"] = gb_per_step * k / (ms / 1e3)
        res.update(bound_ms(n, k, form))
        res["launches"] = resident_adam.launches - launched
        print(f"[opt_probe {form} K={k:3d}] plain {res['plain_ms']:9.3f} ms "
              f"({res['plain_ms_per_step']:.3f} ms/step, "
              f"{res['plain_gbps']:.0f} GB/s) | resident {res['resident_ms']:9.3f} ms "
              f"({res['resident_ms_per_step']:.3f} ms/step, "
              f"{res['resident_gbps']:.0f} GB/s stream-equivalent) | ratio "
              f"{res['plain_ms'] / res['resident_ms']:.2f}x | bound "
              f"{res['bound_ms']:.3f} ms ({res['bound_by']}), issue bound "
              f"{res['issue_bound_ms']:.3f} ms | max abs err "
              f"{res['max_abs_err']:.3e}, {100 * res['share_differing']:.4f}% "
              f"of elements differ (at most {res['max_ulps']:.2f} bf16 ulps) "
              f"| checksums {res['checksum_plain']:.6f} / "
              f"{res['checksum_resident']:.6f}", flush=True)
        out.append(res)
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ks", nargs="*", type=int, metavar="K",
                    help="steps per call (default 1 10 30)")
    ap.add_argument("--fastmath", action="store_true",
                    help="the fast-math form: p - (LR*m')*rsqrt(v' + EPS*EPS)")
    args = ap.parse_args()
    main(args.ks or None, form="fastmath" if args.fastmath else "ieee")
