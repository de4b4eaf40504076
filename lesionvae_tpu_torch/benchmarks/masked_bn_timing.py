"""Device time of the fleet's masked BatchNorm + ReLU kernels
(``ops/csrc/masked_bn.cu``) at the shapes of the cohort path's fleet step.

    python -m lesionvae_tpu_torch.benchmarks.masked_bn_timing

For float32 and bf16 activations, on the card (CUDA events, median of 25 x
20 launches after a backlog, ``utils.profiling.device_ms``): each kernel
over the seven layers of one 64-member step (64 members x batch 64 x the
layers' L x C, pad rows in every member), the seven layers' forward
(training: statistics + apply) and backward (gradient sums + gradient) as
the sums of those device times (timing the wrappers end to end would add
their host time wherever it outruns the backlog), the plain version (3 x
2), and, as a yardstick the port never calls, ``F.batch_norm(training=True)``
+ ReLU with their backward on the same values unmasked, laid out (N*L,
T*C); beside ``ops.masked_bn.bound_ms``.  One JSON line holds the
readings and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess

import torch
import torch.nn.functional as F

from ..ops import masked_bn as mb
from ..utils.cost_model import bn_layers
from ..utils.profiling import device_ms

MEMBERS, BATCH = 64, 64     # the cohort path's fleet step
OUTPUTS = ("y", "mean", "var", "running_mean", "running_var", "dx", "dweight", "dbias")


def bn_case(L: int, C: int, dtype, seed: int, training: bool, special: bool = True):
    """One layer's inputs on the card: x (64, 64, L, C), pad rows (5% of a
    member's rows; the cohort's last batches hold 35 of 960) and, with
    ``special``, an all-pad member 1 and one NaN in member 2; weight and bias
    as rows of a wider buffer (the stride of the fleet's affine buffer),
    running statistics, an upstream gradient.  Eval takes no mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, N = MEMBERS, BATCH
    x = torch.randn((T, N, L, C), generator=g, device="cuda") * 2 + 0.5
    mask = (torch.rand((T, N), generator=g, device="cuda") > 0.05).float()
    mask[:, 0] = 1.0
    if special:
        x[2, 5, L // 2, C // 3] = float("nan")
        mask[1] = 0.0
    affine = torch.randn((T, 2 * C + 3), generator=g, device="cuda") * 0.3 + 1.0
    rm = torch.randn((T, C), generator=g, device="cuda") * 0.3
    rv = torch.rand((T, C), generator=g, device="cuda") + 0.5
    dy = torch.randn((T, N, L, C), generator=g, device="cuda").to(dtype)
    return (x.to(dtype), mask if training else None, affine[:, :C],
            affine[:, C + 1:2 * C + 1], rm, rv, dy)


def bn_run(case, training: bool, kernel: bool):
    """The eight ``OUTPUTS`` of the kernels or of their plain versions."""
    x, mask, w, b, rm, rv, dy = case
    if kernel:
        fwd = mb.masked_bn_relu_kernel(x, mask, w, b, rm, rv, training)
        bwd = mb.masked_bn_relu_backward_kernel(x, dy, mask, w, b, fwd[1], fwd[2], training)
    else:
        fwd = mb.masked_bn_relu_plain(x, mask, w, b, rm, rv, training)
        bwd = mb.masked_bn_relu_backward_plain(x, dy, mask, w, b, fwd[1], fwd[2], training)
    return [*fwd, *bwd]


def timings(dtype) -> dict:
    """The readings of the module docstring for one activation dtype (ms)."""
    cases = [bn_case(L, C, dtype, 200 + i, True, special=False)
             for i, (L, C) in enumerate(bn_layers().values())]
    saved = []
    for x, mask, w, b, rm, rv, dy in cases:
        mean, part2 = mb.bn_stats(x, mask)
        var = mb.bn_apply(x, mask, w, b, rm, rv, True, mean, part2)[1]
        saved.append((mean, part2, var, *mb.bn_grad_sums(x, dy, mean, var, w, b)))

    def each(fn):
        return lambda: [fn(c, s) for c, s in zip(cases, saved)]

    timed = {
        "stats": each(lambda c, s: mb.bn_stats(c[0], c[1])),
        "apply": each(lambda c, s: mb.bn_apply(*c[:6], True, s[0], s[1])),
        "apply_eval": each(lambda c, s: mb.bn_apply(c[0], None, *c[2:6], False)),
        "grad_sums": each(lambda c, s: mb.bn_grad_sums(c[0], c[6], s[0], s[2], c[2], c[3])),
        "grad_apply": each(lambda c, s: mb.bn_grad_apply(c[0], c[6], c[1], s[0], s[2], c[2],
                                                         c[3], s[3], s[4], True))}
    out = {f"{k}_ms": device_ms(fn) for k, fn in timed.items()}
    out["forward_ms"] = out["stats_ms"] + out["apply_ms"]
    out["backward_ms"] = out["grad_sums_ms"] + out["grad_apply_ms"]
    out["plain_ms"] = device_ms(lambda: [bn_run(c, True, False) for c in cases],
                                reps=3, inner=2)
    lib = []
    for x, _m, w, b, _rm, _rv, dy in cases:
        T, N, L, C = x.shape
        flat = lambda t: t.permute(1, 2, 0, 3).reshape(N * L, T * C).contiguous()  # noqa: E731
        lib.append((flat(x).requires_grad_(), w.reshape(-1).to(x.dtype).requires_grad_(),
                    b.reshape(-1).to(x.dtype).requires_grad_(), flat(dy)))

    def library():
        for x2, w2, b2, dy2 in lib:
            y = F.relu(F.batch_norm(x2, None, None, w2, b2, training=True))
            torch.autograd.grad(y, (x2, w2, b2), dy2)

    out["library_ms"] = device_ms(library)
    bound = mb.bound_ms(MEMBERS, BATCH, 100, dtype)
    out.update(ms=out["forward_ms"] + out["backward_ms"], bound=bound,
               bound_ms=bound["forward"]["bound_ms"] + bound["backward"]["bound_ms"],
               issue_bound_ms=(bound["forward"]["issue_bound_ms"]
                               + bound["backward"]["issue_bound_ms"]),
               bound_by="bytes" if {bound[p]["bound_by"] for p in bound} == {"bytes"}
               else "operations")
    return out


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark times the kernels on an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    out = {str(dt).split(".")[-1]: timings(dt) for dt in (torch.float32, torch.bfloat16)}
    print(json.dumps({"card": card, "readings": out}))
    return out


if __name__ == "__main__":
    main()
