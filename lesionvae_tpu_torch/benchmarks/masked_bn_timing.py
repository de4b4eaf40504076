"""Device time of the fleet's masked BatchNorm + ReLU kernels
(``ops/csrc/masked_bn.cu``) at the shapes of the cohort path's fleet step.

    python -m lesionvae_tpu_torch.benchmarks.masked_bn_timing [--general]

For float32 and bf16 activations, on the card (CUDA events, median of 25 x
20 launches after a backlog, ``utils.profiling.device_ms``), over the seven
layers of one 64-member step (64 members x batch 64 x the layers' L x C,
pad rows in every member): each route's forward (training) and backward as
the sums of its kernels' device times (timing the wrappers end to end would
add their host time wherever it outruns the backlog) -- the cluster route's
two kernels, which these shapes take, also layer by layer, and the general
route's four (statistics twice, apply, gradient sums, gradient), also at
``GENERAL_SHAPE``, a layer only that route takes -- each route's launches
over one step of the seven layers, counted by the wrappers, the eval apply,
the plain version (3 x 2), and, as a yardstick the port never calls,
``F.batch_norm(training=True)`` + ReLU with their backward on the same
values unmasked, laid out (N*L, T*C), captured once in a CUDA graph and
timed by its replays (device time, as the kernels are); beside
``ops.masked_bn.bound_ms``.  One JSON line holds the readings and the
card's name and power limit.

``--general`` times only the general route's kernels at ``GENERAL_SHAPE``
(``general_ms``).  That reading calls no more than the four general-route
wrappers, so the same file, copied into an older tree of the port whose
``ops/masked_bn.py`` has them, times that tree's kernels too: run both
trees in turns on one card to compare them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import masked_bn as mb
from ..utils.cost_model import bn_layers
from ..utils.profiling import device_ms

MEMBERS, BATCH = 64, 64     # the cohort path's fleet step
# (members, batch, L, C) of a layer only the general route takes: at a batch
# of 512 one member's 51,200 rows are too long for one cluster
GENERAL_SHAPE = (4, 512, 100, 64)
OUTPUTS = ("y", "mean", "var", "running_mean", "running_var", "dx", "dweight", "dbias")


def bn_case(L: int, C: int, dtype, seed: int, training: bool, special: bool = True,
            members: int = MEMBERS, batch: int = BATCH):
    """One layer's inputs on the card: x (members, batch, L, C), pad rows
    (5% of a member's rows; the cohort's last batches hold 35 of 960) and,
    with ``special``, an all-pad member 1 and one NaN in member 2; weight
    and bias as rows of a wider buffer (the stride of the fleet's affine
    buffer), running statistics, an upstream gradient.  Eval takes no
    mask."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, N = members, batch
    x = torch.randn((T, N, L, C), generator=g, device="cuda") * 2 + 0.5
    mask = (torch.rand((T, N), generator=g, device="cuda") > 0.05).float()
    mask[:, 0] = 1.0
    if special:
        x[2, min(5, N - 1), L // 2, C // 3] = float("nan")
        mask[1] = 0.0
    affine = torch.randn((T, 2 * C + 3), generator=g, device="cuda") * 0.3 + 1.0
    rm = torch.randn((T, C), generator=g, device="cuda") * 0.3
    rv = torch.rand((T, C), generator=g, device="cuda") + 0.5
    dy = torch.randn((T, N, L, C), generator=g, device="cuda").to(dtype)
    return (x.to(dtype), mask if training else None, affine[:, :C],
            affine[:, C + 1:2 * C + 1], rm, rv, dy)


def bn_run(case, training: bool, kernel: bool):
    """The eight ``OUTPUTS`` of the kernels (by ``ops.masked_bn.route``) or
    of their plain versions."""
    x, mask, w, b, rm, rv, dy = case
    if kernel:
        fwd = mb.masked_bn_relu_kernel(x, mask, w, b, rm, rv, training)
        bwd = mb.masked_bn_relu_backward_kernel(x, dy, mask, w, b, fwd[1], fwd[2], training)
    else:
        fwd = mb.masked_bn_relu_plain(x, mask, w, b, rm, rv, training)
        bwd = mb.masked_bn_relu_backward_plain(x, dy, mask, w, b, fwd[1], fwd[2], training)
    return [*fwd, *bwd]


def library_graph(cases):
    """``F.batch_norm(training=True)`` + ReLU and their backward for every
    case, captured once in a CUDA graph (after two runs on a side stream);
    returns the graph, whose replays are timed."""
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

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            library()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        library()
    return graph


def general_ms(dtype, shape=GENERAL_SHAPE) -> dict:
    """Device ms of the general route's kernels at one (T, N, L, C) layer,
    each and summed: forward (statistics twice, apply) and backward
    (gradient sums, gradient).  Calls only ``bn_stats``, ``bn_apply``, ``bn_grad_sums`` and
    ``bn_grad_apply``."""
    T, N, L, C = shape
    x, mask, w, b, rm, rv, dy = bn_case(L, C, dtype, 300, True, special=False,
                                        members=T, batch=N)
    mean, part2 = mb.bn_stats(x, mask)
    var = mb.bn_apply(x, mask, w, b, rm, rv, True, mean, part2)[1]
    part3, part4 = mb.bn_grad_sums(x, dy, mean, var, w, b)
    ms = {"stats_ms": device_ms(lambda: mb.bn_stats(x, mask)),
          "apply_ms": device_ms(lambda: mb.bn_apply(x, mask, w, b, rm, rv, True, mean, part2)),
          "grad_sums_ms": device_ms(lambda: mb.bn_grad_sums(x, dy, mean, var, w, b)),
          "grad_apply_ms": device_ms(lambda: mb.bn_grad_apply(x, dy, mask, mean, var, w, b,
                                                              part3, part4, True))}
    forward, backward = ms["stats_ms"] + ms["apply_ms"], ms["grad_sums_ms"] + ms["grad_apply_ms"]
    return {"shape": list(shape), "forward_ms": forward, "backward_ms": backward,
            "ms": forward + backward, **ms}


def timings(dtype) -> dict:
    """The readings of the module docstring for one activation dtype (ms)."""
    layers = bn_layers()
    cases = [bn_case(L, C, dtype, 200 + i, True, special=False)
             for i, (L, C) in enumerate(layers.values())]
    routes = [mb.route(BATCH, L, C, dtype, True) for L, C in layers.values()]
    saved = []
    for x, mask, w, b, rm, rv, dy in cases:
        mean, part2 = mb.bn_stats(x, mask)
        var = mb.bn_apply(x, mask, w, b, rm, rv, True, mean, part2)[1]
        saved.append((mean, part2, var, *mb.bn_grad_sums(x, dy, mean, var, w, b)))

    def cluster_forward(c, s):
        return mb.bn_cluster_forward(*c[:6])

    def cluster_backward(c, s):
        return mb.bn_cluster_backward(c[0], c[6], c[1], s[0], s[2], c[2], c[3], True)

    kernels = {
        "cluster_forward": cluster_forward,
        "cluster_backward": cluster_backward,
        "stats": lambda c, s: mb.bn_stats(c[0], c[1]),
        "apply": lambda c, s: mb.bn_apply(*c[:6], True, s[0], s[1]),
        "apply_eval": lambda c, s: mb.bn_apply(c[0], None, *c[2:6], False),
        "grad_sums": lambda c, s: mb.bn_grad_sums(c[0], c[6], s[0], s[2], c[2], c[3]),
        "grad_apply": lambda c, s: mb.bn_grad_apply(c[0], c[6], c[1], s[0], s[2], c[2],
                                                    c[3], s[3], s[4], True)}
    out = {f"{k}_ms": device_ms(lambda fn=fn: [fn(c, s) for c, s in zip(cases, saved)])
           for k, fn in kernels.items()}
    out["cluster_by_layer_ms"] = {
        name: [device_ms(lambda c=c, s=s: cluster_forward(c, s)),
               device_ms(lambda c=c, s=s: cluster_backward(c, s))]
        for name, c, s in zip(layers, cases, saved)}
    def launches(step) -> int:
        """The wrappers' launches over one step of the seven layers, every
        count set to 0 just before."""
        for w in mb.WRAPPERS:
            w.launches = 0
        for c, s in zip(cases, saved):
            step(c, s)
        torch.cuda.synchronize()
        return sum(w.launches for w in mb.WRAPPERS)

    general = ("stats", "apply", "grad_sums", "grad_apply")
    per_route = {
        "cluster": {"forward_ms": out["cluster_forward_ms"],
                    "backward_ms": out["cluster_backward_ms"],
                    "launches_a_step": launches(
                        lambda c, s: [cluster_forward(c, s), cluster_backward(c, s)])},
        "general": {"forward_ms": out["stats_ms"] + out["apply_ms"],
                    "backward_ms": out["grad_sums_ms"] + out["grad_apply_ms"],
                    "launches_a_step": launches(
                        lambda c, s: [kernels[k](c, s) for k in general]),
                    "at_own_shape": general_ms(dtype)}}
    for r in per_route.values():
        r["ms"] = r["forward_ms"] + r["backward_ms"]
    if len(set(routes)) != 1:
        raise RuntimeError(f"the seven layers take several routes: {routes}")
    path = per_route[routes[0]]
    out.update(per_route=per_route, routes=routes, forward_ms=path["forward_ms"],
               backward_ms=path["backward_ms"])
    out["plain_ms"] = device_ms(lambda: [bn_run(c, True, False) for c in cases],
                                reps=3, inner=2)
    out["library_ms"] = device_ms(library_graph(cases).replay)
    bound = mb.bound_ms(MEMBERS, BATCH, 100, dtype)
    out.update(ms=out["forward_ms"] + out["backward_ms"], bound=bound,
               bound_ms=bound["forward"]["bound_ms"] + bound["backward"]["bound_ms"],
               issue_bound_ms=(bound["forward"]["issue_bound_ms"]
                               + bound["backward"]["issue_bound_ms"]),
               bound_by="bytes" if {bound[p]["bound_by"] for p in bound} == {"bytes"}
               else "operations")
    return out


def main(argv=()) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--general", action="store_true",
                    help=f"time only the general route's kernels at {GENERAL_SHAPE}")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark times the kernels on an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    reading = general_ms if args.general else timings
    out = {str(dt).split(".")[-1]: reading(dt) for dt in (torch.float32, torch.bfloat16)}
    print(json.dumps({"card": card, "readings": out}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
