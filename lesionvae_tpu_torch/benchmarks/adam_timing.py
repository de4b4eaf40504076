"""Device time of the optimizer's kernels (``ops/csrc/adam.cu``: the
gradient gather with each member's norm, and the float32-storage update) at
the shapes of the paths that run them.

    python -m lesionvae_tpu_torch.benchmarks.adam_timing

On the card (CUDA events, ``utils.profiling.device_ms``), at full width (seq
100, 13 + 3 channels, latent 10: 2,741,153 weight and 1,088 BatchNorm
elements a member):

- ``grad_sq_norm`` over the 36 leaf gradients of one real 64-member fleet
  step (as autograd returns them, the dense and convolution weights
  transposed inside a member) into the optimizer's packed rows: float32
  gradients (float32 storage) and bf16 weight gradients (bf16 storage).
  ``ms`` is the launch replayed from a CUDA graph, as the training program
  runs it (an eager call builds its leaf table on the host, which in bf16
  takes longer than the kernels: ``eager_ms``); ``by_kernel_us`` splits it
  between the tiles and the finishing launch (``torch.profiler``);
- as an informative line, the gather's library floor: the leaves' copies
  into the packed rows alone (``torch._foreach_copy_``, or one ``copy_`` a
  leaf where PyTorch has no ``_foreach_copy_``), replayed from a CUDA graph;
  it computes no norm, so it is not a yardstick of the same function;
- ``adam_step`` on the 64-member weight rows, the 64 x 1,088 affine rows,
  and the single VAE's two rows (a fleet of one member: 1 x 2,741,153
  and 1 x 1,088);
- the whole optimizer step as the fleet runs it (``LowmemOptimizer.step``)
  against the parent's eager chain (``parent_step``: one copy a leaf, the
  widened square and two sums, the update as elementwise kernels or
  ``sr_adam``), in turns on one card (parent, kernel, kernel, parent), in
  both storages;
- the plain versions (3 x 2) and each kernel's bound (``ops.adam``);
- as an informative line, not a yardstick of the same function,
  ``torch.optim.Adam(fused=True)`` with the same decay on the same 64-member
  rows: it neither clips by a per-member norm nor keeps a step count a
  member.

One JSON line holds the readings and the card's name and power limit.
"""

from __future__ import annotations

import json
import subprocess
from typing import Dict, Optional, Tuple

import torch

from ..models.elbo import elbo_fleet
from ..models.fleet import FleetState, fleet_forward, layout
from ..ops import adam, sr_adam
from ..ops.sr_adam import MASK32
from ..train.lowmem import LowmemOptimizer
from ..utils.precision import full_fp32
from ..utils.profiling import device_ms

MEMBERS, BATCH, SEQ, MICRO, LESION, LATENT = 64, 64, 100, 13, 3, 10
LR, WD, CLIP = 2e-4, 1e-3, 2.0
# the eager chains, timed in turns: fewer calls than the kernels
CHAIN_REPS, CHAIN_INNER = 10, 5


def path_grads(members: int = MEMBERS, store: Optional[torch.dtype] = None,
               seed: int = 0, device="cuda"
               ) -> Tuple[FleetState, Dict[str, torch.Tensor]]:
    """A full-width fleet of ``members`` (weights stored in ``store``, drawn
    on the device) and the leaf gradients of one training step of it on
    random rows, name -> (T, *shape) in the leaf's dtype and in the layout
    autograd returns."""
    device = torch.device(device)
    full_fp32(device)
    lay = layout(SEQ, MICRO, LESION, LATENT)
    state = FleetState(lay, members, torch.float32, store, device)
    g = torch.Generator(device=device).manual_seed(seed)
    for buf, (mean, std) in ((state.weights, (0.0, 0.02)), (state.affine, (1.0, 0.1))):
        buf.copy_(mean + std * torch.randn(buf.shape, generator=g, device=device))
    leaves = state.grad_leaves()
    xm = torch.randn((members, BATCH, SEQ, MICRO), generator=g, device=device)
    xl = torch.rand((members, BATCH, SEQ, LESION), generator=g, device=device)
    mask = torch.ones((members, BATCH), device=device)
    eps = torch.randn((members, BATCH, LATENT), generator=g, device=device)
    xh, mu, logv, _ = fleet_forward(lay, leaves, state.stats, xm, xl, mask, eps, True)
    loss = elbo_fleet(xh, xm, mu, logv, 1.0, mask)[0]
    names = list(lay.leaves)
    grads = torch.autograd.grad(loss.sum(), [leaves[n] for n in names])
    return state, {n: x.detach() for n, x in zip(names, grads)}


@torch.no_grad()
def parent_step(opt: LowmemOptimizer, grads: Dict[str, torch.Tensor],
                finite: torch.Tensor) -> None:
    """The fleet's optimizer step as the port ran it before these kernels:
    a copy a leaf into the packed rows, the norm as a widened square and two
    sums, the update as elementwise kernels (float32 storage) or
    ``sr_adam`` (bf16), the affine leaves as elementwise kernels."""
    st, T, h = opt.state, opt.state.members, opt.hyper
    g_a = torch.empty_like(st.affine)
    for name, (which, off, shape) in st.layout.leaves.items():
        dst = opt.g_w if which == "weights" else g_a
        dst[:, off:off + grads[name][0].numel()].copy_(grads[name].reshape(T, -1))
    g_wide = opt.g_w.float() if opt.lowmem else opt.g_w
    g_norm = torch.sqrt(torch.sum(g_wide * g_wide, dim=1) + torch.sum(g_a * g_a, dim=1))
    count_inc = opt.count + 1
    bc1 = 1 - torch.pow(opt._b1, count_inc)
    bc2 = 1 - torch.pow(opt._b2, count_inc)
    if opt.lowmem:
        salt = (opt.salt + count_inc.to(torch.int64) * 0x01000193) & MASK32
        sr_adam.sr_adam_step(st.weights, opt.mu_w, opt.nu_w, opt.g_w, opt.base, g_norm,
                             bc1, bc2, salt, finite, opt.consts)
    else:
        adam.adam_step_plain(st.weights, opt.mu_w, opt.nu_w, opt.g_w, g_norm, bc1, bc2,
                             finite, h)
    adam.adam_step_plain(st.affine, opt.mu_a, opt.nu_a, g_a, g_norm, bc1, bc2, finite, h)
    opt.count.copy_(torch.where(finite, count_inc, opt.count))


def in_turns(a, b, reps: int = CHAIN_REPS, inner: int = CHAIN_INNER) -> Dict[str, list]:
    """Device ms of ``a`` and ``b`` timed in turns: a, b, b, a."""
    first = [device_ms(a, reps, inner)]
    second = [device_ms(b, reps, inner), device_ms(b, reps, inner)]
    first.append(device_ms(a, reps, inner))
    return {"parent": first, "kernels": second}


def graph_ms(fn, reps: int = 25, inner: int = 20) -> float:
    """Device ms of ``fn`` captured once in a CUDA graph and replayed."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    torch.cuda.synchronize()
    return device_ms(graph.replay, reps, inner)


def by_kernel_us(fn, calls: int = 20) -> Dict[str, float]:
    """Device microseconds a call of ``fn`` by kernel name (``torch.profiler``
    over ``calls`` calls)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key.split("::")[-1]: e.device_time_total / calls
            for e in prof.key_averages() if e.device_time_total > 0}


def copy_floor_ms(srcs, dsts) -> float:
    """The leaves' copies into their packed destinations alone, replayed
    from a CUDA graph: ``torch._foreach_copy_`` where PyTorch has it, else
    one ``copy_`` a leaf."""
    pairs = [(d, x) for x, d in zip(srcs, dsts) if d is not None]
    if hasattr(torch, "_foreach_copy_"):
        def fn():
            torch._foreach_copy_([d for d, _ in pairs], [x for _, x in pairs])
    else:
        def fn():
            for d, x in pairs:
                d.copy_(x)
    return graph_ms(fn)


def norm_args(opt: LowmemOptimizer, grads: Dict[str, torch.Tensor]) -> tuple:
    """``grad_sq_norm``'s arguments as ``LowmemOptimizer.step`` passes them."""
    return [grads[n] for n in opt._names], opt._dsts, opt._work, opt.sq, opt.g_norm


def update_rows(members: int, n: int, seed: int, device="cuda") -> list:
    """p, m, v, g float32 (members, n) in the fleet's row layout, with
    values of a training run's size, and every member's norm below the
    clip, bias corrections of step 7 and finite."""
    g = torch.Generator(device=device).manual_seed(seed)
    rows = []
    for scale in (0.02, 1e-3, 1e-6, 1e-2):
        t = sr_adam.alloc_rows(members, n, torch.float32, device)
        t.copy_(torch.randn((members, n), generator=g, device=device) * scale)
        rows.append(t)
    rows[2].abs_()
    count = torch.full((members,), 7.0, device=device)
    return rows + [torch.full((members,), 0.5, device=device),
                   1 - torch.pow(torch.tensor(0.9, device=device), count),
                   1 - torch.pow(torch.tensor(0.999, device=device), count),
                   torch.ones(members, dtype=torch.bool, device=device)]


def timings() -> dict:
    out: Dict[str, dict] = {}
    hyper = adam.Hyper(LR, WD, CLIP)
    for label, store in (("f32", None), ("bf16", torch.bfloat16)):
        state, grads = path_grads(MEMBERS, store)
        opt = LowmemOptimizer(state, LR, WD, CLIP)
        args = norm_args(opt, grads)
        finite = torch.ones(MEMBERS, dtype=torch.bool, device="cuda")
        before = adam.grad_sq_norm.launches
        norm = {"ms": graph_ms(lambda: adam.grad_sq_norm(*args)),
                "eager_ms": device_ms(lambda: adam.grad_sq_norm(*args)),
                "plain_ms": device_ms(lambda: adam.grad_sq_norm_plain(*args), 3, 2),
                **adam.norm_bound_ms(args[0], args[1]),
                "bytes": adam.norm_bytes(args[0], args[1]), "tiles": args[2].shape[1],
                "transposed_leaves": [n for n, x in grads.items()
                                      if adam.inner_strides(x)[0] == 1 and x.dim() > 2],
                "by_kernel_us": by_kernel_us(lambda: adam.grad_sq_norm(*args)),
                "copy_floor_informative_ms": copy_floor_ms(args[0], args[1])}
        norm["share_of_bound"] = norm["bound_ms"] / norm["ms"]
        out[f"grad_sq_norm_{label}"] = norm
        # the optimizer step as the path runs it, against the parent's chain
        turns = in_turns(lambda: parent_step(opt, grads, finite),
                         lambda: opt.step(grads, finite))
        out[f"step_{label}"] = {"parent_ms": turns["parent"], "ms": turns["kernels"]}
        out[f"grad_sq_norm_{label}"]["launches_timed"] = adam.grad_sq_norm.launches - before
        del state, grads, opt, args
        torch.cuda.empty_cache()
    for label, (members, n) in (("weights", (MEMBERS, 2_741_153)),
                                ("affine", (MEMBERS, 1_088)),
                                ("single_weights", (1, 2_741_153)),
                                ("single_affine", (1, 1_088))):
        a = update_rows(members, n, 1)
        out[f"adam_step_{label}"] = {
            "members": members, "n": n,
            "ms": device_ms(lambda: adam.adam_step(*a, hyper)),
            "plain_ms": device_ms(lambda: adam.adam_step_plain(*a, hyper), 3, 2),
            **adam.adam_bound_ms(members * n)}
        if label == "weights":
            # informative: PyTorch's fused Adam on the same rows (another
            # function: no clip by a member's norm, one step count)
            p = torch.nn.Parameter(a[0].clone())
            p.grad = a[3].clone()
            fused = torch.optim.Adam([p], lr=LR, weight_decay=WD, fused=True)
            out["fused_adam_informative_ms"] = device_ms(fused.step)
            del p, fused
        del a
        torch.cuda.empty_cache()
    out["registers"] = adam.kernel_attributes()
    if hasattr(adam, "norm_blocks_per_sm"):
        out["norm_blocks_per_sm"] = adam.norm_blocks_per_sm()
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    return out


if __name__ == "__main__":
    print(json.dumps(timings()))
