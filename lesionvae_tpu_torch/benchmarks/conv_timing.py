"""Device time of the fleet's convolution kernels (``ops/csrc/conv1d.cu``)
at the eight layers of the cohort path's fleet step.

    python -m lesionvae_tpu_torch.benchmarks.conv_timing [--reps 25] [--members 64]

For float32 and bf16, on the card, at 64 members (``--members``; 1 is the
single VAE's step) x batch 64 x each layer's (L, C_in, C_out) of
``utils.cost_model.conv_layers``, inputs laid out as the
step hands them (dec_t1's input is fc_dec's rows as a transposed view; the
weights are views of a wider buffer, as the fleet's leaves are):

- the kernels: the forward (``conv_fwd``), the input gradient (``conv_fwd``
  on dy; none for micro_c1 and lesion_c1, which take the input data) and
  the weight gradient (``conv_wgrad``; float32 with its finishing launch), captured
  in CUDA graphs and timed by their replays, as the training program runs
  them (``utils.profiling.device_ms``: median of ``reps`` x 20): the step's
  eight layers forward and backward (``ms``), and layer by layer;
- in turns with them on the same card (in order, then in reverse; both
  readings kept), two yardsticks the port never calls, graph-replayed the
  same way, over the step and layer by layer: the chain the kernels replaced
  (``conv1d_plain``: pad + unfold + ``baddbmm``, and its autograd backward)
  and the one PyTorch call for the same function, ``F.conv1d`` with a group
  a member over the members' channels side by side, (N, T*C, L), and its
  backward (cuDNN, without the layout copies around it);
- the plain version (``conv1d_plain`` + ``conv1d_backward_plain``, eager, 3
  x 2) over the eight layers;
- the kernels' launches over one step of the eight layers through
  ``fleet_conv1d`` and autograd, every count set to 0 just before;
- the bounds of ``utils.cost_model.conv_bound_ms``.

TF32 is off (``utils.precision.full_fp32``), as on the path.  One JSON line
holds the readings and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..ops import conv1d as cv
from ..utils.cost_model import CONV_INPUT_LAYERS, conv_bound_ms, conv_layers
from ..utils.precision import full_fp32
from ..utils.profiling import device_ms

MEMBERS, BATCH = 64, 64     # the cohort path's fleet step
OUTPUTS = ("y", "dh", "dw", "db")


def conv_case(name: str, dtype: torch.dtype, seed: int, members: int = MEMBERS,
              batch: int = BATCH, shape=None) -> dict:
    """One layer's inputs on the card: h (members, batch, L, C_in) (dec_t1:
    a transposed view of (members, batch, C_in, L), as fc_dec hands it on),
    the weight leaf and bias as views of a wider buffer (the fleet's member
    stride) at torch's init scale, and an upstream gradient dy.  ``shape``
    (L, C_in, C_out, transposed) replaces the layer's own."""
    L, cin, cout, transposed = shape or conv_layers()[name]
    g = torch.Generator(device="cuda").manual_seed(seed)
    T, N = members, batch
    if name == "dec_t1":
        h = torch.randn((T, N, cin, L), generator=g, device="cuda").transpose(2, 3)
    else:
        h = torch.randn((T, N, L, cin), generator=g, device="cuda")
    size = cin * cout * cv.TAPS
    bound = (cv.TAPS * (cout if transposed else cin)) ** -0.5
    buf = ((torch.rand((T, size + cout + 3), generator=g, device="cuda") * 2 - 1)
           * bound).to(dtype)
    dims = (cin, cout) if transposed else (cout, cin)
    w = buf[:, :size].view(T, *dims, cv.TAPS)
    b = buf[:, size + 1:size + 1 + cout]
    dy = torch.randn((T, N, L, cout), generator=g, device="cuda").to(dtype)
    return {"name": name, "h": h.to(dtype), "w": w, "b": b, "dy": dy,
            "transposed": transposed, "need_dh": name not in CONV_INPUT_LAYERS}


def kernel_run(c: dict) -> list:
    """y, dh (None where the layer takes no input gradient), dw, db of the
    kernels."""
    t = c["transposed"]
    y = cv.conv_fwd(c["h"], c["w"], c["b"], t)
    dh = cv.conv_fwd(c["dy"], c["w"], None, not t) if c["need_dh"] else None
    return [y, dh, *cv.conv_wgrad(c["h"], c["dy"], t)]


def plain_run(c: dict, dtype=None) -> list:
    """The same four outputs of the plain versions, on the inputs cast to
    ``dtype`` (float64: the reference of the kernels' tolerance)."""
    h, w, b, dy = (c[k] if dtype is None else c[k].to(dtype) for k in ("h", "w", "b", "dy"))
    y = cv.conv1d_plain(h, w, b, c["transposed"])
    return [y, *cv.conv1d_backward_plain(h, w, dy, c["transposed"], c["need_dh"])]


def captured(fn):
    """``fn`` captured once in a CUDA graph (after two runs on a side
    stream); returns the graph, whose replays are timed."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph


def replay_ms(fn, reps: int) -> float:
    graph = captured(fn)
    ms = device_ms(graph.replay, reps=reps)
    del graph
    return ms


def _chain(c: dict):
    """(forward, forward + backward) of the replaced chain: ``conv1d_plain``
    and autograd through it."""
    t = c["transposed"]
    h = c["h"].detach().requires_grad_(c["need_dh"])
    w, b = c["w"].detach().requires_grad_(), c["b"].detach().requires_grad_()
    leaves = [x for x in (h, w, b) if x.requires_grad]

    def both():
        y = cv.conv1d_plain(h, w, b, t)
        torch.autograd.grad(y, leaves, c["dy"])

    return (lambda: cv.conv1d_plain(c["h"], c["w"], c["b"], t)), both


def _library(c: dict):
    """(forward, forward + backward) of ``F.conv1d`` with a group a member on
    the members' channels side by side."""
    T, N, L, C = c["h"].shape
    w = c["w"].flip(3).transpose(1, 2) if c["transposed"] else c["w"]
    x = c["h"].permute(1, 0, 3, 2).reshape(N, T * C, L).requires_grad_(c["need_dh"])
    wl = w.reshape(-1, C, cv.TAPS).contiguous().requires_grad_()
    bl = c["b"].reshape(-1).contiguous().requires_grad_()
    dy = c["dy"].permute(1, 0, 3, 2).reshape(N, -1, L).contiguous()
    leaves = [v for v in (x, wl, bl) if v.requires_grad]

    def forward():
        return F.conv1d(x, wl, bl, padding=cv.PAD, groups=T)

    def both():
        torch.autograd.grad(forward(), leaves, dy)

    return forward, both


def launches(cases) -> dict:
    """The wrappers' launches over one training step of the layers through
    ``fleet_conv1d`` and autograd, every count set to 0 just before."""
    for w in cv.WRAPPERS:
        w.launches = 0
    for c in cases:
        h = c["h"].detach().requires_grad_(c["need_dh"])
        w, b = c["w"].detach().requires_grad_(), c["b"].detach().requires_grad_()
        y = cv.fleet_conv1d(h, w, b, c["transposed"])
        torch.autograd.grad(y, [x for x in (h, w, b) if x.requires_grad], c["dy"])
    torch.cuda.synchronize()
    return {w.__name__: w.launches for w in cv.WRAPPERS}


def _in_turns(graphs: dict, reps: int) -> dict:
    """Each fn of ``graphs`` timed replayed from a CUDA graph, in turns (the
    order, then the reverse): {name: [first reading, second reading]}."""
    readings = {}
    for name in list(graphs) + list(graphs)[::-1]:
        readings.setdefault(name, []).append(replay_ms(graphs[name], reps))
    return readings


def _by_layer(cases, reps: int) -> dict:
    """Per layer: the kernels' forward, dx and dw, the chain's and the
    library's forward and forward + backward, in turns."""
    layers = {}
    for c in cases:
        t = c["transposed"]
        graphs = {"kernel_forward": lambda c=c: cv.conv_fwd(c["h"], c["w"], c["b"], t),
                  "kernel_dw": lambda c=c: cv.conv_wgrad(c["h"], c["dy"], t)}
        if c["need_dh"]:
            graphs["kernel_dx"] = lambda c=c: cv.conv_fwd(c["dy"], c["w"], None, not t)
        (graphs["chain_forward"], graphs["chain_ms"]) = _chain(c)
        (graphs["library_forward"], graphs["library_ms"]) = _library(c)
        reading = _in_turns(graphs, reps)
        mean = {k: sum(v) / len(v) for k, v in reading.items()}
        row = {"kernel_forward_ms": mean["kernel_forward"],
               "kernel_dx_ms": mean.get("kernel_dx", 0.0), "kernel_dw_ms": mean["kernel_dw"],
               "chain_forward_ms": mean["chain_forward"],
               "chain_backward_ms": mean["chain_ms"] - mean["chain_forward"],
               "library_forward_ms": mean["library_forward"],
               "library_backward_ms": mean["library_ms"] - mean["library_forward"],
               "chain_ms": mean["chain_ms"], "library_ms": mean["library_ms"],
               "readings": reading}
        row["kernel_ms"] = row["kernel_forward_ms"] + row["kernel_dx_ms"] + row["kernel_dw_ms"]
        layers[c["name"]] = row
        torch.cuda.empty_cache()
    return layers


def timings(dtype: torch.dtype, reps: int = 25, by_layer: bool = True,
            members: int = MEMBERS) -> dict:
    """The readings of the module docstring for one compute dtype (ms) at
    ``members`` members: the step's eight layers as four graphs in turns
    (the kernels' forward, their backward, the chain's forward + backward,
    the library's), and, with ``by_layer``, each layer's (chip_smoke.py
    leaves those out)."""
    full_fp32(torch.device("cuda"))
    cases = [conv_case(name, dtype, 400 + i, members=members)
             for i, name in enumerate(conv_layers())]
    chains = [_chain(c)[1] for c in cases]
    libraries = [_library(c)[1] for c in cases]

    def backward(c):
        if c["need_dh"]:
            cv.conv_fwd(c["dy"], c["w"], None, not c["transposed"])
        cv.conv_wgrad(c["h"], c["dy"], c["transposed"])

    step = _in_turns({
        "forward": lambda: [cv.conv_fwd(c["h"], c["w"], c["b"], c["transposed"])
                            for c in cases],
        "backward": lambda: [backward(c) for c in cases],
        "chain": lambda: [f() for f in chains],
        "library": lambda: [f() for f in libraries]}, reps)
    mean = {k: sum(v) / len(v) for k, v in step.items()}
    torch.cuda.empty_cache()
    bound = conv_bound_ms(members, BATCH, compute_dtype=dtype)
    out = {"members": members, "ms": mean["forward"] + mean["backward"],
           "forward_ms": mean["forward"],
           "backward_ms": mean["backward"], "chain_ms": mean["chain"],
           "library_ms": mean["library"], "step_readings": step,
           "launches_a_step": launches(cases),
           "plain_ms": device_ms(lambda: [plain_run(c) for c in cases], reps=3, inner=2),
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "bound": {k: v for k, v in bound.items() if k != "layers"},
           "bound_by_layer": bound["layers"]}
    out["share_of_bound"] = out["bound_ms"] / out["ms"]
    if by_layer:
        out["by_layer"] = _by_layer(cases, reps)
    return out


def main(argv=()) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=25,
                    help="timed groups of 20 replays a reading (the median is kept)")
    ap.add_argument("--members", type=int, default=MEMBERS,
                    help="members of the fleet step (1: the single VAE's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("this benchmark times the kernels on an NVIDIA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    out = {str(dt).split(".")[-1]: timings(dt, args.reps, members=args.members)
           for dt in (torch.float32, torch.bfloat16)}
    print(json.dumps({"card": card, "readings": out}))
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
