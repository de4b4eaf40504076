"""The geometry kernel's launch geometry: lanes a streamline and warps a block.

    python -m lesionvae_tpu_torch.benchmarks.geometry_lanes [--S 32768] [--P 64]

Times ``csrc/geometry.cu`` on the card at one chunk of the geometry path's
shape (``--S`` streamlines of 49-60 real points, ``io/synth.py::make_bundle``,
padded to ``--P``), in both modes, for every launch geometry the kernel
takes: 16 or 32 lanes a streamline, 2, 4 or 8 warps a block.  Each launch
geometry's output is held bit for bit against the plain version first.  It
reports the device time of each (``utils/profiling.device_ms``) beside the
one ``ops/geometry.py::block_streamlines`` picks, and the card's name and
power limit.  Card only.

One JSON line closes the output.
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from ..io.synth import make_bundle
from ..ops import geometry as g
from ..ops.geo_codec import encode_u16_delta
from ..ops.padding import pad_streamlines
from ..utils.profiling import device_ms


def launch(args, P: int, lanes: int, warps: int) -> torch.Tensor:
    """One launch of the kernel with an explicit launch geometry: ``args``
    is (points, None, None, None, None, lengths) or (None, codes, p0, lo,
    sc, lengths) on the card."""
    spb = warps * (32 // lanes)
    shared = spb * 4 * g.stream_floats(P, lanes)
    lengths = args[5]
    out = torch.empty((len(g.STACKED_NAMES), lengths.shape[0]), device=lengths.device)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = g._kernel()(*(ptr(t) for t in args[:5]), lengths.data_ptr(), out.data_ptr(),
                      lengths.shape[0], P, lanes, spb, shared,
                      torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"geometry kernel launch failed: cudaError {err}")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--S", type=int, default=32768)
    ap.add_argument("--P", type=int, default=64)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("geometry_lanes times the kernel on the card: no CUDA device")
    rng = np.random.default_rng(a.seed)
    sls = []
    while len(sls) < a.S:
        sls += make_bundle(rng, min(100, a.S - len(sls)), min_pts=49, max_pts=min(60, a.P))
    pts, lens = pad_streamlines(sls, max_points=a.P)
    codes, p0, lo, sc = encode_u16_delta(pts, lens)
    dev = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to("cuda")  # noqa: E731
    f32 = (dev(pts), None, None, None, None, dev(lens))
    u16 = (None, dev(codes.view(np.int16)), dev(p0), dev(lo), dev(sc), dev(lens))
    modes = {"f32": (f32, g.streamline_metrics_stacked_plain(f32[0], f32[5])),
             "u16": (u16, g.streamline_metrics_stacked_u16_plain(*u16[1:]))}
    rows = []
    for lanes in (16, 32):
        for warps in (2, 4, 8):
            row = {"lanes": lanes, "warps": warps}
            for mode, (args, plain) in modes.items():
                got = launch(args, a.P, lanes, warps)
                if not torch.equal(got.view(torch.int32), plain.view(torch.int32)):
                    raise SystemExit(f"geometry kernel with {lanes} lanes, {warps} warps "
                                     f"({mode}) differs from the plain version")
                row[f"{mode}_ms"] = device_ms(lambda: launch(args, a.P, lanes, warps))
            rows.append(row)
            print(json.dumps(row), flush=True)
    lanes, spb, _ = g.block_streamlines(a.P)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    result = {"card": card, "S": a.S, "P": a.P, "real_points": int(lens.sum()),
              "picked": {"lanes": lanes, "warps": spb * lanes // 32}, "runs": rows}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
