"""Rank bodies for ``parallel.mesh.spawn``: each drives one entry point of
the port with ``mesh=`` on the inputs it is handed and returns numpy results
(the same on every rank).  The CPU tests hold them against the one-process
port and the JAX package; ``chip_smoke.py`` runs them on the card.

``run(device, jobs)`` is the spawned function: ``jobs`` is a list of
``(body name, model_parallel, keyword arguments)``, run in order on one
mesh a ``model_parallel``, so that several checks share one start of the
ranks.  Each job returns ``(result, counts)``: the kernels' launches, the
collectives issued and the wall seconds of the job on this rank.
"""

from __future__ import annotations

import pickle
import sys
import time
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from .mesh import collectives_issued, make_mesh, reset_collectives


def _counts_reset() -> None:
    from ..ops import geometry, sr_adam

    geometry.streamline_metrics_stacked.launches = 0
    sr_adam.sr_adam_step.launches = 0
    reset_collectives()


def _counts() -> Dict[str, int]:
    from ..ops import geometry, sr_adam

    return {"geometry": geometry.streamline_metrics_stacked.launches,
            "sr_adam": sr_adam.sr_adam_step.launches,
            "collectives": collectives_issued()}


def _numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run(device, jobs: List[Tuple[str, int, dict]]) -> list:
    meshes = {}
    out = []
    for name, model_parallel, kwargs in jobs:
        if model_parallel not in meshes:
            meshes[model_parallel] = make_mesh(model_parallel=model_parallel,
                                               device=device)
        _counts_reset()
        t0 = time.perf_counter()
        result = BODIES[name](meshes[model_parallel], **kwargs)
        if meshes[model_parallel].device.type == "cuda":
            torch.cuda.synchronize()
        out.append((result, dict(_counts(), seconds=time.perf_counter() - t0)))
    return out


# ---------------------------------------------------------------- bodies
def imported(mesh) -> List[str]:
    """The top-level packages this rank has imported."""
    return sorted({m.split(".")[0] for m in sys.modules})


def streamlines(mesh, points, lengths, dtype=torch.float32):
    from .sharded import sharded_streamline_metrics

    return sharded_streamline_metrics(points, lengths, mesh, dtype=dtype)


def bundle_metrics(mesh, bundles, dtype=torch.float32, upload="f32", device="cuda"):
    """``launch_bundle_metrics(mesh=)``: (summaries, this rank's launches)."""
    from ..pipeline.geometry_run import launch_bundle_metrics

    finish = launch_bundle_metrics(bundles, dtype=dtype, upload=upload,
                                   device=device, mesh=mesh)
    return finish(), finish.launches


def geometry_csvs(mesh, bundles_file: str, output_dir: str):
    """The geometry stage's three CSVs from bundles read once: ``bundles_file``
    holds the pickled (bundles, metadata) of ``launch_all_tracts``; rank 0
    writes the CSVs under ``output_dir``.  Returns this rank's launches."""
    from ..pipeline.geometry_run import (launch_bundle_metrics, summaries_frame,
                                         write_geometry_csvs)

    with open(bundles_file, "rb") as f:
        bundles, meta = pickle.load(f)
    finish = launch_bundle_metrics(bundles, device=mesh.device.type, mesh=mesh)
    results_df = summaries_frame(finish(), meta)
    if mesh.is_main:
        Path(output_dir).mkdir(parents=True, exist_ok=True)
        write_geometry_csvs(results_df, Path(output_dir))
    return finish.launches


def fleet(mesh, data, kwargs: dict, out: str | None = None):
    """``launch_many_vaes(mesh=)`` then ``fetch``.  ``data``: a dict of Xm, Xl,
    n_real (and sham, subj for the summary) or the path of such an ``.npz``;
    ``kwargs`` the launch's other arguments (``n_seg``, ``norm_seed`` with
    the summary).  Returns the assembled fleet as numpy (or, with ``out``,
    rank 0 saves it there) with the collectives and the ledger entries of
    the launch alone, before ``fetch``."""
    from ..train import batched

    if isinstance(data, str):
        data = dict(np.load(data))
    kwargs = dict(kwargs)
    if "sham" in data:
        kwargs["summary_spec"] = (data["sham"], data["subj"], kwargs.pop("n_seg"),
                                  kwargs.pop("norm_seed"))
    batched.reset_fleet_ledger()
    reset_collectives()
    handle = batched.launch_many_vaes(data["Xm"], data["Xl"], data["n_real"],
                                      mesh=mesh, device=mesh.device.type, **kwargs)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize()
    launch = {"collectives": collectives_issued(),
              "ledger": list(batched.FLEET_LAUNCH_LEDGER)}
    handle.fetch()
    got = fleet_arrays(handle)
    if out is None:
        return got, launch
    if mesh.is_main:
        np.savez(out, **got)
    return None, launch


def state_arrays(state) -> Dict[str, np.ndarray]:
    """A fleet's buffers as numpy: ``weights`` (bfloat16 storage widened to
    float32), ``affine`` and ``stats.<name>``."""
    w = state.weights
    out = {"weights": _numpy(w.float() if w.dtype == torch.bfloat16 else w),
           "affine": _numpy(state.affine)}
    out.update({f"stats.{k}": _numpy(v) for k, v in state.stats.items()})
    return out


def fleet_arrays(handle) -> Dict[str, np.ndarray]:
    """``state_arrays`` of a fetched fleet with its ``hist``, ``summary.<i>``
    and ``norm.<name>``."""
    out = dict(state_arrays(handle.state), hist=_numpy(handle.hist))
    if handle.summary is not None:
        out.update({f"summary.{i}": _numpy(t) for i, t in enumerate(handle.summary)})
    if handle.norm_stats is not None:
        out.update({f"norm.{k}": _numpy(v) for k, v in handle.norm_stats.items()})
    return out


def train(mesh, X_micro, X_lesion, kwargs: dict):
    """``train_lesion_vae(mesh=)``: (history array, state_dict as numpy)."""
    from ..train.trainer import train_lesion_vae

    model, hist = train_lesion_vae(X_micro, X_lesion, mesh=mesh,
                                   device=mesh.device.type, **kwargs)
    return hist.to_numpy(), {k: _numpy(v) for k, v in model.module.state_dict().items()}


def steps(mesh, kind: str, hyper: dict, state_dict: dict, xm, xl, mask, eps, betas,
          dtype=torch.float32):
    """``len(betas)`` steps of ``build_shardmap_train_step`` (``kind
    "shardmap"``) or ``build_sharded_train_step`` (``"sharded"``) from the
    weights ``state_dict`` on the global batch, eps (steps, N, latent).
    Returns (losses, the one-process state_dict after the steps)."""
    from ..models.lesion_vae import LesionConditionedVAE
    from .sharded import (build_shardmap_train_step, build_sharded_train_step,
                          full_state_dict)

    dev = mesh.device
    module = LesionConditionedVAE(**hyper).to(dtype)
    module.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    module.to(dev)
    put = lambda a: torch.as_tensor(a).to(dev, dtype)  # noqa: E731
    xm, xl, mask, eps = map(put, (xm, xl, mask, eps))
    if kind == "shardmap":
        step, _ = build_shardmap_train_step(module, mesh)
    else:
        step, _ = build_sharded_train_step(module, mesh, xm.shape[0])
    losses = [float(step(xm, xl, mask, eps[i], float(b))[0]) for i, b in enumerate(betas)]
    return losses, {k: _numpy(v) for k, v in full_state_dict(module).items()}


def score(mesh, kwargs: dict):
    """``score_cohort(mesh=)``: (the DataFrame it returns, the warnings it
    logged)."""
    import logging

    from ..pipeline.infer import log, score_cohort

    warnings: List[str] = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = lambda record: warnings.append(record.getMessage())
    log.addHandler(handler)
    try:
        return score_cohort(mesh=mesh, device=mesh.device.type, **kwargs), warnings
    finally:
        log.removeHandler(handler)


BODIES = {f.__name__: f for f in (imported, streamlines, bundle_metrics, geometry_csvs,
                                  fleet, train, steps, score)}
