"""Save and load trained VAEs with their normalization stats.

The directory holds ``module.json`` with the fields the JAX package writes
(seq_len, micro_ch, lesion_ch, latent and, with stats, norm_stats_spec) and
``state.pt``, a ``torch.save`` of the state dict and the stats.  The JAX
package's orbax checkpoints need JAX to read; the tests carry them across
with ``models.convert.from_jax_params``.  ``load_vae_many`` reads many
member directories at once and hands back the exception, not a model, for
a member it cannot read.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.lesion_vae import LesionConditionedVAE, TrainedVAE


def save_vae(path: str | Path, model: TrainedVAE,
             norm_stats: Optional[Dict[str, np.ndarray]] = None) -> None:
    path = Path(path).resolve()
    path.mkdir(parents=True, exist_ok=True)
    meta = model.module.hyperparameters()
    payload = {"state_dict": {k: v.detach().cpu().clone()
                              for k, v in model.module.state_dict().items()}}
    if norm_stats is not None:
        arrays = {k: np.asarray(v) for k, v in norm_stats.items()}
        payload["norm_stats"] = {k: torch.from_numpy(v.copy())
                                 for k, v in arrays.items()}
        meta["norm_stats_spec"] = {
            k: {"shape": list(v.shape), "dtype": str(v.dtype)}
            for k, v in arrays.items()}
    (path / "module.json").write_text(json.dumps(meta))
    torch.save(payload, path / "state.pt")


def load_vae(path: str | Path, device="cuda", dtype: torch.dtype = torch.float32
             ) -> Tuple[TrainedVAE, Optional[Dict[str, np.ndarray]]]:
    """(model on ``device`` in ``dtype``, normalization stats or None)."""
    path = Path(path).resolve()
    meta = json.loads((path / "module.json").read_text())
    norm_spec = meta.pop("norm_stats_spec", None)
    blob = torch.load(path / "state.pt", map_location="cpu", weights_only=True)
    module = LesionConditionedVAE(**meta)
    module.load_state_dict(blob["state_dict"])
    module.to(device=device, dtype=dtype)
    norm = ({k: v.numpy() for k, v in blob["norm_stats"].items()}
            if norm_spec is not None else None)
    return TrainedVAE(module), norm


def load_vae_many(paths: Sequence, device="cuda",
                  dtype: torch.dtype = torch.float32, max_workers: int = 8
                  ) -> List:
    """Load many member checkpoints concurrently (the reads release the
    interpreter lock).  Returns a list aligned with ``paths``:
    ``(model, norm_stats)`` per member, or the raised exception object for a
    member that cannot be read (callers skip and continue on
    ``isinstance(x, Exception)``)."""
    import concurrent.futures as cf

    with cf.ThreadPoolExecutor(max_workers=max_workers) as pool:
        futures = [pool.submit(load_vae, p, device, dtype) for p in paths]
        out = []
        for f in futures:
            try:
                out.append(f.result())
            except Exception as e:  # a member-level failure; the caller skips it
                out.append(e)
    return out
