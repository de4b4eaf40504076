"""Save and load trained VAEs with their normalization stats.

The directory holds ``module.json`` with the fields the JAX package writes
(seq_len, micro_ch, lesion_ch, latent and, with stats, norm_stats_spec) and
``state.pt``, a ``torch.save`` of the state dict and the stats.  The JAX
package's orbax checkpoints need JAX to read; the tests carry them across
with ``models.convert.from_jax_params``.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.lesion_vae import LesionConditionedVAE
from .trainer import TrainedVAE


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
