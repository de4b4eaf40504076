"""Serving: z-score new subjects with a trained model, without retraining
(the port of lesionvae_tpu/pipeline/infer.py:26-67).

Train once (``pipeline/vae_run.py``), save (``train/checkpoint.py``), then
score incoming subject profile CSVs against the frozen normative model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch

from ..core.config import Config, load_config
from ..train import data as vdata
from ..train.checkpoint import load_vae
from ..train.normative import compute_zscore_residuals
from ..utils.logging import get_logger

log = get_logger("infer")


def score_subjects(checkpoint_dir: str | Path,
                   norm_mean: np.ndarray, norm_std: np.ndarray,
                   base_path: str | Path, tract: str, timepoint: str,
                   subjects: Sequence, config: Optional[Config] = None,
                   seed: int = 0, device="cuda",
                   dtype: torch.dtype = torch.float32,
                   eps=None) -> pd.DataFrame:
    """Per-subject z-score deviation magnitudes (mean/std/max/count over
    the subject's streamlines).

    Loads the saved VAE and its normalization stats onto ``device``,
    builds tensors from the subjects' profile CSVs, normalizes them there
    (float32, as on the host) and z-scores them; the noise comes from
    ``seed`` unless ``eps`` (n, latent) is given.  On ``cuda`` the model
    runs float32."""
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"serving runs float32 on cuda, got {dtype}")
    config = config or load_config()
    model, norm_stats = load_vae(checkpoint_dir, device=device, dtype=dtype)
    if norm_stats is None:
        raise ValueError(f"{checkpoint_dir} lacks normalization stats; "
                         "save_vae(..., norm_stats=...) when training")

    groups_dict = {g: list(s) for g, s in config.subjects_by_group().items()}
    Xm, Xl, subj_ids, group_labels, _s = vdata.build_tensor_with_lesion_context(
        base_path, tract, timepoint, subjects,
        config.microstructure_features, config.lesion_features, groups_dict)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    Xz, Xl = vdata.apply_normalization_device(
        f32(Xm), f32(Xl), {k: f32(v) for k, v in norm_stats.items()})

    _Z, magnitude = compute_zscore_residuals(model, Xz, Xl, norm_mean,
                                             norm_std, seed=seed, eps=eps)
    df = pd.DataFrame({
        "subject_id": subj_ids,
        "group": group_labels,
        "z_magnitude": magnitude,
    })
    summary = (df.groupby(["subject_id", "group"])["z_magnitude"]
               .agg(["mean", "std", "max", "count"]).reset_index())
    log.info("scored %d streamlines across %d subjects for %s@%s on %s",
             len(df), summary.shape[0], tract, timepoint, device)
    return summary


def load_normative(npz_path: str | Path) -> Dict[str, np.ndarray]:
    """The normative statistics written by run_vae_analysis
    (zscores_{tp}.npz: norm_mean / norm_std)."""
    z = np.load(npz_path, allow_pickle=True)
    return {"mean": z["norm_mean"], "std": z["norm_std"]}
