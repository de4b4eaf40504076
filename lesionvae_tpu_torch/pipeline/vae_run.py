"""run_vae_analysis — the single-tract VAE stage end to end (the port of
lesionvae_tpu/pipeline/vae_run.py:34-149):

  build_tensor_with_lesion_context -> fit/apply_normalization ->
  train_lesion_vae -> normative_zscores_fused

per timepoint, writing ``training_history_{tp}.csv`` and ``zscores_{tp}.npz``
(Z, magnitude, subj_ids, group_labels, latents, lesion_burden, norm_mean,
norm_std) and, unless ``make_plots`` is off, the three figures per
timepoint.  Training and z-scores run on ``device`` (float32 on ``cuda``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..core.config import Config, load_config
from ..train import data as vdata
from ..train.normative import normative_zscores_fused
from ..train.trainer import train_lesion_vae
from ..utils.logging import get_logger
from ..utils.profiling import stage

log = get_logger("vae")


def run_vae_analysis(tract: str, latent_dim: int = 10, epochs: int = 40,
                     batch_size: int = 64, lr: float = 2e-4,
                     config: Optional[Config] = None,
                     base_path: str | Path | None = None,
                     timepoints: Optional[Sequence[str]] = None,
                     output_dir: str | Path | None = None,
                     seed: int = 42, make_plots: bool = True,
                     device="cuda", dtype: torch.dtype = torch.float32
                     ) -> Dict[str, dict]:
    """Train a lesion-conditioned VAE per timepoint and compute normative
    z-score deviation maps.

    Returns {timepoint: {"model", "history", "Z", "magnitude", "subj_ids",
    "group_labels", "latents", "lesion_burden", "s"}}.
    """
    config = config or load_config()
    base_path = Path(base_path) if base_path else Path(config.base_path)
    timepoints = list(timepoints if timepoints is not None else config.timepoints)
    output_dir = (Path(output_dir) if output_dir
                  else base_path / "results" / "vae_analysis" / tract)
    output_dir.mkdir(parents=True, exist_ok=True)

    groups_dict = {g: list(s) for g, s in config.subjects_by_group().items()}
    subjects = [s for subs in groups_dict.values() for s in subs]

    results: Dict[str, dict] = {}
    bundle_profiles, lesion_profiles, group_mappings = {}, {}, {}
    latents_by_tp, burden_by_tp, groups_by_tp = {}, {}, {}

    for tp in timepoints:
        log.info("=== %s @ %s ===", tract, tp)
        try:
            with stage("vae.tensors"):
                Xm, Xl, subj_ids, group_labels, s = \
                    vdata.build_tensor_with_lesion_context(
                        base_path, tract, tp, subjects,
                        config.microstructure_features,
                        config.lesion_features, groups_dict)
        except ValueError as e:
            log.warning("%s", e)
            continue

        with stage("vae.normalize"):
            stats = vdata.fit_normalization_stats(
                Xm, Xl, list(config.microstructure_features))
            Xz, Xl = vdata.apply_normalization(Xm, Xl, stats)

        with stage("vae.train"):
            model, hist = train_lesion_vae(
                Xz, Xl, latent_dim=latent_dim, epochs=epochs,
                batch_size=batch_size, lr=lr, seed=seed, device=device,
                dtype=dtype)
        hist.to_csv(output_dir / f"training_history_{tp}.csv", index=False)

        sham = group_labels == "Sham"
        if not sham.any():
            log.warning("no Sham streamlines at %s — skipping z-scores", tp)
            continue
        with stage("vae.normative"):
            mean_r, std_r, Z, magnitude = normative_zscores_fused(
                model, Xz, Xl, sham, seed=seed)
            mu, _, _ = model.encode(Xz, Xl)
            mu = mu.cpu().numpy()
        lesion_burden = Xl[:, :, 0].mean(axis=1)  # mean in_lesion per streamline

        np.savez_compressed(
            output_dir / f"zscores_{tp}.npz", Z=Z, magnitude=magnitude,
            subj_ids=subj_ids, group_labels=group_labels, latents=mu,
            lesion_burden=lesion_burden, norm_mean=mean_r, norm_std=std_r)

        results[tp] = dict(model=model, history=hist, Z=Z, magnitude=magnitude,
                           subj_ids=subj_ids, group_labels=group_labels,
                           latents=mu, lesion_burden=lesion_burden, s=s)

        # per-subject profiles for the figures: mean |z| over
        # (streamlines, features) per position; mean in_lesion per position
        prof, les, gmap = {}, {}, {}
        for sid in np.unique(subj_ids):
            m = subj_ids == sid
            prof[sid] = np.abs(Z[m]).mean(axis=(0, 2))
            les[sid] = Xl[m, :, 0].mean(axis=0)
            gmap[sid] = group_labels[m][0]
        bundle_profiles[tp] = prof
        lesion_profiles[tp] = les
        group_mappings[tp] = gmap
        latents_by_tp[tp] = mu
        burden_by_tp[tp] = lesion_burden
        groups_by_tp[tp] = subj_ids  # per-streamline subject ids for grouping

    if make_plots and bundle_profiles:
        with stage("vae.figures"):
            _make_vae_figures(bundle_profiles, lesion_profiles, group_mappings,
                              latents_by_tp, burden_by_tp, groups_by_tp,
                              results, output_dir)

    log.info("VAE analysis complete for %s: %d timepoints → %s",
             tract, len(results), output_dir)
    return results


def _make_vae_figures(bundle_profiles, lesion_profiles, group_mappings,
                      latents_by_tp, burden_by_tp, groups_by_tp, results,
                      output_dir):
    from ..viz.vae_viz import (plot_latent_space_with_lesion_context,
                               plot_lesion_aware_deviation_profiles,
                               plot_lesion_impact_analysis)
    for tp in bundle_profiles:
        plot_lesion_aware_deviation_profiles(
            bundle_profiles, lesion_profiles, group_mappings, tp,
            output_dir / f"deviation_profiles_{tp}.png")
        plot_lesion_impact_analysis(
            bundle_profiles, lesion_profiles, group_mappings, tp,
            output_dir / f"lesion_impact_{tp}.png")
        plot_latent_space_with_lesion_context(
            latents_by_tp, burden_by_tp, groups_by_tp,
            {tp2: results[tp2]["group_labels"] for tp2 in results}, tp,
            output_dir / f"latent_space_{tp}.png")
