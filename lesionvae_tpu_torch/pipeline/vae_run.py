"""run_vae_analysis — the single-tract VAE stage end to end (the port of
lesionvae_tpu/pipeline/vae_run.py:34-149):

  build_tensor_with_lesion_context -> fit/apply_normalization ->
  train_lesion_vae -> normative_zscores_fused

per timepoint, writing ``training_history_{tp}.csv`` and ``zscores_{tp}.npz``
(Z, magnitude, subj_ids, group_labels, latents, lesion_burden, norm_mean,
norm_std) and, unless ``make_plots`` is off, the three figures per
timepoint.  Training and z-scores run on ``device`` (float32 on ``cuda``).

``run_vae_cohort`` (:152-297 there) is the production path: every
(tract, timepoint) VAE of the cohort trained as one program
(``train.batched``), with normalization before and the normative summary
after it on the device, writing ``training_history_{tract}_{tp}.csv``,
``zscores_{tract}_{tp}.npz`` and, on request, ``checkpoints/{tract}_{tp}``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
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
                     device="cuda", dtype: torch.dtype = torch.float32,
                     mesh=None) -> Dict[str, dict]:
    """Train a lesion-conditioned VAE per timepoint and compute normative
    z-score deviation maps.

    Returns {timepoint: {"model", "history", "Z", "magnitude", "subj_ids",
    "group_labels", "latents", "lesion_burden", "s"}}.

    ``mesh``: training is data-parallel over its ranks
    (``train_lesion_vae(mesh=)``); every rank returns the same results and
    rank 0 alone writes the files.
    """
    writes = mesh is None or mesh.is_main
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
                dtype=dtype, mesh=mesh)
        if writes:
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

        if writes:
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

    if make_plots and bundle_profiles and writes:
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


def run_vae_cohort(tracts: Sequence[str], latent_dim: int = 10,
                   epochs: int = 40, batch_size: int = 64, lr: float = 2e-4,
                   config: Optional[Config] = None,
                   base_path: str | Path | None = None,
                   timepoints: Optional[Sequence[str]] = None,
                   output_dir: str | Path | None = None,
                   seed: int = 42, save_z: bool = False,
                   compute_dtype: Optional[torch.dtype] = None,
                   store_dtype: Optional[torch.dtype] = None,
                   quantize_upload: bool = False,
                   upload_chunks: "int | str" = 1,
                   save_checkpoints: bool = False, device="cuda",
                   dtype: torch.dtype = torch.float32,
                   **launch_kwargs) -> Dict[tuple, dict]:
    """Train the whole (tract x timepoint) VAE fleet as one program on
    ``device`` and compute normative z-scores per member.

    The full per-streamline z-score block stays on the device and only
    summaries leave it (per-streamline magnitudes, per-subject mean-|z|
    profiles, normative mean/std); ``save_z=True`` also fetches and stores
    the full ``Z`` per member.  ``compute_dtype=torch.bfloat16``: mixed
    precision; ``store_dtype=torch.bfloat16``: bfloat16 storage of weights
    and moments with stochastic rounding (``train.lowmem``);
    ``quantize_upload``: uint16 upload of the raw tensors
    (``train.quantize``); ``upload_chunks`` (an int or ``"auto"``): the
    launch split into member-axis chunks, each its own copy and training
    run (``train.batched``).  ``launch_kwargs`` go to ``launch_many_vaes``
    (tests inject weights and draws).

    Returns {(tract, timepoint): {"model", "history", "magnitude",
    "subj_profiles", "subj_ids", "group_labels"[, "Z"]}}.
    """
    from ..train.batched import launch_many_vaes, pad_datasets
    from ..train.checkpoint import save_vae
    from ..train.normative import normative_zscores_fleet

    config = config or load_config()
    base_path = Path(base_path) if base_path else Path(config.base_path)
    timepoints = list(timepoints if timepoints is not None else config.timepoints)
    output_dir = (Path(output_dir) if output_dir
                  else base_path / "results" / "vae_cohort")
    output_dir.mkdir(parents=True, exist_ok=True)

    groups_dict = {g: list(s) for g, s in config.subjects_by_group().items()}
    subjects = [s for subs in groups_dict.values() for s in subs]

    keys, tensors, meta = [], [], []
    csv_cache: dict = {}   # each subject CSV holds every tract: read it once
    with stage("vae_cohort.tensors"):
        for tract in tracts:
            for tp in timepoints:
                try:
                    Xm, Xl, subj_ids, group_labels, _s = \
                        vdata.build_tensor_with_lesion_context(
                            base_path, tract, tp, subjects,
                            config.microstructure_features,
                            config.lesion_features, groups_dict,
                            csv_cache=csv_cache)
                except ValueError as e:
                    log.warning("%s", e)
                    continue
                # raw tensors: normalization (fit + apply) runs on the device
                keys.append((tract, tp))
                tensors.append((Xm, Xl))
                meta.append((subj_ids, group_labels))
    del csv_cache

    if not tensors:
        log.error("no datasets for the VAE cohort")
        return {}

    with stage("vae_cohort.train"):
        Xm_all, Xl_all, n_real = pad_datasets(tensors, batch_size=batch_size)
        n_pad = Xm_all.shape[1]
        T = len(keys)
        sham_T = np.zeros((T, n_pad), np.float32)
        uniq_subj = [np.unique(s) for s, _ in meta]
        n_seg = max(len(u) for u in uniq_subj) + 1  # last segment = pad rows
        subj_idx_T = np.full((T, n_pad), n_seg - 1, np.int32)
        for i, (subj_ids, group_labels) in enumerate(meta):
            sham_T[i, :n_real[i]] = (group_labels == "Sham")
            subj_idx_T[i, :n_real[i]] = np.searchsorted(uniq_subj[i], subj_ids)
        handle = launch_many_vaes(
            Xm_all, Xl_all, n_real, latent_dim=latent_dim, epochs=epochs,
            batch_size=batch_size, lr=lr, seed=seed, compute_dtype=compute_dtype,
            summary_spec=(sham_T, subj_idx_T, n_seg, seed),
            normalize_on_device=True, store_dtype=store_dtype,
            quantize_upload=quantize_upload, upload_chunks=upload_chunks,
            device=device, dtype=dtype, **launch_kwargs)
        models, hist = handle.fetch()

    with stage("vae_cohort.normative"):
        mean_T, std_T, mag_T, prof_T, _cnt = [x.cpu().numpy()
                                              for x in handle.summary]
        Z_T = None
        if save_z:
            _m, _s, Z_T, _mag = normative_zscores_fleet(
                handle.state, handle.Xm, handle.Xl, sham_T, seed=seed,
                noise=launch_kwargs.get("summary_noise"))
        norm_stats = {k: v.cpu().numpy() for k, v in handle.norm_stats.items()}

    results: Dict[tuple, dict] = {}
    for i, key in enumerate(keys):
        tract, tp = key
        subj_ids, group_labels = meta[i]
        n_i = int(n_real[i])
        hist_df = pd.DataFrame(hist[i], columns=["loss", "recon", "kld", "beta"])
        hist_df.to_csv(output_dir / f"training_history_{tract}_{tp}.csv",
                       index=False)
        entry = dict(model=models[i], history=hist_df, subj_ids=subj_ids,
                     group_labels=group_labels)
        if sham_T[i].any():
            profiles = {sid: prof_T[i, j] for j, sid in enumerate(uniq_subj[i])}
            payload = dict(magnitude=mag_T[i, :n_i], subj_ids=subj_ids,
                           group_labels=group_labels, norm_mean=mean_T[i],
                           norm_std=std_T[i],
                           subj_profile=prof_T[i, :len(uniq_subj[i])],
                           subj_order=uniq_subj[i])
            entry.update(magnitude=mag_T[i, :n_i], subj_profiles=profiles)
            if Z_T is not None:
                payload["Z"] = Z_T[i, :n_i]
                entry["Z"] = Z_T[i, :n_i]
            np.savez_compressed(output_dir / f"zscores_{tract}_{tp}.npz",
                                **payload)
        if save_checkpoints:
            # the member with its data-normalization stats: the serving
            # bundle of pipeline.infer
            save_vae(output_dir / "checkpoints" / f"{tract}_{tp}", models[i],
                     norm_stats={k: v[i] for k, v in norm_stats.items()})
        results[key] = entry

    log.info("VAE cohort complete: %d members → %s", len(results), output_dir)
    return results
