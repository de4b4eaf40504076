"""Serving: z-score new subjects with a trained model, without retraining
(the port of lesionvae_tpu/pipeline/infer.py).

Train once (``pipeline/vae_run.py``), save (``train/checkpoint.py``), then
score incoming subject profile CSVs against the frozen normative model:
``score_subjects`` for one member, ``score_cohort`` for every saved
(tract, timepoint) member of a cohort in one pass of the stacked model.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import pandas as pd
import torch
from torch.profiler import record_function

from ..core.config import Config, load_config
from ..train import data as vdata
from ..train.checkpoint import load_vae, load_vae_many
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


SCORE_COLUMNS = ["tract", "timepoint", "subject_id", "group", "mean", "std",
                 "max", "count"]


def score_cohort(cohort_dir: str | Path, base_path: str | Path,
                 subjects: Sequence, config: Optional[Config] = None,
                 keys: Optional[Sequence] = None, seed: int = 0,
                 output_dir: str | Path | None = None, device="cuda",
                 dtype: torch.dtype = torch.float32, eps=None,
                 mesh=None) -> pd.DataFrame:
    """Score a whole cohort of saved members in one pass.

    Every ``(tract, timepoint)`` member under ``cohort_dir/checkpoints``
    (the layout ``run_vae_cohort(save_checkpoints=True)`` writes, with its
    normative ``zscores_{tract}_{tp}.npz`` beside) is loaded, the subjects'
    tensors are padded into one (T, n_pad, L, C) block, and normalization
    (each member's saved stats), eval-mode reconstruction and the z-score
    magnitude run once for all members on ``device``.  A member whose
    checkpoint cannot be read, that has no normative file or no data is
    skipped with a warning.  Each member draws its own noise from ``seed``
    (one (T, n_pad, latent) draw on the CPU) unless ``eps`` is given.

    Returns one summary row per (tract, timepoint, subject): mean/std/max/
    count of per-streamline z magnitudes; also writes ``cohort_scores.csv``
    when ``output_dir`` is given (with the columns alone when no member
    could be scored).

    ``mesh`` (``parallel.mesh.make_mesh``): when the members tile its data
    axis each rank scores its block of them on the mesh's device and the
    magnitudes are gathered exactly; otherwise a warning is logged and the
    first rank of the axis scores them all and broadcasts them, as
    lesionvae_tpu/pipeline/infer.py:213-230 falls back to one device.
    Every rank returns the same rows; rank 0 alone writes the CSV."""
    from ..models.fleet import FleetState, layout
    from ..train.batched import pad_datasets
    from ..train.normative import fleet_reconstruct, z_residual
    from ..utils.precision import full_fp32

    if mesh is not None:
        from ..parallel.mesh import mesh_device
        device = mesh_device(mesh, device)
    writes = mesh is None or mesh.is_main
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"serving runs float32 on cuda, got {dtype}")
    full_fp32(device)
    config = config or load_config()
    cohort_dir = Path(cohort_dir)
    ckpt_root = cohort_dir / "checkpoints"
    if keys is None:
        keys = []
        if ckpt_root.is_dir():
            for d in sorted(ckpt_root.iterdir()):
                # member dirs are named <tract>_<timepoint>; anything else
                # (temp dirs, stray files) is not a checkpoint
                if d.is_dir() and "_" in d.name:
                    keys.append(tuple(d.name.rsplit("_", 1)))
    if not keys:
        raise ValueError(
            f"no member checkpoints under {ckpt_root} — run the fleet with "
            "checkpointing first (run_vae_cohort(save_checkpoints=True); "
            "CLI: vae-cohort --save-checkpoints)")

    groups_dict = {g: list(s) for g, s in config.subjects_by_group().items()}
    members, tensors = [], []
    hyper = None
    restored = load_vae_many([ckpt_root / f"{t}_{tp}" for t, tp in keys],
                             device="cpu", dtype=dtype)
    csv_cache: dict = {}  # (subject, tp) -> profile df, shared across tracts
    for (tract, tp), member in zip(keys, restored):
        if isinstance(member, Exception):
            log.warning("skipping %s@%s: unreadable checkpoint (%s)", tract, tp,
                        member)
            continue
        model, norm_stats = member
        if norm_stats is None:
            raise ValueError(f"{tract}_{tp} checkpoint lacks norm stats")
        if hyper is None:
            hyper = model.module.hyperparameters()
        elif hyper != model.module.hyperparameters():
            raise ValueError("cohort members have mismatched architectures")
        npz = cohort_dir / f"zscores_{tract}_{tp}.npz"
        if not npz.exists():
            # run_vae_cohort writes normative stats only for members with a
            # Sham row
            log.warning("skipping %s@%s: no normative stats (%s)", tract, tp,
                        npz.name)
            continue
        norm = load_normative(npz)
        try:
            Xm, Xl, sids, glabels, _ = vdata.build_tensor_with_lesion_context(
                base_path, tract, tp, subjects, config.microstructure_features,
                config.lesion_features, groups_dict, csv_cache=csv_cache)
        except ValueError as e:   # no data for this member
            log.warning("skipping %s@%s: %s", tract, tp, e)
            continue
        members.append(dict(tract=tract, tp=tp, model=model,
                            norm_stats=norm_stats, norm=norm, sids=sids,
                            groups=glabels))
        tensors.append((Xm, Xl))
    if not members:
        out = pd.DataFrame(columns=SCORE_COLUMNS)
        if output_dir is not None and writes:
            output_dir = Path(output_dir)
            output_dir.mkdir(parents=True, exist_ok=True)
            out.to_csv(output_dir / "cohort_scores.csv", index=False)
        log.warning("score_cohort: no scoreable members")
        return out

    # batch_size=1 pads to the largest member's row count exactly
    Xm_T, Xl_T, n_real = pad_datasets(tensors, batch_size=1)
    T, n_pad = Xm_T.shape[:2]
    if eps is None:
        eps = torch.randn((T, n_pad, hyper["latent"]),
                          generator=torch.Generator().manual_seed(seed))
    eps = torch.as_tensor(eps)
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731

    def magnitudes(sl: slice) -> torch.Tensor:
        """(members, n_pad) z magnitudes of the members ``sl``."""
        part = members[sl]
        state = FleetState.from_state_dicts(
            [m["model"].module.state_dict() for m in part], layout(**hyper),
            dtype=dtype, device=device)
        stack = lambda f: f32(np.stack([f(m) for m in part]))  # noqa: E731
        # float32 normalization with the saved stats, as on the host
        Xz, Xl_d = vdata.apply_normalization_device(
            f32(Xm_T[sl]), f32(Xl_T[sl]),
            {k: stack(lambda m, k=k: m["norm_stats"][k])
             for k in ("median", "mean", "std")})
        Xz, Xl_d = Xz.to(dtype), Xl_d.to(dtype)
        with record_function("score_fleet"):
            xh = fleet_reconstruct(state, Xz, Xl_d, eps[sl].to(device, dtype))
        nm = stack(lambda m: m["norm"]["mean"]).to(dtype)
        ns = stack(lambda m: m["norm"]["std"]).to(dtype)
        z = z_residual(Xz.transpose(0, 1), xh.transpose(0, 1), nm, ns)  # (n, T, L, C)
        return torch.sqrt(torch.mean(z ** 2, dim=(2, 3))).transpose(0, 1)

    if mesh is None:
        mags = magnitudes(slice(None))
    else:
        axis = mesh.axis("data")
        if T % axis.size == 0:
            mags = axis.gather(magnitudes(axis.block(T)), 0)
        else:
            log.warning("score_cohort: %d members don't tile the mesh's data axis "
                        "(%d); scoring on one rank", T, axis.size)
            mags = (magnitudes(slice(None)) if axis.index == 0 else
                    torch.empty((T, n_pad), dtype=dtype, device=device))
            axis.broadcast_(mags, 0)
    mags = mags.cpu().numpy()

    rows = []
    for i, m in enumerate(members):
        df = pd.DataFrame({"subject_id": m["sids"], "group": m["groups"],
                           "z_magnitude": mags[i, :n_real[i]]})
        summ = (df.groupby(["subject_id", "group"])["z_magnitude"]
                .agg(["mean", "std", "max", "count"]).reset_index())
        summ.insert(0, "tract", m["tract"])
        summ.insert(1, "timepoint", m["tp"])
        rows.append(summ)
    out = pd.concat(rows, ignore_index=True)
    log.info("scored %d members x %d subjects in one pass on %s", T,
             out["subject_id"].nunique(), device)
    if output_dir is not None and writes:
        output_dir = Path(output_dir)
        output_dir.mkdir(parents=True, exist_ok=True)
        out.to_csv(output_dir / "cohort_scores.csv", index=False)
    return out
