"""Deterministic synthetic lesion cohort.

Writes the volumes the lesion SH + heme stage reads and, with
``with_profiles=True``, the per-subject tract-profile CSVs the VAE stage
reads, in the directory contract the reference expects (reference:
README.md:128-141, src/vae/data_loader.py:10-24,
src/lesion/lesion_sh_heme_comprehensive.py:228,273,327):

    data/{sid}/{tp}/lesion_cleaned.nii.gz | tissue.nii.gz | heme.nii.gz | dti_FA.nii.gz
    results/{sid}/timepoint_analysis_{sid}_{tp}/comprehensive_tract_data_{sid}_{tp}.csv

Every file is drawn from a generator seeded per (kind, sid, tp), so it is
byte-identical to the one the JAX package's synth writes for the same seed;
tract bundles belong to a later slice and are not written here.
"""

from __future__ import annotations

import hashlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.config import Config
from . import nifti


def _rng(seed: int, *parts) -> np.random.Generator:
    h = hashlib.sha256(("|".join(map(str, parts)) + f"|{seed}").encode()).digest()
    return np.random.default_rng(int.from_bytes(h[:8], "little"))


def make_lesion_volume(rng: np.random.Generator, shape=(32, 32, 32),
                       radius_vox: float = 6.0) -> np.ndarray:
    """A bumpy ellipsoidal blob (binary mask) — gives a non-trivial SH
    spectrum while staying star-convex about its centroid."""
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    center = np.array(shape) / 2 + rng.uniform(-3, 3, size=3)
    axes = radius_vox * rng.uniform(0.6, 1.4, size=3)
    d = (grid - center) / axes
    r = np.linalg.norm(d, axis=-1)
    # angular modulation for shape richness
    with np.errstate(invalid="ignore", divide="ignore"):
        ct = np.where(r > 0, d[..., 2] / (r + 1e-12), 0.0)
    bump = 1.0 + 0.15 * rng.uniform(-1, 1) * (3 * ct ** 2 - 1)
    return (r <= bump).astype(np.float32)


def make_brain_volume(shape=(32, 32, 32), radius_frac: float = 0.45) -> np.ndarray:
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    center = (np.array(shape) - 1) / 2
    r = np.linalg.norm((grid - center) / (np.array(shape) * radius_frac), axis=-1)
    return (r <= 1.0).astype(np.float32)


def write_profile_csv(path: Path, rng: np.random.Generator, tracts: Sequence[str],
                      micro_feats: Sequence[str], lesion_feats: Sequence[str],
                      n_streamlines: int, n_points: int = 100,
                      include_lesion_cols: bool = True,
                      lesion_shift: float = 0.0) -> None:
    """Long-format per-subject tract-profile CSV (schema implied by
    data_loader.py:63-117: tract_id, streamline_id, point_id,
    position_along_tract, then feature columns)."""
    import pandas as pd

    frames = []
    pos = np.linspace(0, 1, n_points)
    for tract in tracts:
        for s_id in range(n_streamlines):
            base = {
                "tract_id": tract,
                "streamline_id": s_id,
                "point_id": np.arange(n_points),
                "position_along_tract": pos,
            }
            for j, feat in enumerate(micro_feats):
                profile = (np.sin(2 * np.pi * (pos + 0.1 * j)) * 0.5
                           + rng.normal(scale=0.1, size=n_points)
                           + lesion_shift * np.exp(-((pos - 0.5) ** 2) / 0.02))
                base[feat] = profile.astype(np.float32)
            if include_lesion_cols:
                in_lesion = ((pos > 0.4) & (pos < 0.6) & (lesion_shift > 0))
                base["in_lesion"] = in_lesion.astype(np.float32)
                base["in_cavity"] = np.zeros(n_points, dtype=np.float32)
                dist = np.abs(pos - 0.5) * 30.0 + (0.0 if lesion_shift > 0 else 15.0)
                base["lesion_distance"] = dist.astype(np.float32)
            frames.append(pd.DataFrame(base))
    df = pd.concat(frames, ignore_index=True)
    path.parent.mkdir(parents=True, exist_ok=True)
    df.to_csv(path, index=False)


def generate_cohort(root: str | Path, config: Config, seed: int = 0,
                    volume_shape=(32, 32, 32),
                    subjects: Optional[Dict[str, List[str]]] = None,
                    with_profiles: bool = False, n_streamlines: int = 30,
                    tracts: Optional[Sequence[str]] = None) -> Path:
    """Write tissue, heme and FA volumes for every subject x timepoint under
    ``root/data``, and a lesion mask for TBI/PTE subjects at every timepoint
    but 2d (exercising the zero-row contract at
    lesion_sh_heme_comprehensive.py:354-357).

    ``with_profiles``: also write each subject's profile CSV for ``tracts``
    (default: the config's geometry tracts) with ``max(4, n_streamlines // 4)``
    streamlines a tract; Sham CSVs lack the lesion columns (exercising the
    imputation at data_loader.py:77-88)."""
    root = Path(root)
    tracts = list(tracts if tracts is not None else config.geometry_tracts)
    groups = subjects if subjects is not None else config.subjects_by_group()
    affine = np.diag([0.5, 0.5, 0.5, 1.0])
    affine[:3, 3] = -np.array(volume_shape) * 0.25

    for group, sids in groups.items():
        for sid in sids:
            for tp in config.timepoints:
                ddir = root / "data" / sid / tp
                brain = make_brain_volume(volume_shape)
                nifti.save(ddir / "tissue.nii.gz", brain, affine)
                rng = _rng(seed, "heme", sid, tp)
                heme = (brain * np.clip(rng.gamma(2.0, 1.0, size=volume_shape), 0, None)
                        ).astype(np.float32)
                nifti.save(ddir / "heme.nii.gz", heme, affine)
                fa = (brain * rng.uniform(0.05, 0.9, size=volume_shape)).astype(np.float32)
                nifti.save(ddir / "dti_FA.nii.gz", fa, affine)

                has_lesion = group in ("TBI", "PTE") and tp != "2d"
                if has_lesion:
                    rng = _rng(seed, "lesion", sid, tp)
                    lesion = make_lesion_volume(rng, volume_shape)
                    nifti.save(ddir / "lesion_cleaned.nii.gz", lesion, affine)

                if with_profiles:
                    rng = _rng(seed, "profiles", sid, tp)
                    write_profile_csv(
                        root / "results" / sid / f"timepoint_analysis_{sid}_{tp}"
                        / f"comprehensive_tract_data_{sid}_{tp}.csv",
                        rng, tracts, config.microstructure_features,
                        config.lesion_features, n_streamlines=max(4, n_streamlines // 4),
                        include_lesion_cols=(group != "Sham"),
                        lesion_shift=(0.8 if has_lesion else 0.0))
    return root


def tiny_config(n_per_group: int = 2, tracts: Optional[Sequence[str]] = None) -> Config:
    """A small config for tests: 2 subjects/group, 2 tracts by default."""
    tracts = list(tracts if tracts is not None else ["atr_left", "fimbria_right"])
    return Config(
        base_path=".",
        tracts=tracts,
        geometry_tracts=tracts,
        timepoints=["2d", "9d", "1mo", "5mo"],
        groups={
            "Sham": list(range(9001, 9001 + n_per_group)),
            "TBI": list(range(9101, 9101 + n_per_group)),
            "PTE": list(range(9201, 9201 + n_per_group)),
        },
        microstructure_features=[
            "dti_ad", "dti_fa", "dti_md", "dti_rd", "mge_r2star", "mge_t2star",
            "xfib_crossing_fraction", "xfib_crossing_strength", "xfib_d",
            "xfib_f1", "xfib_f2", "xfib_f3", "xfib_primary_fraction"],
        lesion_features=["in_lesion", "in_cavity", "lesion_distance"],
    )
