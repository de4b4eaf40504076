"""Deterministic synthetic lesion cohort.

Writes the volumes the lesion SH + heme stage reads, in the directory
contract the reference expects (reference: README.md:128-141,
src/lesion/lesion_sh_heme_comprehensive.py:228,273,327):

    data/{sid}/{tp}/lesion_cleaned.nii.gz | tissue.nii.gz | heme.nii.gz | dti_FA.nii.gz

Every volume is drawn from a generator seeded per (kind, sid, tp), so the
files are byte-identical to the ones the JAX package's synth writes for the
same seed; tract bundles and profile CSVs belong to later stages and are not
written here.
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


def generate_cohort(root: str | Path, config: Config, seed: int = 0,
                    volume_shape=(32, 32, 32),
                    subjects: Optional[Dict[str, List[str]]] = None) -> Path:
    """Write tissue, heme and FA volumes for every subject x timepoint under
    ``root/data``, and a lesion mask for TBI/PTE subjects at every timepoint
    but 2d (exercising the zero-row contract at
    lesion_sh_heme_comprehensive.py:354-357)."""
    root = Path(root)
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

                if group in ("TBI", "PTE") and tp != "2d":
                    rng = _rng(seed, "lesion", sid, tp)
                    lesion = make_lesion_volume(rng, volume_shape)
                    nifti.save(ddir / "lesion_cleaned.nii.gz", lesion, affine)
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
