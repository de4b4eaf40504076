"""Host-side voxel-volume preprocessing for lesion analysis.

These are small, irregular, data-dependent operations (connected components,
morphology) that belong on the host (SURVEY.md §7 build step 3); everything
from radius sampling onward runs on the device (ops/radius.py, ops/sh.py).

Reference semantics (file:line into the reference implementation):
- largest connected component: src/lesion/lesion_sh_heme_comprehensive.py:58-75
- centroid: :78-84
- unit-volume normalization scale V^(-1/3): :87-95
- surface extraction: an in-repo marching-cubes vertex extractor is the
  primary path for lesions >100 voxels, with erosion-based extraction as the
  fallback — mirroring the reference's skimage gate at :119 and its fallback
  at :132-144; parity is distributional because the reference's surface
  subsampling is unseeded (SURVEY.md §5.6)
- brain volume from tissue mask with FA fallback: :226-259
- heme content metrics: :262-319
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
from scipy import ndimage

from ..io import nifti
from ..utils.logging import get_logger

log = get_logger("volume")


def extract_largest_connected_component(mask_data: np.ndarray,
                                        threshold: float = 0.5) -> np.ndarray:
    binary_mask = mask_data > threshold
    labeled, num_features = ndimage.label(binary_mask)
    if num_features == 0:
        return np.zeros_like(mask_data)
    sizes = ndimage.sum(binary_mask, labeled, range(1, num_features + 1))
    largest = int(np.argmax(sizes)) + 1
    return (labeled == largest).astype(float)


def compute_centroid(mask_data: np.ndarray) -> np.ndarray:
    coords = np.argwhere(mask_data > 0)
    if len(coords) == 0:
        return np.array([0, 0, 0])
    return coords.mean(axis=0)


def normalize_to_unit_volume(mask_data: np.ndarray,
                             affine: np.ndarray) -> Tuple[float, float]:
    """Returns (scale_factor, lesion_volume_mm3); scale = V^(-1/3)."""
    voxel_volume = float(abs(np.linalg.det(affine[:3, :3])))
    lesion_volume = float(np.sum(mask_data > 0) * voxel_volume)
    return lesion_volume ** (-1.0 / 3.0), lesion_volume


def marching_cubes_vertices(mask_data: np.ndarray,
                            level: float = 0.5) -> np.ndarray:
    """Isosurface vertex set of a binary volume — the exact vertex set
    ``skimage.measure.marching_cubes(mask, level=0.5)`` produces for binary
    input (the reference's primary surface path, :119-128): every axis edge
    whose endpoints straddle the level contributes one vertex, linearly
    interpolated (the midpoint for a 0/1 mask).  Faces/normals are not needed
    downstream (the reference discards them), so no case tables are required.
    Fully vectorized numpy."""
    m = mask_data > level
    verts = []
    for axis in range(3):
        a = m.take(range(0, m.shape[axis] - 1), axis=axis)
        b = m.take(range(1, m.shape[axis]), axis=axis)
        cross = a != b
        idx = np.argwhere(cross).astype(np.float64)
        idx[:, axis] += 0.5
        verts.append(idx)
    if not verts:
        return np.empty((0, 3))
    return np.concatenate(verts, axis=0)


def extract_surface_points(mask_data: np.ndarray, affine: np.ndarray,
                           num_points: int = 2000,
                           rng: Optional[np.random.Generator] = None,
                           method: str = "auto") -> np.ndarray:
    """Surface points in world mm, subsampled to at most ``num_points``.

    ``method``: "marching" (isosurface edge vertices — the reference's
    primary path), "erosion" (boundary voxels, the reference's fallback,
    :132-144), or "auto" (marching when the lesion has >100 voxels, matching
    the reference's gate at :119).  Unlike the reference (unseeded
    np.random.choice, :125,141) the subsampling RNG is injectable."""
    binary_mask = mask_data > 0.5
    if method == "auto":
        method = "marching" if binary_mask.sum() > 100 else "erosion"
    if method == "marching":
        surface_voxels = marching_cubes_vertices(mask_data)
    else:
        eroded = ndimage.binary_erosion(binary_mask, iterations=1)
        surface_voxels = np.argwhere(binary_mask & ~eroded)
    surface_coords = nifti.apply_affine(affine, surface_voxels)
    if len(surface_coords) > num_points:
        if rng is None:
            rng = np.random.default_rng()
        indices = rng.choice(len(surface_coords), num_points, replace=False)
        surface_coords = surface_coords[indices]
    return surface_coords


def compute_brain_volume(subject_id: str, timepoint: str,
                         data_dir: Path) -> Optional[float]:
    tissue_path = data_dir / subject_id / timepoint / "tissue.nii.gz"
    if tissue_path.exists():
        try:
            img = nifti.load(tissue_path)
            return float(np.sum(img.get_fdata() > 0) * img.voxel_volume())
        except Exception as e:
            log.warning("could not load tissue mask %s: %s", tissue_path, e)

    fa_path = data_dir / subject_id / timepoint / "dti_FA.nii.gz"
    if fa_path.exists():
        try:
            img = nifti.load(fa_path)
            brain_mask = img.get_fdata() > 0.1
            brain_mask = ndimage.binary_erosion(brain_mask, iterations=1)
            brain_mask = ndimage.binary_dilation(brain_mask, iterations=1)
            return float(np.sum(brain_mask) * img.voxel_volume())
        except Exception as e:
            log.warning("could not compute brain volume from FA %s: %s", fa_path, e)
    return None


HEME_ZERO = {
    "heme_mean": 0.0, "heme_std": 0.0, "heme_total": 0.0, "heme_max": 0.0,
    "heme_95percentile": 0.0, "heme_volume_mm3": 0.0,
}


def compute_heme_content(subject_id: str, timepoint: str,
                         data_dir: Path) -> Optional[Dict[str, float]]:
    """Heme statistics over heme>0 voxels plus volume above the in-mask 95th
    percentile (the threshold is computed inside the mask but applied to the
    whole volume, matching :311-313)."""
    heme_path = data_dir / subject_id / timepoint / "heme.nii.gz"
    if not heme_path.exists():
        log.warning("heme file not found: %s", heme_path)
        return None
    try:
        img = nifti.load(heme_path)
        heme_data = img.get_fdata()
        voxel_volume = img.voxel_volume()
        brain_mask = heme_data > 0
        if np.sum(brain_mask) == 0:
            log.warning("no heme signal for %s@%s", subject_id, timepoint)
            return dict(HEME_ZERO)
        vals = heme_data[brain_mask]
        threshold = float(np.percentile(vals, 95))
        return {
            "heme_mean": float(np.mean(vals)),
            "heme_std": float(np.std(vals)),
            "heme_total": float(np.sum(vals)),
            "heme_max": float(np.max(vals)),
            "heme_95percentile": threshold,
            "heme_volume_mm3": float(np.sum(heme_data > threshold) * voxel_volume),
        }
    except Exception as e:
        log.error("failed to compute heme content for %s@%s: %s",
                  subject_id, timepoint, e)
        return None
