"""Lesion SH + heme pipeline: preserved per-lesion API and batched cohort.

The reference has two near-identical lesion analyzers (SURVEY.md §2 C10):
- the LENIENT variant emits an all-zeros SH row for every subject x timepoint
  so downstream merges always find a record
  (src/lesion/lesion_sh_heme_comprehensive.py:322-441);
- the STRICT variant returns (None, False) on any failure
  (src/lesion/lesion_sh_shape_descriptors.py:458-569).
Here both are one implementation with ``strict`` as a parameter.

Cohort design: host preprocessing (connected components, surface vertices)
streams per lesion, then radius sampling + SH fitting for the WHOLE cohort
runs as one batch on the device.  ``device`` and ``dtype`` select the
device path: on ``cuda`` the stage is float32 and the radii always go
through the radius kernel (ops/radius.py); on ``cpu`` it runs the plain
versions in the requested dtype.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch
from torch.profiler import record_function

from ..core.config import Config, load_config
from ..io import nifti
from ..ops import volume as vol
from ..ops.padding import pad_batch
from ..ops.radius import sample_radii
from ..ops.sh import cached_basis, sh_fit_batch_packed, unpack_sh_fit
from ..utils.logging import get_logger
from ..utils.profiling import stage

log = get_logger("lesion")

MIN_LESION_VOXELS = 10     # lesion_sh_heme_comprehensive.py:368
MIN_SURFACE_POINTS = 100   # :382


def _sh_zero_fields(max_l: int, interleaved: bool) -> Dict[str, float]:
    """Zero SH descriptor fields in the reference's insertion order.

    LENIENT interleaves P{l}/P{l}_raw/c{l}_0 (:347-351); STRICT groups all
    P{l}, then all P{l}_raw, then all c{l}_0 (:551-563)."""
    out: Dict[str, float] = {}
    if interleaved:
        for l in range(max_l + 1):
            out[f"P{l}"] = 0.0
            out[f"P{l}_raw"] = 0.0
            out[f"c{l}_0"] = 0.0
    else:
        for l in range(max_l + 1):
            out[f"P{l}"] = 0.0
        for l in range(max_l + 1):
            out[f"P{l}_raw"] = 0.0
        for l in range(max_l + 1):
            out[f"c{l}_0"] = 0.0
    out["reconstruction_r"] = 0.0
    return out


def _base_result(subject_id: str, timepoint: str,
                 brain_volume: Optional[float], max_l: int,
                 interleaved: bool) -> Dict:
    res = {
        "subject_id": subject_id,
        "timepoint": timepoint,
        "original_volume_mm3": 0.0,
        "brain_volume_mm3": brain_volume,
        "lesion_brain_ratio": 0.0,
        "scale_factor": 0.0,
        "centroid_x": 0.0, "centroid_y": 0.0, "centroid_z": 0.0,
        "num_surface_points": 0,
    }
    res.update(_sh_zero_fields(max_l, interleaved))
    return res


class _PreparedLesion:
    """Host-side lesion preprocessing output, ready for device batching."""

    __slots__ = ("surface", "centroid_mm", "scale", "volume", "n_surface")

    def __init__(self, surface, centroid_mm, scale, volume):
        self.surface = surface
        self.centroid_mm = centroid_mm
        self.scale = scale
        self.volume = volume
        self.n_surface = len(surface)


def prepare_lesion(lesion_path: Path, num_samples: int,
                   rng: Optional[np.random.Generator] = None
                   ) -> Tuple[Optional[_PreparedLesion], str]:
    """Host part of the lesion analysis: LCC → centroid → unit-volume scale →
    surface vertices (reference :361-384).  Returns (prepared|None, reason)."""
    if not lesion_path.exists():
        return None, "missing"
    try:
        # the whole preprocessing chain is guarded: the reference's lenient
        # analyzer zeroes out on ANY exception
        # (lesion_sh_heme_comprehensive.py:438-441)
        img = nifti.load(lesion_path)
        lesion_data = img.get_fdata()
        affine = img.affine
        largest_cc = vol.extract_largest_connected_component(lesion_data)
        if np.sum(largest_cc) < MIN_LESION_VOXELS:
            return None, "too_small"
        centroid_voxel = vol.compute_centroid(largest_cc)
        centroid_mm = nifti.apply_affine(affine, centroid_voxel)
        scale, volume = vol.normalize_to_unit_volume(largest_cc, affine)
        surface = vol.extract_surface_points(largest_cc, affine,
                                             num_points=num_samples, rng=rng)
    except Exception as e:
        log.warning("error analyzing lesion %s: %s", lesion_path, e)
        return None, "error"
    if len(surface) < MIN_SURFACE_POINTS:
        return None, "few_surface_points"
    return _PreparedLesion(surface, centroid_mm, scale, volume), "ok"


def radius_inputs(prepared: List[_PreparedLesion], dtype: torch.dtype,
                  device) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(surface (B, N, 3), counts (B,) int32, centroids (B, 3)) on ``device``:
    the radius sampler's inputs for a batch of prepared lesions."""
    np_dtype = torch.empty((), dtype=dtype).numpy().dtype
    surf, counts = pad_batch([p.surface for p in prepared], dtype=np_dtype)
    cens = np.stack([p.centroid_mm for p in prepared]).astype(np_dtype)
    return (torch.from_numpy(surf).to(device), torch.from_numpy(counts).to(device),
            torch.from_numpy(cens).to(device))


def _sh_device_launch(prepared: List[_PreparedLesion], max_l: int,
                      num_samples: int, device, dtype: torch.dtype):
    """Enqueue the batched radius-sampling + SH fit; returns the packed
    device tensor (or None for an empty batch).  CUDA work is queued without
    blocking, so callers can overlap other host work before the copy in
    ``_sh_device_finish``."""
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"the lesion stage runs float32 on cuda, got {dtype}")
    if not prepared:
        return None
    directions, _theta, _phi, basis, chol_c = cached_basis(
        max_l, num_samples, dtype=dtype, device=device)
    surf, counts, cens = radius_inputs(prepared, dtype, device)
    scales = torch.tensor([p.scale for p in prepared], dtype=dtype,
                          device=device)
    with record_function("sh_fit"):
        radii = sample_radii(surf, counts, cens, directions)
        radii_normalized = radii * scales[:, None]  # :392-393
        return sh_fit_batch_packed(radii_normalized, basis, chol_c, max_l=max_l)


def _sh_device_finish(packed, n: int, max_l: int
                      ) -> List[Dict[str, np.ndarray]]:
    """Copy + unpack the device batch from ``_sh_device_launch``."""
    if packed is None:
        return []
    out = unpack_sh_fit(packed.cpu().numpy(), max_l)  # single D2H copy
    return [
        {k: out[k][i] for k in ("coeffs", "P_raw", "P_norm",
                                "reconstruction_r", "c_l0")}
        for i in range(n)
    ]


def _sh_device_batch(prepared: List[_PreparedLesion], max_l: int,
                     num_samples: int, device, dtype: torch.dtype
                     ) -> List[Dict[str, np.ndarray]]:
    """One batched device pass: radius sampling + SH fit for all lesions."""
    return _sh_device_finish(
        _sh_device_launch(prepared, max_l, num_samples, device, dtype),
        len(prepared), max_l)


def _fill_sh_fields(result: Dict, p: _PreparedLesion, sh: Dict,
                    brain_volume: Optional[float], max_l: int,
                    strict: bool) -> None:
    ratio = (p.volume / brain_volume if brain_volume else
             (None if strict else 0.0))
    result.update({
        "original_volume_mm3": p.volume,
        "lesion_brain_ratio": ratio,
        "scale_factor": p.scale,
        "centroid_x": p.centroid_mm[0],
        "centroid_y": p.centroid_mm[1],
        "centroid_z": p.centroid_mm[2],
        "num_surface_points": p.n_surface,
    })
    for l in range(max_l + 1):
        result[f"P{l}"] = float(sh["P_norm"][l])
        result[f"P{l}_raw"] = float(sh["P_raw"][l])
        result[f"c{l}_0"] = float(sh["c_l0"][l])
    result["reconstruction_r"] = float(sh["reconstruction_r"])


def analyze_single_lesion(subject_id: str, timepoint: str,
                          data_dir: str | Path, output_dir: str | Path = None,
                          max_l: int = 6, num_samples: int = 2000,
                          strict: bool = False,
                          rng: Optional[np.random.Generator] = None,
                          device="cuda", dtype: torch.dtype = torch.float32
                          ) -> Tuple[Optional[Dict], bool]:
    """Preserved public API (both reference variants; ``strict`` selects).

    Lenient (default): always returns (result, True); missing/small lesions
    yield zero SH descriptors (:322-441).  Strict: (None, False) on failure
    (lesion_sh_shape_descriptors.py:458-503)."""
    data_dir = Path(data_dir)
    lesion_path = data_dir / str(subject_id) / timepoint / "lesion_cleaned.nii.gz"
    brain_volume = vol.compute_brain_volume(str(subject_id), timepoint, data_dir)
    result = _base_result(str(subject_id), timepoint, brain_volume, max_l,
                          interleaved=not strict)

    p, reason = prepare_lesion(lesion_path, num_samples, rng=rng)
    if p is None:
        if strict:
            log.warning("lesion %s@%s failed (%s)", subject_id, timepoint, reason)
            return None, False
        log.info("lesion %s@%s: %s — zero SH descriptors", subject_id,
                 timepoint, reason)
        return result, True

    sh = _sh_device_batch([p], max_l, num_samples, device, dtype)[0]
    _fill_sh_fields(result, p, sh, brain_volume, max_l, strict)
    return result, True


def _per_lesion_plots(row: Dict, p: _PreparedLesion, sh: Dict, max_l: int,
                      num_samples: int, plots_dir: Path, device,
                      dtype: torch.dtype) -> None:
    """Strict-variant per-lesion artifacts: 3-D surface comparison + power
    spectrum (reference lesion_sh_shape_descriptors.py:521-532)."""
    from ..viz.lesion_viz import (plot_3d_surface_comparison,
                                  plot_power_spectrum)
    directions, _t, _p, basis, _c = cached_basis(max_l, num_samples,
                                                 dtype=dtype, device=device)
    recon_radii = basis.cpu().numpy() @ np.asarray(sh["coeffs"])   # (D,)
    reconstructed = (np.asarray(p.centroid_mm)[None, :]
                     + directions.cpu().numpy() * (recon_radii / p.scale)[:, None])
    plot_3d_surface_comparison(p.surface, reconstructed, row["subject_id"],
                               row["timepoint"], plots_dir)
    plot_power_spectrum({l: row[f"P{l}"] for l in range(max_l + 1)},
                        row["subject_id"], row["timepoint"], plots_dir)


# ----------------------------------------------------------------------------
# Cohort entry points
# ----------------------------------------------------------------------------
def launch_all_lesions(config: Config, data_dir: Path,
                       max_l: int = 6, num_samples: int = 2000,
                       strict: bool = False, with_heme: bool = True,
                       seed: Optional[int] = 0,
                       per_lesion_plots_dir: Optional[Path] = None,
                       device="cuda", dtype: torch.dtype = torch.float32):
    """Host prepare + ENQUEUE the cohort SH device batch; returns a
    zero-argument ``finish()`` producing the DataFrame.

    The blocking device→host copy is in finish(), so callers can launch here
    and copy after their other work."""
    subjects_by_group = config.subjects_by_group(only=("TBI", "PTE"))
    group_mapping = {s: g for g, subs in subjects_by_group.items() for s in subs}
    all_subjects = sorted(group_mapping)
    timepoints = list(config.timepoints)

    rows: List[Dict] = []
    pending: List[Tuple[int, _PreparedLesion]] = []  # (row index, prepared)
    rng = np.random.default_rng(seed) if seed is not None else None

    with stage("lesion.prepare"):
        for subject_id in all_subjects:
            for timepoint in timepoints:
                brain_volume = vol.compute_brain_volume(subject_id, timepoint,
                                                        data_dir)
                lesion_path = (data_dir / subject_id / timepoint
                               / "lesion_cleaned.nii.gz")
                p, reason = prepare_lesion(lesion_path, num_samples, rng=rng)
                if p is None and strict:
                    log.info("skip %s@%s (%s)", subject_id, timepoint, reason)
                    continue
                result = _base_result(subject_id, timepoint, brain_volume,
                                      max_l, interleaved=not strict)
                if p is not None:
                    pending.append((len(rows), p))
                result["_brain_volume"] = brain_volume
                result["group"] = group_mapping[subject_id]
                if with_heme:
                    heme = vol.compute_heme_content(subject_id, timepoint,
                                                    data_dir)
                    result.update(heme if heme is not None else {
                        k: np.nan for k in vol.HEME_ZERO})
                rows.append(result)

    # one device batch for every real lesion in the cohort (enqueued now;
    # copied back in finish())
    with stage("lesion.sh_launch"):
        packed = _sh_device_launch([p for _, p in pending], max_l,
                                   num_samples, device, dtype)

    def finish() -> pd.DataFrame:
        with stage("lesion.sh_batch"):
            sh_results = _sh_device_finish(packed, len(pending), max_l)
        for (idx, p), sh in zip(pending, sh_results):
            _fill_sh_fields(rows[idx], p, sh, rows[idx]["_brain_volume"],
                            max_l, strict)
            if per_lesion_plots_dir is not None:
                _per_lesion_plots(rows[idx], p, sh, max_l, num_samples,
                                  per_lesion_plots_dir, device, dtype)
        for r in rows:
            r.pop("_brain_volume", None)

        df = pd.DataFrame(rows)
        log.info("lesion analysis complete: %d records (strict=%s)",
                 len(df), strict)
        return df

    return finish


def analyze_all_lesions(config: Config, data_dir: Path,
                        max_l: int = 6, num_samples: int = 2000,
                        strict: bool = False, with_heme: bool = True,
                        seed: Optional[int] = 0,
                        per_lesion_plots_dir: Optional[Path] = None,
                        device="cuda", dtype: torch.dtype = torch.float32
                        ) -> pd.DataFrame:
    """Batched cohort analysis over TBI+PTE subjects x all timepoints.

    Mirrors analyze_all_lesions_and_heme (lenient, :444-529) or
    analyze_all_lesions (strict, lesion_sh_shape_descriptors.py:572-643),
    but the SH math for every lesion runs as one device batch."""
    return launch_all_lesions(config, data_dir, max_l=max_l,
                              num_samples=num_samples, strict=strict,
                              with_heme=with_heme, seed=seed,
                              per_lesion_plots_dir=per_lesion_plots_dir,
                              device=device, dtype=dtype)()


def launch_lesion_analysis(config: Optional[Config] = None,
                           data_dir: str | Path | None = None,
                           output_dir: str | Path | None = None,
                           max_l: int = 6, num_samples: int = 2000,
                           seed: Optional[int] = 0, device="cuda",
                           dtype: torch.dtype = torch.float32):
    """Async lenient SH+heme stage: host prepare + device enqueue NOW; the
    returned ``finish()`` copies back, writes the CSV, and prints the pivot
    summaries.  Same outputs as ``run_lesion_analysis``."""
    config = config or load_config()
    base = Path(config.base_path)
    data_dir = Path(data_dir) if data_dir else base / "data"
    output_dir = (Path(output_dir) if output_dir
                  else base / "results" / "lesion_sh_heme_comprehensive")
    output_dir.mkdir(parents=True, exist_ok=True)

    finish_cohort = launch_all_lesions(config, data_dir, max_l=max_l,
                                       num_samples=num_samples, strict=False,
                                       with_heme=True, seed=seed,
                                       device=device, dtype=dtype)

    def finish() -> pd.DataFrame:
        df = finish_cohort()
        if len(df):
            df.to_csv(output_dir / "lesion_sh_heme_comprehensive.csv",
                      index=False)
            # console pivot-table summaries, matching the reference main's
            # end-of-run report (lesion_sh_heme_comprehensive.py:556-571)
            log.info("Lesion Volume by Group and Timepoint:\n%s",
                     df.pivot_table(values="original_volume_mm3",
                                    index="timepoint", columns="group",
                                    aggfunc="mean"))
            log.info("Heme Content by Group and Timepoint:\n%s",
                     df.pivot_table(values="heme_mean", index="timepoint",
                                    columns="group", aggfunc="mean"))
        return df

    return finish


def run_lesion_analysis(config: Optional[Config] = None,
                        data_dir: str | Path | None = None,
                        output_dir: str | Path | None = None,
                        max_l: int = 6, num_samples: int = 2000,
                        seed: Optional[int] = 0, device="cuda",
                        dtype: torch.dtype = torch.float32) -> pd.DataFrame:
    """Lenient SH+heme stage → lesion_sh_heme_comprehensive.csv
    (reference main(): lesion_sh_heme_comprehensive.py:532-575)."""
    with stage("lesion"):
        return launch_lesion_analysis(config, data_dir=data_dir,
                                      output_dir=output_dir, max_l=max_l,
                                      num_samples=num_samples, seed=seed,
                                      device=device, dtype=dtype)()


def run_lesion_shape_descriptors(config: Optional[Config] = None,
                                 data_dir: str | Path | None = None,
                                 output_dir: str | Path | None = None,
                                 max_l: int = 6, num_samples: int = 2000,
                                 seed: Optional[int] = 0,
                                 make_plots: bool = True, device="cuda",
                                 dtype: torch.dtype = torch.float32
                                 ) -> pd.DataFrame:
    """Strict SH stage → lesion_sh_descriptors.csv + group statistics
    (reference main(): lesion_sh_shape_descriptors.py:1019-1053)."""
    config = config or load_config()
    base = Path(config.base_path)
    data_dir = Path(data_dir) if data_dir else base / "data"
    output_dir = (Path(output_dir) if output_dir
                  else base / "results" / "lesion_sh_descriptors_cleaned")
    output_dir.mkdir(parents=True, exist_ok=True)

    with stage("lesion.strict"):
        df = analyze_all_lesions(
            config, data_dir, max_l=max_l, num_samples=num_samples,
            strict=True, with_heme=False, seed=seed,
            per_lesion_plots_dir=(output_dir / "plots") if make_plots else None,
            device=device, dtype=dtype)
    if len(df) == 0:
        log.error("no lesions successfully analyzed")
        return df
    df.to_csv(output_dir / "lesion_sh_descriptors.csv", index=False)

    from ..viz.lesion_viz import (compute_group_statistics,
                                  visualize_brain_volume_analysis,
                                  visualize_group_spectra)
    stats_df = compute_group_statistics(df, output_dir)
    if make_plots:
        visualize_group_spectra(df, stats_df, output_dir)
        visualize_brain_volume_analysis(df, output_dir)
    return df
