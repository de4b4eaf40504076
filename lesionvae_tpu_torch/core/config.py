"""Typed configuration for the lesion/tract analysis framework (PyTorch port).

Honors the same JSON schema as the reference's ``configs/tract_config.json``
(reference: configs/tract_config.json:1-59, loaded by hand-rolled ``load_config``
at src/lesion/lesion_sh_heme_comprehensive.py:37-41).  Unlike the reference,
every hardcoded orchestration parameter (tract list, timepoints, streamline cap,
model hyperparameters) is surfaced here so nothing bypasses the config.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

# The geometry script in the reference hardcodes a 16-tract list separate from
# the 8 tracts in its config (reference:
# src/geometry/comprehensive_tract_geometry_analysis.py:25-32 vs
# configs/tract_config.json:4-13).  We keep both: ``tracts`` is the config list,
# ``geometry_tracts`` defaults to that script's 16-tract list for CSV parity.
DEFAULT_GEOMETRY_TRACTS: List[str] = [
    "chip_right", "hipcom", "thalsub_left",
    "cing_left", "thalsub_right",
    "cing_right",
    "fimbria_left", "ant_comm", "fimbria_right",
    "atr_left", "fornix_left", "intcap_left",
    "atr_right", "chip_left", "fornix_right", "intcap_right",
]

DEFAULT_TIMEPOINTS: List[str] = ["2d", "9d", "1mo", "5mo"]


@dataclasses.dataclass(frozen=True)
class ModelParams:
    """VAE hyperparameters (reference: configs/tract_config.json:46-52 and the
    duplicated function defaults at src/vae/vae_model.py:140-141)."""

    latent_dim: int = 10
    epochs: int = 40
    batch_size: int = 64
    learning_rate: float = 2e-4
    seed: int = 42
    weight_decay: float = 1e-3        # vae_model.py:168
    grad_clip_norm: float = 2.0       # vae_model.py:199
    seq_len: int = 100                # vae_model.py:20, data_loader.py:98-100


@dataclasses.dataclass(frozen=True)
class AnalysisParams:
    """Statistical analysis knobs (reference: configs/tract_config.json:54-58)."""

    n_segments: int = 20
    alpha: float = 0.05
    effect_size_threshold: float = 0.5


@dataclasses.dataclass(frozen=True)
class Config:
    base_path: str = "."
    tracts: Sequence[str] = dataclasses.field(default_factory=list)
    timepoints: Sequence[str] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_TIMEPOINTS))
    groups: Dict[str, List[int]] = dataclasses.field(default_factory=dict)
    microstructure_features: Sequence[str] = dataclasses.field(default_factory=list)
    lesion_features: Sequence[str] = dataclasses.field(default_factory=list)
    model_params: ModelParams = dataclasses.field(default_factory=ModelParams)
    analysis_params: AnalysisParams = dataclasses.field(default_factory=AnalysisParams)
    # Orchestration parameters the reference hardcodes:
    geometry_tracts: Sequence[str] = dataclasses.field(
        default_factory=lambda: list(DEFAULT_GEOMETRY_TRACTS))
    max_streamlines: Optional[int] = 100  # comprehensive_tract_geometry_analysis.py:310
    sh_max_l: int = 6                     # lesion_sh_heme_comprehensive.py:542
    sh_num_samples: int = 2000            # lesion_sh_heme_comprehensive.py:542

    # ------------------------------------------------------------------
    def subjects_by_group(self, only: Optional[Sequence[str]] = None) -> Dict[str, List[str]]:
        """String subject IDs per group, optionally restricted to ``only``.

        Mirrors get_all_subjects / get_tbi_pte_subjects (reference:
        comprehensive_tract_geometry_analysis.py:41-51,
        lesion_sh_heme_comprehensive.py:44-55): IDs are stringified.
        """
        keep = set(only) if only is not None else {"Sham", "TBI", "PTE"}
        return {g: [str(s) for s in subs] for g, subs in self.groups.items() if g in keep}

    def group_of(self, subject_id: str) -> Optional[str]:
        for g, subs in self.groups.items():
            if str(subject_id) in {str(s) for s in subs}:
                return g
        return None

    def all_subjects(self, only: Optional[Sequence[str]] = None) -> List[str]:
        out: List[str] = []
        for subs in self.subjects_by_group(only).values():
            out.extend(subs)
        return out

    def to_json_dict(self) -> dict:
        return {
            "base_path": self.base_path,
            "tracts": list(self.tracts),
            "timepoints": list(self.timepoints),
            "groups": {g: list(s) for g, s in self.groups.items()},
            "microstructure_features": list(self.microstructure_features),
            "lesion_features": list(self.lesion_features),
            "model_params": {
                "latent_dim": self.model_params.latent_dim,
                "epochs": self.model_params.epochs,
                "batch_size": self.model_params.batch_size,
                "learning_rate": self.model_params.learning_rate,
                "seed": self.model_params.seed,
            },
            "analysis_params": {
                "n_segments": self.analysis_params.n_segments,
                "alpha": self.analysis_params.alpha,
                "effect_size_threshold": self.analysis_params.effect_size_threshold,
            },
        }


def load_config(path: str | Path | None = None) -> Config:
    """Load a config from a tract_config.json-schema file.

    Accepts exactly the reference schema (configs/tract_config.json) plus the
    optional extension keys ``geometry_tracts``, ``max_streamlines``,
    ``sh_max_l``, ``sh_num_samples``.
    """
    if path is None:
        path = Path(__file__).resolve().parents[2] / "configs" / "tract_config.json"
    with open(path, "r") as f:
        raw = json.load(f)

    mp = raw.get("model_params", {})
    ap = raw.get("analysis_params", {})
    model_params = ModelParams(
        latent_dim=int(mp.get("latent_dim", 10)),
        epochs=int(mp.get("epochs", 40)),
        batch_size=int(mp.get("batch_size", 64)),
        learning_rate=float(mp.get("learning_rate", 2e-4)),
        seed=int(mp.get("seed", 42)),
        weight_decay=float(mp.get("weight_decay", 1e-3)),
        grad_clip_norm=float(mp.get("grad_clip_norm", 2.0)),
        seq_len=int(mp.get("seq_len", 100)),
    )
    analysis_params = AnalysisParams(
        n_segments=int(ap.get("n_segments", 20)),
        alpha=float(ap.get("alpha", 0.05)),
        effect_size_threshold=float(ap.get("effect_size_threshold", 0.5)),
    )
    max_sl = raw.get("max_streamlines", 100)
    return Config(
        base_path=raw.get("base_path", "."),
        tracts=list(raw.get("tracts", [])),
        timepoints=list(raw.get("timepoints", DEFAULT_TIMEPOINTS)),
        groups={g: list(s) for g, s in raw.get("groups", {}).items()},
        microstructure_features=list(raw.get("microstructure_features", [])),
        lesion_features=list(raw.get("lesion_features", [])),
        model_params=model_params,
        analysis_params=analysis_params,
        geometry_tracts=list(raw.get("geometry_tracts", DEFAULT_GEOMETRY_TRACTS)),
        max_streamlines=None if max_sl is None else int(max_sl),
        sh_max_l=int(raw.get("sh_max_l", 6)),
        sh_num_samples=int(raw.get("sh_num_samples", 2000)),
    )
