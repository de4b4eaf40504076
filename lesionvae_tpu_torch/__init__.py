"""lesionvae_tpu_torch — the PyTorch/CUDA port of ``lesionvae_tpu`` for one
NVIDIA H100, built slice by slice beside the JAX package it is held against.

Ported so far: the lesion SH + heme stage (``analyze_single_lesion``,
``run_lesion_analysis`` and its launch/finish split), with radius sampling
as a CUDA kernel written by hand for Hopper (ops/csrc/radius.cu); the
single-tract VAE stage (``run_vae_analysis``: train -> normative z-scores)
and serving a saved VAE (``score_subjects``); and the optimizer probe
(benchmarks/opt_probe.py) with its resident bf16 Adam kernel
(ops/csrc/resident_adam.cu).  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``.
"""

from .core.config import AnalysisParams, Config, ModelParams, load_config

__all__ = [
    "AnalysisParams", "Config", "ModelParams", "load_config",
    "analyze_single_lesion", "analyze_all_lesions", "launch_lesion_analysis",
    "run_lesion_analysis", "run_lesion_shape_descriptors",
    "run_vae_analysis", "train_lesion_vae", "score_subjects",
]

__version__ = "0.2.0"

_LAZY = {name: "pipeline.lesion_run" for name in __all__[4:9]}
_LAZY.update(run_vae_analysis="pipeline.vae_run",
             train_lesion_vae="train.trainer",
             score_subjects="pipeline.infer")


def __getattr__(name):  # lazy: keep `import lesionvae_tpu_torch` light
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(name)
