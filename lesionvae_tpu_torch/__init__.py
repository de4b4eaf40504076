"""lesionvae_tpu_torch — the PyTorch/CUDA port of ``lesionvae_tpu`` for one
NVIDIA H100, built slice by slice beside the JAX package it is held against.

Ported so far: the lesion SH + heme stage (``analyze_single_lesion``,
``run_lesion_analysis`` and its launch/finish split), with radius sampling
as a CUDA kernel written by hand for Hopper (ops/csrc/radius.cu).  Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from .core.config import AnalysisParams, Config, ModelParams, load_config

__all__ = [
    "AnalysisParams", "Config", "ModelParams", "load_config",
    "analyze_single_lesion", "analyze_all_lesions", "launch_lesion_analysis",
    "run_lesion_analysis", "run_lesion_shape_descriptors",
]

__version__ = "0.1.0"

_LAZY = {name: "pipeline.lesion_run" for name in __all__[4:]}


def __getattr__(name):  # lazy: keep `import lesionvae_tpu_torch` light
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f".{_LAZY[name]}", __name__)
        return getattr(module, name)
    raise AttributeError(name)
