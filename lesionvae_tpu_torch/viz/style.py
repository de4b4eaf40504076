"""Shared figure conventions.

The reference renders every figure at 300 dpi with the seaborn whitegrid
style (src/vae/visualization.py:13-14, src/analysis/classification.py:36);
we match that by default.  ``LESIONVAE_DPI`` overrides the dpi (tests set a
low value — rendering hundreds of 300-dpi artifacts on a 1-core CI host is
pure waste).
"""

from __future__ import annotations

import os

import matplotlib

matplotlib.use("Agg")

DPI = int(os.environ.get("LESIONVAE_DPI", "300"))


def apply_style() -> None:
    """seaborn whitegrid, as every reference figure module sets at import."""
    import seaborn as sns

    sns.set_style("whitegrid")
