"""VAE-stage figures (host-side matplotlib).

A copy of lesionvae_tpu/viz/vae_viz.py (itself a functional port of
src/vae/visualization.py:19-336): lesion-aware z-score deviation profiles
(3 panels), lesion-impact analysis (2x2), and a t-SNE of subject-mean
latents.  Host only.
"""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
from matplotlib.patches import Patch  # noqa: E402

from ..utils.logging import get_logger  # noqa: E402
from .style import DPI, apply_style  # noqa: E402

log = get_logger("vae_viz")
apply_style()

GROUP_COLORS = {"Sham": "#2E8B57", "TBI": "#4169E1", "PTE": "#DC143C"}


def plot_lesion_aware_deviation_profiles(bundle_profiles, lesion_profiles,
                                         group_mappings, tp, save_path):
    """3-panel figure: group |z| profiles with lesion-location shading,
    PTE−TBI difference, Cohen's d with Welch-t significance stars
    (reference visualization.py:19-181)."""
    tp_profiles = bundle_profiles[tp]
    tp_lesions = lesion_profiles[tp]
    tp_groups = group_mappings[tp]

    n_segments = len(next(iter(tp_profiles.values())))
    x = np.linspace(0, 1, n_segments)
    width = 1.0 / n_segments

    fig, axes = plt.subplots(3, 1, figsize=(14, 12),
                             height_ratios=[2.5, 1.5, 1])

    # panel 1: profiles + lesion shading
    ax1 = axes[0]
    for group, shade in (("TBI", "#4169E1"), ("PTE", "#DC143C")):
        sids = [s for s, g in tp_groups.items() if g == group]
        if not sids:
            continue
        burden = np.mean([tp_lesions[s] for s in sids], axis=0)
        for i in range(n_segments):
            if burden[i] > 0.01:
                ax1.axvspan(x[i] - width / 2, x[i] + width / 2,
                            alpha=min(0.3, burden[i] * 10), color=shade,
                            zorder=0)

    for group, color in GROUP_COLORS.items():
        profs = [tp_profiles[s] for s, g in tp_groups.items() if g == group]
        if not profs:
            continue
        arr = np.array(profs)
        mean, sem = arr.mean(0), arr.std(0) / np.sqrt(len(arr))
        ax1.fill_between(x, mean - sem, mean + sem, alpha=0.25, color=color)
        ax1.plot(x, mean, color=color, linewidth=3 if group != "Sham" else 2,
                 linestyle="--" if group == "Sham" else "-",
                 label=f"{group} (n={len(arr)})")
    ax1.axhline(0, color="gray", linestyle="--", alpha=0.5)
    ax1.set_ylabel("Mean |Z-Score| Deviation")
    ax1.set_title(f"Lesion-Aware Z-Score Deviation Profiles @ {tp}\n"
                  "Shaded regions: lesion location (blue=TBI, red=PTE)")
    ax1.legend(loc="upper left")
    legend2 = [Patch(facecolor="#4169E1", alpha=0.2, label="TBI lesion"),
               Patch(facecolor="#DC143C", alpha=0.2, label="PTE lesion")]
    ax1.add_artist(ax1.legend(handles=legend2, loc="upper right"))
    ax1.grid(alpha=0.3)
    ax1.set_xlim(0, 1)

    # panel 2: PTE − TBI difference
    ax2 = axes[1]
    tbi = [tp_profiles[s] for s, g in tp_groups.items() if g == "TBI"]
    pte = [tp_profiles[s] for s, g in tp_groups.items() if g == "PTE"]
    if tbi and pte:
        diff = np.array(pte).mean(0) - np.array(tbi).mean(0)
        ax2.fill_between(x, 0, diff, where=diff > 0, color="red", alpha=0.6,
                         label="PTE > TBI")
        ax2.fill_between(x, 0, diff, where=diff < 0, color="blue", alpha=0.6,
                         label="TBI > PTE")
        ax2.plot(x, diff, color="black", linewidth=2)
        ax2.axhline(0, color="gray", alpha=0.5)
    ax2.set_ylabel("Z Difference\n(PTE − TBI)")
    ax2.set_title("Seizure-Specific Deviations")
    ax2.legend(loc="upper left")
    ax2.grid(alpha=0.3)
    ax2.set_xlim(0, 1)

    # panel 3: Cohen's d + Welch t significance
    ax3 = axes[2]
    if tbi and pte:
        from scipy import stats as sstats
        tbi_a, pte_a = np.array(tbi), np.array(pte)
        d_vals, p_vals = [], []
        for i in range(n_segments):
            a, b = tbi_a[:, i], pte_a[:, i]
            pooled = np.sqrt(((len(a) - 1) * a.var(ddof=1)
                              + (len(b) - 1) * b.var(ddof=1))
                             / max(len(a) + len(b) - 2, 1))
            d_vals.append((b.mean() - a.mean()) / pooled if pooled > 0 else 0.0)
            p_vals.append(sstats.ttest_ind(a, b, equal_var=False).pvalue
                          if len(a) > 1 and len(b) > 1 else 1.0)
        d_vals, p_vals = np.array(d_vals), np.array(p_vals)
        ax3.plot(x, d_vals, color="purple", linewidth=2)
        for y, c in ((0.5, "red"), (0.8, "darkred"), (-0.5, "red"),
                     (-0.8, "darkred")):
            ax3.axhline(y, color=c, linestyle="--", alpha=0.5)
        ax3.axhline(0, color="gray", alpha=0.5)
        sig = p_vals < 0.05
        if sig.any():
            ax3.scatter(x[sig], d_vals[sig], s=90, color="gold", marker="*",
                        edgecolors="black", zorder=4, label="p<0.05")
            ax3.legend()
    ax3.set_ylabel("Cohen's d")
    ax3.set_xlabel("Position Along Tract")
    ax3.set_title("Effect Size with Significance Markers")
    ax3.grid(alpha=0.3)
    ax3.set_xlim(0, 1)

    fig.tight_layout()
    fig.savefig(save_path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)
    log.info("saved deviation profile: %s", save_path)


def plot_lesion_impact_analysis(bundle_profiles, lesion_profiles,
                                group_mappings, tp, save_path):
    """Lesion burden vs deviation scatter + lesioned/non-lesioned boxplots
    (reference visualization.py:184-270)."""
    tp_profiles = bundle_profiles[tp]
    tp_lesions = lesion_profiles[tp]
    tp_groups = group_mappings[tp]

    fig, axes = plt.subplots(2, 2, figsize=(13, 10))

    ax1 = axes[0, 0]
    for group in ("TBI", "PTE"):
        xs = [np.mean(tp_lesions[s]) * 100
              for s, g in tp_groups.items() if g == group]
        ys = [np.mean(tp_profiles[s])
              for s, g in tp_groups.items() if g == group]
        if xs:
            ax1.scatter(xs, ys, color=GROUP_COLORS[group], s=80, alpha=0.7,
                        label=group, edgecolors="black")
    ax1.set_xlabel("Mean Lesion Burden (%)")
    ax1.set_ylabel("Mean |Z-Score| Deviation")
    ax1.set_title("Lesion Burden vs Z-Score Deviation")
    ax1.legend()
    ax1.grid(alpha=0.3)

    ax2 = axes[0, 1]
    positions = {"TBI": (0, 0.5), "PTE": (2, 2.5)}
    for group in ("TBI", "PTE"):
        les_dev, non_dev = [], []
        for s, g in tp_groups.items():
            if g != group:
                continue
            lesion_mask = tp_lesions[s] > 0.01
            les_dev.extend(tp_profiles[s][lesion_mask])
            non_dev.extend(tp_profiles[s][~lesion_mask])
        if les_dev and non_dev:
            bp = ax2.boxplot([les_dev, non_dev], positions=positions[group],
                             widths=0.4, patch_artist=True, showmeans=True)
            for patch in bp["boxes"]:
                patch.set_facecolor(GROUP_COLORS[group])
                patch.set_alpha(0.6)
    ax2.set_xticks([0.25, 2.25], ["TBI", "PTE"])
    ax2.set_ylabel("|Z-Score| Deviation")
    ax2.set_title("Deviations: Lesioned vs Non-Lesioned Segments")
    ax2.grid(alpha=0.3, axis="y")

    for ax in (axes[1, 0], axes[1, 1]):
        ax.text(0.5, 0.5, "Additional analysis panel", ha="center",
                va="center")
        ax.set_title("Reserved for future analysis")

    fig.tight_layout()
    fig.savefig(save_path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)
    log.info("saved lesion impact analysis: %s", save_path)


def plot_latent_space_with_lesion_context(latents, lesion_burden, subj_ids,
                                          group_labels, tp, save_path):
    """t-SNE of subject-mean latents colored by group and lesion burden
    (reference visualization.py:273-336)."""
    from sklearn.manifold import TSNE

    Z = latents[tp]
    lesion = lesion_burden[tp]
    sids = subj_ids[tp]
    glabels = group_labels[tp]

    subj_lat, subj_les, subj_grp = [], [], []
    for sid in np.unique(sids):
        m = sids == sid
        subj_lat.append(Z[m].mean(axis=0))
        subj_les.append(lesion[m].mean())
        subj_grp.append(glabels[m][0])
    subj_lat = np.array(subj_lat)
    subj_les = np.array(subj_les)

    if len(subj_lat) < 5:
        log.warning("too few subjects for t-SNE at %s", tp)
        return

    perplexity = min(5, len(subj_lat) - 1)
    emb = TSNE(n_components=2, random_state=42,
               perplexity=perplexity).fit_transform(subj_lat)

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(13, 5))
    for group, color in GROUP_COLORS.items():
        m = np.array(subj_grp) == group
        if m.any():
            ax1.scatter(emb[m, 0], emb[m, 1], c=color, s=90, alpha=0.7,
                        edgecolors="black", label=f"{group} (n={m.sum()})")
    ax1.set_xlabel("t-SNE 1")
    ax1.set_ylabel("t-SNE 2")
    ax1.set_title(f"Latent Space @ {tp} (by Group)")
    ax1.legend()
    ax1.grid(alpha=0.3)

    sc = ax2.scatter(emb[:, 0], emb[:, 1], c=subj_les * 100, cmap="YlOrRd",
                     s=90, alpha=0.7, edgecolors="black")
    fig.colorbar(sc, ax=ax2, label="Lesion Burden (%)")
    ax2.set_xlabel("t-SNE 1")
    ax2.set_ylabel("t-SNE 2")
    ax2.set_title(f"Latent Space @ {tp} (by Lesion Burden)")
    ax2.grid(alpha=0.3)

    fig.tight_layout()
    fig.savefig(save_path, dpi=DPI, bbox_inches="tight")
    plt.close(fig)
    log.info("saved latent space plot: %s", save_path)
