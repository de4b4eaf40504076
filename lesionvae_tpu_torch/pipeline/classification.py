"""TBI-vs-PTE classification stage (sklearn, host-side).

A copy of lesionvae_tpu/pipeline/classification.py; it reads the geometry
CSV the port's ``geometry`` stage writes (the device work is done by then)
and behaves as src/analysis/classification.py does:
- subject-level mean aggregation over tracts per timepoint (:78-91)
- mean imputation + StandardScaler (:136-142)
- RandomForest(100 trees, depth 5), SVC(rbf, C=1, probability),
  ElasticNet(α=0.1, l1_ratio=0.5) thresholded at 0.5 (:107-128, :148-152)
- balanced class weights (:100-102), StratifiedKFold(10, shuffle, seed 42)
  cross_val_predict (:131, :150-157)
- accuracy/AUC/sensitivity/specificity + confusion matrix (:159-182)
- RF feature importances from a full-data refit (:186-189)
- centroid displacement from the 2d baseline (:463-624)
- classification_summary.csv (:698-713)

Different by construction: the figure module (matplotlib, seaborn) is
imported only when figures are asked for, and
``analyze_centroid_displacement`` takes ``make_plots`` (the JAX package
draws its figure whatever ``make_plots`` says).  With figures on, both
packages write the same files.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import pandas as pd

from ..utils.logging import get_logger
from ..utils.profiling import stage

log = get_logger("classify")

TIMEPOINTS = ["2d", "9d", "1mo", "5mo"]
EXCLUDE_COLS = ["centroid_x_mean", "centroid_y_mean", "centroid_z_mean",
                "subject_id", "timepoint", "tract", "group", "group_binary"]


def _banner(title: str) -> None:
    """Reference console convention (classification.py:43-45 etc.): an
    80-char rule above/below a section title."""
    log.info("\n%s\n%s\n%s", "=" * 80, title, "=" * 80)


def load_and_prepare_data(data_path: str | Path) -> pd.DataFrame:
    """Load geometry CSV, keep TBI/PTE, add binary label (PTE=1).

    Console report mirrors the reference's data-loading block
    (classification.py:43-56): totals, group/timepoint counts, and the
    post-filter TBI/PTE split."""
    df = pd.read_csv(data_path)
    _banner("DATA LOADING AND PREPARATION")
    log.info("Total records: %d", len(df))
    log.info("Groups: %s", df["group"].value_counts().to_dict())
    log.info("Timepoints: %s", df["timepoint"].value_counts().to_dict())
    df = df[df["group"].isin(["TBI", "PTE"])].copy()
    df["group_binary"] = (df["group"] == "PTE").astype(int)
    log.info("\nAfter filtering to TBI and PTE:\nTotal records: %d\n"
             "TBI: %d\nPTE: %d", len(df), (df["group"] == "TBI").sum(),
             (df["group"] == "PTE").sum())
    return df


def get_feature_columns(df: pd.DataFrame, report: bool = False) -> List[str]:
    cols = [c for c in df.columns if c not in EXCLUDE_COLS]
    if report:  # reference classification.py:71-73
        log.info("\nFeature columns (%d):\n%s", len(cols),
                 "\n".join(f"  - {c}" for c in cols))
    return cols


def aggregate_features_per_subject(df: pd.DataFrame, timepoint: str,
                                   feature_cols: List[str]) -> pd.DataFrame:
    df_tp = df[df["timepoint"] == timepoint]
    agg = {c: "mean" for c in feature_cols}
    agg["group_binary"] = "first"
    return df_tp.groupby("subject_id").agg(agg).reset_index()


def train_models_with_cv(X: np.ndarray, y: np.ndarray,
                         random_state: int = 42) -> Tuple[Dict, object]:
    from sklearn.ensemble import RandomForestClassifier
    from sklearn.impute import SimpleImputer
    from sklearn.linear_model import ElasticNet
    from sklearn.metrics import (accuracy_score, confusion_matrix, roc_curve,
                                 roc_auc_score)
    from sklearn.model_selection import StratifiedKFold, cross_val_predict
    from sklearn.preprocessing import StandardScaler
    from sklearn.svm import SVC
    from sklearn.utils.class_weight import compute_class_weight

    weights = compute_class_weight("balanced", classes=np.unique(y), y=y)
    class_weight = {0: weights[0], 1: weights[1]}
    # reference classification.py:104
    log.info("  Class weights: TBI=%.2f, PTE=%.2f",
             class_weight[0], class_weight[1])

    models = {
        "Random Forest": RandomForestClassifier(
            n_estimators=100, max_depth=5, class_weight=class_weight,
            random_state=random_state, n_jobs=-1),
        "SVM": SVC(kernel="rbf", C=1.0, class_weight=class_weight,
                   probability=True, random_state=random_state),
        "Elastic Net": ElasticNet(alpha=0.1, l1_ratio=0.5,
                                  random_state=random_state, max_iter=10000),
    }
    # 10-fold like the reference (:131); capped at the minority-class count so
    # small cohorts degrade gracefully instead of crashing
    n_splits = min(10, int(np.bincount(y).min()))
    if n_splits < 10:
        log.warning("reducing CV folds to %d (minority class too small)",
                    n_splits)
    cv = StratifiedKFold(n_splits=max(2, n_splits), shuffle=True,
                         random_state=random_state)

    X_imp = SimpleImputer(strategy="mean").fit_transform(X)
    scaler = StandardScaler()
    X_scaled = scaler.fit_transform(X_imp)

    results: Dict[str, dict] = {}
    for name, model in models.items():
        log.info("  Training %s...", name)  # reference :145
        if name == "Elastic Net":
            y_cont = cross_val_predict(model, X_scaled, y, cv=cv, n_jobs=-1)
            y_pred = (y_cont > 0.5).astype(int)
            # the reference stacks [1-y_cont, y_cont] and reads column 1
            # (classification.py:152-153) — y_cont IS column 1, so AUC/ROC
            # are identical without materializing the 2-column array
            y_score = y_cont
        else:
            y_pred = cross_val_predict(model, X_scaled, y, cv=cv, n_jobs=-1)
            proba = cross_val_predict(model, X_scaled, y, cv=cv,
                                      method="predict_proba", n_jobs=-1)
            y_score = proba[:, 1]

        cm = confusion_matrix(y, y_pred)
        tn, fp, fn, tp = cm.ravel()
        try:
            auc = roc_auc_score(y, y_score)
        except Exception:
            auc = 0.5
        fpr, tpr, _ = roc_curve(y, y_score)

        importance = None
        if name == "Random Forest":
            model.fit(X_scaled, y)          # full-data refit (:186-189)
            importance = model.feature_importances_

        results[name] = {
            "y_true": y, "y_pred": y_pred, "y_pred_proba": y_score,
            "accuracy": accuracy_score(y, y_pred),
            "sensitivity": tp / (tp + fn) if (tp + fn) > 0 else 0,
            "specificity": tn / (tn + fp) if (tn + fp) > 0 else 0,
            "auc": auc, "fpr": fpr, "tpr": tpr, "confusion_matrix": cm,
            "feature_importance": importance,
        }
        # reference per-model metric line (classification.py:205-206)
        log.info("    Accuracy: %.3f, AUC: %.3f, Sens: %.3f, Spec: %.3f",
                 results[name]["accuracy"], auc,
                 results[name]["sensitivity"],
                 results[name]["specificity"])
    return results, scaler


def analyze_centroid_displacement(df: pd.DataFrame, output_dir: Path,
                                  make_plots: bool = True) -> pd.DataFrame:
    """Euclidean displacement of per-(subject, tract) mean centroids from the
    2d baseline → centroid_displacement_data.csv + figure (:463-624)."""
    centroid_cols = ["centroid_x_mean", "centroid_y_mean", "centroid_z_mean"]
    _banner("CENTROID DISPLACEMENT ANALYSIS")  # reference :467-469
    frames = []
    for tp in TIMEPOINTS:
        df_tp = df[df["timepoint"] == tp]
        agg = {c: "mean" for c in centroid_cols}
        agg["group"] = "first"
        g = df_tp.groupby(["subject_id", "tract"], as_index=False).agg(agg)
        g["timepoint"] = tp
        frames.append(g)
    cents = pd.concat(frames, ignore_index=True)

    rows = []
    for (subject, tract), g in cents.groupby(["subject_id", "tract"]):
        base = g[g["timepoint"] == "2d"]
        if len(g) < 2 or len(base) == 0:
            continue
        bx, by, bz = (base[c].values[0] for c in centroid_cols)
        group = base["group"].values[0]
        for _, row in g.iterrows():
            dx = row["centroid_x_mean"] - bx
            dy = row["centroid_y_mean"] - by
            dz = row["centroid_z_mean"] - bz
            rows.append({
                "subject_id": subject, "tract": tract,
                "timepoint": row["timepoint"], "group": group,
                "displacement_mm": float(np.sqrt(dx * dx + dy * dy + dz * dz)),
                "dx": dx, "dy": dy, "dz": dz})
    disp = pd.DataFrame(rows)
    output_dir.mkdir(parents=True, exist_ok=True)
    disp.to_csv(output_dir / "centroid_displacement_data.csv", index=False)

    if len(disp):
        if make_plots:
            from ..viz.classify_viz import plot_centroid_displacement
            plot_centroid_displacement(disp, TIMEPOINTS, output_dir)
        # reference displacement summary report (classification.py:613-624)
        lines = ["\nDisplacement Summary (from 2d baseline):", "-" * 80]
        for tp in TIMEPOINTS:
            d_tp = disp[disp["timepoint"] == tp]
            if not len(d_tp):
                continue
            lines.append(f"\n{tp}:")
            for group in ("TBI", "PTE"):
                d_g = d_tp[d_tp["group"] == group]["displacement_mm"]
                if len(d_g):
                    lines.append(f"  {group}: {d_g.mean():.2f} "
                                 f"± {d_g.std():.2f} mm")
        log.info("%s", "\n".join(lines))
    return disp


def run_classification(data_path: str | Path,
                       output_dir: str | Path,
                       make_plots: bool = True) -> pd.DataFrame:
    """Full classification stage (reference main(): 627-722).
    Returns the classification_summary DataFrame."""
    output_dir = Path(output_dir)
    output_dir.mkdir(parents=True, exist_ok=True)
    _banner("TBI vs PTE CLASSIFICATION AND VISUALIZATION ANALYSIS")  # :637-639
    df = load_and_prepare_data(data_path)
    feature_cols = get_feature_columns(df, report=True)

    if make_plots:
        from ..viz.classify_viz import (plot_classification_results,
                                        plot_temporal_trends,
                                        plot_top_predictor_boxplots,
                                        plot_top_predictors)

    all_results = {}
    with stage("classify.cv"):
        for tp in TIMEPOINTS:
            df_subj = aggregate_features_per_subject(df, tp, feature_cols)
            if df_subj.empty or df_subj["group_binary"].nunique() < 2:
                log.warning("timepoint %s lacks both classes — skipped", tp)
                continue
            _banner(f"TIMEPOINT: {tp}")  # reference :655-657
            log.info("\nSubjects: %d (TBI: %d, PTE: %d)", len(df_subj),
                     (df_subj["group_binary"] == 0).sum(),
                     (df_subj["group_binary"] == 1).sum())  # reference :662
            X = df_subj[feature_cols].values
            y = df_subj["group_binary"].values
            results, _ = train_models_with_cv(X, y)
            all_results[tp] = results

            if make_plots:
                plot_classification_results(results, tp, output_dir)
                imp = results["Random Forest"]["feature_importance"]
                if imp is not None:
                    top = plot_top_predictors(imp, feature_cols, tp, output_dir)
                    plot_top_predictor_boxplots(df, tp, top, output_dir)

    with stage("classify.displacement"):
        if make_plots and len(df):
            _banner("TEMPORAL TREND ANALYSIS")  # reference :689-691
            plot_temporal_trends(df, feature_cols, TIMEPOINTS, output_dir)
        analyze_centroid_displacement(df, output_dir, make_plots=make_plots)

    summary_rows = []
    for tp, results in all_results.items():
        for name in ("Random Forest", "SVM", "Elastic Net"):
            r = results[name]
            summary_rows.append({
                "timepoint": tp, "model": name, "accuracy": r["accuracy"],
                "auc": r["auc"], "sensitivity": r["sensitivity"],
                "specificity": r["specificity"]})
    summary = pd.DataFrame(summary_rows)
    summary.to_csv(output_dir / "classification_summary.csv", index=False)
    _banner("ANALYSIS COMPLETE!")  # reference :715-716
    log.info("classification complete → %s", output_dir)
    return summary
