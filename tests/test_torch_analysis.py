"""The port's host analysis stages (classification, correlation) and
``ops.padding.unpad`` against the JAX package's.

Both packages run the same scipy/sklearn code on the same CSV, so every
value is held with rtol 0: the summary, the displacement table and the
significant correlations equal the JAX package's cell for cell.  The golden
cohort is tests/test_analysis_golden.py's (18 TBI / 12 PTE, the reference's
10 folds); the adaptive-fold cases are tests/test_adaptive_cv.py's; the
strong-signal and zero-at-baseline cases are tests/test_analysis.py's."""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

from lesionvae_tpu.ops import padding as jpad
from lesionvae_tpu.pipeline import classification as jclf
from lesionvae_tpu.pipeline import correlation as jcorr
from lesionvae_tpu_torch.ops import padding as tpad
from lesionvae_tpu_torch.pipeline import classification as tclf
from lesionvae_tpu_torch.pipeline import correlation as tcorr

from test_adaptive_cv import _tiny_cohort
from test_analysis import _synth_geometry_csv, _synth_lesion_csv
from test_analysis_golden import _make_cohort_csvs

CLF_FILES = ("classification_summary.csv", "centroid_displacement_data.csv")


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


def _same_csv(a, b):
    """Equal columns, equal text, numbers equal to the bit (rtol 0)."""
    pd.testing.assert_frame_equal(pd.read_csv(a), pd.read_csv(b), check_exact=True)


# ---------------------------------------------------------------- unpad
@pytest.mark.parametrize("as_tensor", [False, True])
def test_unpad_matches_jax(as_tensor):
    rng = np.random.default_rng(0)
    sls = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 1, 9, 2)]
    values, lengths = tpad.pad_streamlines(sls)
    want = jpad.unpad(values, lengths)
    if as_tensor:
        values, lengths = torch.from_numpy(values), torch.from_numpy(lengths)
    got = tpad.unpad(values, lengths)
    assert len(got) == len(want) == len(sls)
    for g, w, s in zip(got, want, sls):
        assert isinstance(g, np.ndarray)
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, s)


def test_unpad_surfaces_matches_jax():
    rng = np.random.default_rng(1)
    pts = [rng.normal(size=(n, 3)) for n in (7, 3, 12)]
    values, counts = tpad.pad_batch(pts, dtype=np.float64)
    for g, w in zip(tpad.unpad(values, counts), jpad.unpad(values, counts)):
        np.testing.assert_array_equal(g, w)


# ---------------------------------------------------------------- golden cohort
@pytest.fixture(scope="module")
def golden(tmp_path_factory):
    """Both packages' classification and correlation stages on the golden
    cohort's CSVs, figures off."""
    root = tmp_path_factory.mktemp("golden_both")
    geo_csv, les_csv = _make_cohort_csvs(root)
    out = {}
    for name, clf, corr in (("jax", jclf, jcorr), ("torch", tclf, tcorr)):
        d = root / name
        out[name] = dict(
            dir=d,
            summary=clf.run_classification(geo_csv, d / "clf", make_plots=False),
            sig=corr.run_correlation(les_csv, geo_csv, d / "corr", make_plots=False))
    return out


@pytest.mark.parametrize("name", CLF_FILES)
def test_classification_files_equal_jax(golden, name):
    _same_csv(golden["torch"]["dir"] / "clf" / name, golden["jax"]["dir"] / "clf" / name)


def test_classification_summary_equal_jax(golden):
    got, want = golden["torch"]["summary"], golden["jax"]["summary"]
    assert len(got) == 12
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_correlations_equal_jax(golden):
    got, want = golden["torch"]["sig"], golden["jax"]["sig"]
    assert len(got) == 33 and (got["p"] < 0.05).all()
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    _same_csv(golden["torch"]["dir"] / "corr" / "significant_correlations.csv",
              golden["jax"]["dir"] / "corr" / "significant_correlations.csv")


def test_figures_off_leave_out_the_displacement_figure_only(golden):
    """Figures off, the JAX package still draws the displacement figure (it
    imports the figure module whatever ``make_plots`` says); the port writes
    the rest and not that figure (different by construction)."""
    want = [f for f in _tree(golden["jax"]["dir"])
            if f != "clf/centroid_displacement_analysis.png"]
    assert len(want) == len(_tree(golden["jax"]["dir"])) - 1
    assert _tree(golden["torch"]["dir"]) == want


def test_correlation_report_equal_jax(golden):
    sig = golden["jax"]["sig"]
    assert tcorr.create_summary_report(sig) == jcorr.create_summary_report(sig)
    assert tcorr.create_summary_report(pd.DataFrame()) == "no significant correlations"


def test_constants_equal_jax():
    assert tcorr.SH_FEATURES == jcorr.SH_FEATURES
    assert tcorr.TRACT_FEATURES == jcorr.TRACT_FEATURES
    assert tcorr.TIMEPOINTS == jcorr.TIMEPOINTS
    assert tclf.TIMEPOINTS == jclf.TIMEPOINTS
    assert tclf.EXCLUDE_COLS == jclf.EXCLUDE_COLS


# ---------------------------------------------------------------- figures on
@pytest.mark.parametrize("stage", ["classify", "correlate"])
def test_figures_on_write_the_same_file_names(tmp_path, stage):
    """With figures on, both packages write the same files (a small cohort:
    4 TBI / 3 PTE, so the folds cap at 3)."""
    gcsv = tmp_path / "geom.csv"
    gdf, _ = _synth_geometry_csv(gcsv, seed=3, n_tbi=4, n_pte=3)
    lcsv = tmp_path / "lesion.csv"
    _synth_lesion_csv(lcsv, gdf, seed=3)
    for name, clf, corr in (("jax", jclf, jcorr), ("torch", tclf, tcorr)):
        if stage == "classify":
            clf.run_classification(gcsv, tmp_path / name, make_plots=True)
        else:
            corr.run_correlation(lcsv, gcsv, tmp_path / name, make_plots=True)
    got, want = _tree(tmp_path / "torch"), _tree(tmp_path / "jax")
    assert got == want and any(f.endswith(".png") for f in got)
    for f in got:
        if f.endswith(".csv"):
            _same_csv(tmp_path / "torch" / f, tmp_path / "jax" / f)


# ---------------------------------------------------------------- adaptive folds
@pytest.mark.parametrize("n_maj,n_min,folds", [(9, 4, 4), (6, 2, 2)])
def test_adaptive_folds_equal_jax(caplog, n_maj, n_min, folds):
    X, y = _tiny_cohort(n_maj=n_maj, n_min=n_min)
    logger = logging.getLogger("lesionvae_tpu_torch.classify")
    logger.addHandler(caplog.handler)
    try:
        got, _ = tclf.train_models_with_cv(X, y, random_state=42)
    finally:
        logger.removeHandler(caplog.handler)
    assert any(f"reducing CV folds to {folds}" in r.getMessage()
               for r in caplog.records)
    want, _ = jclf.train_models_with_cv(X, y, random_state=42)
    assert set(got) == set(want) == {"Random Forest", "SVM", "Elastic Net"}
    for name in want:
        for key in ("accuracy", "auc", "sensitivity", "specificity"):
            assert got[name][key] == want[name][key], (name, key)
        for key in ("y_pred", "y_pred_proba", "fpr", "tpr", "confusion_matrix"):
            np.testing.assert_array_equal(got[name][key], want[name][key])
    np.testing.assert_array_equal(got["Random Forest"]["feature_importance"],
                                  want["Random Forest"]["feature_importance"])
    if folds == 4:   # tests/test_adaptive_cv.py's pins
        assert got["SVM"]["accuracy"] == pytest.approx(12 / 13, abs=1e-4)
        assert got["SVM"]["auc"] == pytest.approx(0.52778, abs=1e-4)


# ---------------------------------------------------------------- the stages' cases
def test_centroid_displacement_zero_at_baseline(tmp_path):
    csv = tmp_path / "geom.csv"
    _synth_geometry_csv(csv, seed=2)
    df = tclf.load_and_prepare_data(csv)
    disp = tclf.analyze_centroid_displacement(df, tmp_path / "t", make_plots=False)
    base = disp[disp["timepoint"] == "2d"]
    np.testing.assert_allclose(base["displacement_mm"], 0.0, atol=1e-12)
    assert {"dx", "dy", "dz"}.issubset(disp.columns)
    want = jclf.analyze_centroid_displacement(jclf.load_and_prepare_data(csv),
                                              tmp_path / "j")
    pd.testing.assert_frame_equal(disp, want, check_exact=True)
    # figures off: the table and nothing else
    assert _tree(tmp_path / "t") == ["centroid_displacement_data.csv"]


def test_aggregation_and_feature_columns_equal_jax(tmp_path):
    csv = tmp_path / "geom.csv"
    _synth_geometry_csv(csv, seed=4)
    got, want = tclf.load_and_prepare_data(csv), jclf.load_and_prepare_data(csv)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    cols = tclf.get_feature_columns(got)
    assert cols == jclf.get_feature_columns(want)
    for tp in tclf.TIMEPOINTS:
        pd.testing.assert_frame_equal(
            tclf.aggregate_features_per_subject(got, tp, cols),
            jclf.aggregate_features_per_subject(want, tp, cols), check_exact=True)


def test_correlation_strong_signal_detected(tmp_path):
    """A perfect P2 <-> length_mean correlation is reported, as the JAX
    package reports it."""
    rng = np.random.default_rng(9)
    rows_l, rows_g = [], []
    for i in range(12):
        sid = 5000 + i
        p2 = rng.uniform(0, 1)
        rows_l.append({"subject_id": sid, "timepoint": "1mo", "group": "TBI",
                       **{f"P{l}": (p2 if l == 2 else 0.1) for l in range(7)},
                       "original_volume_mm3": 1.0, "lesion_brain_ratio": 0.01,
                       "brain_volume_mm3": 500.0})
        rows_g.append({"subject_id": sid, "timepoint": "1mo", "group": "TBI",
                       "tract": "atr_left", "n_streamlines": 10,
                       "length_mean": 2.0 + 3.0 * p2,
                       **{c: rng.normal() for c in tcorr.TRACT_FEATURES[2:]}})
    lcsv, gcsv = tmp_path / "l.csv", tmp_path / "g.csv"
    pd.DataFrame(rows_l).to_csv(lcsv, index=False)
    pd.DataFrame(rows_g).to_csv(gcsv, index=False)
    got = tcorr.run_correlation(lcsv, gcsv, tmp_path / "t", make_plots=False)
    hit = got[(got["sh_feature"] == "P2") & (got["tract_feature"] == "length_mean")]
    assert len(hit) == 1
    assert hit.iloc[0]["r"] == pytest.approx(1.0, abs=1e-9)
    want = jcorr.run_correlation(lcsv, gcsv, tmp_path / "j", make_plots=False)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_pair_values_is_the_filter_of_compute_correlations(tmp_path):
    """``pair_values`` returns the data of every pair ``compute_correlations``
    tests and None for the pairs it skips (too few, constant)."""
    from scipy.stats import pearsonr

    gcsv, lcsv = tmp_path / "g.csv", tmp_path / "l.csv"
    gdf, _ = _synth_geometry_csv(gcsv, seed=6)
    _synth_lesion_csv(lcsv, gdf, seed=6)
    merged = tcorr.merge_lesion_tract_data(*tcorr.load_data(lcsv, gcsv))
    merged.loc[merged.index[:3], "P4"] = np.nan
    sig = tcorr.compute_correlations(merged, "TBI", "9d", tcorr.SH_FEATURES,
                                     tcorr.TRACT_FEATURES)
    assert sig == jcorr.compute_correlations(merged, "TBI", "9d", jcorr.SH_FEATURES,
                                             jcorr.TRACT_FEATURES)
    for row in sig:
        xy = tcorr.pair_values(merged, "TBI", "9d", row["sh_feature"],
                               row["tract_feature"])
        assert pearsonr(*xy)[1] == row["p"] and len(xy[0]) == row["n"]
    assert tcorr.pair_values(merged, "TBI", "2d", "P0", "length_mean") is None
    merged["const"] = 1.0
    assert tcorr.pair_values(merged, "TBI", "9d", "P0", "const") is None
