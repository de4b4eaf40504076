"""``python -m lesionvae_tpu_torch all|classify|correlate`` against
``python -m lesionvae_tpu`` on a tiny synthetic cohort, on the CPU.

- ``all --device cpu`` writes the JAX ``all``'s tree of file names; its
  geometry CSVs are held to the float32 bounds of
  tests/test_torch_geometry_pipeline.py (1e-5 x max(1, |x|), the two
  eigen-ratio means 2e-3) and its lesion CSV to 1e-5 x max(1, |x|), the
  float32 bound of the lesion path (``chip_smoke.py`` holds the card to
  1e-4 there; the CPU float32 runs of the two packages read ~1e-7);
- ``classify`` and ``correlate`` fed the JAX run's CSVs write the JAX run's
  classification and correlation CSVs exactly (rtol 0);
- ``all --with-vae --epochs 2 --no-plots`` writes the fleet's files and no
  figure;
- a missing host package stops ``all`` before its first stage."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

from lesionvae_tpu import cli as jcli
from lesionvae_tpu_torch import cli as tcli
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.utils import profiling

torch.set_num_threads(1)

GEO_DIR, LES_DIR = "comprehensive_tract_geometry", "lesion_sh_heme_comprehensive"
GEO_CSVS = ("comprehensive_tract_geometry_metrics.csv",
            "summary_statistics_by_group_timepoint.csv",
            "summary_statistics_by_tract_group.csv")
RATIO_MEANS = {"elongation_ratio_mean", "planarity_ratio_mean",
               "elongation_ratio_mean_mean", "elongation_ratio_mean_std",
               "planarity_ratio_mean_mean", "planarity_ratio_mean_std"}
ANALYSIS_CSVS = ("tbi_pte_classification/classification_summary.csv",
                 "tbi_pte_classification/centroid_displacement_data.csv",
                 "lesion_tract_correlations/significant_correlations.csv")


def _tree(root):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One cohort (3 subjects a group, one tract, bundles and profiles), the
    JAX ``all`` and the port's ``all --device cpu`` over it, figures on."""
    root = tmp_path_factory.mktemp("cli_all")
    cfg = tsynth.tiny_config(n_per_group=3, tracts=["atr_left"])
    tsynth.generate_cohort(root, cfg, seed=29, n_streamlines=4,
                           volume_shape=(16, 16, 16), with_profiles=True,
                           with_bundles=True)
    cfg_path = root / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    common = ["--config", str(cfg_path), "--base-path", str(root),
              "--num-samples", "256"]
    assert jcli.main(["all", *common, "--output-dir", str(root / "jax")]) == 0
    profiling.reset()
    assert tcli.main(["all", *common, "--output-dir", str(root / "torch"),
                      "--device", "cpu"]) == 0
    return dict(root=root, common=common, cfg_path=cfg_path,
                spans=profiling.report())


def test_all_writes_the_jax_tree(runs):
    got, want = _tree(runs["root"] / "torch"), _tree(runs["root"] / "jax")
    assert got == want
    assert any(f.endswith(".png") for f in got)
    assert all(f in got for f in ANALYSIS_CSVS)
    for key in ("geometry", "geometry.read", "lesion", "classify.cv",
                "classify.displacement", "correlate"):
        assert key in runs["spans"], key


def _close(got_csv, want_csv, bound):
    got, want = pd.read_csv(got_csv), pd.read_csv(want_csv)
    assert list(got.columns) == list(want.columns) and len(got) == len(want) > 0
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if not pd.api.types.is_numeric_dtype(want[col]):
            assert list(g.astype(str)) == list(w.astype(str)), col
            continue
        g, w = g.astype(float), w.astype(float)
        np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=col)
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=col)
        fin = np.isfinite(w)
        rel = np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
        assert rel.size == 0 or rel.max() <= bound(col), (col, rel.max())


@pytest.mark.parametrize("name", GEO_CSVS)
def test_all_geometry_csvs_match_jax(runs, name):
    _close(runs["root"] / "torch" / GEO_DIR / name, runs["root"] / "jax" / GEO_DIR / name,
           lambda col: 2e-3 if col in RATIO_MEANS else 1e-5)


def test_all_lesion_csv_matches_jax(runs):
    name = f"{LES_DIR}/lesion_sh_heme_comprehensive.csv"
    _close(runs["root"] / "torch" / name, runs["root"] / "jax" / name, lambda col: 1e-5)
    assert len(pd.read_csv(runs["root"] / "torch" / name)) == 6 * 4


def test_classify_and_correlate_on_the_jax_csvs_equal_jax(runs, tmp_path):
    """The two host stages through the port's CLI, fed the JAX run's CSVs,
    write its analysis CSVs cell for cell."""
    jax_out = runs["root"] / "jax"
    args = ["--config", str(runs["cfg_path"]), "--output-dir", str(tmp_path),
            "--no-plots"]
    assert tcli.main(["classify", *args, "--geometry-csv",
                      str(jax_out / GEO_DIR / GEO_CSVS[0])]) == 0
    assert tcli.main(["correlate", *args, "--geometry-csv",
                      str(jax_out / GEO_DIR / GEO_CSVS[0]), "--lesion-csv",
                      str(jax_out / LES_DIR / "lesion_sh_heme_comprehensive.csv")]) == 0
    for name in ANALYSIS_CSVS:
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / name),
                                      pd.read_csv(jax_out / name), check_exact=True)
    assert not any(f.endswith(".png") for f in _tree(tmp_path))


def test_classify_and_correlate_default_paths(runs, tmp_path):
    """Without CSV flags the two stages read what ``geometry`` and ``lesion``
    wrote under the output directory, as the JAX CLI does."""
    out = tmp_path / "out"
    for sub in (GEO_DIR, LES_DIR):
        (out / sub).mkdir(parents=True)
    src = runs["root"] / "jax"
    (out / GEO_DIR / GEO_CSVS[0]).write_bytes((src / GEO_DIR / GEO_CSVS[0]).read_bytes())
    name = "lesion_sh_heme_comprehensive.csv"
    (out / LES_DIR / name).write_bytes((src / LES_DIR / name).read_bytes())
    args = ["--config", str(runs["cfg_path"]), "--output-dir", str(out), "--no-plots"]
    assert tcli.main(["classify", *args]) == 0
    assert tcli.main(["correlate", *args]) == 0
    for name in ANALYSIS_CSVS:
        assert (out / name).read_bytes() == (src / name).read_bytes(), name


def test_all_with_vae_writes_the_fleet(runs, tmp_path):
    assert tcli.main(["all", *runs["common"], "--output-dir", str(tmp_path),
                      "--device", "cpu", "--with-vae", "--epochs", "2",
                      "--no-plots"]) == 0
    fleet = tmp_path / "vae_cohort"
    files = sorted(p.name for p in fleet.iterdir())
    keys = [f"atr_left_{tp}" for tp in ("2d", "9d", "1mo", "5mo")]
    assert files == sorted([f"training_history_{k}.csv" for k in keys]
                           + [f"zscores_{k}.npz" for k in keys])
    for k in keys:
        hist = pd.read_csv(fleet / f"training_history_{k}.csv")
        assert len(hist) == 2 and np.isfinite(hist.to_numpy()).all()
        z = np.load(fleet / f"zscores_{k}.npz", allow_pickle=True)
        assert np.isfinite(z["magnitude"]).all() and np.isfinite(z["subj_profile"]).all()
    assert not any(f.endswith(".png") for f in _tree(tmp_path))
    assert all((tmp_path / f).exists() for f in ANALYSIS_CSVS)


@pytest.mark.parametrize("missing,plots,stage", [
    ("sklearn", False, "all"), ("sklearn", False, "classify"),
    ("seaborn", True, "all"), ("matplotlib", True, "correlate")])
def test_a_missing_host_package_stops_before_any_stage(runs, tmp_path, monkeypatch,
                                                       missing, plots, stage):
    """An import check, before the first stage: an ImportError naming the
    package, and nothing written."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == missing else real(name, *a))
    args = [stage, *runs["common"][:4], "--output-dir", str(tmp_path / "out"),
            "--device", "cpu"] + ([] if plots else ["--no-plots"])
    with pytest.raises(ImportError, match=missing) as err:
        tcli.main(args)
    assert err.value.name == missing
    assert ("--no-plots" in str(err.value)) == plots
    assert not (tmp_path / "out").exists()
