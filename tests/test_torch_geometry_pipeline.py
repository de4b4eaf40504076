"""The port's tract-geometry stage (lesionvae_tpu_torch.pipeline.geometry_run,
its synth bundles and its CLI) against the JAX package, end to end on a tiny
synthetic cohort, on the CPU.

Bounds on the three CSVs (relative to max(1, |x|)):
- float64, points uploaded as float32 (the JAX package's route): 1e-10,
  inf for inf, NaN for NaN (read: equal);
- float32: 1e-5, but the two eigen-ratio means at 2e-3, the band
  tests/test_geo_codec.py pins at bundle level (a float32 ratio over a small
  eigenvalue carries ~1e-6 x its conditioning; read 9e-5);
- ``upload="u16d"``, either type: 2e-3 for every column but torsion (the
  port sums the decoded deltas in order, XLA associates its cumsum otherwise:
  points differ in their last bits and curvature energy, a square of
  curvature, by ~2e-5), torsion from the host in float64 on both sides:
  equal.
"""

import gzip
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lesionvae_tpu.io import synth as jsynth
from lesionvae_tpu.pipeline import geometry_run as jrun
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.io import vtk as tvtk
from lesionvae_tpu_torch.ops import geometry as tg
from lesionvae_tpu_torch.pipeline import geometry_run as trun
from lesionvae_tpu_torch.utils import profiling
from tests.test_geometry_pipeline import EXPECTED_COLS

REPO = Path(__file__).resolve().parents[1]
CSVS = ("comprehensive_tract_geometry_metrics.csv",
        "summary_statistics_by_group_timepoint.csv",
        "summary_statistics_by_tract_group.csv")
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32)}
RATIO_MEANS = {"elongation_ratio_mean", "planarity_ratio_mean",
               "elongation_ratio_mean_mean", "elongation_ratio_mean_std",
               "planarity_ratio_mean_mean", "planarity_ratio_mean_std"}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The fixture of tests/test_geometry_pipeline.py, written by the port's
    synth with bundles."""
    cfg = tsynth.tiny_config(n_per_group=1, tracts=["atr_left", "fimbria_right"])
    root = tsynth.generate_cohort(tmp_path_factory.mktemp("torch_geometry"), cfg,
                                  seed=5, n_streamlines=8, volume_shape=(8, 8, 8),
                                  with_bundles=True)
    return cfg, root


def _bound(col: str, dtype: str, upload: str) -> float:
    if upload == "u16d" and col != "torsion_mean_avg":
        return 2e-3
    if dtype == "f32" and col in RATIO_MEANS:
        return 2e-3
    return 1e-10 if dtype == "f64" else 1e-5


def _assert_csvs_match(got_dir: Path, want_dir: Path, dtype: str, upload: str = "f32"):
    for name in CSVS:
        got, want = pd.read_csv(got_dir / name), pd.read_csv(want_dir / name)
        assert list(got.columns) == list(want.columns), name
        assert len(got) == len(want) > 0, name
        for col in want.columns:
            g, w = got[col].to_numpy(), want[col].to_numpy()
            if not pd.api.types.is_numeric_dtype(want[col]):
                assert list(g.astype(str)) == list(w.astype(str)), (name, col)
                continue
            g, w = g.astype(float), w.astype(float)
            np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=col)
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=col)
            fin = np.isfinite(w)
            rel = np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
            assert rel.size == 0 or rel.max() <= _bound(col, dtype, upload), \
                (name, col, rel.max())


def test_synth_bundles_byte_identical(cohort, tmp_path):
    cfg, root = cohort
    jroot = jsynth.generate_cohort(tmp_path / "jax", cfg, seed=5, n_streamlines=8,
                                   volume_shape=(8, 8, 8), with_profiles=False)
    want = sorted(p.relative_to(jroot) for p in jroot.rglob("*.gz"))
    got = sorted(p.relative_to(root) for p in root.rglob("*.gz"))
    assert got == want and sum("bundles" in str(p) for p in got) == 3 * 4 * 2
    for rel in want:
        assert (root / rel).read_bytes() == (jroot / rel).read_bytes(), rel
    # without bundles the same call writes the same volumes and no bundle
    plain = tsynth.generate_cohort(tmp_path / "plain", cfg, seed=5, n_streamlines=8,
                                   volume_shape=(8, 8, 8))
    files = sorted(p.relative_to(plain) for p in plain.rglob("*.gz"))
    assert files == [p for p in want if "bundles" not in str(p)]
    for rel in files:
        assert (plain / rel).read_bytes() == (jroot / rel).read_bytes(), rel


def test_make_streamline_matches_jax():
    rng_t, rng_j = np.random.default_rng(3), np.random.default_rng(3)
    center = np.array([1.0, -2.0, 0.5])
    np.testing.assert_array_equal(tsynth.make_streamline(rng_t, 25, center),
                                  jsynth.make_streamline(rng_j, 25, center))


@pytest.mark.parametrize("upload", ["f32", "u16d"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_run_geometry_matches_jax(cohort, tmp_path, dtype, upload):
    cfg, root = cohort
    tdt, jdt = DTYPES[dtype]
    profiling.reset()
    got = trun.run_geometry(cfg, data_dir=root / "data", output_dir=tmp_path / "t",
                            dtype=tdt, upload=upload, device="cpu")
    rep = profiling.report()
    for key in ("geometry", "geometry.read", "geometry.launch", "geometry.compute",
                "geometry.write"):
        assert key in rep and rep[key] >= 0.0
    want = jrun.run_geometry(cfg, data_dir=root / "data", output_dir=tmp_path / "j",
                             dtype=jdt, upload=upload)
    assert list(got.columns) == EXPECTED_COLS and len(got) == 3 * 4 * 2
    assert (got["n_streamlines"] == 8).all()
    _assert_csvs_match(tmp_path / "t", tmp_path / "j", dtype, upload)


@pytest.mark.parametrize("upload", ["f32", "u16d"])
def test_chunking_changes_nothing(cohort, monkeypatch, upload):
    """Results do not depend on the chunk size: 16 streamlines a launch
    (full chunks and a power-of-two tail in each bucket) against the default
    single chunk, bit for bit."""
    cfg, root = cohort
    bundles = [tvtk.read_streamlines(p) for p in
               sorted((root / "data").rglob("*_curves.vtk.gz"))]
    whole = trun.launch_bundle_metrics(bundles, upload=upload, device="cpu")
    want = whole()
    monkeypatch.setattr(trun, "_CHUNK_S", 16)
    chunked = trun.launch_bundle_metrics(bundles, upload=upload, device="cpu")
    got = chunked()
    buckets = {}
    for b in bundles:
        for sl in b:
            buckets[trun._bucket_P(len(sl))] = buckets.get(trun._bucket_P(len(sl)), 0) + 1
    assert chunked.launches == sum(-(-n // 16) for n in buckets.values()) > len(buckets)
    assert whole.launches == len(buckets)
    assert chunked.streamlines == whole.streamlines == sum(buckets.values())
    assert got == pytest.approx(want, rel=0, abs=0, nan_ok=True)


def test_launch_bundle_metrics_matches_jax_both_codecs(cohort):
    cfg, root = cohort
    bundles = [tvtk.read_streamlines(p) for p in
               sorted((root / "data").rglob("*_curves.vtk.gz"))[:6]]
    line = np.stack([np.linspace(0, 1, 20)] * 3, axis=1)   # inf eigen ratios
    bundles[0] = bundles[0] + [line]
    for upload in ("f32", "u16d"):
        for tdt, jdt in DTYPES.values():
            got = trun.launch_bundle_metrics(bundles, dtype=tdt, upload=upload,
                                             device="cpu")()
            want = jrun.launch_bundle_metrics(bundles, dtype=jdt, upload=upload)()
            for g, w in zip(got, want):
                assert g.keys() == w.keys() and g["n_streamlines"] == w["n_streamlines"]
                for k in w:
                    if np.isinf(w[k]):
                        assert g[k] == w[k], k
                    else:
                        bound = _bound(k, "f64" if tdt == torch.float64 else "f32", upload)
                        assert abs(g[k] - w[k]) <= bound * max(1.0, abs(w[k])), (k, upload)
    assert np.isinf(got[0]["elongation_ratio_mean"])
    with pytest.raises(ValueError, match="codec"):
        trun.launch_bundle_metrics([], upload="zstd", device="cpu")
    with pytest.raises(ValueError, match="float32 on cuda"):
        trun.launch_bundle_metrics(bundles, dtype=torch.float64, device="cuda")


def test_public_api_matches_jax_and_batched(cohort):
    cfg, root = cohort
    sid = cfg.subjects_by_group()["TBI"][0]
    path = root / "data" / sid / "9d" / "bundles" / "atr_left_curves.vtk.gz"
    df_sl, df_bundle = trun.compute_streamline_metrics(path, max_streamlines=100,
                                                       dtype=torch.float64, device="cpu")
    j_sl, j_bundle = jrun.compute_streamline_metrics(path, max_streamlines=100,
                                                     dtype=jnp.float64)
    assert list(df_sl.columns) == list(tg.METRIC_NAMES) and len(df_sl) == 8
    np.testing.assert_allclose(df_sl.to_numpy(), j_sl.to_numpy(), rtol=1e-10)
    pd.testing.assert_frame_equal(df_bundle, j_bundle, rtol=1e-10)
    sls = tvtk.read_streamlines(path, max_streamlines=100)
    batched = trun.batched_bundle_metrics([sls], dtype=torch.float64, device="cpu")[0]
    for k, v in batched.items():
        np.testing.assert_allclose(df_bundle.iloc[0][k], v, rtol=1e-12, err_msg=k)
    df_sl, df_bundle = trun.compute_streamline_metrics(path, max_streamlines=3,
                                                       device="cpu")
    assert len(df_sl) == 3 and df_bundle.iloc[0]["n_streamlines"] == 3
    empty_sl, empty_b = trun.metrics_dataframe([], device="cpu")
    assert list(empty_sl.columns) == list(tg.METRIC_NAMES) and len(empty_sl) == 0
    assert empty_b.iloc[0]["n_streamlines"] == 0


def test_missing_and_corrupt_files_skipped(cohort, tmp_path):
    cfg, root = cohort
    data = tmp_path / "data"
    subprocess.run(["cp", "-r", str(root / "data"), str(data)], check=True)
    sham = cfg.subjects_by_group()["Sham"][0]
    (data / sham / "2d" / "bundles" / "atr_left_curves.vtk.gz").write_bytes(
        gzip.compress(b"# vtk DataFile Version 3.0\nt\nASCII\nDATASET POLYDATA\n"
                      b"POINTS 5 float\n1 2 3\n"))
    cfg2 = tsynth.tiny_config(n_per_group=1, tracts=["atr_left", "nonexistent_tract"])
    df = trun.process_all_tracts(cfg2, data, max_streamlines=10, device="cpu")
    assert set(df["tract"]) == {"atr_left"} and len(df) == 3 * 4 - 1
    want = jrun.process_all_tracts(cfg2, data, max_streamlines=10, dtype=jnp.float64)
    assert list(df.columns) == list(want.columns) and len(df) == len(want)
    nothing = trun.launch_geometry(cfg2, data_dir=tmp_path / "none",
                                   output_dir=tmp_path / "out", device="cpu")
    assert len(nothing()) == 0


def test_decompress_vtk_if_needed(tmp_path):
    """The reference's inflate cache (comprehensive_tract_geometry_analysis
    .py:54-76): .gz inflates to a kept sibling .vtk, a fresh sibling is
    reused, a stale one refreshed, a corrupt archive falls back to itself."""
    sl = [np.cumsum(np.ones((5, 3)), axis=0)]
    raw = tmp_path / "bundle_curves.vtk"
    tvtk.write_vtk_polylines(raw, sl, binary=True)
    gz = tmp_path / "bundle_curves.vtk.gz"
    gz.write_bytes(gzip.compress(raw.read_bytes()))
    raw.unlink()
    out = trun.decompress_vtk_if_needed(gz)
    assert out == raw and out.exists()
    np.testing.assert_allclose(tvtk.read_streamlines(out)[0], sl[0])
    mtime = out.stat().st_mtime_ns
    assert trun.decompress_vtk_if_needed(gz) == out and out.stat().st_mtime_ns == mtime
    os.utime(out, (1, 1))
    assert trun.decompress_vtk_if_needed(gz) == out and out.stat().st_mtime_ns > 1e9
    bad = tmp_path / "bad_curves.vtk.gz"
    bad.write_bytes(b"not gzip at all")
    assert trun.decompress_vtk_if_needed(bad) == bad
    assert not (tmp_path / "bad_curves.vtk").exists()
    assert trun.decompress_vtk_if_needed(out) == out


def test_launch_geometry_equals_sync(cohort, tmp_path):
    cfg, root = cohort
    df_sync = trun.run_geometry(cfg, data_dir=root / "data", output_dir=tmp_path / "sync",
                                max_streamlines=50, device="cpu")
    finish = trun.launch_geometry(cfg, data_dir=root / "data",
                                  output_dir=tmp_path / "async", max_streamlines=50,
                                  device="cpu")
    finish.drain()
    pd.testing.assert_frame_equal(finish(), df_sync)
    assert finish.metrics.launches == 3 and finish.metrics.refined == 0   # P32, P48, P64
    for name in CSVS:
        assert ((tmp_path / "async" / name).read_bytes()
                == (tmp_path / "sync" / name).read_bytes())


@pytest.mark.parametrize("bucket", [(5, 32), (32, 32), (33, 48), (60, 64), (128, 128),
                                    (129, 256), (300, 512)])
def test_bucket_P_matches_jax(bucket):
    n, P = bucket
    assert trun._bucket_P(n) == jrun._bucket_P(n) == P


def _cli(pkg: str, *args, cwd=None):
    proc = subprocess.run([sys.executable, "-m", pkg, *args], cwd=cwd or REPO,
                          capture_output=True, text=True, timeout=600,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc


def test_cli_synth_then_geometry_match_jax(tmp_path):
    """``synth`` writes the JAX CLI's files byte for byte; ``geometry
    --device cpu`` writes its three CSVs (float32, both packages)."""
    cfg = tsynth.tiny_config(n_per_group=1, tracts=["atr_left"])
    cfg_path = tmp_path / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    for pkg, d in (("lesionvae_tpu_torch", "t"), ("lesionvae_tpu", "j")):
        _cli(pkg, "synth", "--config", str(cfg_path), "--base-path", str(tmp_path / d),
             "--n-streamlines", "5", "--volume", "8", "--seed", "3")
    want = sorted(p.relative_to(tmp_path / "j") for p in (tmp_path / "j").rglob("*")
                  if p.is_file())
    got = sorted(p.relative_to(tmp_path / "t") for p in (tmp_path / "t").rglob("*")
                 if p.is_file())
    assert got == want and any(p.suffix == ".csv" for p in got)
    for rel in want:
        assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes(), rel
    _cli("lesionvae_tpu_torch", "geometry", "--device", "cpu", "--config", str(cfg_path),
         "--base-path", str(tmp_path / "t"), "--max-streamlines", "20",
         "--trace", str(tmp_path / "trace"))
    _cli("lesionvae_tpu", "geometry", "--config", str(cfg_path), "--base-path",
         str(tmp_path / "j"), "--max-streamlines", "20")
    sub = Path("results") / "comprehensive_tract_geometry"
    _assert_csvs_match(tmp_path / "t" / sub, tmp_path / "j" / sub, "f32")
    assert (tmp_path / "trace" / "trace.json").exists()
