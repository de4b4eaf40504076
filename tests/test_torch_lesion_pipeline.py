"""The lesion SH + heme stage of the port against the JAX package, end to
end on a tiny synthetic cohort: synth volumes, the lenient cohort DataFrame,
the strict single-lesion record and cohort, and the port's CLI."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from lesionvae_tpu.io import synth as jsynth
from lesionvae_tpu.pipeline import lesion_run as jrun
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.pipeline import lesion_run as trun
from tests.test_lesion_pipeline import LENIENT_COLS, STRICT_COLS

REPO = Path(__file__).resolve().parents[1]
PORT = dict(device="cpu", dtype=torch.float64)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """The fixture of tests/test_lesion_pipeline.py, written by the port's
    synth (no bundles)."""
    cfg = tsynth.tiny_config(n_per_group=1, tracts=["atr_left"])
    root = tsynth.generate_cohort(tmp_path_factory.mktemp("torch_lesions"),
                                  cfg, seed=11, volume_shape=(24, 24, 24))
    return cfg, root


def _assert_frames_equal(got: pd.DataFrame, want: pd.DataFrame):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if not pd.api.types.is_numeric_dtype(want[col]):
            assert list(g) == list(w), col
        else:
            np.testing.assert_allclose(g.astype(float), w.astype(float),
                                       rtol=1e-9, atol=1e-12, equal_nan=True,
                                       err_msg=col)


def test_synth_volumes_byte_identical(cohort, tmp_path):
    cfg, root = cohort
    jroot = jsynth.generate_cohort(tmp_path, cfg, seed=11, n_streamlines=1,
                                   volume_shape=(24, 24, 24),
                                   with_profiles=False)
    want = sorted(p.relative_to(jroot) for p in jroot.rglob("*.nii.gz"))
    got = sorted(p.relative_to(root) for p in root.rglob("*.nii.gz"))
    assert got == want and len(got) == 3 * 4 * 3 + 2 * 3
    for rel in want:
        assert (root / rel).read_bytes() == (jroot / rel).read_bytes(), rel


def test_lenient_cohort_matches_jax(cohort, tmp_path):
    cfg, root = cohort
    want = jrun.run_lesion_analysis(cfg, data_dir=root / "data",
                                    output_dir=tmp_path / "jax",
                                    num_samples=500, seed=0)
    got = trun.run_lesion_analysis(cfg, data_dir=root / "data",
                                   output_dir=tmp_path / "torch",
                                   num_samples=500, seed=0, **PORT)
    assert list(got.columns) == LENIENT_COLS
    # some surfaces were subsampled, so the seeded host RNG is exercised
    assert (got["num_surface_points"] == 500).any()
    _assert_frames_equal(got, want)
    on_disk = pd.read_csv(tmp_path / "torch" / "lesion_sh_heme_comprehensive.csv")
    assert list(on_disk.columns) == LENIENT_COLS and len(on_disk) == 8


def test_strict_single_lesion_matches_jax(cohort):
    cfg, root = cohort
    tbi = cfg.subjects_by_group()["TBI"][0]
    for tp in ("2d", "9d"):
        want, ok_w = jrun.analyze_single_lesion(
            tbi, tp, root / "data", strict=True, num_samples=500,
            rng=np.random.default_rng(3))
        got, ok_g = trun.analyze_single_lesion(
            tbi, tp, root / "data", strict=True, num_samples=500,
            rng=np.random.default_rng(3), **PORT)
        assert ok_g == ok_w
        if want is None:
            assert got is None
            continue
        assert list(got) == list(want) == STRICT_COLS[:-1]
        _assert_frames_equal(pd.DataFrame([got]), pd.DataFrame([want]))


def test_strict_cohort_matches_jax(cohort, tmp_path):
    cfg, root = cohort
    kw = dict(data_dir=root / "data", num_samples=500, seed=5,
              make_plots=False)
    want = jrun.run_lesion_shape_descriptors(cfg, output_dir=tmp_path / "j", **kw)
    got = trun.run_lesion_shape_descriptors(cfg, output_dir=tmp_path / "t",
                                            **kw, **PORT)
    assert list(got.columns) == STRICT_COLS
    _assert_frames_equal(got, want)
    assert (tmp_path / "t" / "group_statistics.csv").exists()


def test_cli_lesion_on_cpu(cohort, tmp_path):
    """``python -m lesionvae_tpu_torch lesion --device cpu``, with a
    torch.profiler trace of the stage."""
    cfg, root = cohort
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    out = tmp_path / "results"
    proc = subprocess.run(
        [sys.executable, "-m", "lesionvae_tpu_torch", "lesion", "--device",
         "cpu", "--config", str(cfg_path), "--base-path", str(root),
         "--output-dir", str(out), "--num-samples", "300", "--seed", "0",
         "--trace", str(tmp_path / "trace")],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "lesion.sh_batch" in proc.stdout
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
    df = pd.read_csv(out / "lesion_sh_heme_comprehensive"
                     / "lesion_sh_heme_comprehensive.csv")
    assert list(df.columns) == LENIENT_COLS and len(df) == 8
    real = df[df["original_volume_mm3"] > 0]
    assert len(real) == 6
    np.testing.assert_allclose(real[[f"P{l}" for l in range(7)]].sum(axis=1),
                               1.0, rtol=1e-5)
    assert (real["reconstruction_r"] > 0.9).all()
