"""The port's VAE pipeline against the JAX package's: synthetic profile
CSVs, tensor building and normalization, normative z-scores and serving
(float64, with a JAX checkpoint carried across and the JAX noise injected),
and ``run_vae_analysis`` / the CLI end to end on the CPU."""

import json

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.io import synth as jsynth
from lesionvae_tpu.pipeline import infer as jinfer
from lesionvae_tpu.pipeline.vae_run import run_vae_analysis as jax_run_vae
from lesionvae_tpu.train import checkpoint as jckpt
from lesionvae_tpu.train import data as jdata
from lesionvae_tpu.train import normative as jnorm
from lesionvae_tpu.train.trainer import TrainedVAE as JaxTrainedVAE
from lesionvae_tpu.train.trainer import train_lesion_vae as jax_train
from lesionvae_tpu_torch import cli
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.pipeline import infer as tinfer
from lesionvae_tpu_torch.pipeline.vae_run import run_vae_analysis
from lesionvae_tpu_torch.train import checkpoint as tckpt
from lesionvae_tpu_torch.train import data as tdata
from lesionvae_tpu_torch.train import normative as tnorm
from lesionvae_tpu_torch.train.trainer import TrainedVAE

# Tiny shapes: one intra-op thread.  Several test workers, each with a
# thread per core inside every small product, oversubscribe the cores and
# slow these files many times over.
torch.set_num_threads(1)

TRACT, LAT, SEED = "atr_left", 3, 5


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A tiny profiles cohort (6 subjects x 4 timepoints) written by the
    port's synth, and its config."""
    root = tmp_path_factory.mktemp("vae_cohort")
    cfg = tsynth.tiny_config(n_per_group=2, tracts=[TRACT])
    tsynth.generate_cohort(root, cfg, seed=SEED, volume_shape=(8, 8, 8),
                           with_profiles=True, n_streamlines=16)
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    return root, cfg, cfg_path


def _subjects(cfg):
    groups = {g: list(s) for g, s in cfg.subjects_by_group().items()}
    return groups, [s for subs in groups.values() for s in subs]


def _tensors(cfg, root, tp, pkg=tdata):
    groups, subjects = _subjects(cfg)
    return pkg.build_tensor_with_lesion_context(
        root, TRACT, tp, subjects, cfg.microstructure_features,
        cfg.lesion_features, groups)


@pytest.fixture(scope="module")
def jax_checkpoint(cohort, tmp_path_factory):
    """A VAE trained by the JAX package on the 9d tensors, saved with its
    normalization stats by the JAX package's save_vae (orbax)."""
    root, cfg, _ = cohort
    Xm, Xl, *_ = _tensors(cfg, root, "9d", jdata)
    stats = jdata.fit_normalization_stats(Xm, Xl, cfg.microstructure_features)
    Xz, Xl = jdata.apply_normalization(Xm, Xl, stats)
    model, _ = jax_train(Xz, Xl, latent_dim=LAT, epochs=2, batch_size=16, seed=1)
    path = tmp_path_factory.mktemp("jax_ckpt") / "vae"
    jckpt.save_vae(path, model, stats)
    return path


@pytest.fixture(scope="module")
def carried(jax_checkpoint):
    """(JAX model with float64 weights, port model in float64, norm stats):
    the JAX checkpoint loaded by the JAX package and carried across."""
    jmodel, norm = jckpt.load_vae(jax_checkpoint)
    to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    j64 = JaxTrainedVAE(jmodel.module, to64(jmodel.params), to64(jmodel.batch_stats))
    m = jmodel.module
    tm = LesionConditionedVAE(seq_len=m.seq_len, micro_ch=m.micro_ch,
                              lesion_ch=m.lesion_ch, latent=m.latent).double()
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    tm.load_state_dict(from_jax_params(np_tree(j64.params), np_tree(j64.batch_stats)))
    return j64, TrainedVAE(tm), norm


def _jax_noise(seed, n):
    return np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (n, LAT), jnp.float64))


@pytest.mark.parametrize("seed", [0, 21])
def test_synth_profile_csvs_are_byte_identical(tmp_path, seed):
    cfg = tsynth.tiny_config(n_per_group=1, tracts=["atr_left", "fimbria_right"])
    jsynth.generate_cohort(tmp_path / "jax", cfg, seed=seed, n_streamlines=8,
                           volume_shape=(8, 8, 8), with_profiles=True)
    tsynth.generate_cohort(tmp_path / "torch", cfg, seed=seed, n_streamlines=8,
                           volume_shape=(8, 8, 8), with_profiles=True)
    csvs = sorted((tmp_path / "jax" / "results").rglob("*.csv"))
    assert len(csvs) == 3 * 4
    for f in csvs:
        twin = tmp_path / "torch" / f.relative_to(tmp_path / "jax")
        assert twin.read_bytes() == f.read_bytes(), f.name


@pytest.mark.parametrize("tp", ["2d", "9d"])
def test_tensors_and_normalization_match_jax(cohort, tp):
    root, cfg, _ = cohort
    got, want = _tensors(cfg, root, tp), _tensors(cfg, root, tp, jdata)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    Xm, Xl = got[0].copy(), got[1].copy()
    Xm[0, 3, 1], Xm[2, 7, 4], Xl[1, 0, 0] = np.nan, np.inf, np.nan
    st = tdata.fit_normalization_stats(Xm, Xl, cfg.microstructure_features)
    st_j = jdata.fit_normalization_stats(Xm, Xl, cfg.microstructure_features)
    for k in ("median", "mean", "std"):
        np.testing.assert_array_equal(st[k], st_j[k])
    for g, w in zip(tdata.apply_normalization(Xm, Xl, st),
                    jdata.apply_normalization(Xm, Xl, st_j)):
        np.testing.assert_array_equal(g, w)
    # the serving path's on-device apply: the same float32 arithmetic
    host = tdata.apply_normalization(Xm, Xl, st)
    dev = tdata.apply_normalization_device(
        torch.from_numpy(Xm), torch.from_numpy(Xl),
        {k: torch.from_numpy(v) for k, v in st.items()})
    jdev = jdata.apply_normalization_device(
        jnp.asarray(Xm), jnp.asarray(Xl), {k: jnp.asarray(v) for k, v in st.items()})
    for d, h, j in zip(dev, host, jdev):
        np.testing.assert_array_equal(d.numpy(), h)
        np.testing.assert_array_equal(d.numpy(), np.asarray(j))


def test_normative_zscores_match_jax_f64(cohort, carried):
    root, cfg, _ = cohort
    j64, tmodel, norm = carried
    Xm, Xl, _sids, glabels, _ = _tensors(cfg, root, "1mo")
    Xz, Xl = tdata.apply_normalization(Xm, Xl, norm)
    sham = glabels == "Sham"
    want = jnorm.normative_zscores_fused(j64, Xz, Xl, sham, seed=SEED)
    n = len(Xz)
    got = tnorm.normative_zscores_fused(
        tmodel, Xz, Xl, sham, seed=SEED,
        noise=(_jax_noise(SEED, n), _jax_noise(SEED + 1, n)))
    for name, g, w in zip(("mean", "std", "Z", "magnitude"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)

    # the two-call form: sham statistics, then residuals
    m_j, s_j = jnorm.compute_normative_statistics(j64, Xz[sham], Xl[sham], seed=2)
    m_t, s_t = tnorm.compute_normative_statistics(
        tmodel, Xz[sham], Xl[sham], eps=_jax_noise(2, int(sham.sum())))
    np.testing.assert_allclose(m_t, m_j, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(s_t, s_j, rtol=1e-9, atol=1e-9)
    z_j, mag_j = jnorm.compute_zscore_residuals(j64, Xz, Xl, m_j, s_j, seed=4)
    z_t, mag_t = tnorm.compute_zscore_residuals(tmodel, Xz, Xl, m_j, s_j,
                                                eps=_jax_noise(4, n))
    np.testing.assert_allclose(z_t, z_j, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(mag_t, mag_j, rtol=1e-9, atol=1e-9)


def test_score_subjects_matches_jax_f64(cohort, carried, tmp_path, monkeypatch):
    """Serving: the JAX checkpoint carried across and saved by the port's
    save_vae; both packages score the 5mo subjects with the same noise."""
    root, cfg, _ = cohort
    j64, tmodel, norm = carried
    _, subjects = _subjects(cfg)
    rng = np.random.default_rng(0)
    mean_r = rng.normal(scale=0.1, size=(100, 13))
    std_r = rng.uniform(0.5, 1.5, size=(100, 13))
    monkeypatch.setattr(jinfer, "load_vae", lambda _path: (j64, norm))
    want = jinfer.score_subjects("unused", mean_r, std_r, root, TRACT, "5mo",
                                 subjects, config=cfg, seed=SEED)

    tckpt.save_vae(tmp_path / "ckpt", tmodel, norm)
    n = len(_tensors(cfg, root, "5mo")[0])
    got = tinfer.score_subjects(tmp_path / "ckpt", mean_r, std_r, root, TRACT,
                                "5mo", subjects, config=cfg, device="cpu",
                                dtype=torch.float64, eps=_jax_noise(SEED, n))
    assert list(got.columns) == list(want.columns)
    assert got[["subject_id", "group"]].equals(want[["subject_id", "group"]])
    np.testing.assert_allclose(got[["mean", "std", "max", "count"]].to_numpy(float),
                               want[["mean", "std", "max", "count"]].to_numpy(float),
                               rtol=1e-9, atol=1e-9)


def test_checkpoint_roundtrip(carried, tmp_path):
    _, tmodel, norm = carried
    tckpt.save_vae(tmp_path / "a", tmodel, norm)
    meta = json.loads((tmp_path / "a" / "module.json").read_text())
    assert {k: meta[k] for k in ("seq_len", "micro_ch", "lesion_ch", "latent")} \
        == tmodel.module.hyperparameters()
    assert set(meta["norm_stats_spec"]) == {"median", "mean", "std"}
    loaded, norm2 = tckpt.load_vae(tmp_path / "a", device="cpu", dtype=torch.float64)
    for (k, a), b in zip(tmodel.module.state_dict().items(),
                         loaded.module.state_dict().values()):
        assert torch.equal(a, b), k
    for k in norm:
        np.testing.assert_array_equal(norm2[k], norm[k])
    tckpt.save_vae(tmp_path / "b", tmodel)
    assert tckpt.load_vae(tmp_path / "b", device="cpu")[1] is None


def test_run_vae_analysis_writes_the_jax_schema(cohort, tmp_path):
    root, cfg, _ = cohort
    kw = dict(latent_dim=LAT, epochs=2, batch_size=16, config=cfg,
              base_path=root, make_plots=False, seed=SEED)
    jax_run_vae(TRACT, output_dir=tmp_path / "jax", **kw)
    res = run_vae_analysis(TRACT, output_dir=tmp_path / "torch", device="cpu", **kw)
    assert set(res) == set(cfg.timepoints)
    for tp in cfg.timepoints:
        hj = pd.read_csv(tmp_path / "jax" / f"training_history_{tp}.csv")
        ht = pd.read_csv(tmp_path / "torch" / f"training_history_{tp}.csv")
        assert list(ht.columns) == list(hj.columns) and len(ht) == len(hj) == 2
        assert np.isfinite(ht.to_numpy()).all()
        np.testing.assert_array_equal(ht["beta"], hj["beta"])
        zj = np.load(tmp_path / "jax" / f"zscores_{tp}.npz", allow_pickle=True)
        zt = np.load(tmp_path / "torch" / f"zscores_{tp}.npz", allow_pickle=True)
        assert zt.files == zj.files
        for k in zj.files:
            assert zt[k].shape == zj[k].shape and zt[k].dtype == zj[k].dtype, k
        for k in ("subj_ids", "group_labels", "lesion_burden"):
            np.testing.assert_array_equal(zt[k], zj[k])
        assert np.isfinite(zt["Z"]).all() and (zt["norm_std"] >= 1e-6).all()


def test_cli_vae_then_score_on_cpu(cohort, tmp_path):
    """``vae`` (with figures) and ``score`` through the port's CLI."""
    root, cfg, cfg_path = cohort
    out = tmp_path / "results"
    common = ["--config", str(cfg_path), "--base-path", str(root),
              "--output-dir", str(out), "--device", "cpu", "--seed", "3"]
    assert cli.main(["vae", "--tract", TRACT, "--epochs", "2", "--batch-size",
                     "16", "--latent-dim", str(LAT), *common]) == 0
    vdir = out / "vae_analysis" / TRACT
    assert (vdir / "deviation_profiles_9d.png").exists()
    assert (vdir / "lesion_impact_9d.png").exists()

    # a model trained on 9d, saved with its stats, serves the 1mo subjects
    Xm, Xl, *_ = _tensors(cfg, root, "9d")
    stats = tdata.fit_normalization_stats(Xm, Xl, cfg.microstructure_features)
    from lesionvae_tpu_torch.train.trainer import train_lesion_vae
    model, _ = train_lesion_vae(*tdata.apply_normalization(Xm, Xl, stats),
                                latent_dim=LAT, epochs=1, batch_size=16,
                                device="cpu")
    tckpt.save_vae(tmp_path / "ckpt", model, stats)
    assert cli.main(["score", "--checkpoint", str(tmp_path / "ckpt"),
                     "--normative", str(vdir / "zscores_9d.npz"),
                     "--tract", TRACT, "--timepoint", "1mo", *common]) == 0
    scores = pd.read_csv(out / "serving" / f"scores_{TRACT}_1mo.csv")
    assert list(scores.columns) == ["subject_id", "group", "mean", "std", "max", "count"]
    assert len(scores) == 6 and np.isfinite(scores["mean"]).all()


def test_score_defaults_to_cuda(cohort, tmp_path):
    """Without ``device`` serving targets the card: on a host without one
    that is a CUDA error, never a quiet CPU run."""
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    tmodel, norm = _fresh_model()
    tckpt.save_vae(tmp_path / "ckpt", tmodel, norm)
    root, cfg, _ = cohort
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tinfer.score_subjects(tmp_path / "ckpt", np.zeros((100, 13)),
                              np.ones((100, 13)), root, TRACT, "9d",
                              _subjects(cfg)[1], config=cfg)


def _fresh_model():
    torch.manual_seed(0)
    tm = LesionConditionedVAE(seq_len=100, micro_ch=13, lesion_ch=3, latent=LAT)
    norm = {"median": np.zeros(13, np.float32), "mean": np.zeros(13, np.float32),
            "std": np.ones(13, np.float32)}
    return TrainedVAE(tm), norm
