"""The port's cohort pipeline (``run_vae_cohort`` -> ``score_cohort``) against
the JAX package's on a tiny profiles cohort: the files, keys and columns
written, the normative summary and the served scores to 1e-9 in float64 with
the JAX members' weights carried across and the JAX noise injected, the
skip-and-continue rules, and the two CLI subcommands on the CPU."""

import json
import logging
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.pipeline import infer as jinfer
from lesionvae_tpu.pipeline.vae_run import run_vae_cohort as jax_run_cohort
from lesionvae_tpu.train import checkpoint as jckpt
from lesionvae_tpu.train import normative as jnorm
from lesionvae_tpu.train.batched import pad_datasets as jax_pad
from lesionvae_tpu.train.trainer import TrainedVAE as JaxTrainedVAE
from lesionvae_tpu_torch import cli
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.fleet import FleetState, layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.pipeline import infer as tinfer
from lesionvae_tpu_torch.pipeline.vae_run import run_vae_cohort
from lesionvae_tpu_torch.train import checkpoint as tckpt
from lesionvae_tpu_torch.train import data as tdata
from lesionvae_tpu_torch.train import normative as tnorm
from lesionvae_tpu_torch.train.trainer import TrainedVAE

# Tiny shapes: one intra-op thread.  Several test workers, each with a
# thread per core inside every small product, oversubscribe the cores and
# slow these files many times over.
torch.set_num_threads(1)

TRACTS, LAT, SEED, BATCH = ["atr_left"], 3, 5, 8
NPZ_KEYS = ["magnitude", "subj_ids", "group_labels", "norm_mean", "norm_std",
            "subj_profile", "subj_order", "Z"]


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """A tiny profiles cohort (6 subjects x 4 timepoints, one tract: four
    members of 24 rows) and both packages' ``run_vae_cohort`` over it."""
    root = tmp_path_factory.mktemp("cohort")
    cfg = tsynth.tiny_config(n_per_group=2, tracts=TRACTS)
    tsynth.generate_cohort(root, cfg, seed=SEED, volume_shape=(8, 8, 8),
                           with_profiles=True, n_streamlines=16)
    cfg_path = root / "cfg.json"
    cfg_path.write_text(json.dumps(cfg.to_json_dict()))
    kw = dict(latent_dim=LAT, epochs=2, batch_size=BATCH, config=cfg, base_path=root,
              seed=SEED, save_z=True, save_checkpoints=True)
    jres = jax_run_cohort(TRACTS, output_dir=root / "jax_out", **kw)
    tres = run_vae_cohort(TRACTS, output_dir=root / "torch_out", device="cpu", **kw)
    return root, cfg, cfg_path, jres, tres


def _subjects(cfg):
    groups = {g: list(s) for g, s in cfg.subjects_by_group().items()}
    return groups, [s for subs in groups.values() for s in subs]


def test_run_vae_cohort_writes_the_jax_files(cohort):
    root, cfg, _, jres, tres = cohort
    assert list(tres) == list(jres) == [(TRACTS[0], tp) for tp in cfg.timepoints]
    for tract, tp in tres:
        hj = pd.read_csv(root / "jax_out" / f"training_history_{tract}_{tp}.csv")
        ht = pd.read_csv(root / "torch_out" / f"training_history_{tract}_{tp}.csv")
        assert list(ht.columns) == list(hj.columns) and len(ht) == len(hj) == 2
        assert np.isfinite(ht.to_numpy()).all()
        np.testing.assert_array_equal(ht["beta"], hj["beta"])
        zj = np.load(root / "jax_out" / f"zscores_{tract}_{tp}.npz", allow_pickle=True)
        zt = np.load(root / "torch_out" / f"zscores_{tract}_{tp}.npz", allow_pickle=True)
        assert zt.files == zj.files == NPZ_KEYS
        for k in zj.files:
            assert zt[k].shape == zj[k].shape and zt[k].dtype == zj[k].dtype, k
        for k in ("subj_ids", "group_labels", "subj_order"):
            np.testing.assert_array_equal(zt[k], zj[k])
        assert np.isfinite(zt["Z"]).all() and (zt["norm_std"] >= 1e-6).all()
        meta = json.loads((root / "torch_out" / "checkpoints" / f"{tract}_{tp}"
                           / "module.json").read_text())
        jmeta = json.loads((root / "jax_out" / "checkpoints" / f"{tract}_{tp}"
                            / "module.json").read_text())
        assert meta == jmeta
        entry = tres[(tract, tp)]
        assert set(entry) == set(jres[(tract, tp)])
        assert entry["Z"].shape == (24, 100, 13) and len(entry["subj_profiles"]) == 6
        # the magnitude is the RMS of the stored z block
        np.testing.assert_allclose(np.sqrt((entry["Z"] ** 2).mean(axis=(1, 2))),
                                   entry["magnitude"], rtol=1e-5)
        # and the normalization stats saved with the member are the host's
        Xm, Xl, *_ = tdata.build_tensor_with_lesion_context(
            root, tract, tp, _subjects(cfg)[1], cfg.microstructure_features,
            cfg.lesion_features, _subjects(cfg)[0])
        host = tdata.fit_normalization_stats(Xm, Xl, cfg.microstructure_features)
        _m, norm = tckpt.load_vae(root / "torch_out" / "checkpoints" / f"{tract}_{tp}",
                                  device="cpu")
        for k in host:
            np.testing.assert_allclose(norm[k], host[k], rtol=1e-5, atol=1e-6)


def test_tensor_builder_matches_jax_on_shuffled_and_incomplete_csvs(tmp_path):
    """The builder takes complete (streamline, node) grids without a pivot;
    shuffled rows and a missing row (which the pivot fills with NaN) must
    give the JAX package's tensors all the same."""
    from lesionvae_tpu.train import data as jdata

    cfg = tsynth.tiny_config(n_per_group=1, tracts=TRACTS)
    tsynth.generate_cohort(tmp_path, cfg, seed=1, volume_shape=(8, 8, 8),
                           with_profiles=True, n_streamlines=16)
    groups, subjects = _subjects(cfg)
    shuffled = tdata.csv_path(tmp_path, subjects[0], "9d")
    df = pd.read_csv(shuffled)
    df.sample(frac=1.0, random_state=0).to_csv(shuffled, index=False)
    holed = tdata.csv_path(tmp_path, subjects[1], "9d")
    df = pd.read_csv(holed)
    df.drop(index=[5, 217]).to_csv(holed, index=False)
    args = (tmp_path, TRACTS[0], "9d", subjects, cfg.microstructure_features,
            cfg.lesion_features, groups)
    got = tdata.build_tensor_with_lesion_context(*args)
    want = jdata.build_tensor_with_lesion_context(*args)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert np.isnan(got[0]).sum() == 2 * 13      # the two missing rows


@pytest.fixture(scope="module")
def carried(cohort):
    """The JAX fleet's members in float64, and the same weights in the
    port's layout: [(key, JAX model, port state dict, norm stats)]."""
    root, cfg, _, jres, _ = cohort
    to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    np_tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    out = []
    for (tract, tp) in jres:
        jmodel, norm = jckpt.load_vae(root / "jax_out" / "checkpoints" / f"{tract}_{tp}")
        j64 = JaxTrainedVAE(jmodel.module, to64(jmodel.params), to64(jmodel.batch_stats))
        sd = from_jax_params(np_tree(j64.params), np_tree(j64.batch_stats))
        out.append(((tract, tp), j64, sd, norm))
    return out


def _jax_noise(key, n):
    return np.asarray(jax.random.normal(key, (n, LAT), jnp.float64))


def test_fleet_normative_programs_match_jax_f64(cohort, carried):
    """``normative_fleet_summary`` and ``normative_zscores_fleet`` on padded
    blocks, float64, the JAX members' weights and noise: 1e-9."""
    root, cfg, *_ = cohort
    groups, subjects = _subjects(cfg)
    tensors, sham_rows, seg_rows = [], [], []
    for (tract, tp), _j, _sd, norm in carried:
        Xm, Xl, sids, glabels, _ = tdata.build_tensor_with_lesion_context(
            root, tract, tp, subjects, cfg.microstructure_features,
            cfg.lesion_features, groups)
        tensors.append(tdata.apply_normalization(Xm, Xl, norm))
        sham_rows.append(glabels == "Sham")
        seg_rows.append(np.searchsorted(np.unique(sids), sids))
    Xm_T, Xl_T, n_real = jax_pad(tensors, batch_size=BATCH, min_rows=32)
    T, n_pad = Xm_T.shape[:2]
    n_seg = 7
    sham = np.zeros((T, n_pad), np.float32)
    seg = np.full((T, n_pad), n_seg - 1, np.int32)
    for i in range(T):
        sham[i, :n_real[i]] = sham_rows[i]
        seg[i, :n_real[i]] = seg_rows[i]

    stack = lambda xs: jax.tree.map(lambda *a: jnp.stack(a), *xs)  # noqa: E731
    module = carried[0][1].module
    params_T = stack([j.params for _k, j, _sd, _n in carried])
    stats_T = stack([j.batch_stats for _k, j, _sd, _n in carried])
    lay = layout(100, 13, 3, LAT)
    state = FleetState.from_state_dicts([sd for _k, _j, sd, _n in carried], lay,
                                        dtype=torch.float64, device="cpu")
    noise = (_jax_noise(jax.random.PRNGKey(SEED), n_pad),
             _jax_noise(jax.random.PRNGKey(SEED + 1), n_pad))

    want = jnorm.normative_fleet_summary(module, params_T, stats_T, Xm_T, Xl_T,
                                         sham, seg, n_seg, seed=SEED)
    got = tnorm.normative_fleet_summary(state, Xm_T, Xl_T, sham, seg, n_seg,
                                        seed=SEED, noise=noise)
    for name, g, w in zip(("mean", "std", "magnitude", "profile", "counts"), got, want):
        assert g.shape == w.shape, name
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)
    assert got[4][:, n_seg - 1].tolist() == [n_pad - n for n in n_real]

    want = jnorm.normative_zscores_fleet(module, params_T, stats_T, Xm_T, Xl_T,
                                         sham, seed=SEED)
    got = tnorm.normative_zscores_fleet(state, Xm_T, Xl_T, sham, seed=SEED, noise=noise)
    for name, g, w in zip(("mean", "std", "Z", "magnitude"), got, want):
        np.testing.assert_allclose(g, w, rtol=1e-9, atol=1e-9, err_msg=name)
    # a member of the fleet is the single-member program on its own block
    single = tnorm.normative_zscores_fused(
        TrainedVAE(state.member(1)), Xm_T[1], Xl_T[1], sham[1], noise=noise)
    for g, w in zip(got, single):
        np.testing.assert_allclose(g[1], w, rtol=1e-12, atol=1e-12)


@pytest.fixture()
def served_dirs(cohort, carried, tmp_path):
    """A port cohort directory holding the carried float64 members with the
    JAX run's normative files beside them."""
    root, cfg, *_ = cohort
    out = tmp_path / "cohort_dir"
    out.mkdir()
    for (tract, tp), _j, sd, norm in carried:
        tm = LesionConditionedVAE(seq_len=100, micro_ch=13, lesion_ch=3,
                                  latent=LAT).double()
        tm.load_state_dict(sd)
        tckpt.save_vae(out / "checkpoints" / f"{tract}_{tp}", TrainedVAE(tm), norm)
        shutil.copy(root / "jax_out" / f"zscores_{tract}_{tp}.npz", out)
    return out


def test_score_cohort_matches_jax_f64(cohort, carried, served_dirs, monkeypatch, tmp_path):
    root, cfg, *_ = cohort
    _, subjects = _subjects(cfg)
    by_dir = {f"{k[0]}_{k[1]}": (j, norm) for k, j, _sd, norm in carried}
    monkeypatch.setattr(jckpt, "load_vae_many",
                        lambda paths: [by_dir[p.name] for p in paths])
    want = jinfer.score_cohort(root / "jax_out", root, subjects, config=cfg, seed=SEED)

    T = len(carried)
    keys = jax.random.split(jax.random.PRNGKey(SEED), T)
    eps = np.stack([_jax_noise(k, 24) for k in keys])     # every member has 24 rows
    got = tinfer.score_cohort(served_dirs, root, subjects, config=cfg, seed=SEED,
                              output_dir=tmp_path / "serving", device="cpu",
                              dtype=torch.float64, eps=eps)
    assert list(got.columns) == list(want.columns) == tinfer.SCORE_COLUMNS
    ids = ["tract", "timepoint", "subject_id", "group"]
    assert got[ids].astype(str).equals(want[ids].astype(str))
    cols = ["mean", "std", "max", "count"]
    np.testing.assert_allclose(got[cols].to_numpy(float), want[cols].to_numpy(float),
                               rtol=1e-9, atol=1e-9)
    written = pd.read_csv(tmp_path / "serving" / "cohort_scores.csv")
    assert list(written.columns) == tinfer.SCORE_COLUMNS and len(written) == len(got)
    # one member of the cohort pass is score_subjects on that member (the
    # members are scored in the order of their directory names)
    tract, tp = sorted(f"{k[0]}_{k[1]}" for k, *_ in carried)[2].rsplit("_", 1)
    norm = tinfer.load_normative(served_dirs / f"zscores_{tract}_{tp}.npz")
    one = tinfer.score_subjects(served_dirs / "checkpoints" / f"{tract}_{tp}",
                                norm["mean"], norm["std"], root, tract, tp, subjects,
                                config=cfg, device="cpu", dtype=torch.float64, eps=eps[2])
    part = got[(got.tract == tract) & (got.timepoint == tp)]
    np.testing.assert_allclose(part[cols].to_numpy(float), one[cols].to_numpy(float),
                               rtol=1e-10, atol=1e-10)


def test_score_cohort_skip_rules(cohort, served_dirs, tmp_path):
    """A missing normative file and an unreadable checkpoint directory are
    skipped with a warning; with nothing left the frame is empty but has
    its columns and the CSV is written; no checkpoints at all is an error."""
    root, cfg, *_ = cohort
    _, subjects = _subjects(cfg)
    tps = list(cfg.timepoints)
    (served_dirs / f"zscores_{TRACTS[0]}_{tps[0]}.npz").unlink()
    (served_dirs / "checkpoints" / "stray_dir").mkdir()
    (served_dirs / "checkpoints" / "notes.txt").write_text("not a member")
    kw = dict(config=cfg, device="cpu", seed=1)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("lesionvae_tpu_torch.infer")
    logger.addHandler(handler)
    try:
        got = tinfer.score_cohort(served_dirs, root, subjects, **kw)
    finally:
        logger.removeHandler(handler)
    assert sorted(got["timepoint"].unique()) == sorted(tps[1:])
    assert len(got) == 3 * 6 and np.isfinite(got["mean"]).all()
    text = " ".join(r.getMessage() for r in records if r.levelname == "WARNING")
    assert "no normative stats" in text and "unreadable checkpoint" in text

    restored = tckpt.load_vae_many([served_dirs / "checkpoints" / "stray_dir",
                                    served_dirs / "checkpoints" / f"{TRACTS[0]}_{tps[1]}"],
                                   device="cpu")
    assert isinstance(restored[0], Exception) and isinstance(restored[1], tuple)

    for tp in tps[1:]:
        (served_dirs / f"zscores_{TRACTS[0]}_{tp}.npz").unlink()
    empty = tinfer.score_cohort(served_dirs, root, subjects, output_dir=tmp_path / "s",
                                **kw)
    assert len(empty) == 0 and list(empty.columns) == tinfer.SCORE_COLUMNS
    assert list(pd.read_csv(tmp_path / "s" / "cohort_scores.csv").columns) \
        == tinfer.SCORE_COLUMNS
    with pytest.raises(ValueError, match="no member checkpoints"):
        tinfer.score_cohort(tmp_path / "nowhere", root, subjects, **kw)
    with pytest.raises(ValueError, match="float32 on cuda"):
        tinfer.score_cohort(served_dirs, root, subjects, config=cfg,
                            dtype=torch.float64)


@pytest.mark.parametrize("flags", [
    ["--store", "bf16"],
    ["--dtype", "bf16", "--quantize-upload", "--save-z"],
])
def test_cli_vae_cohort_then_score_cohort_on_cpu(cohort, tmp_path, flags):
    root, cfg, cfg_path, *_ = cohort
    out = tmp_path / "results"
    common = ["--config", str(cfg_path), "--base-path", str(root),
              "--output-dir", str(out), "--device", "cpu", "--seed", "3"]
    assert cli.main(["vae-cohort", "--epochs", "2", "--batch-size", str(BATCH),
                     "--latent-dim", str(LAT), "--save-checkpoints", *flags,
                     *common]) == 0
    for tp in cfg.timepoints:
        hist = pd.read_csv(out / "vae_cohort" / f"training_history_{TRACTS[0]}_{tp}.csv")
        assert len(hist) == 2 and np.isfinite(hist.to_numpy()).all()
        z = np.load(out / "vae_cohort" / f"zscores_{TRACTS[0]}_{tp}.npz",
                    allow_pickle=True)
        assert ("Z" in z.files) == ("--save-z" in flags)
        assert z["subj_profile"].shape == (6, 100)
    assert cli.main(["score-cohort", "--subjects", "9001", "9101", *common]) == 0
    scores = pd.read_csv(out / "serving" / "cohort_scores.csv")
    assert list(scores.columns) == tinfer.SCORE_COLUMNS
    assert len(scores) == 4 * 2 and np.isfinite(scores["mean"]).all()


def test_cohort_entry_points_default_to_cuda(cohort, served_dirs):
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the CPU-only host")
    root, cfg, *_ = cohort
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        run_vae_cohort(TRACTS, epochs=1, batch_size=BATCH, latent_dim=LAT, config=cfg,
                       base_path=root, output_dir=root / "unused")
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tinfer.score_cohort(served_dirs, root, _subjects(cfg)[1], config=cfg)
