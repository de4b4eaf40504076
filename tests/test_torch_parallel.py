"""The port's multi-rank paths (``lesionvae_tpu_torch.parallel``) on four gloo
ranks on the CPU, against the port in one process and against the JAX
package on its 8-virtual-device CPU mesh (the counterparts of
tests/test_parallel.py and tests/test_zero_collectives.py).

One start of the ranks serves the file (``parallel.ranks.run``); inputs are
made with numpy from a seed.  Bounds:
- sharded geometry: float32 bit-equal to one process; float64 within 1e-12
  of the JAX ``batched_bundle_metrics(mesh=make_mesh(8))``;
- member-sharded fleet, float64: 1e-12 against one process (the bound of
  tests/test_torch_upload_chunks.py), tests/test_parallel.py:71-107's
  bounds against the JAX fleet on its mesh (JAX draws injected), no
  collective between the upload and ``fetch``;
- ``train_lesion_vae(mesh=)``, float64, 2 epochs: history and weights within
  1e-10 of one process;
- ``score_cohort(mesh=)``: the CSV equal to one process's, and the
  non-tiling fleet logged and scored on one rank.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lesionvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lesionvae_tpu.pipeline.geometry_run import batched_bundle_metrics as jax_bundles
from lesionvae_tpu.train import batched as jb
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.ops.padding import pad_streamlines
from lesionvae_tpu_torch.parallel import mesh as pm
from lesionvae_tpu_torch.parallel import ranks
from lesionvae_tpu_torch.parallel.sharded import sharded_streamline_metrics
from lesionvae_tpu_torch.pipeline import geometry_run as trun
from lesionvae_tpu_torch.pipeline.infer import score_cohort
from lesionvae_tpu_torch.pipeline.vae_run import run_vae_cohort
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train.trainer import train_lesion_vae

torch.set_num_threads(1)

WORLD = 4
F64 = dict(rtol=1e-12, atol=1e-12)
# the fleet of tests/test_parallel.py:71-107
T, ROWS, SEQ, MC, LC, LAT, B, EPOCHS, SEED = 8, 24, 12, 3, 2, 2, 8, 2, 5


def _bundles(seed=42):
    rng = np.random.default_rng(seed)
    return [[rng.normal(size=(int(rng.integers(5, 30)), 3)) for _ in range(6)]
            for _ in range(5)]


def _fleet_inputs():
    rng = np.random.default_rng(SEED)
    tensors = [(rng.normal(size=(ROWS, SEQ, MC)).astype(np.float32),
                rng.uniform(size=(ROWS, SEQ, LC)).astype(np.float32)) for _ in range(T)]
    Xm, Xl, n_real = tb.pad_datasets(tensors, batch_size=B)
    n_pad = Xm.shape[1]
    sham = np.zeros((T, n_pad), np.float32)
    sham[:, :6] = 1.0
    subj = np.full((T, n_pad), 3, np.int32)
    subj[:, :n_real[0]] = np.arange(n_real[0]) % 3
    return dict(Xm=Xm, Xl=Xl, n_real=n_real, sham=sham, subj=subj)


def _jax_draws(data):
    """The JAX fleet's per-member draws (initial weights, permutations,
    noise, summary noise), as tests/test_torch_fleet.py carries them."""
    n_pad = data["Xm"].shape[1]
    _prog, module, _ = jb._fleet_program(n_pad, SEQ, MC, LC, LAT, EPOCHS, B, 2e-4,
                                         1e-3, 2.0, None, 4, SEED, True)
    sds, perms, noise = [], [], []
    for key in jax.random.split(jax.random.PRNGKey(SEED), T):
        k1, k2 = jax.random.split(key)
        v = module.init({"params": k1}, jnp.zeros((2, SEQ, MC), jnp.float32),
                        jnp.zeros((2, SEQ, LC), jnp.float32), k2,
                        jnp.ones(2, jnp.float32), True)
        sds.append(from_jax_params(jax.tree.map(np.asarray, v["params"]),
                                   jax.tree.map(np.asarray, v["batch_stats"])))
        p, e = [], []
        for ep_key in jax.random.split(jax.random.fold_in(key, 1), EPOCHS):
            k_perm, k_eps = jax.random.split(ep_key)
            p.append(np.asarray(jax.random.permutation(k_perm, n_pad)))
            e.append([np.asarray(jax.random.normal(r, (B, LAT), jnp.float32))
                      for r in jax.random.split(k_eps, n_pad // B)])
        perms.append(np.stack(p))
        noise.append(np.asarray(e))
    summary_noise = tuple(np.asarray(jax.random.normal(
        jax.random.PRNGKey(SEED + d), (n_pad, LAT), jnp.float32)) for d in (0, 1))
    return dict(state_dicts=sds, perms=torch.from_numpy(np.stack(perms)),
                noise=torch.from_numpy(np.stack(noise)), summary_noise=summary_noise)


FLEET_KW = dict(latent_dim=LAT, epochs=EPOCHS, batch_size=B, seed=SEED,
                normalize_on_device=True, dtype=torch.float64, n_seg=4, norm_seed=SEED)


def _train_data(n=45, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 16, 4)).astype(np.float32),
            rng.uniform(size=(n, 16, 2)).astype(np.float32))


TRAIN_KW = dict(latent_dim=3, epochs=2, batch_size=16, seed=3, dtype=torch.float64)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Four saved members (one tract x four timepoints) of a tiny cohort."""
    root = tmp_path_factory.mktemp("cohort")
    cfg = tsynth.tiny_config(n_per_group=2, tracts=["atr_left"])
    tsynth.generate_cohort(root, cfg, seed=SEED, volume_shape=(8, 8, 8),
                           with_profiles=True, n_streamlines=16)
    run_vae_cohort(["atr_left"], latent_dim=3, epochs=1, batch_size=8, config=cfg,
                   base_path=root, seed=SEED, save_checkpoints=True,
                   output_dir=root / "fleet", device="cpu")
    subjects = [s for subs in cfg.subjects_by_group().values() for s in subs]
    return root, cfg, subjects


@pytest.fixture(scope="module")
def run(cohort, tmp_path_factory):
    """Every job on one start of four gloo ranks; {job: [per-rank result]}."""
    root, cfg, subjects = cohort
    pts, lens = pad_streamlines([s for b in _bundles() for s in b], max_points=32)
    data = _fleet_inputs()
    out = tmp_path_factory.mktemp("served")
    score_kw = dict(cohort_dir=root / "fleet", base_path=root, subjects=subjects,
                    config=cfg, seed=SEED, dtype=torch.float64)
    keys3 = [("atr_left", tp) for tp in cfg.timepoints[:3]]
    jobs = {
        "streamlines": ("streamlines", 1, dict(points=pts, lengths=lens)),
        "bundles_f32": ("bundle_metrics", 1, dict(bundles=_bundles(), device="cpu")),
        "bundles_f64": ("bundle_metrics", 1, dict(bundles=_bundles(), device="cpu",
                                                  dtype=torch.float64)),
        "fleet": ("fleet", 1, dict(data=data, kwargs=dict(FLEET_KW, **_jax_draws(data)))),
        "fleet_auto": ("fleet", 1, dict(data=data, kwargs=dict(
            FLEET_KW, upload_chunks="auto", epochs=1))),
        "train": ("train", 1, dict(zip(("X_micro", "X_lesion"), _train_data()),
                                   kwargs=TRAIN_KW)),
        "score": ("score", 1, dict(kwargs=dict(score_kw, output_dir=out / "mesh"))),
        "score_3": ("score", 1, dict(kwargs=dict(score_kw, keys=keys3))),
    }
    per_rank = pm.spawn(ranks.run, WORLD, "gloo", "cpu", list(jobs.values()))
    return {name: [r[i] for r in per_rank] for i, name in enumerate(jobs)}, out


def _same_on_every_rank(results):
    first = results[0][0]
    for r, _counts in results[1:]:
        _assert_equal(r, first)
    return first


def _assert_equal(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_equal(x, y)
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True)
    else:
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- the mesh
def test_mesh_shapes_and_coordinates():
    mesh = pm.Mesh(8, 2, rank=5, device="cpu")
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.coords == {"data": 2, "model": 1}
    assert mesh.axis("data").ranks == [1, 3, 5, 7]
    assert mesh.axis("model").ranks == [4, 5]
    assert pm.Mesh(8, 1, 0, "cpu").shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match="6 devices not divisible by model_parallel=4"):
        pm.Mesh(6, 4, 0, "cpu")
    # a rank's rows of axis 0 over ``data`` (rank 5 is data coordinate 2 of 4)
    x = np.arange(16.0).reshape(8, 2)
    np.testing.assert_array_equal(pm.data_sharding(mesh, x), x[4:6])
    assert pm.replicated(mesh, x) is x
    with pytest.raises(ValueError, match="6 rows not divisible by the mesh's data axis"):
        pm.data_sharding(mesh, x[:6])


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(4)


def test_pad_to_multiple_matches_jax():
    from lesionvae_tpu.parallel.mesh import pad_to_multiple as jax_pad
    arr = np.arange(39.0).reshape(13, 3)
    for mult in (1, 4, 8, 13):
        got, want = pm.pad_to_multiple(arr, mult), jax_pad(arr, mult)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1] == 13


# ---------------------------------------------------------------- geometry
def test_sharded_geometry_is_bit_equal_to_one_process(run):
    results, _ = run
    pts, lens = pad_streamlines([s for b in _bundles() for s in b], max_points=32)
    got = _same_on_every_rank(results["streamlines"])
    want = sharded_streamline_metrics(pts, lens, pm.Mesh(1, 1, 0, "cpu"))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    summaries, launches = _same_on_every_rank(results["bundles_f32"])
    plain = trun.batched_bundle_metrics(_bundles(), device="cpu")
    for g, w in zip(summaries, plain):
        assert g.keys() == w.keys()
        np.testing.assert_array_equal(list(g.values()), list(w.values()))
    assert launches == 1


def test_sharded_geometry_matches_the_jax_mesh_f64(run):
    results, _ = run
    summaries, _ = _same_on_every_rank(results["bundles_f64"])
    want = jax_bundles(_bundles(), dtype=jnp.float64, mesh=jax_make_mesh(8))
    for g, w in zip(summaries, want):
        for k in w:
            np.testing.assert_allclose(g[k], w[k], err_msg=k, **F64)


# ---------------------------------------------------------------- the fleet
def _one_process_fleet(data, **kw):
    kw = dict(FLEET_KW, **kw)
    spec = (data["sham"], data["subj"], kw.pop("n_seg"), kw.pop("norm_seed"))
    h = tb.launch_many_vaes(data["Xm"], data["Xl"], data["n_real"], summary_spec=spec,
                            device="cpu", **kw)
    h.fetch()
    return h


def test_member_sharded_fleet_matches_one_process_f64(run):
    results, _ = run
    (got, launch) = _same_on_every_rank(results["fleet"])
    data = _fleet_inputs()
    want = _one_process_fleet(data, **_jax_draws(data))
    np.testing.assert_allclose(got["hist"], want.hist.numpy(), **F64)
    np.testing.assert_allclose(got["weights"], want.state.weights.numpy(), **F64)
    np.testing.assert_allclose(got["affine"], want.state.affine.numpy(), **F64)
    for k, v in want.state.stats.items():
        np.testing.assert_allclose(got[f"stats.{k}"], v.numpy(), err_msg=k, **F64)
    for i, v in enumerate(want.summary):
        np.testing.assert_allclose(got[f"summary.{i}"], v.numpy(), **F64)
    for k, v in want.norm_stats.items():
        np.testing.assert_allclose(got[f"norm.{k}"], v.numpy(), **F64)
    # "auto" under a mesh is one launch a rank, of its own 2 members
    auto, auto_launch = _same_on_every_rank(results["fleet_auto"])
    assert [spec.shape for spec in auto_launch["ledger"][0][1][:3]] == [
        (2, 24, SEQ, MC), (2, 24, SEQ, LC), (2,)]
    assert len(auto_launch["ledger"]) == len(launch["ledger"]) == 1


def test_member_sharded_fleet_matches_the_jax_mesh(run):
    """tests/test_parallel.py:71-107's bounds, against the JAX fleet on its
    8-device mesh with the same draws (JAX in float32, the port in
    float64)."""
    results, _ = run
    got, _launch = _same_on_every_rank(results["fleet"])
    data = _fleet_inputs()
    h = jb.launch_many_vaes(data["Xm"], data["Xl"], data["n_real"], latent_dim=LAT,
                            epochs=EPOCHS, batch_size=B, seed=SEED,
                            summary_spec=(data["sham"], data["subj"], 4, SEED),
                            normalize_on_device=True, mesh=jax_make_mesh(8))
    np.testing.assert_allclose(got["hist"], np.asarray(h.hist_T), rtol=1e-5, atol=1e-6)
    for i, w in enumerate(h.summary_T):
        np.testing.assert_allclose(got[f"summary.{i}"], np.asarray(w),
                                   rtol=1e-4, atol=1e-5)


def test_member_sharded_fleet_issues_zero_collectives(run):
    """Members are independent models: no rank communicates between the
    upload and ``fetch`` (the property tests/test_zero_collectives.py pins
    on the JAX program's text); only ``fetch`` gathers."""
    results, _ = run
    for name in ("fleet", "fleet_auto"):
        for (got, launch), counts in results[name]:
            assert launch["collectives"] == 0, name
            assert counts["collectives"] > 0, name      # fetch's gathers


def test_fleet_mesh_validation_mirrors_jax():
    """An indivisible fleet and ``upload_chunks > 1`` under a mesh raise
    before anything is staged (lesionvae_tpu/train/batched.py:392-410)."""
    data = _fleet_inputs()
    mesh = pm.Mesh(4, 1, 0, "cpu")
    kw = dict(latent_dim=LAT, epochs=1, batch_size=B, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="fleet size 6 not divisible by the mesh's "
                                         r"data axis \(4\)") as got:
        tb.launch_many_vaes(data["Xm"][:6], data["Xl"][:6], data["n_real"][:6], **kw)
    with pytest.raises(ValueError) as want:
        jb.launch_many_vaes(data["Xm"][:6], data["Xl"][:6], data["n_real"][:6],
                            latent_dim=LAT, epochs=1, batch_size=B,
                            mesh=jax_make_mesh(4))
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="a mesh fleet already splits"):
        tb.launch_many_vaes(data["Xm"], data["Xl"], data["n_real"], upload_chunks=2, **kw)
    with pytest.raises(ValueError, match="the mesh's rank holds cpu"):
        tb.launch_many_vaes(data["Xm"], data["Xl"], data["n_real"],
                            **dict(kw, device="cuda"))


# ---------------------------------------------------------------- single VAE
def test_train_lesion_vae_on_a_mesh_matches_one_process_f64(run):
    results, _ = run
    hist, sd = _same_on_every_rank(results["train"])
    model, want = train_lesion_vae(*_train_data(), device="cpu", **TRAIN_KW)
    np.testing.assert_allclose(hist, want.to_numpy(), rtol=1e-10, atol=1e-10)
    for k, v in model.module.state_dict().items():
        np.testing.assert_allclose(sd[k], v.numpy(), rtol=1e-10, atol=1e-10, err_msg=k)
    # a step: forward, the 7 BatchNorms' count, sum and squares and the
    # ELBO's 4 sums; backward, the sums that carry a gradient (2 a BatchNorm,
    # sse and kl); the real rows; and one all-reduce of the gradients
    counts = results["train"][0][1]
    steps = TRAIN_KW["epochs"] * 3
    assert counts["collectives"] == steps * ((7 * 3 + 4) + (7 * 2 + 2) + 1 + 1)


def test_train_lesion_vae_mesh_checks():
    mesh = pm.Mesh(4, 1, 0, "cpu")
    Xm, Xl = _train_data()
    with pytest.raises(ValueError, match="18 rows not divisible by the mesh's data"):
        train_lesion_vae(Xm, Xl, batch_size=18, device="cpu", mesh=mesh)
    with pytest.raises(ValueError, match="the mesh's rank holds cpu"):
        train_lesion_vae(Xm, Xl, batch_size=16, mesh=mesh)


# ---------------------------------------------------------------- serving
def test_score_cohort_on_a_mesh_equals_one_process(run, cohort, tmp_path):
    results, out = run
    root, cfg, subjects = cohort
    got, warnings = _same_on_every_rank(results["score"])
    want = score_cohort(root / "fleet", root, subjects, config=cfg, seed=SEED,
                        device="cpu", dtype=torch.float64, output_dir=tmp_path)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert not warnings
    assert (out / "mesh" / "cohort_scores.csv").read_text() == \
        (tmp_path / "cohort_scores.csv").read_text()


def test_score_cohort_that_does_not_tile_scores_on_one_rank(run, cohort):
    results, _ = run
    root, cfg, subjects = cohort
    got, warnings = _same_on_every_rank(results["score_3"])
    want = score_cohort(root / "fleet", root, subjects, config=cfg, seed=SEED,
                        keys=[("atr_left", tp) for tp in cfg.timepoints[:3]],
                        device="cpu", dtype=torch.float64)
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert warnings == ["score_cohort: 3 members don't tile the mesh's data axis "
                        "(4); scoring on one rank"]


def test_entry_points_check_the_mesh_device(cohort):
    root, cfg, subjects = cohort
    mesh = pm.Mesh(2, 1, 0, "cpu")
    with pytest.raises(ValueError, match="the mesh's rank holds cpu"):
        trun.launch_bundle_metrics(_bundles(), mesh=mesh)
    with pytest.raises(ValueError, match="the mesh's rank holds cpu"):
        score_cohort(root / "fleet", root, subjects, config=cfg, mesh=mesh)
