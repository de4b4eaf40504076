"""``warm_compile`` launches of the port, held to the JAX package's contract
(tests/test_warm_compile.py) and against the JAX package's own warm
launches on the same inputs.

A warm launch reads no block of data: the fleet tiles a ``batch_size``-row
host pattern on the device, geometry a helix.  It must run end to end with
the real launch's shapes (the port's programs are cached by shape, so the
real launch that follows replays what the warm one captured), give finite
fleet outputs of the right shape, and never send a geometry row to the
float64 refinement.  The patterns are the JAX package's, so where the JAX
warm launch is deterministic (the fleet's normalized blocks and
statistics, every geometry summary) the port's must agree with it.
"""

import logging

import numpy as np
import pandas as pd
import pytest
import torch

from lesionvae_tpu.pipeline import geometry_run as jrun
from lesionvae_tpu.train import batched as jb
from lesionvae_tpu_torch.io import synth as tsynth
from lesionvae_tpu_torch.pipeline import geometry_run as trun
from lesionvae_tpu_torch.train import batched as tb

torch.set_num_threads(1)

# port against the JAX package, float32 geometry: the bounds of
# tests/test_torch_geometry_pipeline.py (1e-5 x max(1, |x|); the eigen ratio
# means 2e-3; the u16 upload 2e-3)
GEO_F32, GEO_RATIO, GEO_U16 = 1e-5, 2e-3, 2e-3


def _bundles(seed=0):
    """tests/test_warm_compile.py's bundles."""
    rng = np.random.default_rng(seed)
    out = []
    for n_sl in (3, 5):
        out.append([rng.normal(size=(int(p), 3)).astype(np.float32) * 5.0
                    for p in rng.integers(8, 60, size=n_sl)])
    return out


def _fleet_inputs():
    """tests/test_warm_compile.py's fleet inputs."""
    T, n, L, cm, cl = 3, 32, 8, 3, 2
    rng = np.random.default_rng(1)
    Xm = rng.normal(size=(T, n, L, cm)).astype(np.float32)
    Xl = rng.uniform(size=(T, n, L, cl)).astype(np.float32)
    n_real = np.array([n, n - 5, n - 2], np.int32)
    sham = np.zeros((T, n), np.float32)
    sham[:, :4] = 1.0
    subj = np.tile(np.arange(n, dtype=np.int32) % 3, (T, 1))
    return Xm, Xl, n_real, sham, subj


@pytest.mark.parametrize("quantize", [False, True])
def test_fleet_warm_compile_safe(quantize):
    """Finite history and summary of the real shapes; the warm blocks and
    their normalization statistics those of the JAX warm launch (same host
    pattern); the ledger entry that of a real launch; a real launch of the
    same configuration then reuses the warm launch's program."""
    Xm, Xl, n_real, sham, subj = _fleet_inputs()
    T = len(n_real)
    kw = dict(latent_dim=2, epochs=2, batch_size=16, seed=11,
              summary_spec=(sham, subj, 3, 7), normalize_on_device=True,
              quantize_upload=quantize)
    tb.PROGRAMS.clear()
    tb.reset_fleet_ledger()
    h = tb.launch_many_vaes(Xm, Xl, n_real, warm_compile=True, device="cpu", **kw)
    hist = h.hist.numpy()
    assert hist.shape == (T, 2, 4) and np.isfinite(hist).all()
    _m, _s, mag, prof, _cnt = [t.numpy() for t in h.summary]
    assert mag.shape[0] == T and np.isfinite(mag).all()
    assert prof.shape[0] == T

    j = jb.launch_many_vaes(Xm, Xl, n_real, warm_compile=True, **kw)
    np.testing.assert_allclose(h.Xm.numpy(), np.asarray(j.Xm_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(h.Xl.numpy(), np.asarray(j.Xl_j), rtol=1e-5, atol=1e-5)
    for k in ("median", "mean", "std"):
        np.testing.assert_allclose(h.norm_stats[k].numpy(), np.asarray(j.norm_stats_T[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # the warm blocks are the pattern, not the data
    assert not np.allclose(h.Xm.numpy()[0, :4], Xm[0, :4])

    program = next(iter(tb.PROGRAMS.programs.values()))
    real = tb.launch_many_vaes(Xm, Xl, n_real, device="cpu", **kw)
    assert len(tb.PROGRAMS) == 1 and next(iter(tb.PROGRAMS.programs.values())) is program
    assert tb.FLEET_LAUNCH_LEDGER[0] == tb.FLEET_LAUNCH_LEDGER[1]
    assert np.isfinite(real.hist.numpy()).all()
    assert not np.array_equal(real.hist.numpy(), hist)


def test_fleet_warm_compile_chunks_share_one_program():
    """A chunked warm launch runs every chunk through one program, the one
    the chunked real launch then uses."""
    Xm, Xl, n_real, sham, subj = _fleet_inputs()
    kw = dict(latent_dim=2, epochs=1, batch_size=16, seed=3, upload_chunks=3,
              device="cpu")
    tb.PROGRAMS.clear()
    h = tb.launch_many_vaes(Xm, Xl, n_real, warm_compile=True, **kw)
    assert h.hist.shape == (3, 1, 4) and torch.isfinite(h.hist).all()
    assert len(tb.PROGRAMS) == 1
    tb.launch_many_vaes(Xm, Xl, n_real, **kw)
    assert len(tb.PROGRAMS) == 1


def _geo_close(got, want, upload):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["n_streamlines"] == w["n_streamlines"]
        for k, v in w.items():
            if isinstance(v, str):
                assert g[k] == v, k
                continue
            bound = (GEO_U16 if upload == "u16d" else
                     GEO_RATIO if k.startswith(("elongation", "planarity")) else GEO_F32)
            assert abs(g[k] - v) <= bound * max(1.0, abs(v)), (k, g[k], v)


@pytest.mark.parametrize("upload", ["f32", "u16d"])
def test_geometry_warm_compile_safe(upload, caplog):
    """Every bundle's summary has its streamlines (the helix rows are
    valid), no row is refined in float64, and the summaries are the JAX
    warm launch's."""
    bundles = _bundles()
    with caplog.at_level(logging.INFO):
        finish = trun.launch_bundle_metrics(bundles, upload=upload, warm_compile=True,
                                            device="cpu")
        summaries = finish()
    assert len(summaries) == len(bundles)
    assert all(s["n_streamlines"] > 0 for s in summaries)
    assert finish.refined == 0
    assert not any("refined" in r.message for r in caplog.records)
    want = jrun.launch_bundle_metrics(bundles, upload=upload, warm_compile=True)()
    _geo_close(summaries, want, upload)


@pytest.mark.parametrize("upload", ["f32", "u16d"])
def test_geometry_warm_matches_real_program_shapes(upload, monkeypatch):
    """A warm launch launches the real plan's chunk shapes, one launch a
    chunk, with the real streamline counts."""
    bundles = _bundles()
    shapes = []
    for name in ("streamline_metrics_stacked", "streamline_metrics_stacked_u16"):
        fn = getattr(trun, name)
        monkeypatch.setattr(trun, name, lambda first, *a, _fn=fn, **k: (
            shapes.append(tuple(first.shape)), _fn(first, *a, **k))[1])
    real = trun.launch_bundle_metrics(bundles, upload=upload, device="cpu")
    real_shapes, shapes[:] = list(shapes), []
    warm = trun.launch_bundle_metrics(bundles, upload=upload, warm_compile=True,
                                      device="cpu")
    assert shapes == real_shapes and len(shapes) == warm.launches == real.launches
    plan = trun.chunk_plan(bundles)
    want = [(S_pad, P - 1 if upload == "u16d" else P, 3) for P, _, S_pad in plan]
    assert shapes == want
    assert [s["n_streamlines"] for s in real()] == [s["n_streamlines"] for s in warm()]


def test_launch_geometry_warm_compile_matches_jax(tmp_path):
    """``warm_compile`` through ``launch_geometry`` (and ``launch_all_tracts``)
    on a cohort: no refined row, and the written metrics those of the JAX
    warm launch."""
    cfg = tsynth.tiny_config(n_per_group=1, tracts=["atr_left"])
    root = tsynth.generate_cohort(tmp_path / "c", cfg, seed=5, n_streamlines=8,
                                  volume_shape=(8, 8, 8), with_bundles=True)
    finish = trun.launch_geometry(cfg, data_dir=root / "data", output_dir=tmp_path / "t",
                                  device="cpu", warm_compile=True)
    got = finish()
    assert finish.metrics.refined == 0 and len(got) == 3 * 4
    want = jrun.launch_geometry(cfg, data_dir=root / "data", output_dir=tmp_path / "j",
                                warm_compile=True)()
    name = "comprehensive_tract_geometry_metrics.csv"
    g, w = pd.read_csv(tmp_path / "t" / name), pd.read_csv(tmp_path / "j" / name)
    assert list(g.columns) == list(w.columns) and len(g) == len(w)
    _geo_close(g.to_dict("records"), w.to_dict("records"), "f32")


def test_warm_launches_default_to_cuda():
    """A warm launch targets the card unless asked for the CPU: with no card
    it raises before any work, as the real launches do."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    Xm, Xl, n_real, _sham, _subj = _fleet_inputs()
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        tb.launch_many_vaes(Xm, Xl, n_real, latent_dim=2, epochs=1, batch_size=16,
                            warm_compile=True)
    with pytest.raises((AssertionError, RuntimeError), match="CUDA|accelerator"):
        trun.launch_bundle_metrics(_bundles(), warm_compile=True)
