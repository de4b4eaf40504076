"""Member-chunked and split fleet launches of the port
(``train.batched.launch_many_vaes(upload_chunks=)``, ``member_draws``):
the counterparts of tests/test_upload_chunks.py.

Chunking splits the launch into K member-axis slices, each its own copy to
the device and its own training run.  The draws are made once for the whole
fleet and sliced, normalization, quantization ranges and the summary are per
member, and every output is member-leading, so the chunked fleet equals the
single launch member for member: in float64 on the CPU to 1e-12.  So does
one logical fleet launched as blocks with the canonical draws of
``member_draws``."""

import numpy as np
import pytest
import torch

from lesionvae_tpu.train.batched import launch_many_vaes as jax_launch
from lesionvae_tpu_torch.models.fleet import layout
from lesionvae_tpu_torch.train import batched as tb

torch.set_num_threads(1)

L, CM, CL, LAT = 8, 3, 2, 2
TOL = dict(rtol=1e-12, atol=1e-12)


def _cohort(T=4, n=32, seed=0):
    """tests/test_upload_chunks.py's cohort."""
    rng = np.random.default_rng(seed)
    Xm = rng.normal(size=(T, n, L, CM)).astype(np.float32)
    Xl = rng.uniform(size=(T, n, L, CL)).astype(np.float32)
    n_real = np.array([n, n - 5, n - 2, n, n - 1, n - 3], np.int32)[:T]
    return Xm, Xl, n_real


def _spec(T, n):
    sham = np.zeros((T, n), np.float32)
    sham[:, :4] = 1.0
    subj = np.tile(np.arange(n, dtype=np.int64) % 3, (T, 1))
    return sham, subj, 3, 7


def _launch(Xm, Xl, n_real, **kw):
    kw = dict(dict(latent_dim=LAT, epochs=2, batch_size=16, seed=11, device="cpu",
                   dtype=torch.float64), **kw)
    return tb.launch_many_vaes(Xm, Xl, n_real, **kw)


def _assert_same(h1, h2, summary=True, norm=True):
    np.testing.assert_allclose(h1.hist.numpy(), h2.hist.numpy(), **TOL)
    for name in ("weights", "affine"):
        np.testing.assert_allclose(getattr(h1.state, name).numpy(),
                                   getattr(h2.state, name).numpy(), **TOL)
    for k in h1.state.stats:
        np.testing.assert_allclose(h1.state.stats[k].numpy(),
                                   h2.state.stats[k].numpy(), **TOL)
    np.testing.assert_allclose(h1.Xm.numpy(), h2.Xm.numpy(), **TOL)
    np.testing.assert_allclose(h1.Xl.numpy(), h2.Xl.numpy(), **TOL)
    if summary:
        assert len(h1.summary) == len(h2.summary) == 5
        for a, b in zip(h1.summary, h2.summary):
            np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    if norm:
        for k in h1.norm_stats:
            np.testing.assert_allclose(h1.norm_stats[k].numpy(),
                                       h2.norm_stats[k].numpy(), **TOL)


@pytest.mark.parametrize("quantize", [False, True])
def test_chunked_matches_single_launch(quantize):
    Xm, Xl, n_real = _cohort()
    kw = dict(summary_spec=_spec(4, 32), normalize_on_device=True,
              quantize_upload=quantize)
    h1 = _launch(Xm, Xl, n_real, upload_chunks=1, **kw)
    h2 = _launch(Xm, Xl, n_real, upload_chunks=2, **kw)
    assert h2.state.members == 4 and h2.hist.shape == (4, 2, 4)
    _assert_same(h1, h2)


def test_chunked_matches_single_launch_bf16_storage():
    """The stochastic-rounding salts are sliced with the members too (bf16
    storage trains in float32: every stored bit equal)."""
    Xm, Xl, n_real = _cohort()
    kw = dict(normalize_on_device=True, store_dtype=torch.bfloat16, dtype=torch.float32)
    h1 = _launch(Xm, Xl, n_real, upload_chunks=1, **kw)
    h2 = _launch(Xm, Xl, n_real, upload_chunks=4, **kw)
    assert h2.state.weights.dtype == torch.bfloat16
    assert torch.equal(h1.state.weights, h2.state.weights)
    assert torch.equal(h1.state.affine, h2.state.affine)
    assert torch.equal(h1.hist, h2.hist)


def test_chunked_without_summary_or_normalize():
    Xm, Xl, n_real = _cohort()
    h1 = _launch(Xm, Xl, n_real, epochs=1, seed=3, upload_chunks=1)
    h2 = _launch(Xm, Xl, n_real, epochs=1, seed=3, upload_chunks=4)
    assert h1.summary is h2.summary is None and h2.norm_stats is None
    _assert_same(h1, h2, summary=False, norm=False)
    models, hist = h2.fetch()
    assert len(models) == 4 and hist.shape[0] == 4


@pytest.mark.parametrize("chunks,match", [(3, "not divisible"), (0, "must be >= 1"),
                                          ("two", "must be >= 1")])
def test_chunk_validation_mirrors_jax(chunks, match):
    Xm, Xl, n_real = _cohort()
    with pytest.raises(ValueError, match=match) as got:
        _launch(Xm, Xl, n_real, epochs=1, upload_chunks=chunks)
    with pytest.raises(ValueError, match=match) as want:
        jax_launch(Xm, Xl, n_real, latent_dim=LAT, epochs=1, batch_size=16,
                   upload_chunks=chunks)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("T,want", [(6, 6), (4, 4), (64, 8), (7, 7), (11, 1), (16, 8), (12, 6)])
def test_auto_is_the_largest_divisor_up_to_8(T, want):
    assert tb.resolve_chunks("auto", T) == want


def test_chunks_auto():
    """'auto' = largest divisor of T <= 8: T=6 -> 6 chunks of one member
    (the JAX package's rule, lesionvae_tpu/train/batched.py:339-341); the
    members equal the single launch's."""
    Xm, Xl, _ = _cohort(T=6)
    n_real = np.array([32, 27, 30, 32, 31, 32], np.int32)
    h1 = _launch(Xm, Xl, n_real, epochs=1, seed=5, upload_chunks=1)
    h2 = _launch(Xm, Xl, n_real, epochs=1, seed=5, upload_chunks="auto")
    _assert_same(h1, h2, summary=False, norm=False)


def test_member_draws_split_launch():
    """One logical fleet launched as two blocks with the canonical fleet's
    draws reproduces the single launch member for member."""
    Xm, Xl, n_real = _cohort(T=4)
    spec = _spec(4, 32)
    kw = dict(normalize_on_device=True)
    h_full = _launch(Xm, Xl, n_real, seed=9, summary_spec=spec, **kw)
    hyper = layout(L, CM, CL, LAT).hyper
    parts = []
    for sl in (slice(0, 2), slice(2, 4)):
        draws = tb.member_draws(4, 32, hyper, epochs=2, batch_size=16, seed=9, block=sl)
        assert len(draws["state_dicts"]) == 2 and draws["perms"].shape == (2, 2, 32)
        parts.append(_launch(Xm[sl], Xl[sl], n_real[sl], seed=123,   # ignored
                             summary_spec=(spec[0][sl], spec[1][sl], 3, 7), **kw,
                             **draws))
    joined = tb.cat_handles(parts)
    _assert_same(h_full, joined)


def test_member_draws_are_the_launch_draws():
    """With the whole fleet as the block, ``member_draws`` are what a launch
    draws from its seed: injecting them changes nothing."""
    Xm, Xl, n_real = _cohort(T=3)
    hyper = layout(L, CM, CL, LAT).hyper
    draws = tb.member_draws(3, 32, hyper, epochs=2, batch_size=16, seed=4)
    kw = dict(seed=4, store_dtype=torch.bfloat16, dtype=torch.float32)
    h1, h2 = _launch(Xm, Xl, n_real, **kw), _launch(Xm, Xl, n_real, **kw, **draws)
    assert torch.equal(h1.state.weights, h2.state.weights)
    assert torch.equal(h1.hist, h2.hist)


def test_split_launch_checks_its_draws():
    Xm, Xl, n_real = _cohort(T=4)
    hyper = layout(L, CM, CL, LAT).hyper
    draws = tb.member_draws(4, 32, hyper, epochs=1, batch_size=16, seed=9,
                            block=slice(0, 2))
    with pytest.raises(ValueError, match="state_dicts has 2 members for a 4-member"):
        _launch(Xm, Xl, n_real, epochs=1, **draws)
    # a block padded to other rows than the fleet's
    with pytest.raises(ValueError, match="pad every block"):
        _launch(Xm[:2, :16], Xl[:2, :16], np.minimum(n_real[:2], 16), epochs=1, **draws)


def test_vae_cohort_upload_chunks_auto_cli(tmp_path):
    """``vae-cohort --upload-chunks auto --device cpu`` through the CLI writes
    the files of a single launch, with the same histories."""
    import json

    import pandas as pd

    from lesionvae_tpu_torch import cli
    from lesionvae_tpu_torch.io.synth import generate_cohort, tiny_config

    cfg = tiny_config(1, tracts=["atr_left", "fimbria_left"])
    root = generate_cohort(tmp_path / "c", cfg, volume_shape=(8,) * 3,
                           with_profiles=True, n_streamlines=16)
    cfg_json = tmp_path / "cfg.json"
    cfg_json.write_text(json.dumps(cfg.to_json_dict()))
    outs = {}
    for chunks in ("1", "auto"):
        out = tmp_path / f"out_{chunks}"
        assert cli.main(["vae-cohort", "--config", str(cfg_json), "--base-path",
                         str(root), "--output-dir", str(out), "--device", "cpu",
                         "--epochs", "2", "--batch-size", "8", "--latent-dim", "4",
                         "--upload-chunks", chunks]) == 0
        outs[chunks] = out / "vae_cohort"
    files = sorted(p.name for p in outs["1"].iterdir())
    assert files == sorted(p.name for p in outs["auto"].iterdir())
    hists = [f for f in files if f.startswith("training_history_")]
    assert len(hists) == 8     # 2 tracts x 4 timepoints
    for f in hists:
        np.testing.assert_allclose(pd.read_csv(outs["auto"] / f).to_numpy(),
                                   pd.read_csv(outs["1"] / f).to_numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
