"""The port's trainer against the JAX package's.

Lockstep: the JAX package's own jitted training program (``_train_program``)
and the port's ``train_lesion_vae`` start from the same weights, in float64,
with the JAX permutations and reparameterisation noise recomputed from the
same keys and injected into the port; weights and history must agree.
Besides: the fused optimizer against the optax chain, the non-finite-loss
skip, and a float32 curve-band check."""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.train import trainer as jtrainer
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.train import trainer as ttrainer

# Tiny shapes: one intra-op thread.  Several test workers, each with a
# thread per core inside every small product, oversubscribe the cores and
# slow these files many times over.
torch.set_num_threads(1)

SEQ, MC, LC, LAT = 24, 5, 3, 4


def _data(n, seed, seq=SEQ):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, seq)
    Xm = (np.sin(2 * np.pi * t)[None, :, None]
          + 0.3 * rng.normal(size=(n, seq, MC))).astype(np.float32)
    Xl = rng.uniform(0, 1, size=(n, seq, LC)).astype(np.float32)
    return Xm, Xl


def _np64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


def _jax_draws(key, n, n_pad, epochs, batch_size):
    """The permutations and noise the JAX program draws from ``key``
    (trainer.py:157-166,201; reparam at lesion_vae.py:97)."""
    perms, noise = [], []
    for ep_key in jax.random.split(key, epochs):
        k_perm, k_eps = jax.random.split(ep_key)
        perms.append(np.concatenate([np.asarray(jax.random.permutation(k_perm, n)),
                                     np.arange(n, n_pad)]))
        noise.append([np.asarray(jax.random.normal(r, (batch_size, LAT), jnp.float64))
                      for r in jax.random.split(k_eps, n_pad // batch_size)])
    return torch.from_numpy(np.stack(perms)), torch.from_numpy(np.asarray(noise))


@pytest.mark.parametrize("n,batch_size,epochs,lr", [
    (24, 16, 3, 1e-3),     # 6 steps, a partial batch of 8 real rows each epoch
    (20, 4, 1, 2e-4),      # 5 full batches, beta = 1 for a single epoch
])
def test_lockstep_with_jax_program(n, batch_size, epochs, lr):
    wd, clip, seed = 1e-3, 2.0, 3
    Xm, Xl = _data(n, seed=n)
    n_pad = -(-n // batch_size) * batch_size
    pad = lambda X: np.concatenate([X, np.zeros((n_pad - n,) + X.shape[1:], X.dtype)])  # noqa: E731

    module, run = jtrainer._train_program(n, n_pad, SEQ, MC, LC, LAT, epochs,
                                          batch_size, lr, wd, clip)
    k_init, k_eps0, k_train = jax.random.split(jax.random.PRNGKey(seed), 3)
    variables = module.init({"params": k_init}, jnp.asarray(Xm[:2]),
                            jnp.asarray(Xl[:2]), k_eps0, jnp.ones(2), True)
    to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    params, stats = to64(variables["params"]), to64(variables["batch_stats"])
    opt_state = jtrainer.make_optimizer(lr, wd, clip).init(params)
    (j_params, j_stats, _), j_hist = run(
        params, stats, opt_state, jnp.asarray(pad(Xm), jnp.float64),
        jnp.asarray(pad(Xl), jnp.float64), k_train)

    tm = LesionConditionedVAE(seq_len=SEQ, micro_ch=MC, lesion_ch=LC,
                              latent=LAT).double()
    tm.load_state_dict(from_jax_params(_np64(params), _np64(stats)))
    perms, noise = _jax_draws(k_train, n, n_pad, epochs, batch_size)
    model, hist = ttrainer.train_lesion_vae(
        Xm, Xl, latent_dim=LAT, epochs=epochs, batch_size=batch_size, lr=lr,
        weight_decay=wd, grad_clip=clip, device="cpu", dtype=torch.float64,
        module=tm, perms=perms, noise=noise)

    np.testing.assert_allclose(hist.to_numpy(), np.asarray(j_hist), rtol=1e-8,
                               atol=1e-8)
    want = from_jax_params(_np64(j_params), _np64(j_stats))
    start = from_jax_params(_np64(params), _np64(stats))
    got = model.module.state_dict()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-8, err_msg=name)
    # the weights did move, far beyond the tolerance
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-4


def test_fused_optimizer_matches_optax_chain():
    """ClipDecayAdam against the optax chain of the JAX package
    (make_optimizer_reference), float64, steps above and below the clip and
    one skipped non-finite step."""
    rng = np.random.default_rng(11)

    class Two(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(7, 5))))
            self.b = torch.nn.Parameter(torch.from_numpy(rng.normal(size=(5,))))

    tm = Two()
    params = {"w": jnp.asarray(tm.w.detach().numpy()), "b": jnp.asarray(tm.b.detach().numpy())}
    ref = jtrainer.make_optimizer_reference(2e-4, 1e-3, 2.0)
    state = ref.init(params)
    opt = ttrainer.ClipDecayAdam(tm, 2e-4, 1e-3, 2.0)
    for step in range(6):
        scale = 100.0 if step in (1, 3) else 0.1
        g = {"w": rng.normal(size=(7, 5)) * scale, "b": rng.normal(size=(5,)) * scale}
        finite = step != 4
        opt.step([torch.from_numpy(g["w"]), torch.from_numpy(g["b"])],
                 torch.tensor(finite))
        if finite:
            upd, state = ref.update(jax.tree.map(jnp.asarray, g), state, params)
            params = optax.apply_updates(params, upd)
        np.testing.assert_allclose(tm.w.detach().numpy(), np.asarray(params["w"]),
                                   rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(tm.b.detach().numpy(), np.asarray(params["b"]),
                                   rtol=1e-12, atol=1e-15)
    assert int(opt.count) == 5


def test_nonfinite_loss_skips_update_but_advances_bn():
    """An infinite KLD weight makes the loss non-finite: the forward still
    advances the BatchNorm running stats, the weights, moments and step
    count stay, and the batch adds NaN to the epoch's loss sum as the JAX
    program's ``where(finite, 1, 0) * [loss * n, ...]`` does."""
    torch.manual_seed(0)
    tm = LesionConditionedVAE(seq_len=SEQ, micro_ch=MC, lesion_ch=LC,
                              latent=LAT).double()
    opt = ttrainer.ClipDecayAdam(tm, 2e-4, 1e-3, 2.0)
    Xm, Xl = (torch.from_numpy(a.astype(np.float64)) for a in _data(8, seed=1))
    mask = torch.tensor([1.0] * 6 + [0.0] * 2, dtype=torch.float64)
    eps = torch.zeros(8, LAT, dtype=torch.float64)
    w0, rm0 = opt.flat.clone(), tm.micro_b1.running_mean.clone()

    sums = ttrainer.train_step(tm, opt, Xm, Xl, mask, eps, float("inf"))
    assert torch.equal(opt.flat, w0) and int(opt.count) == 0
    assert torch.equal(opt.mu, torch.zeros_like(opt.mu))
    assert not torch.equal(tm.micro_b1.running_mean, rm0)
    assert torch.isnan(sums[0]) and torch.equal(sums[1:], torch.zeros(3, dtype=torch.float64))

    sums = ttrainer.train_step(tm, opt, Xm, Xl, mask, eps, 0.5)
    assert not torch.equal(opt.flat, w0) and int(opt.count) == 1
    assert float(sums[3]) == 6.0 and torch.isfinite(sums).all()


def test_history_contract_and_determinism():
    Xm, Xl = _data(40, seed=2)
    kw = dict(latent_dim=LAT, epochs=4, batch_size=16, seed=7, device="cpu")
    model, h1 = ttrainer.train_lesion_vae(Xm, Xl, **kw)
    _, h2 = ttrainer.train_lesion_vae(Xm, Xl, **kw)
    assert list(h1.columns) == ["loss", "recon", "kld", "beta"] and len(h1) == 4
    np.testing.assert_array_equal(h1.to_numpy(), h2.to_numpy())
    np.testing.assert_allclose(h1["beta"], [0.1, 0.1 + 1.9 / 3, 0.1 + 3.8 / 3, 2.0],
                               rtol=1e-6)
    assert model.dtype == torch.float32 and model.device.type == "cpu"


def test_draws_keep_pad_rows_at_the_tail():
    perms, noise = ttrainer.draw_run(37, 48, 3, 16, 5, torch.Generator().manual_seed(1))
    assert perms.shape == (3, 48) and noise.shape == (3, 3, 16, 5)
    for p in perms:
        assert sorted(p[:37].tolist()) == list(range(37))
        assert p[37:].tolist() == list(range(37, 48))


def test_cuda_requires_float32():
    Xm, Xl = _data(8, seed=0)
    with pytest.raises(ValueError, match="float32 on cuda"):
        ttrainer.train_lesion_vae(Xm, Xl, epochs=1, dtype=torch.float64)


def test_training_curve_within_band_of_jax():
    """float32 training curves of the two packages on the same data: init
    draws and noise differ (threefry vs the CPU generator), so the check is
    a band, as in tests/test_training_curve_parity.py."""
    Xm, Xl = _data(192, seed=0, seq=48)
    kw = dict(latent_dim=LAT, epochs=8, batch_size=32, lr=1e-3, seed=0)
    _, ours = ttrainer.train_lesion_vae(Xm, Xl, device="cpu", **kw)
    _, ref = jtrainer.train_lesion_vae(Xm, Xl, **kw)
    ours, ref = ours["loss"].to_numpy(), ref["loss"].to_numpy()
    assert ours[-1] < ours[0] and ref[-1] < ref[0]
    rel = np.abs(ours - ref) / np.abs(ref)
    assert rel.max() < 0.35, (ours.round(3), ref.round(3))
    assert abs(ours[-1] - ref[-1]) / ref[-1] < 0.2
