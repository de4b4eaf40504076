"""The port's VAE (layers, model, ELBO, weight conversion) against the JAX
package's flax model, float64, with JAX weights carried across by
``from_jax_params`` and the same reparameterisation noise on both sides."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from lesionvae_tpu.models import elbo as jelbo
from lesionvae_tpu.models import layers as jlayers
from lesionvae_tpu.models.lesion_vae import LesionConditionedVAE as JaxVAE
from lesionvae_tpu_torch.models import elbo as telbo
from lesionvae_tpu_torch.models import layers as tlayers
from lesionvae_tpu_torch.models.convert import _flat_perm, from_jax_params
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE

MC, LC, LAT, N = 13, 3, 10, 7
TOL = 1e-9
SEQS = [48, 100]   # 100: odd pooling (25 -> 12) and the final resize 96 -> 100


def _np_tree(t):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), t)


@pytest.fixture(scope="module", params=SEQS)
def pair(request):
    """(seq, flax module, params, batch_stats, port module, inputs)."""
    seq = request.param
    fm = JaxVAE(seq_len=seq, micro_ch=MC, lesion_ch=LC, latent=LAT)
    rng = np.random.default_rng(seq)
    xm = rng.normal(size=(N, seq, MC))
    xl = rng.uniform(size=(N, seq, LC))
    variables = fm.init({"params": jax.random.PRNGKey(seq)}, jnp.asarray(xm[:2]),
                        jnp.asarray(xl[:2]), jax.random.PRNGKey(1),
                        jnp.ones(2), True)
    params = _np_tree(variables["params"])
    # random running stats so that eval-mode BatchNorm is not the identity
    stats = {k: {"mean": rng.normal(0, 0.3, size=v["mean"].shape),
                 "var": rng.uniform(0.5, 2.0, size=v["var"].shape)}
             for k, v in variables["batch_stats"].items()}
    tm = LesionConditionedVAE(seq_len=seq, micro_ch=MC, lesion_ch=LC,
                              latent=LAT).double()
    tm.load_state_dict(from_jax_params(params, stats))
    eps = rng.normal(size=(N, LAT))
    return seq, fm, params, stats, tm, (xm, xl, eps)


def _jax_apply(fm, params, stats, xm, xl, eps, mask=None, train=False):
    mask_j = None if mask is None else jnp.asarray(mask)
    out = fm.apply({"params": params, "batch_stats": stats}, jnp.asarray(xm),
                   jnp.asarray(xl), None, mask_j, train, eps=jnp.asarray(eps),
                   mutable=["batch_stats"] if train else False)
    return out


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def test_eval_forward_matches_jax(pair):
    seq, fm, params, stats, tm, (xm, xl, eps) = pair
    xh, mu, logv = _jax_apply(fm, params, stats, xm, xl, eps)
    tm.eval()
    with torch.no_grad():
        txh, tmu, tlogv = tm(*_t(xm, xl), eps=torch.from_numpy(eps))
    assert txh.shape == (N, seq, MC)
    np.testing.assert_allclose(tmu.numpy(), np.asarray(mu), rtol=0, atol=TOL)
    np.testing.assert_allclose(tlogv.numpy(), np.asarray(logv), rtol=0, atol=TOL)
    np.testing.assert_allclose(txh.numpy(), np.asarray(xh), rtol=0, atol=TOL)


def test_encode_lesion_context_is_channel_major(pair):
    seq, fm, params, stats, tm, (xm, xl, _eps) = pair
    _, _, hl = fm.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(xm), jnp.asarray(xl), None, False,
                        method=JaxVAE.encode)
    tm.eval()
    with torch.no_grad():
        _, _, thl = tm.encode(*_t(xm, xl))
    perm = _flat_perm(seq // 4, 64)
    np.testing.assert_allclose(thl.numpy()[:, perm], np.asarray(hl), rtol=0,
                               atol=TOL)


def test_train_mode_masked_bn_matches_jax(pair):
    """Train-mode forward with pad rows (value 999) masked out: outputs and
    every updated running stat agree."""
    seq, fm, params, stats, _tm, (xm, xl, eps) = pair
    pad_m = np.concatenate([xm, np.full((3, seq, MC), 999.0)])
    pad_l = np.concatenate([xl, np.full((3, seq, LC), 999.0)])
    pad_eps = np.concatenate([eps, np.zeros((3, LAT))])
    mask = np.array([1.0] * N + [0.0] * 3)
    (xh, mu, logv), new = _jax_apply(fm, params, stats, pad_m, pad_l, pad_eps,
                                     mask=mask, train=True)
    tm = LesionConditionedVAE(seq_len=seq, micro_ch=MC, lesion_ch=LC,
                              latent=LAT).double()
    tm.load_state_dict(from_jax_params(params, stats))
    tm.train()
    with torch.no_grad():
        txh, tmu, _ = tm(*_t(pad_m, pad_l), mask=torch.from_numpy(mask),
                         eps=torch.from_numpy(pad_eps))
    np.testing.assert_allclose(tmu.numpy()[:N], np.asarray(mu)[:N], rtol=0, atol=TOL)
    np.testing.assert_allclose(txh.numpy()[:N], np.asarray(xh)[:N], rtol=0, atol=TOL)
    sd = tm.state_dict()
    for name, st in new["batch_stats"].items():
        np.testing.assert_allclose(sd[f"{name}.running_mean"].numpy(),
                                   np.asarray(st["mean"]), rtol=0, atol=TOL,
                                   err_msg=name)
        np.testing.assert_allclose(sd[f"{name}.running_var"].numpy(),
                                   np.asarray(st["var"]), rtol=0, atol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_loss_gradients_match_jax(pair, masked):
    """Gradients of the masked ELBO through a train-mode forward, carried
    into the port's layout with the same mapping as the weights."""
    seq, fm, params, stats, _tm, (xm, xl, eps) = pair
    mask = np.array([1, 1, 0, 1, 1, 1, 0], np.float64) if masked else None
    beta = 0.7

    def loss_fn(p):
        (xh, mu, logv), _ = fm.apply(
            {"params": p, "batch_stats": stats}, jnp.asarray(xm), jnp.asarray(xl),
            None, None if mask is None else jnp.asarray(mask), True,
            eps=jnp.asarray(eps), mutable=["batch_stats"])
        return jelbo.elbo(xh, jnp.asarray(xm), mu, logv, beta=beta,
                          mask=None if mask is None else jnp.asarray(mask))[0]

    jloss, jgrads = jax.value_and_grad(loss_fn)(
        jax.tree.map(jnp.asarray, params))
    want = from_jax_params(_np_tree(jgrads), stats)

    tm = LesionConditionedVAE(seq_len=seq, micro_ch=MC, lesion_ch=LC,
                              latent=LAT).double()
    tm.load_state_dict(from_jax_params(params, stats))
    tm.train()
    tmask = None if mask is None else torch.from_numpy(mask)
    xh, mu, logv = tm(*_t(xm, xl), mask=tmask, eps=torch.from_numpy(eps))
    loss = telbo.elbo(xh, torch.from_numpy(xm), mu, logv, beta=beta, mask=tmask)[0]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL, atol=0)
    for name, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), rtol=0,
                                   atol=TOL, err_msg=name)


@pytest.mark.parametrize("masked", [False, True])
def test_elbo_matches_jax(masked):
    rng = np.random.default_rng(3)
    x, xh = rng.normal(size=(9, 20, 4)), rng.normal(size=(9, 20, 4))
    mu, logv = rng.normal(size=(9, 5)), 0.3 * rng.normal(size=(9, 5))
    mask = (np.arange(9) < 6).astype(np.float64) if masked else None
    beta = jelbo.beta_schedule(5, 40)
    want = jelbo.elbo(*(jnp.asarray(a) for a in (xh, x, mu, logv)), beta=beta,
                      mask=None if mask is None else jnp.asarray(mask))
    got = telbo.elbo(*_t(xh, x, mu, logv), beta=beta,
                     mask=None if mask is None else torch.from_numpy(mask))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=1e-12, atol=0)
    if masked:
        # pad rows change nothing
        short = telbo.elbo(*_t(xh[:6], x[:6], mu[:6], logv[:6]), beta=beta)
        np.testing.assert_allclose(got[0].item(), short[0].item(), rtol=1e-12)


@pytest.mark.parametrize("epoch,total", [(0, 40), (5, 40), (39, 40), (0, 1), (3, 7)])
def test_beta_schedule_matches_jax(epoch, total):
    assert telbo.beta_schedule(epoch, total) == jelbo.beta_schedule(epoch, total)


@pytest.mark.parametrize("L,out", [(25, 12), (24, 48), (12, 24), (96, 100), (7, 3)])
def test_pool_and_resize_match_jax(L, out):
    """avg_pool_half (floor mode) and the linear resize, channel-first vs
    the JAX package's channel-last."""
    x = np.random.default_rng(L).normal(size=(3, L, 5))
    xt = torch.from_numpy(x.transpose(0, 2, 1).copy())
    np.testing.assert_allclose(
        tlayers.avg_pool_half(xt).numpy().transpose(0, 2, 1),
        np.asarray(jlayers.avg_pool_half(jnp.asarray(x))), rtol=0, atol=1e-12)
    np.testing.assert_allclose(
        tlayers.interp_linear(xt, out).numpy().transpose(0, 2, 1),
        np.asarray(jlayers.interp_linear(jnp.asarray(x), out)), rtol=0, atol=1e-12)
    # the interpolation matrix is torch's own linear resize
    np.testing.assert_allclose(
        tlayers.interp_linear(xt, out).numpy(),
        F.interpolate(xt, size=out, mode="linear", align_corners=False).numpy(),
        rtol=0, atol=1e-12)


def test_from_jax_params_inverts_the_torch_transplant():
    """tests/test_vae_parity.py moves a torch model's weights into the flax
    layout; from_jax_params must give them back unchanged."""
    from tests.test_vae_parity import SEQ, TorchVAE, transplant

    torch.manual_seed(5)
    oracle = TorchVAE().double()
    for m in oracle.modules():
        if isinstance(m, torch.nn.BatchNorm1d):
            m.running_mean.normal_(0, 0.3)
            m.running_var.uniform_(0.5, 2.0)
    params, stats = transplant(oracle, seq_len=SEQ)
    sd = from_jax_params(_np_tree(params), _np_tree(stats))
    for name, want in oracle.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        np.testing.assert_array_equal(sd[name].numpy(), want.numpy(), err_msg=name)


def test_param_count_at_full_width():
    """The slice's model: seq 100, 13 + 3 channels, latent 10."""
    tm = LesionConditionedVAE(seq_len=100, micro_ch=13, lesion_ch=3, latent=10)
    n = sum(p.numel() for p in tm.parameters())
    fm = JaxVAE(seq_len=100, micro_ch=13, lesion_ch=3, latent=10)
    shapes = jax.eval_shape(lambda: fm.init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 100, 13)),
        jnp.zeros((2, 100, 3)), jax.random.PRNGKey(1), jnp.ones(2), True))
    n_jax = sum(int(np.prod(a.shape)) for a in jax.tree.leaves(shapes["params"]))
    assert n == n_jax and 2.7e6 < n < 2.8e6
