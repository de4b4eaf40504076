"""The port's data- and tensor-parallel VAE steps
(``parallel.sharded.build_shardmap_train_step`` / ``build_sharded_train_step``)
and its dryruns, on gloo ranks on the CPU (the counterparts of
tests/test_shardmap.py and the dryrun cases of tests/test_parallel.py).

Bounds:
- the data-parallel step on 4 ranks against the port's one-process
  ``train_step`` in float64: loss, every parameter and the BatchNorm running
  statistics (the whole batch's) within 1e-10, over 3 steps;
- the same step against the JAX ``build_shardmap_train_step`` on its
  8-device mesh, JAX weights carried across with ``from_jax_params``, at
  tests/test_shardmap.py:55-82's bounds (loss rtol 1e-5, parameters rtol
  2e-4 / atol 1e-6, running mean rtol 1e-5);
- data 2 x model 2 (``build_sharded_train_step``) against one process in
  float64 within 1e-10 over 3 steps;
- the dryruns with their own assertions, ``dryrun_flagship`` at the real
  widths and reduced depth (3 steps, 2 members x 1 epoch).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lesionvae_tpu.models.lesion_vae import LesionConditionedVAE as JaxVAE
from lesionvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from lesionvae_tpu.parallel.sharded import build_shardmap_train_step as jax_shardmap
from lesionvae_tpu.train.trainer import make_optimizer
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.parallel import mesh as pm
from lesionvae_tpu_torch.parallel import ranks, sharded
from lesionvae_tpu_torch.train.trainer import ClipDecayAdam, train_step

torch.set_num_threads(1)

KW = dict(seq_len=16, micro_ch=4, lesion_ch=2, latent=4)
BATCH, STEPS, BETAS = 32, 3, [0.7, 0.4, 1.3]
TIGHT = dict(rtol=1e-10, atol=1e-10)
JAX_TEST_LEAVES = ("dec_b1.bias", "dec_b1.weight", "dec_b2.bias", "dec_b2.weight",
                   "dec_t1.bias", "dec_t1.weight")


def _jax_setup(seed=0):
    """tests/test_shardmap.py's batch and init, at latent 4 (even, so the
    model axis can split fc_mu and fc_logv)."""
    module = JaxVAE(**KW)
    k1, k2, k3, k4 = jax.random.split(jax.random.PRNGKey(seed), 4)
    xm = jax.random.normal(k1, (BATCH, KW["seq_len"], KW["micro_ch"]), jnp.float32)
    xl = jax.random.normal(k2, (BATCH, KW["seq_len"], KW["lesion_ch"]), jnp.float32)
    eps = jax.random.normal(k4, (STEPS, BATCH, KW["latent"]), jnp.float32)
    mask = jnp.ones(BATCH, jnp.float32).at[-3:].set(0.0)
    variables = module.init({"params": k3}, xm[:2], xl[:2], k3,
                            jnp.ones(2, jnp.float32), True)
    return module, variables, xm, xl, mask, eps


def _inputs():
    _m, variables, xm, xl, mask, eps = _jax_setup()
    sd = from_jax_params(jax.tree.map(np.asarray, variables["params"]),
                         jax.tree.map(np.asarray, variables["batch_stats"]))
    return ({k: v.numpy() for k, v in sd.items()},
            *(np.asarray(a, np.float64) for a in (xm, xl, mask, eps)))


def _one_process(sd, xm, xl, mask, eps):
    module = LesionConditionedVAE(**KW).double()
    module.load_state_dict({k: torch.from_numpy(v).double() for k, v in sd.items()})
    opt = ClipDecayAdam(module, 2e-4, 1e-3, 2.0)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    losses = []
    for i, beta in enumerate(BETAS):
        out = train_step(module, opt, t(xm), t(xl), t(mask), t(eps[i]), beta)
        losses.append(float(out[0] / out[3]))
    return losses, {k: v.numpy() for k, v in module.state_dict().items()}


@pytest.fixture(scope="module")
def run():
    sd, xm, xl, mask, eps = _inputs()
    common = dict(hyper=KW, state_dict=sd, xm=xm, xl=xl, mask=mask, eps=eps,
                  betas=BETAS, dtype=torch.float64)
    jobs = [("steps", 1, dict(common, kind="shardmap")),
            ("steps", 2, dict(common, kind="sharded"))]
    per_rank = pm.spawn(ranks.run, 4, "gloo", "cpu", jobs)
    return [[r[i][0] for r in per_rank] for i in range(len(jobs))]


@pytest.mark.parametrize("job", [0, 1], ids=["shardmap_dp4", "sharded_dp2_tp2"])
def test_parallel_step_matches_one_process_f64(run, job):
    want_losses, want = _one_process(*_inputs())
    for losses, got in run[job]:            # every rank holds the whole model
        np.testing.assert_allclose(losses, want_losses, **TIGHT)
        assert got.keys() == want.keys()
        for k in want:                      # parameters and running statistics
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TIGHT)


def test_shardmap_step_matches_jax_shardmap(run):
    """One step against the JAX shard_map step at its own test's bounds."""
    module, variables, xm, xl, mask, eps = _jax_setup()
    tx = make_optimizer(2e-4, 1e-3, 2.0)
    step, _ = jax_shardmap(KW, tx, jax_make_mesh(8))
    new_p, new_stats, _o, loss, _r, _k = step(
        variables["params"], variables["batch_stats"], tx.init(variables["params"]),
        xm, xl, mask, eps[0], jnp.asarray(BETAS[0], jnp.float32))
    want = from_jax_params(jax.tree.map(np.asarray, new_p),
                           jax.tree.map(np.asarray, new_stats))
    sd, xm_, xl_, mask_, eps_ = _inputs()
    got = ranks.steps(pm.Mesh(1, 1, 0, "cpu"), "shardmap", KW, sd, xm_, xl_, mask_,
                      eps_[:1], BETAS[:1], torch.float64)
    np.testing.assert_allclose(got[0][0], float(loss), rtol=1e-5)
    # the six leaves tests/test_shardmap.py compares (the first of the flax
    # tree), at its bounds
    for k in JAX_TEST_LEAVES:
        np.testing.assert_allclose(got[1][k], want[k].numpy(), rtol=2e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got[1]["micro_b1.running_mean"],
                               want["micro_b1.running_mean"].numpy(), rtol=1e-5)
    # and the 4-rank run's first step is that one-rank step
    assert run[0][0][0][0] == pytest.approx(got[0][0], rel=1e-12)


def test_param_shardings_mark_the_column_parallel_leaves():
    specs = sharded.param_shardings(LesionConditionedVAE(**KW))
    split = {k for k, v in specs.items() if v}
    assert split == {f"{n}.{p}" for n in sharded.TP_LAYERS for p in ("weight", "bias")}
    assert specs["fc_dec.weight"] == ("model", None) and specs["fc_mu.bias"] == ("model",)
    assert specs["micro_c1.weight"] == ()


def test_dryrun_shardmap_matches_single_device():
    loss_sm, loss_ref = sharded.dryrun_shardmap_step(4, device="cpu")
    np.testing.assert_allclose(loss_sm, loss_ref, rtol=1e-5)


def test_dryrun_train_step_dp_tp():
    loss, delta = sharded.dryrun_train_step(2, model_parallel=2, device="cpu")
    assert np.isfinite(loss) and delta > 0


def test_dryrun_flagship_reduced():
    """Real widths, reduced depth: the JAX function's assertions hold inside
    the ranks; the summary carries its keys."""
    out = sharded.dryrun_flagship(2, steps=3, epochs=1, fleet_members=2, device="cpu")
    assert out["dims"] == dict(seq_len=100, micro_ch=13, lesion_ch=3, latent=10)
    assert out["early_step_rel"] < 1e-5 and out["max_param_rel_div"] < 0.5
    assert out["fleet_members"] == 2 and out["fleet_epochs"] == 1
    assert np.isfinite(out["fleet_mean_loss"]) and out["steps"] == 3 and out["batch"] == 8

