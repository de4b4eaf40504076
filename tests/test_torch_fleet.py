"""The port's cohort fleet (``train/batched.py``, ``models/fleet.py``) against
the JAX package's fleet program and against the port's own single trainer:
normalization on the device, padding, the whole program in lockstep with
injected draws, member independence, the skipped non-finite step, and the
bf16 compute and storage options."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.models import layers as jlayers
from lesionvae_tpu.train import batched as jb
from lesionvae_tpu.train import data as jdata
from lesionvae_tpu_torch.models import layers as tlayers
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.fleet import FleetState, layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.ops import masked_bn
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train import data as tdata
from lesionvae_tpu_torch.train import trainer as ttrainer
from lesionvae_tpu_torch.train.lowmem import LowmemOptimizer

# Tiny shapes: one intra-op thread.  Several test workers, each with a
# thread per core inside every small product, oversubscribe the cores and
# slow these files many times over.
torch.set_num_threads(1)

SEQ, MC, LC, LAT = 24, 5, 3, 4
HYPER = dict(seq_len=SEQ, micro_ch=MC, lesion_ch=LC, latent=LAT)
LR, WD, CLIP = 2e-4, 1e-3, 2.0
HIST_RTOL, MOVE_RTOL = 5e-3, 0.1


def _blocks(T, n_pad, n_real, seed, seq=SEQ):
    """Padded raw blocks (pad rows zero) with a signal to learn."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, seq)
    Xm = (np.sin(2 * np.pi * t)[None, None, :, None] * (1 + np.arange(MC))
          + 0.3 * rng.normal(size=(T, n_pad, seq, MC)) + 2.0).astype(np.float32)
    Xl = rng.uniform(0, 1, size=(T, n_pad, seq, LC)).astype(np.float32)
    for i, n in enumerate(n_real):
        Xm[i, n:] = 0
        Xl[i, n:] = 0
    return Xm, Xl


# ------------------------------------------------------------ normalization
@pytest.mark.parametrize("n_real", [(12, 9), (7, 12)])   # even and odd counts
def test_normalize_on_device_matches_jax_f64(n_real):
    """Per member against lesionvae_tpu/train/data.py:188 in float64, to
    1e-12: NaN and ±inf entries, a feature with no finite value, odd and even
    counts (the median averages two order statistics or takes one twice),
    and pad rows that hold garbage and must be ignored."""
    T, n_pad = 2, 12
    rng = np.random.default_rng(1)
    Xm = rng.normal(size=(T, n_pad, SEQ, MC)) * [1, 5, 0.1, 20, 1] + [0, 3, -1, 0, 9]
    Xl = rng.uniform(size=(T, n_pad, SEQ, LC))
    Xm[0, 1, 3, 0], Xm[0, 2, 5, 1], Xm[1, 0, 0, 3] = np.nan, np.inf, -np.inf
    Xm[1, :, :, 2] = np.nan                       # no finite value at all
    Xm[0, 3, ::2, 4] = np.nan                     # odd count of finite values
    Xl[0, 0, 0, 1] = np.nan
    for i, n in enumerate(n_real):
        Xm[i, n:] = 1e9 * rng.normal(size=Xm[i, n:].shape)   # pad rows: garbage
    Xz, Xl_t, stats = tdata.normalize_on_device(
        torch.from_numpy(Xm), torch.from_numpy(Xl), torch.tensor(n_real))
    for i, n in enumerate(n_real):
        jz, jl, jstats = jdata.normalize_on_device(
            jnp.asarray(Xm[i], jnp.float64), jnp.asarray(Xl[i], jnp.float64), n)
        for k in ("median", "mean", "std"):
            np.testing.assert_allclose(stats[k][i].numpy(), np.asarray(jstats[k]),
                                       rtol=1e-12, atol=1e-12, err_msg=k)
        np.testing.assert_allclose(Xz[i, :n].numpy(), np.asarray(jz)[:n],
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_array_equal(Xl_t[i].numpy(), np.asarray(jl))
    assert stats["std"][1, 2] == 1.0 and stats["median"][1, 2] == 0.0
    assert bool((Xz[1, :n_real[1], :, 2] == 0).all())


@pytest.mark.parametrize("batch_size,min_rows", [(16, 0), (8, 40), (1, 0)])
def test_pad_datasets_matches_jax(batch_size, min_rows):
    rng = np.random.default_rng(2)
    tensors = [(rng.normal(size=(n, SEQ, MC)).astype(np.float32),
                rng.normal(size=(n, SEQ, LC)).astype(np.float32)) for n in (13, 21, 5)]
    got = tb.pad_datasets(tensors, batch_size=batch_size, min_rows=min_rows)
    want = jb.pad_datasets(tensors, batch_size=batch_size, min_rows=min_rows)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] % batch_size == 0 and got[0].shape[1] >= min_rows


# ------------------------------------------------------------ lockstep with JAX
def _jax_member_draws(key, n_pad, epochs, batch_size):
    """What ``train_one`` draws from a member's key (batched.py:108-114,
    165-175, 208-209): initial variables, the permutations of all padded
    rows and the reparameterisation noise."""
    perms, noise = [], []
    for ep_key in jax.random.split(jax.random.fold_in(key, 1), epochs):
        k_perm, k_eps = jax.random.split(ep_key)
        perms.append(np.asarray(jax.random.permutation(k_perm, n_pad)))
        noise.append([np.asarray(jax.random.normal(r, (batch_size, LAT), jnp.float32))
                      for r in jax.random.split(k_eps, n_pad // batch_size)])
    return np.stack(perms), np.asarray(noise)


def test_fleet_lockstep_with_jax_program():
    """``_fleet_program`` in float32 (normalization and summary fused in, as
    ``launch_many_vaes`` runs it) against the port's fleet with the JAX
    initial weights, permutations and noise.  Tolerance: both run float32
    and sum in other orders (XLA's convolutions against batched products,
    its reductions against PyTorch's).  Adam divides each gradient by its
    own running size, so where a gradient is small and made of cancelling
    terms (the micro encoder early on, which reaches the loss only through
    four latent inputs of the decoder) a relative rounding error of 1e-2 in
    g is a relative error of 1e-2 in the step.  Read: two members agree to
    5e-6 in history and 4e-4 of each leaf's movement (the port's float64 run
    lies within 1e-7 of the JAX float32 histories of those two), the third,
    whichever has scattered pad rows in small batches, to 2e-3 and 3e-2.
    So: every member within HIST_RTOL and MOVE_RTOL (error of a leaf over
    the distance it moved, in L2), the median member within 5e-5 and 2e-3."""
    T, n_pad, B, epochs, n_seg, seed = 3, 32, 8, 3, 4, 7
    n_real = np.array([32, 27, 18], np.int32)
    Xm, Xl = _blocks(T, n_pad, n_real, seed=3)
    Xm[0, 2, 3, 1], Xm[1, 5, 7, 0] = np.nan, np.inf       # imputed on the device
    rng = np.random.default_rng(4)
    sham = np.zeros((T, n_pad), np.float32)
    subj = np.full((T, n_pad), n_seg - 1, np.int32)
    for i, n in enumerate(n_real):
        sham[i, :n] = rng.uniform(size=n) < 0.4
        subj[i, :n] = rng.integers(0, n_seg - 1, size=n)

    program, module, _ = jb._fleet_program(
        n_pad, SEQ, MC, LC, LAT, epochs, B, LR, WD, CLIP, None, n_seg, seed, True)
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    (params_T, stats_T, hist_T, summ, Xm_n, Xl_n, norm_T) = program(
        jnp.asarray(Xm), jnp.asarray(Xl), jnp.asarray(n_real), keys,
        jnp.asarray(sham), jnp.asarray(subj))

    sds, perms, noise = [], [], []
    for key in keys:
        k1, k2 = jax.random.split(key)
        v = module.init({"params": k1}, jnp.zeros((2, SEQ, MC), jnp.float32),
                        jnp.zeros((2, SEQ, LC), jnp.float32), k2,
                        jnp.ones(2, jnp.float32), True)
        sds.append(from_jax_params(jax.tree.map(np.asarray, v["params"]),
                                   jax.tree.map(np.asarray, v["batch_stats"])))
        p, e = _jax_member_draws(key, n_pad, epochs, B)
        perms.append(p)
        noise.append(e)
    summary_noise = tuple(
        np.asarray(jax.random.normal(jax.random.PRNGKey(seed + d), (n_pad, LAT),
                                     jnp.float32)) for d in (0, 1))
    handle = tb.launch_many_vaes(
        Xm, Xl, n_real, latent_dim=LAT, epochs=epochs, batch_size=B, lr=LR,
        weight_decay=WD, grad_clip=CLIP, summary_spec=(sham, subj, n_seg, seed),
        normalize_on_device=True, device="cpu", state_dicts=sds,
        perms=torch.from_numpy(np.stack(perms)),
        noise=torch.from_numpy(np.stack(noise)), summary_noise=summary_noise)
    models, hist = handle.fetch()

    for k in ("median", "mean", "std"):
        np.testing.assert_allclose(handle.norm_stats[k].numpy(), np.asarray(norm_T[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    # pad rows normalize zeros: compared too
    np.testing.assert_allclose(handle.Xm.numpy(), np.asarray(Xm_n), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(handle.Xl.numpy(), np.asarray(Xl_n))
    assert hist.shape == (T, epochs, 4)
    hist_err = np.abs(hist / np.asarray(hist_T) - 1).max(axis=(1, 2))
    leaf_err = np.zeros(T)
    for i in range(T):
        take = lambda t: jax.tree.map(lambda a: np.asarray(a[i]), t)  # noqa: E731
        want = from_jax_params(take(params_T), take(stats_T))
        got = models[i].module.state_dict()
        for name, w in want.items():
            moved = float((w - sds[i][name]).norm())
            assert moved > 0, name
            leaf_err[i] = max(leaf_err[i], float((got[name] - w).norm()) / moved)
    assert hist_err.max() < HIST_RTOL and np.median(hist_err) < 5e-5, hist_err
    assert leaf_err.max() < MOVE_RTOL and np.median(leaf_err) < 2e-3, leaf_err
    for name, g, w in zip(("mean", "std", "magnitude", "profile", "counts"),
                          handle.summary, summ):
        # the summary of weights that differ as above (read 3.5e-4); held to
        # 1e-9 in float64 with carried weights in test_torch_cohort_pipeline
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-3, atol=3e-3,
                                   err_msg=name)


# ------------------------------------------------------------ inside the port
def _fleet_inputs(T=3, n_pad=32, B=8, epochs=2, seed=0):
    n_real = np.array([32, 27, 19][:T])
    Xm, Xl = _blocks(T, n_pad, n_real, seed)
    sds = tb.init_state_dicts(T, HYPER, seed + 1)
    perms, noise = tb.draw_fleet(T, n_pad, epochs, B, LAT,
                                 torch.Generator().manual_seed(seed + 2))
    return Xm, Xl, n_real, sds, perms, noise


def test_fleet_member_equals_member_trained_alone_f64():
    """Float64: every member of the fleet against ``train_module`` on that
    member alone with the same weights, scattered-pad permutations and
    noise, to 1e-10 in history, weights and BatchNorm statistics."""
    B, epochs = 8, 2
    Xm, Xl, n_real, sds, perms, noise = _fleet_inputs(B=B, epochs=epochs)
    handle = tb.launch_many_vaes(
        Xm, Xl, n_real, latent_dim=LAT, epochs=epochs, batch_size=B, lr=LR,
        device="cpu", dtype=torch.float64, state_dicts=sds, perms=perms,
        noise=noise.double())
    models, hist = handle.fetch()
    for i, n in enumerate(n_real):
        alone = LesionConditionedVAE(**HYPER).double()
        alone.load_state_dict({k: v.double() for k, v in sds[i].items()})
        h = ttrainer.train_module(
            alone, torch.from_numpy(Xm[i]).double(), torch.from_numpy(Xl[i]).double(),
            int(n), perms[i], noise[i].double(), epochs, B, LR, 1e-3, 2.0)
        np.testing.assert_allclose(hist[i], h, rtol=1e-10, atol=1e-10)
        for (k, a), b in zip(alone.state_dict().items(),
                             models[i].module.state_dict().values()):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=0, atol=1e-10,
                                       err_msg=f"member {i} {k}")
        assert float((alone.fc_dec.weight - sds[i]["fc_dec.weight"]).abs().max()) > 1e-3


@pytest.mark.parametrize("route", ["grouped", "vmap"])
def test_other_ways_to_batch_the_members_agree_f64(route, monkeypatch):
    """The two routes ``benchmarks/vae_step_profile.py --fleet --route`` reads
    beside the package's batched products, grouped convolutions and
    ``torch.func.vmap`` of the single member's gradient, take the same three
    steps: weights and BatchNorm statistics to 1e-11 in float64."""
    from lesionvae_tpu_torch.benchmarks import vae_step_profile as prof
    from lesionvae_tpu_torch.models import fleet

    T, B = 3, 8
    Xm, Xl, _n, sds, _p, noise = _fleet_inputs(T=T, B=B)
    lay = layout(**HYPER)
    xm = torch.from_numpy(Xm[:, :B]).double()
    xl = torch.from_numpy(Xl[:, :B]).double()
    mask = torch.ones(T, B, dtype=torch.float64)
    mask[1, 5:] = 0.0
    eps = noise[:, 0, 0].double()

    def three_steps(step):
        state = FleetState.from_state_dicts(sds, lay, torch.float64, None, "cpu")
        opt = LowmemOptimizer(state, LR, 1e-3, 2.0)
        for _ in range(3):
            step(state, opt)
        return state

    want = three_steps(lambda s, o: tb.fleet_step(s, o, xm, xl, mask, eps, 1.0))
    if route == "grouped":
        monkeypatch.setattr(fleet, "_conv", prof.conv_grouped)
        got = three_steps(lambda s, o: tb.fleet_step(s, o, xm, xl, mask, eps, 1.0))
    else:
        module = LesionConditionedVAE(**HYPER).double().train()
        got = three_steps(lambda s, o: prof.fleet_step_vmap(
            s, o, module, xm, xl, mask, eps, 1.0))
    for name, a in {**want.leaves, **want.stats}.items():
        np.testing.assert_allclose({**got.leaves, **got.stats}[name].numpy(),
                                   a.numpy(), rtol=0, atol=1e-11, err_msg=name)
    moved = want.leaves["fc_dec.weight"] - torch.stack(
        [sd["fc_dec.weight"] for sd in sds]).double()
    assert float(moved.abs().max()) > 1e-4


def test_fleet_is_deterministic_and_seeded():
    Xm, Xl, n_real, *_ = _fleet_inputs(T=2)
    kw = dict(latent_dim=LAT, epochs=2, batch_size=8, device="cpu", seed=5)
    _, h1 = tb.train_many_vaes(Xm, Xl, n_real[:2], **kw)
    _, h2 = tb.train_many_vaes(Xm, Xl, n_real[:2], **kw)
    np.testing.assert_array_equal(h1, h2)
    assert h1.shape == (2, 2, 4) and np.isfinite(h1).all()
    np.testing.assert_allclose(h1[:, :, 3], [[0.1, 2.0]] * 2, rtol=1e-6)
    perms, noise = tb.draw_fleet(2, 32, 3, 8, LAT, torch.Generator().manual_seed(0))
    assert perms.shape == (2, 3, 32) and noise.shape == (2, 3, 4, 8, LAT)
    assert sorted(perms[1, 2].tolist()) == list(range(32))


def test_nonfinite_step_of_one_member_leaves_the_others_untouched():
    """An infinite input makes member 1's loss non-finite: its weights,
    moments and step count stay, its BatchNorm statistics have advanced,
    and members 0 and 2 end bit for bit where they end without it."""
    T, B = 3, 8
    Xm, Xl, n_real, sds, _p, noise = _fleet_inputs(T=T, B=B)
    lay = layout(**HYPER)
    xb_m, xb_l = torch.from_numpy(Xm[:, :B]), torch.from_numpy(Xl[:, :B])
    mask = torch.ones(T, B)
    mask[2, 6:] = 0
    bad = xb_m.clone()
    bad[1, 3, 5, 2] = float("inf")
    ends = []
    for x in (xb_m, bad):
        state = FleetState.from_state_dicts(sds, lay, device="cpu")
        opt = LowmemOptimizer(state, LR, WD, CLIP)
        sums = tb.fleet_step(state, opt, x, xb_l, mask, noise[:, 0, 0], 0.5)
        ends.append((state, opt, sums))
    (clean, opt_c, sums_c), (state, opt, sums) = ends
    assert opt_c.count.tolist() == [1, 1, 1] and opt.count.tolist() == [1, 0, 1]
    start = FleetState.from_state_dicts(sds, lay, device="cpu")
    for i in (0, 2):
        assert torch.equal(state.weights[i], clean.weights[i])
        assert torch.equal(state.affine[i], clean.affine[i])
        assert torch.equal(opt.mu_w[i], opt_c.mu_w[i])
        assert torch.equal(sums[i], sums_c[i])
        assert not torch.equal(state.weights[i], start.weights[i])
    assert torch.equal(state.weights[1], start.weights[1])
    assert torch.equal(state.affine[1], start.affine[1])
    assert not bool(opt.mu_w[1].any()) and not bool(opt.nu_a[1].any())
    rm = "micro_b1.running_mean"
    assert not torch.equal(state.stats[rm][1], start.stats[rm][1])
    assert torch.equal(state.stats[rm][0], clean.stats[rm][0])
    # the skipped member adds NaN (not-finite times zero) to its loss sum only
    assert torch.isnan(sums[1, 0]) and float(sums[1, 3]) == 0.0
    assert float(sums[2, 3]) == 6.0 and torch.isfinite(sums[[0, 2]]).all()


def test_launch_checks_its_arguments():
    Xm, Xl, n_real, *_ = _fleet_inputs(T=2)
    kw = dict(latent_dim=LAT, epochs=1, device="cpu")
    with pytest.raises(ValueError, match="requires normalize_on_device"):
        tb.launch_many_vaes(Xm, Xl, n_real[:2], batch_size=8, quantize_upload=True, **kw)
    with pytest.raises(ValueError, match="multiple of batch_size"):
        tb.launch_many_vaes(Xm, Xl, n_real[:2], batch_size=12, **kw)
    with pytest.raises(ValueError, match="float32 on cuda"):
        tb.launch_many_vaes(Xm, Xl, n_real[:2], batch_size=8, latent_dim=LAT,
                            dtype=torch.float64)
    if not torch.cuda.is_available():
        # the default device is the card: no quiet CPU run
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            tb.launch_many_vaes(Xm, Xl, n_real[:2], batch_size=8, latent_dim=LAT,
                                epochs=1)


# ------------------------------------------------------------ bf16 compute and storage
@pytest.mark.parametrize("masked", [False, True])
def test_folded_batch_norm_bf16_matches_jax(masked):
    """bfloat16 input: scale and shift folded in float32 and applied in
    bfloat16 (lesionvae_tpu/models/layers.py:101-110), against the flax
    layer to 1 bf16 ulp, for the member's layer and the stacked one."""
    rng = np.random.default_rng(0)
    N, L, C = 8, 12, 6
    x = rng.normal(size=(N, L, C)).astype(np.float32) * 2 + 1
    mask = np.array([1, 1, 1, 0, 1, 1, 0, 1], np.float32) if masked else None
    gamma = rng.uniform(0.5, 1.5, C).astype(np.float32)
    beta = rng.normal(size=C).astype(np.float32)
    jbn = jlayers.MaskedBatchNorm(C)
    variables = {"params": {"scale": jnp.asarray(gamma), "bias": jnp.asarray(beta)},
                 "batch_stats": {"mean": jnp.zeros(C), "var": jnp.ones(C)}}
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want, new = jbn.apply(variables, xb, None if mask is None else jnp.asarray(mask),
                          True, mutable=["batch_stats"])
    want = np.asarray(want.astype(jnp.float32))

    xt = torch.from_numpy(x).to(torch.bfloat16)
    mt = None if mask is None else torch.from_numpy(mask)
    bn = tlayers.MaskedBatchNorm(C)
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(gamma))
        bn.bias.copy_(torch.from_numpy(beta))
    bn.train()
    got = bn(xt.transpose(1, 2), mt).transpose(1, 2)
    mean, var, rm, rv = masked_bn.stats_plain(
        xt[None], None if mt is None else mt[None], torch.zeros(1, C), torch.ones(1, C))
    stacked = masked_bn.batch_norm_plain(xt[None], mean, var, bn.weight.detach()[None],
                                         bn.bias.detach()[None])
    for y in (got, stacked[0]):
        assert y.dtype == torch.bfloat16
        y = y.float().detach().numpy()
        ulp = np.maximum(np.abs(want), 2.0 ** -6) * 2.0 ** -7
        assert np.all(np.abs(y - want) <= ulp)
    np.testing.assert_allclose(rm[0].numpy(), np.asarray(new["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["batch_stats"]["var"]), rtol=1e-5, atol=1e-6)


def _curve_data(T=2, n_pad=64, L=32, seed=0):
    """The data of tests/test_mixed_precision.py and tests/test_lowmem.py."""
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, L)
    base = np.sin(2 * np.pi * t)[None, None, :, None]
    Xm = (base + 0.2 * rng.normal(size=(T, n_pad, L, MC))).astype(np.float32)
    Xl = rng.uniform(size=(T, n_pad, L, LC)).astype(np.float32)
    return Xm, Xl, np.full(T, 60, np.int32)


@pytest.mark.parametrize("base,option", [
    (dict(), dict(compute_dtype=torch.bfloat16)),             # test_mixed_precision
    (dict(compute_dtype=torch.bfloat16),
     dict(compute_dtype=torch.bfloat16, store_dtype=torch.bfloat16)),   # test_lowmem
])
def test_bf16_curves_track_the_float32_form(base, option):
    """The 10% band of the JAX package's own tests: bf16 compute against
    float32, and bf16 storage against float32 storage (both bf16 compute),
    from the same seed."""
    Xm, Xl, n_real = _curve_data()
    kw = dict(latent_dim=3, epochs=6, batch_size=32, seed=3, device="cpu")
    _, ref = tb.train_many_vaes(Xm, Xl, n_real, **kw, **base)
    handle = tb.launch_many_vaes(Xm, Xl, n_real, **kw, **option)
    models, got = handle.fetch()
    l_ref, l_got = ref[:, :, 0], got[:, :, 0]
    assert np.isfinite(l_got).all() and (l_got[:, -1] < l_got[:, 0]).all()
    rel = np.abs(l_got - l_ref) / np.abs(l_ref)
    assert rel.max() < 0.1, rel.max()
    stored = handle.state.weights.dtype
    assert stored == (torch.bfloat16 if "store_dtype" in option else torch.float32)
    assert handle.state.affine.dtype == torch.float32
    assert models[0].dtype == torch.float32     # members come back widened


def test_bf16_leaves_get_bf16_gradients():
    """The forward widens a stored bf16 leaf, so autograd's backward of the
    cast hands the optimizer a gradient rounded to bf16, as ``jax.grad``
    does for a bf16 leaf; the float32 BatchNorm leaves keep float32."""
    T, B = 2, 8
    Xm, Xl, _n, sds, _p, noise = _fleet_inputs(T=T, B=B)
    lay = layout(**HYPER)
    state = FleetState.from_state_dicts(sds, lay, store_dtype=torch.bfloat16, device="cpu")
    seen = {}

    class Spy(LowmemOptimizer):
        def step(self, grads, finite):
            seen.update({k: v.dtype for k, v in grads.items()})
            super().step(grads, finite)

    opt = Spy(state, LR, WD, CLIP, salts=torch.tensor([1, 2]))
    before = state.weights.clone()
    tb.fleet_step(state, opt, torch.from_numpy(Xm[:T, :B]), torch.from_numpy(Xl[:T, :B]),
                  torch.ones(T, B), noise[:T, 0, 0], 0.5)
    assert seen["fc_dec.weight"] == seen["micro_c1.bias"] == torch.bfloat16
    assert seen["micro_b1.weight"] == torch.float32
    assert state.weights.dtype == torch.bfloat16
    assert not torch.equal(state.weights, before)
