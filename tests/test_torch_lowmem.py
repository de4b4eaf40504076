"""The port's bf16-storage optimizer against the JAX package's
(lesionvae_tpu/train/lowmem.py): the noise hash and the stochastic rounding
bit for bit, one optimizer step on a real model tree carried across with
``from_jax_params`` (so the index table is exercised on every permuted
leaf), and the float32 form against ``ClipDecayAdam``."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.models.lesion_vae import LesionConditionedVAE as JaxVAE
from lesionvae_tpu.train import lowmem as jlow
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.fleet import FleetState, layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.ops import sr_adam
from lesionvae_tpu_torch.train import lowmem as tlow
from lesionvae_tpu_torch.train.trainer import ClipDecayAdam

# Tiny shapes: one intra-op thread.  Several test workers, each with a
# thread per core inside every small product, oversubscribe the cores and
# slow these files many times over.
torch.set_num_threads(1)

SEQ, MC, LC, LAT = 24, 5, 3, 4
LR, WD, CLIP = 2e-4, 1e-3, 2.0


def _bits16(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy().view(np.uint16)


def _jax_bits16(a) -> np.ndarray:
    return np.asarray(jax.lax.bitcast_convert_type(a, jnp.uint16))


@pytest.mark.parametrize("shape", [(7,), (3, 5), (2, 3, 4), (100_003,)])
@pytest.mark.parametrize("salt", [0, 123, 2 ** 32 - 1, 2 ** 32 - 7, 0x9E3779B1])
def test_hash_bits_bit_equal(shape, salt):
    want = np.asarray(jlow._hash_bits(shape, jnp.uint32(salt))).reshape(-1)
    n = int(np.prod(shape))
    got = sr_adam.hash_bits(sr_adam.index_hash_base(n), torch.tensor(salt))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def _round_both(x: np.ndarray, bits: np.ndarray):
    want = jlow._store_round(jnp.asarray(x, jnp.float32), jnp.asarray(bits, jnp.uint32),
                             jnp.bfloat16)
    got = sr_adam.store_round(torch.from_numpy(x.astype(np.float32)),
                              torch.from_numpy(bits.astype(np.int64)))
    return got, want


@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e30])
def test_store_round_bit_equal(scale):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=50_000) * scale).astype(np.float32)
    x[:6] = [0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40]
    bits = rng.integers(0, 2 ** 32, size=x.size, dtype=np.uint64)
    got, want = _round_both(x, bits)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits16(got), _jax_bits16(want))


def test_store_round_statistics_saturation_and_nan():
    """The midpoint and quarter-point statistics of tests/test_lowmem.py,
    saturation at ±bf16-max, and NaN / inf passing through, each equal to
    the JAX function's result."""
    n = 100_000
    bits = np.asarray(jlow._hash_bits((n,), jnp.uint32(123))).astype(np.uint64)
    for value, lo, hi in ((1.0 + 2.0 ** -8, 0.49, 0.51), (1.0 + 2.0 ** -9, 0.24, 0.26)):
        got, want = _round_both(np.full(n, value, np.float32), bits)
        np.testing.assert_array_equal(_bits16(got), _jax_bits16(want))
        r = got.float().numpy()
        assert lo < (r > 1.0).mean() < hi
        np.testing.assert_allclose(r.mean(), value, rtol=6e-5)
    got, _ = _round_both(np.full(1000, 1.0, np.float32), bits[:1000])
    assert (got.float().numpy() == 1.0).all()

    # finite values above bf16-max carry into the infinity pattern: saturate
    big = np.float32(sr_adam.BF16_MAX)
    above = np.nextafter(big, np.float32(np.inf), dtype=np.float32)
    x = np.array([above, -above, np.float32(3.4e38), -np.float32(3.4e38), big, -big],
                 np.float32)
    noise = np.full(x.size, 0xFFFF, np.uint64)
    got, want = _round_both(x, noise)
    np.testing.assert_array_equal(_bits16(got), _jax_bits16(want))
    np.testing.assert_array_equal(got.float().numpy(),
                                  [big, -big, big, -big, big, -big])

    x = np.array([np.nan, np.inf, -np.inf], np.float32)
    got, want = _round_both(x, noise[:3])
    assert torch.isnan(got[0]) and bool(jnp.isnan(want[0]))
    np.testing.assert_array_equal(_bits16(got)[1:], _jax_bits16(want)[1:])
    assert sr_adam.store_round(torch.ones(3), torch.zeros(3, dtype=torch.int64),
                               torch.float32).dtype == torch.float32
    with pytest.raises(TypeError):
        sr_adam.store_round(torch.ones(3), torch.zeros(3, dtype=torch.int64),
                            torch.float16)


def _jax_tree(seed):
    """Initial flax params of a small real model, and a gradient tree."""
    module = JaxVAE(seq_len=SEQ, micro_ch=MC, lesion_ch=LC, latent=LAT)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    variables = module.init({"params": k1}, jnp.zeros((2, SEQ, MC), jnp.float32),
                            jnp.zeros((2, SEQ, LC), jnp.float32), k2,
                            jnp.ones(2, jnp.float32), True)
    params = variables["params"]
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(k3, len(leaves))
    grads = jax.tree.unflatten(treedef, [
        0.05 * jax.random.normal(k, a.shape, jnp.float32) for k, a in zip(keys, leaves)])
    return params, grads, variables["batch_stats"]


def _carry(tree, stats) -> dict:
    """A flax tree (any float dtype) in the port's layout, as float32."""
    f32 = jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)), tree)
    return from_jax_params(f32, jax.tree.map(np.asarray, stats))


def _moment_dict(opt, state, which):
    lay = state.layout
    out = {}
    for name, (buf, off, shape) in lay.leaves.items():
        src = getattr(opt, f"{which}_w" if buf == "weights" else f"{which}_a")
        out[name] = src[0, off:off + int(np.prod(shape))].reshape(shape).float()
    return out


def test_lowmem_step_matches_jax_on_a_model_tree():
    """Two steps of the JAX LowmemOptimizer on bf16-stored weights (one below
    the clip, one above it) against the port's, same salt: p, m and v equal
    bit for bit but for a budget.  The budget is for compiled XLA rounding a
    float32 intermediate differently (a fused multiply-add, its own pow for
    the bias corrections): at most 0.1% of elements, at most 1 bf16 ulp at
    a magnitude of at least 2^-10 (p + u may cancel to almost nothing, and
    then a float32 ulp of u is many ulps of the sum)."""
    params32, grads32, stats = _jax_tree(0)
    params = jlow.cast_params_storage(params32, jnp.bfloat16)
    salt = 0xFEDCBA98
    tx = jlow.LowmemOptimizer(LR, WD, CLIP)
    jstate = tx.init(params, salt=jnp.uint32(salt))

    lay = layout(SEQ, MC, LC, LAT)
    state = FleetState.from_state_dicts([_carry(params, stats)], lay,
                                        store_dtype=torch.bfloat16, device="cpu")
    # carried and stored again, the weights are the JAX tree's bits
    assert state.weights.dtype == torch.bfloat16 and state.affine.dtype == torch.float32
    opt = tlow.LowmemOptimizer(state, LR, WD, CLIP, salts=torch.tensor([salt]))
    total = differing = 0
    for scale in (1.0, 40.0):
        g = jax.tree.map(
            lambda a, p: (scale * a).astype(p.dtype), grads32, params)
        params, jstate = jax.jit(tx.step)(g, jstate, params)
        carried_g = _carry(g, stats)
        grads = {n: carried_g[n][None].to(state.leaves[n].dtype) for n in lay.leaves}
        opt.step(grads, torch.tensor([True]))
        want = {"p": _carry(params, stats), "mu": _carry(jstate["mu"], stats),
                "nu": _carry(jstate["nu"], stats)}
        got = {"p": state.state_dict(0), "mu": _moment_dict(opt, state, "mu"),
               "nu": _moment_dict(opt, state, "nu")}
        for kind in want:
            for name in lay.leaves:
                a, b = got[kind][name].float(), want[kind][name].float()
                if lay.leaves[name][0] == "weights":
                    ulp = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -10) * 2.0 ** -7
                    off = (a != b)
                    assert bool(((a - b).abs() <= ulp)[off].all()), (kind, name)
                    total += a.numel()
                    differing += int(off.sum())
                else:
                    # float32 BatchNorm leaves.  bc2 = 1 - 0.999**2 cancels
                    # to 2e-3, so one float32 ulp between XLA's pow and
                    # PyTorch's is 3e-5 of bc2 and half that of the update
                    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                               atol=1e-9, err_msg=f"{kind} {name}")
    assert int(opt.count[0]) == 2 and int(jstate["count"]) == 2
    assert total > 100_000 and differing <= 1e-3 * total, (differing, total)


def test_index_table_is_a_permutation_of_the_flax_indices():
    lay = layout(SEQ, MC, LC, LAT)
    table = tlow.sr_index_table(lay).numpy().view(np.uint32).astype(np.int64)
    assert table.shape == (lay.n_weights,)
    # fc_mu.bias keeps its layout: flax leaf 15 of 36 (sorted modules dec_b1,
    # dec_b2, dec_t1..3, fc_dec, fc_logv, fc_mu: 2 + 2 + 2*3 + 2 + 2 leaves
    # before it), index = position
    _w, off, shape = lay.leaves["fc_mu.bias"]
    want = (np.arange(shape[0]) * 0x9E3779B9 + ((14 * 0x9E3779B1) & 0xFFFFFFFF)) % 2 ** 32
    np.testing.assert_array_equal(table[off:off + shape[0]], want)
    # a permuted leaf holds the same multiset as the flax leaf
    _w, off, shape = lay.leaves["fc_dec.weight"]
    n = int(np.prod(shape))
    want = (np.arange(n) * 0x9E3779B9 + ((11 * 0x9E3779B1) & 0xFFFFFFFF)) % 2 ** 32
    got = table[off:off + n]
    assert not np.array_equal(got, want)
    np.testing.assert_array_equal(np.sort(got), np.sort(want))


@pytest.mark.parametrize("scale,exact", [(0.01, True), (50.0, False)])
def test_float32_form_matches_clip_decay_adam(scale, exact):
    """Float32 storage: below the clip every element is ``ClipDecayAdam``'s
    bit for bit; above it the two reduce the gradient norm in other orders
    (one flat sum against a row reduction), so 1e-6 relative."""
    torch.manual_seed(1)
    module = LesionConditionedVAE(SEQ, MC, LC, LAT)
    lay = layout(SEQ, MC, LC, LAT)
    state = FleetState.from_state_dicts([module.state_dict()] * 2, lay, device="cpu")
    opt = tlow.LowmemOptimizer(state, LR, WD, CLIP)
    ref = ClipDecayAdam(module, LR, WD, CLIP)
    g = torch.Generator().manual_seed(2)
    for step in range(3):
        grads = [scale * torch.randn(p.shape, generator=g) for p in ref.params]
        names = [n for n, _ in module.named_parameters()]
        finite = step != 1
        ref.step(grads, torch.tensor(finite))
        opt.step({n: torch.stack([x, 2 * x]) for n, x in zip(names, grads)},
                 torch.tensor([finite, True]))
    assert opt.count.tolist() == [2, 3] and int(ref.count) == 2
    got = state.state_dict(0)
    for name, p in module.named_parameters():
        if exact:
            assert torch.equal(got[name], p.detach()), name
        else:
            np.testing.assert_allclose(got[name].numpy(), p.detach().numpy(),
                                       rtol=1e-6, atol=1e-9, err_msg=name)
    # member 1 saw other gradients and took every step
    assert not torch.equal(state.weights[0], state.weights[1])


def test_sr_adam_step_on_cpu_is_the_plain_version_and_skips_members():
    T, n = 3, 37
    g = torch.Generator().manual_seed(0)
    rows = [sr_adam.alloc_rows(T, n, torch.bfloat16, "cpu") for _ in range(4)]
    for t, s in zip(rows, (0.02, 1e-3, 1e-6, 1e-2)):
        t.copy_(torch.randn((T, n), generator=g).abs() * s)
    p, m, v, gr = rows
    assert p.stride() == (40, 1) and sr_adam.padded_width(n) == 40
    base = torch.arange(n, dtype=torch.int32)
    scal = (torch.tensor([0.5, 7.0, 7.0]), torch.full((T,), 0.1), torch.full((T,), 1e-3),
            torch.tensor([1, 2 ** 32 - 1, 5]), torch.tensor([True, False, True]))
    c = sr_adam.consts(LR, WD, CLIP)
    before = [t.clone() for t in (p, m, v)]
    plain = [t.clone() for t in (p, m, v)]
    launches = sr_adam.sr_adam_step.launches
    sr_adam.sr_adam_step(p, m, v, gr, base, *scal, c)
    sr_adam.sr_adam_step_plain(*plain, gr, base, *scal, c)
    assert sr_adam.sr_adam_step.launches == launches    # no kernel on the CPU
    for got, want, old in zip((p, m, v), plain, before):
        np.testing.assert_array_equal(_bits16(got), _bits16(want))
        np.testing.assert_array_equal(_bits16(got[1]), _bits16(old[1]))
        assert not np.array_equal(_bits16(got[0]), _bits16(old[0]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sr_adam.sr_adam_step(*(t.to("meta") for t in (p, m, v, gr, base, *scal)), c)


def test_sr_adam_bound():
    bound = sr_adam.bound_ms(64 * 2_741_153)
    assert bound["bound_by"] == "bytes" and abs(bound["bound_ms"] - 0.7331) < 1e-3
    # 65.5 instructions an element issue in 0.34 ms at 132 x 128 lanes x 1.98 GHz:
    # under the bytes
    assert bound["issue_bound_ms"] == bound["bound_ms"]
    lay = layout(100, 13, 3, 10)
    assert (lay.n_weights, lay.n_affine) == (2_741_153, 1_088)


def test_cast_params_storage_selects_weight_leaves():
    lay = layout(SEQ, MC, LC, LAT)
    sd = LesionConditionedVAE(SEQ, MC, LC, LAT).state_dict()
    cast = tlow.cast_params_storage(sd, lay)
    assert cast["fc_dec.weight"].dtype == cast["micro_c1.bias"].dtype == torch.bfloat16
    assert cast["micro_b1.weight"].dtype == cast["micro_b1.running_var"].dtype \
        == torch.float32
    assert tlow.is_weight_leaf("dec_t3.bias", lay)
    assert not tlow.is_weight_leaf("dec_b2.bias", lay)


# ---------------------------------------------------------------- the flat form
def test_flatten_partition_order_equals_jax():
    """``weights[:, w_order]`` is the JAX package's ``fw`` and
    ``affine[:, o_order]`` its ``fo``, value for value."""
    params, _grads, stats = _jax_tree(3)
    fw, fo, _unflat = jlow.flatten_partition(params)
    lay = layout(SEQ, MC, LC, LAT)
    state = FleetState.from_state_dicts([_carry(params, stats)], lay, device="cpu")
    w_order, o_order = tlow.flatten_partition(lay)
    assert w_order.shape == (lay.n_weights,) and o_order.shape == (lay.n_affine,)
    assert fw.shape == (lay.n_weights,) and fo.shape == (lay.n_affine,)
    np.testing.assert_array_equal(state.weights[0, w_order].numpy(), np.asarray(fw))
    np.testing.assert_array_equal(state.affine[0, o_order].numpy(), np.asarray(fo))
    # both are permutations, and writing fw back restores the buffer
    assert torch.equal(torch.sort(w_order).values, torch.arange(lay.n_weights))
    back = torch.empty_like(state.weights[0])
    back[w_order] = torch.from_numpy(np.array(fw))
    assert torch.equal(back, state.weights[0])


@pytest.mark.parametrize("salt", [0, 0x9E3779B1, 2 ** 32 - 5])
def test_flat_index_table_is_the_jax_flat_hash(salt):
    """The flat table, read in ``fw`` order, is ``position * 0x9E3779B9``, and
    its noise is the JAX package's ``_hash_bits`` over ``fw`` bit for bit."""
    lay = layout(SEQ, MC, LC, LAT)
    table = tlow.sr_index_table(lay, flat=True)
    w_order, _ = tlow.flatten_partition(lay)
    n = lay.n_weights
    in_fw = table[w_order].numpy().view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(in_fw, (np.arange(n) * 0x9E3779B9) % 2 ** 32)
    got = sr_adam.hash_bits(table, torch.tensor(salt))[w_order].numpy().astype(np.uint32)
    want = np.asarray(jlow._hash_bits((n,), jnp.uint32(salt)))
    np.testing.assert_array_equal(got, want)
    # and it is not the per-leaf table
    assert not torch.equal(table, tlow.sr_index_table(lay))


def test_flat_lowmem_step_matches_jax():
    """Two steps of the JAX ``FlatLowmemOptimizer`` (one below the clip, one
    above it) against the port's, same salt, under the budget of
    ``test_lowmem_step_matches_jax_on_a_model_tree``: at most 0.1% of the
    weight elements differ, each by at most 1 bf16 ulp; the float32
    BatchNorm leaves (``fo``: updated without rounding) to 5e-5."""
    params32, grads32, stats = _jax_tree(1)
    params = jlow.cast_params_storage(params32, jnp.bfloat16)
    fw, fo, unflat = jlow.flatten_partition(params)
    salt = 0x13579BDF
    tx = jlow.FlatLowmemOptimizer(LR, WD, CLIP)
    jstate = tx.init((fw, fo), salt=jnp.uint32(salt))

    lay = layout(SEQ, MC, LC, LAT)
    state = FleetState.from_state_dicts([_carry(params, stats)], lay,
                                        store_dtype=torch.bfloat16, device="cpu")
    opt = tlow.FlatLowmemOptimizer(state, LR, WD, CLIP, salts=torch.tensor([salt]))
    assert torch.equal(opt.base, tlow.sr_index_table(lay, flat=True))
    total = differing = 0
    pp = (fw, fo)
    for scale in (1.0, 40.0):
        g = jax.tree.map(lambda a, p: (scale * a).astype(p.dtype), grads32, params)
        gw, go, _ = jlow.flatten_partition(g)
        pp, jstate = jax.jit(tx.step)((gw, go), jstate, pp)
        carried_g = _carry(g, stats)
        opt.step({n: carried_g[n][None].to(state.leaves[n].dtype) for n in lay.leaves},
                 torch.tensor([True]))
        want = {"p": _carry(unflat(*pp), stats), "mu": _carry(unflat(*jstate["mu"]), stats),
                "nu": _carry(unflat(*jstate["nu"]), stats)}
        got = {"p": state.state_dict(0), "mu": _moment_dict(opt, state, "mu"),
               "nu": _moment_dict(opt, state, "nu")}
        for kind in want:
            for name in lay.leaves:
                a, b = got[kind][name].float(), want[kind][name].float()
                if lay.leaves[name][0] == "weights":
                    ulp = torch.maximum(a.abs(), b.abs()).clamp(min=2.0 ** -10) * 2.0 ** -7
                    off = (a != b)
                    assert bool(((a - b).abs() <= ulp)[off].all()), (kind, name)
                    total += a.numel()
                    differing += int(off.sum())
                else:
                    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=5e-5,
                                               atol=1e-9, err_msg=f"{kind} {name}")
    assert int(opt.count[0]) == 2 and int(jstate["count"]) == 2
    assert total > 100_000 and differing <= 1e-3 * total, (differing, total)


def test_flat_opt_needs_bf16_storage():
    from lesionvae_tpu_torch.train.batched import launch_many_vaes

    X = np.zeros((1, 8, SEQ, MC), np.float32)
    with pytest.raises(ValueError, match="flat_opt .* store_dtype"):
        launch_many_vaes(X, np.zeros((1, 8, SEQ, LC), np.float32), np.array([8]),
                         latent_dim=LAT, epochs=1, batch_size=8, flat_opt=True,
                         device="cpu")
    lay = layout(SEQ, MC, LC, LAT)
    state = FleetState(lay, 1, device="cpu")
    with pytest.raises(ValueError, match="bfloat16"):
        tlow.FlatLowmemOptimizer(state, LR, WD, CLIP)
