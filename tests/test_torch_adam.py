"""The clip -> decay -> Adam step's two kernels' plain versions
(``lesionvae_tpu_torch/ops/adam.py``): the gradient gather with each member's
norm against the JAX package's global norm on a carried model tree, the
float32-storage ``LowmemOptimizer`` step against the JAX package's, the
update bit for bit against the chain it replaced, the CPU route of both
wrappers, their argument checks, and the norm's order against a thread by
thread simulation of the kernel (``ops/csrc/adam.cu``)."""

import ctypes
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.models.lesion_vae import LesionConditionedVAE as JaxVAE
from lesionvae_tpu.train import lowmem as jlow
from lesionvae_tpu.train import trainer as jtrainer
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.fleet import FleetState, layout
from lesionvae_tpu_torch.ops import adam
from lesionvae_tpu_torch.train import lowmem as tlow
from lesionvae_tpu_torch.train.trainer import ClipDecayAdam

torch.set_num_threads(1)

SEQ, MC, LC, LAT = 24, 5, 3, 4
LR, WD, CLIP = 2e-4, 1e-3, 2.0
HYPER = adam.Hyper(LR, WD, CLIP)
# gradients laid out transposed inside a member, as autograd returns the
# dense weights' (tests below hold the kernel's table to every route)
TRANSPOSED = ("fc_dec.weight", "fc_mu.weight", "micro_c2.weight", "dec_t1.weight")


def _jax_model_tree(seed):
    """Initial flax params of a small real model and its batch stats."""
    module = JaxVAE(seq_len=SEQ, micro_ch=MC, lesion_ch=LC, latent=LAT)
    k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
    variables = module.init({"params": k1}, jnp.zeros((2, SEQ, MC), jnp.float32),
                            jnp.zeros((2, SEQ, LC), jnp.float32), k2,
                            jnp.ones(2, jnp.float32), True)
    return variables["params"], variables["batch_stats"]


def _grad_trees(params, members, seed, dtype):
    """One gradient tree a member from numpy, member t scaled by 0.002 * 8^t
    (so the members lie on both sides of the clip)."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree.flatten(params)
    return [jax.tree.unflatten(treedef, [
        jnp.asarray(0.002 * 8.0 ** t * rng.normal(size=a.shape), dtype) for a in leaves])
        for t in range(members)]


def _carry(tree, stats, dtype=np.float64) -> dict:
    """A flax tree in the port's layout."""
    return from_jax_params(jax.tree.map(lambda a: np.asarray(a, dtype), tree),
                           jax.tree.map(np.asarray, stats))


def _stacked(trees, stats, lay, dtype, transposed=TRANSPOSED):
    """name -> (T, *shape) gradient of each leaf, the named leaves laid out
    transposed inside a member as autograd returns them."""
    carried = [_carry(t, stats) for t in trees]
    out = {}
    for name in lay.leaves:
        x = torch.stack([c[name] for c in carried]).to(dtype)
        if name in transposed:    # the same values, the first dim fastest
            x = x.movedim(1, -1).contiguous().movedim(-1, 1)
            assert not x.is_contiguous() and x.stride(1) == 1
        out[name] = x
    return out


def _packed(lay, members, dtype):
    """Packed rows and each leaf's destination view, as LowmemOptimizer
    makes them."""
    rows = {w: torch.zeros((members, n), dtype=dtype)
            for w, n in (("weights", lay.n_weights), ("affine", lay.n_affine))}
    dsts = {name: rows[w][:, off:off + math.prod(shape)].view(members, *shape)
            for name, (w, off, shape) in lay.leaves.items()}
    return rows, dsts


def _jax_g_norm(tree, dtype):
    """The JAX package's global norm (lowmem.py:132-133, trainer.py:99-100)."""
    return float(jnp.sqrt(sum(jnp.sum(jnp.square(g.astype(dtype)))
                              for g in jax.tree.leaves(tree))))


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12), (torch.float32, 1e-6)])
def test_norm_plain_matches_jax_g_norm(dtype, rtol):
    params, stats = _jax_model_tree(0)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    trees = _grad_trees(params, 3, 1, jdt)
    lay = layout(SEQ, MC, LC, LAT)
    grads = _stacked(trees, stats, lay, dtype)
    names = list(lay.leaves)
    rows, dsts = _packed(lay, 3, dtype)
    work = adam.norm_work([lay.leaves[n][2] for n in names], 3, "cpu")
    sq, g_norm = torch.zeros(3, dtype=dtype), torch.zeros(3, dtype=dtype)
    adam.grad_sq_norm_plain([grads[n] for n in names], [dsts[n] for n in names], work,
                            sq, g_norm)
    want = np.array([_jax_g_norm(t, jdt) for t in trees])
    np.testing.assert_allclose(g_norm.numpy(), want, rtol=rtol, atol=0)
    np.testing.assert_allclose(sq.numpy(), want ** 2, rtol=2 * rtol, atol=0)
    assert want[0] < CLIP < want[2]
    # the packed rows hold each leaf's gradient, row-major inside a member
    for n in names:
        assert torch.equal(dsts[n], grads[n]), n


def _jax_lowmem_f32(params, grads_trees, stats, finite):
    """Steps of the JAX LowmemOptimizer on float32 leaves, one member."""
    tx = jlow.LowmemOptimizer(LR, WD, CLIP)
    state = tx.init(params)
    for g, ok in zip(grads_trees, finite):
        if ok:
            params, state = jax.jit(tx.step)(g, state, params)
    return params, state


def test_lowmem_float32_step_matches_jax_lowmem():
    """Float32 storage: three steps (above, below and above the clip, the
    second skipped by member 1) of the port's ``LowmemOptimizer`` (gather,
    norm and update through ``ops.adam``) against the JAX ``LowmemOptimizer``
    on the same float32 leaves carried across, one member at a time.  The
    two reduce the norm in other orders and XLA may fuse a product into an
    add, and XLA's pow for the bias corrections differs from PyTorch's by an
    ulp (3e-5 of bc2 at the second step, tests/test_torch_lowmem.py's bound
    of rtol 5e-5 for the float32 leaves), and where the terms of m or p + u
    cancel an element keeps the absolute error of the larger: so each
    element within 5e-5 of itself plus 1e-6 of its leaf's largest."""
    params, stats = _jax_model_tree(2)
    params = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    lay = layout(SEQ, MC, LC, LAT)
    T = 2
    steps = [_grad_trees(params, T, 10 + s, jnp.float32) for s in range(3)]
    steps[1] = [jax.tree.map(lambda a: a * 0.01, tree) for tree in steps[1]]
    finite = [[True, True], [True, False], [True, True]]
    start = _carry(params, stats, np.float32)
    state = FleetState.from_state_dicts([start] * T, lay, device="cpu")
    opt = tlow.LowmemOptimizer(state, LR, WD, CLIP)
    for trees, ok in zip(steps, finite):
        opt.step(_stacked(trees, stats, lay, torch.float32), torch.tensor(ok))
    assert opt.count.tolist() == [3, 2]
    for t in range(T):
        p, jstate = _jax_lowmem_f32(params, [s[t] for s in steps], stats,
                                    [f[t] for f in finite])
        want = {"p": _carry(p, stats, np.float32), "mu": _carry(jstate["mu"], stats),
                "nu": _carry(jstate["nu"], stats)}
        got = {"p": state.state_dict(t)}
        for which in ("mu", "nu"):
            got[which] = {n: getattr(opt, f"{which}_{'w' if w == 'weights' else 'a'}")
                          [t, off:off + math.prod(shape)].reshape(shape)
                          for n, (w, off, shape) in lay.leaves.items()}
        for kind in want:
            for n in lay.leaves:
                w = want[kind][n].numpy().astype(np.float32)
                np.testing.assert_allclose(got[kind][n].numpy(), w, rtol=5e-5,
                                           atol=1e-6 * np.abs(w).max(),
                                           err_msg=f"{kind} {n}")


def test_lowmem_float64_step_matches_jax_update():
    """Float64: the port's ``LowmemOptimizer`` on a fleet of two members
    against the JAX package's fused update (``make_optimizer``, the same
    formula as ``_fused_update``'s float32 branch; the JAX LowmemOptimizer
    itself computes in float32 whatever its leaves) of each member alone,
    steps above and below the clip and a skipped one: 1e-12."""
    params, stats = _jax_model_tree(3)
    params = jax.tree.map(lambda a: a.astype(jnp.float64), params)
    lay = layout(SEQ, MC, LC, LAT)
    T = 2
    steps = [_grad_trees(params, T, 20 + s, jnp.float64) for s in range(3)]
    finite = [[True, True], [False, True], [True, True]]
    state = FleetState.from_state_dicts([_carry(params, stats)] * T, lay,
                                        dtype=torch.float64, device="cpu")
    opt = tlow.LowmemOptimizer(state, LR, WD, CLIP)
    for trees, ok in zip(steps, finite):
        opt.step(_stacked(trees, stats, lay, torch.float64), torch.tensor(ok))
    for t in range(T):
        tx = jtrainer.make_optimizer(LR, WD, CLIP)
        p, jstate = params, tx.init(params)
        for s, ok in zip(steps, finite):
            if ok[t]:
                upd, jstate = tx.update(s[t], jstate, p)
                p = jax.tree.map(lambda a, u: a + u, p, upd)
        want = _carry(p, stats)
        got = state.state_dict(t)
        for n in lay.leaves:
            np.testing.assert_allclose(got[n].numpy(), want[n].numpy(), rtol=1e-12,
                                       atol=1e-15, err_msg=n)
        assert int(opt.count[t]) == sum(f[t] for f in finite)


def test_single_trainer_gathers_and_steps_through_the_wrappers():
    """``ClipDecayAdam``: ``step`` gathers the parameters' gradients into its
    flat ``g`` with their norm, ``step_flat`` takes one flat gradient as a
    one-leaf table (the data-parallel step); both norms are the JAX
    package's (float64, 1e-12), and the two steps move the same module the
    same way (bit for bit below the clip, where the norm only selects)."""
    from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE

    for scale, exact in ((1e-4, True), (1.0, False)):
        mods = []
        for _ in range(2):
            torch.manual_seed(3)
            mods.append(LesionConditionedVAE(SEQ, MC, LC, LAT).double())
        opts = [ClipDecayAdam(m, LR, WD, CLIP) for m in mods]
        rng = np.random.default_rng(8)
        grads = [torch.from_numpy(scale * rng.normal(size=p.shape)) for p in opts[0].params]
        want = math.sqrt(sum(float((g * g).sum()) for g in grads))
        assert (want < CLIP) == exact
        opts[0].step(grads, torch.tensor(True))
        assert torch.equal(opts[0].g, torch.cat([g.reshape(-1) for g in grads]))
        assert float(opts[0].g_norm) == pytest.approx(want, rel=1e-12, abs=0)
        opts[1].step_flat(torch.cat([g.reshape(-1) for g in grads]), torch.tensor(True))
        assert float(opts[1].g_norm) == pytest.approx(want, rel=1e-12, abs=0)
        if exact:
            assert torch.equal(opts[0].flat, opts[1].flat)
        else:
            np.testing.assert_allclose(opts[0].flat.numpy(), opts[1].flat.numpy(),
                                       rtol=1e-12, atol=1e-15)
        assert int(opts[0].count) == int(opts[1].count) == 1


# ------------------------------------------------------------ the update
def _parent_chain(p, m, v, g, g_norm, bc1, bc2, finite, lr, wd, clip, b1, b2, eps):
    """The float32 chain ``adam_step_plain`` replaced
    (``LowmemOptimizer._adam`` and ``ClipDecayAdam.step_flat``), verbatim."""
    g = torch.where(g_norm < clip, g, (g / g_norm) * clip)
    g = g + wd * p
    m2 = (1 - b1) * g + b1 * m
    v2 = (1 - b2) * (g * g) + b2 * v
    u = -lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
    p.copy_(torch.where(finite, p + u, p))
    m.copy_(torch.where(finite, m2, m))
    v.copy_(torch.where(finite, v2, v))


def _update_case(T, n, seed):
    """p, m, v, g (T, n) float32; per member a norm below (0.5) or above
    (7) the clip, step counts 1 and 123,457, member 1 skipping; member 2
    (where T > 2) has a NaN and an infinite gradient element."""
    rng = np.random.default_rng(seed)
    rows = [torch.from_numpy((rng.normal(size=(T, n)) * s).astype(np.float32))
            for s in (0.02, 1e-3, 1e-6, 1e-2)]
    rows[2] = rows[2].abs()
    if T > 2:
        rows[3][2, 3] = float("nan")
        rows[3][2, 5] = float("inf")
    count = torch.tensor([1 if t % 2 == 0 else 123_457 for t in range(T)],
                         dtype=torch.float32)
    g_norm = torch.tensor([0.5 if t % 3 else 7.0 for t in range(T)])
    finite = torch.tensor([t != 1 for t in range(T)])
    bc1 = 1 - torch.pow(torch.tensor(0.9), count)
    bc2 = 1 - torch.pow(torch.tensor(0.999), count)
    return rows, g_norm, bc1, bc2, finite


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("T,n", [(1, 37), (3, 1_088), (4, 4099)])
def test_adam_step_plain_is_the_replaced_chain_bit_for_bit(T, n):
    """Float32, in both clip branches, a skipping member, a NaN and an inf
    gradient: every bit of p, m and v is the replaced chain's, the skipping
    member keeps its bits, and the NaN member's p goes NaN where its
    gradient is NaN."""
    (p, m, v, g), g_norm, bc1, bc2, finite = _update_case(T, n, T * 7 + n)
    before = [t.clone() for t in (p, m, v)]
    ref = [t.clone() for t in (p, m, v)]
    adam.adam_step_plain(p, m, v, g, g_norm, bc1, bc2, finite, HYPER)
    col = lambda x: x[:, None]  # noqa: E731
    _parent_chain(*ref, g, col(g_norm), col(bc1), col(bc2), col(finite), LR, WD, CLIP,
                  0.9, 0.999, 1e-8)
    for got, want, old in zip((p, m, v), ref, before):
        assert torch.equal(_bits(got), _bits(want))
        if T > 1:
            assert torch.equal(_bits(got[1]), _bits(old[1]))
        assert not torch.equal(_bits(got[0]), _bits(old[0]))
    if T > 2:
        assert torch.isnan(p[2, 3]) and torch.isnan(p[2, 5])
        assert torch.isfinite(p[2, :3]).all()


def test_adam_step_plain_is_the_single_trainers_chain():
    """One member as ``ClipDecayAdam`` updates its flat buffer: 0-dim norm,
    corrections and flag in the replaced chain, (1,) here; the same bits."""
    (p, m, v, g), g_norm, bc1, bc2, finite = _update_case(1, 2001, 5)
    for norm in (0.5, 7.0):
        ref = [t[0].clone() for t in (p, m, v)]
        adam.adam_step_plain(p, m, v, g, torch.tensor([norm]), bc1, bc2, finite, HYPER)
        _parent_chain(*ref, g[0], torch.tensor(norm), bc1[0], bc2[0], finite[0], LR, WD,
                      CLIP, 0.9, 0.999, 1e-8)
        for got, want in zip((p, m, v), ref):
            assert torch.equal(_bits(got[0]), _bits(want))


def test_wrappers_take_the_plain_versions_on_the_cpu():
    """CPU tensors: the plain versions, no launch counted; a device that is
    neither raises."""
    (p, m, v, g), g_norm, bc1, bc2, finite = _update_case(3, 301, 9)
    ref = [t.clone() for t in (p, m, v)]
    launches = {w: w.launches for w in adam.WRAPPERS}
    adam.adam_step(p, m, v, g, g_norm, bc1, bc2, finite, HYPER)
    adam.adam_step_plain(*ref, g, g_norm, bc1, bc2, finite, HYPER)
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in zip((p, m, v), ref))

    lay = layout(SEQ, MC, LC, LAT)
    params, stats = _jax_model_tree(4)
    grads = _stacked(_grad_trees(params, 3, 5, jnp.float32), stats, lay, torch.float32)
    names = list(lay.leaves)
    work = adam.norm_work([lay.leaves[n][2] for n in names], 3, "cpu")
    outs = []
    for fn in (adam.grad_sq_norm, adam.grad_sq_norm_plain):
        _rows, dsts = _packed(lay, 3, torch.float32)
        sq, norm = torch.zeros(3), torch.zeros(3)
        fn([grads[n] for n in names], [dsts[n] for n in names], work, sq, norm)
        outs.append((_rows, sq, norm))
    for a, b in zip(*outs):
        if isinstance(a, dict):
            assert all(torch.equal(a[k], b[k]) for k in a)
        else:
            assert torch.equal(_bits(a), _bits(b))
    assert {w: w.launches for w in adam.WRAPPERS} == launches
    meta = [t.to("meta") for t in (p, m, v, g, g_norm, bc1, bc2, finite)]
    with pytest.raises(ValueError, match="cuda or cpu"):
        adam.adam_step(*meta, HYPER)
    with pytest.raises(ValueError, match="cuda or cpu"):
        adam.grad_sq_norm([grads[names[0]].to("meta")], [None], work.to("meta"),
                          sq.to("meta"), norm.to("meta"))


# ------------------------------------------------------------ argument checks
def _update_args(T=3, n=64):
    p, m, v, g = (torch.zeros((T, n)) for _ in range(4))
    return [p, m, v, g, torch.ones(T), torch.ones(T), torch.ones(T),
            torch.ones(T, dtype=torch.bool)]


def test_update_checks_accept_the_paths_rows():
    assert adam.adam_check(*_update_args()) == (3, 64, 64, True)
    # the affine buffer's 1,088-wide rows take 16-byte loads; 1,089 the tail
    assert adam.adam_check(*_update_args(64, 1_088))[3]
    assert not adam.adam_check(*_update_args(2, 1_089))[3]
    assert adam.adam_check(*_update_args(1, 2_742_241)) == (1, 2_742_241, 2_742_241, True)


@pytest.mark.parametrize("bad,err,match", [
    (lambda a: a.__setitem__(0, a[0].double()), TypeError, "float32"),
    (lambda a: a.__setitem__(3, torch.zeros((3, 63))), ValueError, "shape"),
    (lambda a: a.__setitem__(1, torch.zeros((3, 128))[:, ::2]), ValueError, "contiguous"),
    (lambda a: [a.__setitem__(i, torch.zeros((3, 65))[:, 1:]) for i in range(4)],
     ValueError, "aligned"),
    (lambda a: a.__setitem__(3, torch.zeros((3, 72))[:, :64]), ValueError, "row stride"),
    (lambda a: a.__setitem__(4, torch.ones(4)), ValueError, "g_norm"),
    (lambda a: a.__setitem__(6, torch.ones(3, dtype=torch.float64)), ValueError, "bc2"),
    (lambda a: a.__setitem__(7, torch.ones(3)), ValueError, "finite"),
    (lambda a: a.__setitem__(0, torch.zeros(192)), ValueError, r"\(T, n\)"),
])
def test_update_checks_refuse(bad, err, match):
    args = _update_args()
    bad(args)
    with pytest.raises(err, match=match):
        adam.adam_check(*args)


def _norm_args(T=2):
    grads = [torch.zeros((T, 5, 7)).transpose(1, 2), torch.zeros((T, 9))]
    dsts = [torch.zeros((T, 7, 5)), None]
    shapes = [(7, 5), (9,)]
    return [grads, dsts, adam.norm_work(shapes, T, "cpu"), torch.zeros(T), torch.zeros(T)]


def test_norm_table_of_the_paths_leaves():
    """A real step's gradients (the fleet's, from autograd on the CPU) go
    into the table: the dense weights' transposed gradients read down their
    rows, the convolutions' (written in the leaf's own layout by
    ops/conv1d.py) along them, every leaf starts where the one before ended,
    and the table holds what the kernel reads (csrc/adam.cu: Leaf, 80
    bytes)."""
    assert ctypes.sizeof(adam.Leaf) == 80
    lay = layout(SEQ, MC, LC, LAT)
    for store in (None, torch.bfloat16):
        opt, grads = _fleet_step_grads(lay, 2, store)
        names = list(lay.leaves)
        table = adam.norm_table(list(grads), opt._dsts, opt._work, opt.sq, opt.g_norm)
        first = 0
        for e, name, x, d in zip(table, names, grads, opt._dsts):
            rows, cols = adam.leaf_grid(tuple(x.shape[1:]))
            assert (e.src, e.dst, e.rows, e.cols, e.n) == (
                x.data_ptr(), d.data_ptr(), rows, cols, x[0].numel()), name
            assert e.bf16 == (x.dtype == torch.bfloat16) and e.first_tile == first
            first += adam.leaf_tiles(tuple(x.shape[1:]))[0]
            if name in ("fc_dec.weight", "fc_mu.weight"):
                assert e.s0 == 1 and e.s2 != 1 and e.rows_fast == 1, name  # down the rows
            if name in ("micro_c1.weight", "micro_c2.weight", "dec_t1.weight"):
                assert x[0].is_contiguous() and e.rows_fast == 0, name     # along them
        assert first == opt._work.shape[1]


def _fleet_step_grads(lay, members, store, batch=4):
    """An optimizer of a fleet of ``members`` at ``lay``'s widths (weights
    stored in ``store``) and the leaf gradients of one training step, as
    autograd returns them on the CPU."""
    from lesionvae_tpu_torch.models.fleet import fleet_forward
    from lesionvae_tpu_torch.train.batched import elbo_fleet, init_state_dicts

    seq, mc, lc, lat = (lay.hyper[k] for k in ("seq_len", "micro_ch", "lesion_ch",
                                               "latent"))
    state = FleetState.from_state_dicts(init_state_dicts(members, lay.hyper, 0), lay,
                                        torch.float32, store, "cpu")
    leaves = state.grad_leaves()
    g = torch.Generator().manual_seed(0)
    xm = torch.randn((members, batch, seq, mc), generator=g)
    xl = torch.rand((members, batch, seq, lc), generator=g)
    xh, mu, logv, _ = fleet_forward(lay, leaves, state.stats, xm, xl,
                                    torch.ones(members, batch),
                                    torch.randn((members, batch, lat), generator=g), True,
                                    None)
    loss = elbo_fleet(xh, xm, mu, logv, 1.0, torch.ones(members, batch))[0]
    grads = torch.autograd.grad(loss.sum(), [leaves[n] for n in lay.leaves])
    return tlow.LowmemOptimizer(state, LR, WD, CLIP), grads


def _route(e):
    return (e.rows_fast, e.src_vec, e.dst_vec)


# the routes of the full-width path's leaves (seq 100, 13 + 3 channels,
# latent 10), as (rows_fast, src_vec, dst_vec): fc_dec.weight (90% of the
# bytes) loaded down its 1,536 rows 16 bytes at a time and stored in pairs;
# fc_mu/fc_logv.weight columns of 10 rows (not 16-byte aligned) element by
# element; the convolutions' weights, which ops/conv1d.py writes in the
# leaf's own layout, along their rows, in pairs where a member's row is even
# (micro_c1's and lesion_c1's rows of 65 and 15 are not: element by
# element, loaded and stored); the biases and the BatchNorm leaves (float32
# in both storages) loaded along their rows in pairs where a member's row is
# even (dec_t3.bias's 13 is not)
PATH_ROUTES = {
    "f32": {"fc_dec.weight": (1, 4, 2), "fc_logv.weight": (1, 1, 2),
            "fc_mu.weight": (1, 1, 2), "micro_c1.weight": (0, 1, 1),
            "micro_c3.weight": (0, 2, 2), "dec_t1.weight": (0, 2, 2),
            "fc_mu.bias": (0, 2, 2), "fc_dec.bias": (0, 2, 2), "dec_t3.bias": (0, 1, 2),
            "micro_b1.weight": (0, 2, 2)},
    "bf16": {"fc_dec.weight": (1, 8, 2), "fc_logv.weight": (1, 1, 2),
             "fc_mu.weight": (1, 1, 2), "micro_c1.weight": (0, 1, 1),
             "lesion_c1.weight": (0, 1, 1), "dec_t1.weight": (0, 2, 2),
             "micro_c1.bias": (0, 2, 2), "fc_mu.bias": (0, 2, 2), "fc_dec.bias": (0, 2, 2),
             "dec_t3.bias": (0, 1, 2), "micro_b1.weight": (0, 2, 2)},
}


def _flat_case(dtype, shape, offset, row, T=2):
    """A contiguous (T, *shape) gradient and its destination, a view at
    element ``offset`` of packed rows of ``row`` elements a member."""
    x = torch.zeros((T, *shape), dtype=dtype)
    buf = torch.zeros((T, row), dtype=dtype)
    n = math.prod(shape)
    return [x], [buf[:, offset:offset + n].view(T, *shape)]


@pytest.mark.parametrize("case", ["path f32", "path bf16", "odd destination",
                                  "fc_logv offset bf16", "fc_logv offset f32",
                                  "single flat", "one bf16 row", "one bf16 row odd",
                                  "odd member stride"])
def test_norm_table_routes(case):
    """``norm_table``'s routes (``ops.adam.leaf_route``): which way a lane
    loads its two columns of a tile (down them, or along the rows), the
    elements of one load (16 bytes' worth down a column where every column
    starts aligned, a pair along a row where every row starts at an even
    element, else 1) and of one destination store (2 where every packed row
    starts at an even element, else 1)."""
    if case.startswith("path"):
        lay = layout(100, 13, 3, 10)        # full width
        store = torch.bfloat16 if case.endswith("bf16") else None
        opt, grads = _fleet_step_grads(lay, 2, store, batch=2)
        table = adam.norm_table(list(grads), opt._dsts, opt._work, opt.sq, opt.g_norm)
        routes = dict(zip(lay.leaves, map(_route, table)))
        want = PATH_ROUTES[case.split()[1]]
        assert {n: routes[n] for n in want} == want
        return
    T = 1 if case == "single flat" else 2
    if case == "odd destination":       # pairs would straddle: one element a store
        grads, dsts = _flat_case(torch.float32, (6, 64), 3, 400)
        want = (0, 2, 1)
    elif case.startswith("fc_logv"):    # 169,546 = 2 mod 8: pairs still aligned
        dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
        grads, dsts = _flat_case(dtype, (10, 3136), 169_546, 2_741_160)
        want = (0, 2, 2)
    elif case == "single flat":         # the single VAE's flat gradient, one leaf
        grads, dsts = [torch.zeros((1, 2_742_241))], [None]
        want = (0, 2, 1)
    elif case == "one bf16 row":
        grads, dsts = _flat_case(torch.bfloat16, (1, 64), 0, 64)
        want = (0, 2, 2)
    elif case == "one bf16 row odd":    # members 51 elements apart: no pair loads
        grads, dsts = _flat_case(torch.bfloat16, (1, 51), 0, 52)
        want = (0, 1, 2)
    else:                               # an odd member stride of the destination
        grads, dsts = _flat_case(torch.float32, (4, 64), 0, 257)
        want = (0, 2, 1)
    work = adam.norm_work([x.shape[1:] for x in grads], T, "cpu")
    table = adam.norm_table(grads, dsts, work, torch.zeros(T), torch.zeros(T))
    assert _route(table[0]) == want


@pytest.mark.parametrize("bad,err,match", [
    (lambda a: a[0].__setitem__(1, torch.zeros((2, 9), dtype=torch.float64)),
     TypeError, "float32 or bf16"),
    (lambda a: a[0].__setitem__(1, torch.zeros((3, 9))), ValueError, "leaf 1"),
    (lambda a: a[1].__setitem__(0, torch.zeros((2, 7, 5), dtype=torch.bfloat16)),
     ValueError, "destination"),
    (lambda a: a[1].__setitem__(0, torch.zeros((2, 5, 7)).transpose(1, 2)),
     ValueError, "contiguous inside"),
    (lambda a: (a[0].__setitem__(0, torch.zeros((2, 7, 2, 3, 5)).permute(0, 1, 4, 3, 2)),
                a[1].__setitem__(0, None)), ValueError, "strides"),
    (lambda a: a.__setitem__(2, torch.zeros((2, 3))), ValueError, "workspace"),
    (lambda a: a.__setitem__(3, torch.zeros(2, dtype=torch.float64)), ValueError, "sq"),
    (lambda a: a.__setitem__(4, torch.zeros(3)), ValueError, "g_norm"),
    (lambda a: (a.__setitem__(0, a[0] * 25), a.__setitem__(1, a[1] * 25)),
     ValueError, "1 to 48"),
])
def test_norm_checks_refuse(bad, err, match):
    args = _norm_args()
    bad(args)
    with pytest.raises(err, match=match):
        adam.norm_table(*args)


# ------------------------------------------------------------ the kernel's order
def _rows_fast(x):
    """The same values with the rows (dim 1) the fastest dim of a member."""
    return x.transpose(1, 2).contiguous().transpose(1, 2)


@pytest.mark.parametrize("shapes,members,dtype", [
    ([(70, 40)], 3, torch.float32), ([(1536, 1610), (13,)], 2, torch.float32),
    ([(1536, 1610), (13,)], 2, torch.bfloat16), ([(5,), (64, 5, 2), (100,)], 4, torch.float32),
    ([(100, 70), (96, 8), (33, 9), (32, 16)], 2, torch.bfloat16)])
def test_warp_tile_takes_every_tile_once(shapes, members, dtype):
    """The gather's schedule (``ops.adam.warp_tile``): warp g takes member g
    // n_tiles and, of its leaves, the one whose tiles hold tile g %
    n_tiles, so every (member, leaf, tile) is taken by one warp and its
    partial lands in its slot of the workspace."""
    grads = [torch.zeros((members, *s), dtype=dtype) for s in shapes]
    grads = [_rows_fast(x) if x.dim() == 3 else x for x in grads]
    work = adam.norm_work(shapes, members, "cpu")
    table = adam.norm_table(grads, [None] * len(grads), work, torch.zeros(members),
                            torch.zeros(members))
    n_tiles = work.shape[1]
    taken = [adam.warp_tile(g, n_tiles, table) for g in range(members * n_tiles)]
    want = [(m, k, j) for m in range(members) for k, s in enumerate(shapes)
            for j in range(adam.leaf_tiles(s)[0])]
    assert taken == want
    for g, (m, k, j) in enumerate(taken):
        assert m * n_tiles + table[k].first_tile + j == g


def _storage_bytes(x: torch.Tensor) -> np.ndarray:
    """The bytes of ``x``'s storage, sharing its memory."""
    return torch.empty(0, dtype=torch.uint8).set_(x.untyped_storage()).numpy()


def _simulate_kernel(grads, dsts, members):
    """``csrc/adam.cu``'s gather lane by lane in float32: warp g takes its
    tile (``warp_tile``); lane i loads the raw bits of the tile's columns 2i
    and 2i + 1 by its leaf's route (16 bytes down a column, a pair along a
    row, or one element; a wide load's address must be aligned to its
    width), +0 outside the leaf; stores its pairs into the packed
    destination (a pair store's address must be aligned to the pair); adds
    the squares of each logical lane b + 2i + 64q (row 4k + q) in turn, the
    tree's levels 128 and 64 in the lane, 32..2 as shuffles, 1 in the lane;
    then each member's finishing block.  Returns (sq, g_norm, the (T,
    n_tiles) partials), and writes ``dsts``."""
    f32 = np.float32
    n_tiles = sum(adam.leaf_tiles(tuple(x.shape[1:]))[0] for x in grads)
    table = adam.norm_table(grads, dsts, adam.norm_work(
        [x.shape[1:] for x in grads], members, "cpu"), torch.zeros(members),
        torch.zeros(members))
    srcs = [(_storage_bytes(x), x.untyped_storage().data_ptr(), x.storage_offset())
            for x in grads]
    outs = [(_storage_bytes(d), d.untyped_storage().data_ptr(), d.storage_offset())
            if d is not None else None for d in dsts]
    partials = np.zeros(members * n_tiles, np.float32)

    def col_offset(e, c):
        return (c // e.d2) * e.s1 + (c % e.d2) * e.s2

    def gather(g):
        member, k, j = adam.warp_tile(g, n_tiles, table)
        e = table[k]
        size = 2 if e.bf16 else 4
        buf, ptr, off = srcs[k]
        tr, tc = divmod(j, e.col_tiles)
        r0 = tr * 32
        src = member * e.src_member
        x = np.zeros((32, 32, 2), np.uint32)           # [lane, row, column b]

        def load(i, count):
            at = (off + i) * size
            if count > 1:
                assert (ptr + at) % (count * size) == 0, "an unaligned load"
            raw = buf[at:at + count * size]
            return (raw.view(np.uint16) if size == 2 else raw.view(np.uint32)).astype(
                np.uint32)

        for lane in range(32):
            c = tc * 64 + 2 * lane
            if e.rows_fast:
                nr = e.rows - r0
                for b in range(2):
                    if c + b >= e.cols:
                        continue
                    a = src + r0 + col_offset(e, c + b)
                    vw = e.src_vec
                    for v in range(32 // vw):
                        if vw > 1 and v * vw + vw <= nr:
                            x[lane, v * vw:(v + 1) * vw, b] = load(a + v * vw, vw)
                        else:
                            for r in range(v * vw, (v + 1) * vw):
                                if r < nr:
                                    x[lane, r, b] = load(a + r, 1)[0]
            else:
                for r in range(32):
                    if r0 + r >= e.rows:
                        continue
                    lim = min(e.cols, e.n - (r0 + r) * e.cols)
                    row = src + (r0 + r) * e.s0
                    if c + 1 < lim and e.src_vec == 2:
                        x[lane, r] = load(row + col_offset(e, c), 2)
                    else:
                        for b in range(2):
                            if c + b < lim:
                                x[lane, r, b] = load(row + col_offset(e, c + b), 1)[0]
        y = (x << 16 if size == 2 else x).view(np.float32)
        if outs[k] is not None:
            obuf, optr, ooff = outs[k]
            for r in range(32):
                if r0 + r >= e.rows:
                    continue
                lim = min(e.cols, e.n - (r0 + r) * e.cols)
                for lane in range(32):
                    c = tc * 64 + 2 * lane
                    ok = [c < lim, c + 1 < lim]
                    at = (ooff + member * e.dst_member + (r0 + r) * e.cols + c) * size
                    if e.dst_vec == 2 and all(ok):
                        assert (optr + at) % (2 * size) == 0, "an unaligned pair store"
                    for b in range(2):
                        if ok[b]:
                            raw = x[lane, r, b:b + 1].astype(
                                np.uint16 if size == 2 else np.uint32).view(np.uint8)
                            obuf[at + b * size:at + (b + 1) * size] = raw
        acc = np.zeros((4, 32, 2), np.float32)
        for r in range(32):
            acc[r % 4] = acc[r % 4] + y[:, r] * y[:, r]
        a0 = (acc[0] + acc[2]) + (acc[1] + acc[3])
        for w in (16, 8, 4, 2, 1):      # shfl_down: lane l + w past 31 reads itself
            a0 = a0 + np.concatenate([a0[w:], a0[32 - w:]])
        partials[g] = f32(a0[0, 0] + a0[0, 1])

    for g in range(members * n_tiles):
        gather(g)

    def tree(v):
        v = list(v)
        for w in (128, 64, 32):
            for t in range(w):
                v[t] = f32(v[t] + v[t + w])
        lanes = v[:32]
        for w in (16, 8, 4, 2, 1):
            lanes = [f32(lanes[i] + (lanes[i + w] if i + w < 32 else lanes[i]))
                     for i in range(32)]
        return lanes[0]

    sq = []
    for member in range(members):
        acc = [f32(0)] * 256
        for i, part in enumerate(partials[member * n_tiles:(member + 1) * n_tiles]):
            acc[i % 256] = f32(acc[i % 256] + part)
        sq.append(tree(acc))
    sq = np.array(sq, np.float32)
    return sq, np.sqrt(sq), partials.reshape(members, n_tiles)


def _order_leaves(rng, T):
    """Leaves of every route: a transposed float32 matrix whose columns of
    70 rows take no 16-byte load (element by element, ragged), transposed
    float32 (40 rows) and bf16 (72 rows) matrices loaded down their rows 16
    bytes at a time past a row-tile edge, a bf16 vector of 104 (rows of 64,
    pairs, the last row partial) and one of 101 (an odd member stride,
    element by element), a float32 convolution weight whose columns take
    two strides, a row-major float32 matrix of 33 columns, and a bf16 leaf
    of one row."""
    def normal(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=(T, *shape)).astype(np.float32)).to(dtype)

    c = normal(6, 5, 3).permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)
    grads = [_rows_fast(normal(70, 40)), _rows_fast(normal(40, 70)),
             _rows_fast(normal(72, 100, dtype=torch.bfloat16)),
             normal(104, dtype=torch.bfloat16), normal(101, dtype=torch.bfloat16), c,
             normal(9, 33), normal(1, 50, dtype=torch.bfloat16)]
    return grads


def _packed_dsts(grads, odd):
    """Each leaf's destination in its own packed rows of its dtype, one
    element in (``odd``) or at the start, a member's row an even number of
    elements longer than the leaf."""
    out = []
    for x in grads:
        n = x[0].numel()
        buf = torch.zeros((x.shape[0], n + 2 + n % 2), dtype=x.dtype)
        out.append(buf[:, int(odd):int(odd) + n].view(x.shape))
    return out


@pytest.mark.parametrize("odd", [False, True])
def test_plain_order_is_the_kernels_thread_by_thread(odd):
    """Leaves of every route (``_order_leaves``) and two members, the kernel
    simulated lane by lane, destinations at an even and at an odd element:
    the plain version's tile partials (``lane_tree`` of ``tile_squares``),
    sum of squares and root equal the simulated kernel's bit for bit, and
    both write the same packed rows; the routes the table gives are the
    ones the leaves are chosen for."""
    rng = np.random.default_rng(4)
    T = 2
    grads = _order_leaves(rng, T)
    dsts = _packed_dsts(grads, odd)
    sq, norm = torch.zeros(T), torch.zeros(T)
    work = adam.norm_work([x.shape[1:] for x in grads], T, "cpu")
    table = adam.norm_table(grads, dsts, work, sq, norm)
    assert [(e.rows_fast, e.src_vec) for e in table] == [
        (1, 1), (1, 4), (1, 8), (0, 2), (0, 1), (0, 1), (0, 1), (0, 2)]
    assert [e.dst_vec for e in table] == ([1] * 8 if odd else [2] * 5 + [1, 1, 2])
    adam.grad_sq_norm_plain(grads, dsts, work, sq, norm)
    sim_dsts = _packed_dsts(grads, odd)
    want_sq, want_norm, want_part = _simulate_kernel(grads, sim_dsts, T)
    part = adam.lane_tree(torch.cat([adam.tile_squares(x, torch.float32) for x in grads], 1))
    np.testing.assert_array_equal(part.numpy().view(np.int32), want_part.view(np.int32))
    np.testing.assert_array_equal(sq.numpy().view(np.int32), want_sq.view(np.int32))
    np.testing.assert_array_equal(norm.numpy().view(np.int32),
                                  want_norm.astype(np.float32).view(np.int32))
    for x, d, w in zip(grads, dsts, sim_dsts):
        raw = torch.int16 if d.dtype == torch.bfloat16 else torch.int32
        assert torch.equal(d.contiguous().view(raw), w.contiguous().view(raw))
        assert torch.equal(d, x)


def test_kernel_source_holds_the_same_constants_and_fields():
    """csrc/adam.cu's tile, lanes, warps a block and table size are the
    plain version's and the host's, and its Leaf has ctypes' fields in the
    same order and size."""
    import re

    from lesionvae_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "adam.cu").read_text()
    for name, value in (("THREADS", adam.THREADS), ("TILE_R", adam.TILE_ROWS),
                        ("TILE_C", adam.TILE_COLS), ("MAX_LEAVES", adam.MAX_LEAVES),
                        ("WARPS", adam.WARPS)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    body = src[src.index("struct Leaf {"):src.index("};", src.index("struct Leaf {"))]
    fields = re.findall(r"(\w+)(?:\s*,\s*(\w+))?(?:\s*,\s*(\w+))?;", body)
    names = [f for group in fields for f in group if f]
    assert names == [f for f, _t in adam.Leaf._fields_]
    assert f"static_assert(sizeof(Leaf) == {ctypes.sizeof(adam.Leaf)}," in src
