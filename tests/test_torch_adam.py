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
# the dense and convolution weights' gradients come back from autograd
# transposed inside a member (tests below hold the kernel's table to it)
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
    into the table: the transposed leaves read down their rows, every leaf
    starts where the one before ended, and the table holds what the kernel
    reads (csrc/adam.cu: Leaf, 64 bytes)."""
    from lesionvae_tpu_torch.models.fleet import fleet_forward
    from lesionvae_tpu_torch.train.batched import elbo_fleet, init_state_dicts

    assert ctypes.sizeof(adam.Leaf) == 64
    lay = layout(SEQ, MC, LC, LAT)
    for store in (None, torch.bfloat16):
        state = FleetState.from_state_dicts(init_state_dicts(2, lay.hyper, 0), lay,
                                            torch.float32, store, "cpu")
        leaves = state.grad_leaves()
        g = torch.Generator().manual_seed(0)
        xm, xl = torch.randn((2, 8, SEQ, MC), generator=g), torch.rand((2, 8, SEQ, LC))
        xh, mu, logv, _ = fleet_forward(lay, leaves, state.stats, xm, xl,
                                        torch.ones(2, 8), torch.randn((2, 8, LAT)), True,
                                        None)
        loss = elbo_fleet(xh, xm, mu, logv, 1.0, torch.ones(2, 8))[0]
        names = list(lay.leaves)
        grads = torch.autograd.grad(loss.sum(), [leaves[n] for n in names])
        opt = tlow.LowmemOptimizer(state, LR, WD, CLIP)
        table = adam.norm_table(list(grads), opt._dsts, opt._work, opt.sq, opt.g_norm)
        first = 0
        for e, name, x, d in zip(table, names, grads, opt._dsts):
            rows, cols = adam.leaf_grid(tuple(x.shape[1:]))
            assert (e.src, e.dst, e.rows, e.cols, e.n) == (
                x.data_ptr(), d.data_ptr(), rows, cols, x[0].numel()), name
            assert e.bf16 == (x.dtype == torch.bfloat16) and e.first_tile == first
            first += adam.leaf_tiles(tuple(x.shape[1:]))[0]
            if name in ("fc_dec.weight", "fc_mu.weight", "micro_c1.weight"):
                assert e.s0 == 1 and e.s2 != 1, name       # read down the rows
        assert first == opt._work.shape[1]


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
def _simulate_kernel(grads, dsts, members):
    """``csrc/adam.cu`` thread by thread in float32 scalars: each block reads
    its leaf through the table's strides from the tensor's storage, writes
    its destination, sums squares in its threads and its tree; then the
    finishing block.  Returns (sq, g_norm, the packed destinations)."""
    f32 = np.float32
    table = adam.norm_table(grads, dsts, adam.norm_work(
        [x.shape[1:] for x in grads], members, "cpu"), torch.zeros(members),
        torch.zeros(members))
    stores = [torch.tensor([], dtype=x.dtype).set_(x.untyped_storage()).float().numpy()
              for x in grads]
    out = [np.zeros(d.numel(), np.float32) if d is not None else None for d in dsts]

    def tree(a):
        a = list(a)
        for w in (128, 64, 32):
            for t in range(w):
                a[t] = f32(a[t] + a[t + w])
        v = a[:32]
        for w in (16, 8, 4, 2, 1):      # shfl_down: lane l + w past 31 reads itself
            v = [f32(v[lane] + (v[lane + w] if lane + w < 32 else v[lane]))
                 for lane in range(32)]
        return v[0]

    sq = []
    for member in range(members):
        partials = []
        for e, x, store, dst in zip(table, grads, stores, out):
            for j in range(adam.leaf_tiles(tuple(x.shape[1:]))[0]):
                tr, tc = divmod(j, e.col_tiles)
                acc = [f32(0)] * 256
                for t in range(256):
                    c = tc * 64 + t % 64
                    for k in range(8):
                        r = tr * 32 + t // 64 + 4 * k
                        if not (r < e.rows and c < e.cols and r * e.cols + c < e.n):
                            continue
                        col = (c // e.d2) * e.s1 + (c % e.d2) * e.s2
                        xv = f32(store[x.storage_offset() + member * e.src_member
                                       + r * e.s0 + col])
                        acc[t] = f32(acc[t] + f32(xv * xv))
                        if e.dst:
                            dst[member * e.dst_member + r * e.cols + c] = xv
                partials.append(tree(acc))
        acc = [f32(0)] * 256
        for i, part in enumerate(partials):
            acc[i % 256] = f32(acc[i % 256] + part)
        sq.append(tree(acc))
    sq = np.array(sq, np.float32)
    return sq, np.sqrt(sq), out


def test_plain_order_is_the_kernels_thread_by_thread():
    """Three leaves, two members: a transposed float32 matrix over several
    tiles with a ragged edge, a bf16 vector of 100 (rows of 64), a float32
    convolution weight whose columns take two strides; the plain version's
    sum of squares and root equal the simulated kernel's bit for bit, and
    both write the same packed rows."""
    rng = np.random.default_rng(4)
    T = 2
    a = torch.from_numpy(rng.normal(size=(T, 70, 40)).astype(np.float32))
    a = a.transpose(1, 2).contiguous().transpose(1, 2)      # (T, 70, 40), rows fastest
    b = torch.from_numpy(rng.normal(size=(T, 100)).astype(np.float32)).bfloat16()
    c = torch.from_numpy(rng.normal(size=(T, 6, 5, 3)).astype(np.float32))
    c = c.permute(0, 1, 3, 2).contiguous().permute(0, 1, 3, 2)   # (T, 6, 5, 3), 2 strides
    grads = [a, b, c]
    assert adam.inner_strides(a)[0] == 1 and adam.inner_strides(c)[2] != 0
    dsts = [torch.zeros(x.shape, dtype=x.dtype) for x in grads]
    sq, norm = torch.zeros(T), torch.zeros(T)
    adam.grad_sq_norm_plain(grads, dsts, adam.norm_work([x.shape[1:] for x in grads], T,
                                                        "cpu"), sq, norm)
    want_sq, want_norm, want_out = _simulate_kernel(
        grads, [torch.zeros(x.shape, dtype=x.dtype) for x in grads], T)
    np.testing.assert_array_equal(sq.numpy().view(np.int32), want_sq.view(np.int32))
    np.testing.assert_array_equal(norm.numpy().view(np.int32),
                                  want_norm.astype(np.float32).view(np.int32))
    for d, w in zip(dsts, want_out):
        np.testing.assert_array_equal(d.float().reshape(-1).numpy(), w)


def test_kernel_source_holds_the_same_constants_and_fields():
    """csrc/adam.cu's tile, lanes and table size are the plain version's,
    and its Leaf has ctypes' fields in the same order."""
    import re

    from lesionvae_tpu_torch.ops import cuda_build

    src = (cuda_build.CSRC / "adam.cu").read_text()
    for name, value in (("THREADS", adam.THREADS), ("TILE_R", adam.TILE_ROWS),
                        ("TILE_C", adam.TILE_COLS), ("MAX_LEAVES", adam.MAX_LEAVES)):
        assert re.search(rf"constexpr int {name} = {value};", src), name
    body = src[src.index("struct Leaf {"):src.index("};", src.index("struct Leaf {"))]
    fields = re.findall(r"(\w+)(?:\s*,\s*(\w+))?(?:\s*,\s*(\w+))?;", body)
    names = [f for group in fields for f in group if f]
    assert names == [f for f, _t in adam.Leaf._fields_]
