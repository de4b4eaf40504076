"""Training as one device program (``train/program.py``, ``FleetProgram``)
on the CPU, where the epoch body runs eagerly.  The single trainer
(``train_module``) runs the one-member fleet program (the ``trainer``
cases).

- against the JAX package's own programs (``_train_program`` in float64,
  ``_fleet_program`` in float32 with float32 or bfloat16 storage and the
  flat optimizer), with the JAX initial weights and draws carried across;
- against the port's eager fleet loop (``train_fleet``), bit for bit: the
  same operations in the same order; the single trainer also against the
  eager module route (``train_loop``) in float64;
- the properties a CUDA graph needs, checked without a card: every buffer
  keeps its storage across an epoch, the warm-up before a capture leaves the
  state as it found it, the device epoch counter selects each epoch's
  draws, and a cached program run again with other data equals a fresh one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu.train import batched as jb
from lesionvae_tpu.train import trainer as jtrainer
from lesionvae_tpu_torch.models.convert import from_jax_params
from lesionvae_tpu_torch.models.fleet import FleetState, layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train import program as tprog
from lesionvae_tpu_torch.train import trainer as ttrainer
from lesionvae_tpu_torch.train.lowmem import FlatLowmemOptimizer, LowmemOptimizer

# Tiny shapes: one intra-op thread (several test workers share the cores).
torch.set_num_threads(1)

SEQ, MC, LC, LAT = 16, 3, 2, 2
HYPER = dict(seq_len=SEQ, micro_ch=MC, lesion_ch=LC, latent=LAT)
LR, WD, CLIP = 2e-4, 1e-3, 2.0
# the float32 fleet against the JAX fleet program: the bounds of
# tests/test_torch_fleet.py::test_fleet_lockstep_with_jax_program
HIST_RTOL, MOVE_RTOL = 5e-3, 0.1
FLEET_FORMS = {"f32": dict(),
               "bf16": dict(store_dtype=torch.bfloat16),
               "flat": dict(store_dtype=torch.bfloat16, flat_opt=True)}


def _data(n, seed):
    rng = np.random.default_rng(seed)
    t = np.linspace(0, 1, SEQ)
    Xm = (np.sin(2 * np.pi * t)[None, :, None]
          + 0.3 * rng.normal(size=(n, SEQ, MC))).astype(np.float32)
    Xl = rng.uniform(0, 1, size=(n, SEQ, LC)).astype(np.float32)
    return Xm, Xl


def _np64(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float64), tree)


# ------------------------------------------------------------ the trainer
def _trainer_case(n=20, batch_size=8, epochs=2, seed=3, dtype=torch.float64):
    """Padded device blocks, a module and its draws, as ``train_module``
    takes them."""
    Xm, Xl = _data(n, seed)
    n_pad = -(-n // batch_size) * batch_size
    g = torch.Generator().manual_seed(seed)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        module = LesionConditionedVAE(**HYPER).to(dtype)
    perms, noise = ttrainer.draw_run(n, n_pad, epochs, batch_size, LAT, g)

    def padded(X):
        out = torch.zeros((n_pad,) + X.shape[1:], dtype=dtype)
        out[:n] = torch.from_numpy(X).to(dtype)
        return out

    return dict(module=module, Xm=padded(Xm), Xl=padded(Xl), n=n, perms=perms,
                noise=noise.to(dtype), epochs=epochs, batch_size=batch_size)


def _trainer_program(c):
    """The one-member fleet program ``train_module`` runs for the case."""
    return tb.fleet_program(layout(**HYPER), 1, c["Xm"].shape[0], c["epochs"],
                            c["batch_size"], LR, WD, CLIP, None, None, False, "cpu",
                            c["Xm"].dtype, cache=ttrainer.PROGRAMS)


def _member_state(c):
    """The case's module as a one-member ``FleetState``."""
    return FleetState.from_state_dicts([c["module"].state_dict()], layout(**HYPER),
                                       c["Xm"].dtype, None, "cpu")


def _member_inputs(c):
    """The case's blocks, row count and draws with the member axis."""
    return (c["Xm"][None], c["Xl"][None], torch.tensor([c["n"]]), c["perms"][None],
            c["noise"][None])


def _run_trainer_program(c):
    """(trained state_dict, history, program) of ``train_module``."""
    module = LesionConditionedVAE(**HYPER).to(c["Xm"].dtype)
    module.load_state_dict(c["module"].state_dict())
    hist = ttrainer.train_module(module, c["Xm"], c["Xl"], c["n"], c["perms"],
                                 c["noise"], c["epochs"], c["batch_size"], LR, WD, CLIP)
    return module.state_dict(), hist, _trainer_program(c)


def _run_trainer_loop(c):
    """(trained state_dict, history, optimizer) of the eager fleet loop at
    one member from the case's module."""
    state = _member_state(c)
    opt = LowmemOptimizer(state, LR, WD, CLIP)
    hist = tb.train_fleet(state, opt, *_member_inputs(c), c["epochs"], c["batch_size"])
    return state.state_dict(0), hist[0].numpy(), opt


def _run_module_loop(c):
    """(trained state_dict, history) of the eager module route."""
    module = LesionConditionedVAE(**HYPER).to(c["Xm"].dtype)
    module.load_state_dict(c["module"].state_dict())
    hist = ttrainer.train_loop(module, c["Xm"], c["Xl"], c["n"], c["perms"], c["noise"],
                               c["epochs"], c["batch_size"], LR, WD, CLIP)
    return module.state_dict(), hist


def _jax_trainer(n, batch_size, epochs, seed):
    """The JAX ``_train_program`` run in float64 and what the port needs to
    run the same: (the JAX outputs, the carried module, perms, noise, data)."""
    Xm, Xl = _data(n, seed)
    n_pad = -(-n // batch_size) * batch_size
    pad = lambda X: np.concatenate([X, np.zeros((n_pad - n,) + X.shape[1:], X.dtype)])  # noqa: E731
    module, run = jtrainer._train_program(n, n_pad, SEQ, MC, LC, LAT, epochs,
                                          batch_size, LR, WD, CLIP)
    k_init, k_eps0, k_train = jax.random.split(jax.random.PRNGKey(seed), 3)
    variables = module.init({"params": k_init}, jnp.asarray(Xm[:2]),
                            jnp.asarray(Xl[:2]), k_eps0, jnp.ones(2), True)
    to64 = lambda t: jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), t)  # noqa: E731
    params, stats = to64(variables["params"]), to64(variables["batch_stats"])
    opt_state = jtrainer.make_optimizer(LR, WD, CLIP).init(params)
    out = run(params, stats, opt_state, jnp.asarray(pad(Xm), jnp.float64),
              jnp.asarray(pad(Xl), jnp.float64), k_train)

    perms, noise = [], []
    for ep_key in jax.random.split(k_train, epochs):
        k_perm, k_eps = jax.random.split(ep_key)
        perms.append(np.concatenate([np.asarray(jax.random.permutation(k_perm, n)),
                                     np.arange(n, n_pad)]))
        noise.append([np.asarray(jax.random.normal(r, (batch_size, LAT), jnp.float64))
                      for r in jax.random.split(k_eps, n_pad // batch_size)])
    tm = LesionConditionedVAE(**HYPER).double()
    tm.load_state_dict(from_jax_params(_np64(params), _np64(stats)))
    data = [torch.from_numpy(pad(X)).double() for X in (Xm, Xl)]
    return (out, tm, torch.from_numpy(np.stack(perms)),
            torch.from_numpy(np.asarray(noise)), data, (params, stats))


# ------------------------------------------------------------ the fleet
def _fleet_case(form="f32", T=3, n_pad=16, B=8, epochs=2, seed=0, dtype=None):
    """A fleet launch's inputs: the state, salts, device blocks and draws."""
    kw = FLEET_FORMS[form]
    dtype = dtype or (torch.float32 if kw else torch.float64)
    rng = np.random.default_rng(seed)
    n_real = np.array([16, 13, 9][:T])
    Xm = rng.normal(size=(T, n_pad, SEQ, MC))
    Xl = rng.uniform(size=(T, n_pad, SEQ, LC))
    for i, n in enumerate(n_real):
        Xm[i, n:] = Xl[i, n:] = 0
    lay = layout(**HYPER)
    d = tb.member_draws(T, n_pad, lay.hyper, epochs, B, seed + 1)
    return dict(lay=lay, T=T, n_pad=n_pad, B=B, epochs=epochs, dtype=dtype, kw=kw,
                state_dicts=d["state_dicts"], salts=d["salts"],
                Xm=torch.from_numpy(Xm).to(dtype), Xl=torch.from_numpy(Xl).to(dtype),
                n_real=torch.from_numpy(n_real), perms=d["perms"],
                noise=d["noise"].to(dtype))


def _fresh_state(c):
    return FleetState.from_state_dicts(c["state_dicts"], c["lay"], c["dtype"],
                                       c["kw"].get("store_dtype"), "cpu")


def _fleet_program(c):
    kw = c["kw"]
    return tb.fleet_program(c["lay"], c["T"], c["n_pad"], c["epochs"], c["B"], LR, WD,
                            CLIP, kw.get("store_dtype"), None, kw.get("flat_opt", False),
                            "cpu", c["dtype"])


def _run_fleet_program(c):
    state = _fresh_state(c)
    program = _fleet_program(c)
    hist = program.run(state, c["salts"], c["Xm"], c["Xl"], c["n_real"], c["perms"],
                       c["noise"])
    return state, hist, program


def _run_fleet_loop(c):
    state = _fresh_state(c)
    kind = FlatLowmemOptimizer if c["kw"].get("flat_opt") else LowmemOptimizer
    opt = kind(state, LR, WD, CLIP, salts=c["salts"])
    hist = tb.train_fleet(state, opt, c["Xm"], c["Xl"], c["n_real"], c["perms"],
                          c["noise"], c["epochs"], c["B"])
    return state, hist, opt


def _fleet_tensors(state):
    return {"weights": state.weights, "affine": state.affine, **state.stats}


def _jax_member_draws(key, n_pad, epochs, batch_size):
    """What the JAX fleet program draws from a member's key
    (lesionvae_tpu/train/batched.py:108-114, 165-175, 208-209)."""
    perms, noise = [], []
    for ep_key in jax.random.split(jax.random.fold_in(key, 1), epochs):
        k_perm, k_eps = jax.random.split(ep_key)
        perms.append(np.asarray(jax.random.permutation(k_perm, n_pad)))
        noise.append([np.asarray(jax.random.normal(r, (batch_size, LAT), jnp.float32))
                      for r in jax.random.split(k_eps, n_pad // batch_size)])
    return np.stack(perms), np.asarray(noise)


# ------------------------------------------------------------ (a) against JAX
@pytest.mark.parametrize("form", ["trainer", "fleet_f32", "fleet_bf16", "fleet_flat"])
def test_program_matches_the_jax_program(form):
    """The trainer in float64 against ``_train_program`` to 1e-8 in history,
    parameters, Adam moments and BatchNorm statistics (the bounds of
    tests/test_torch_trainer.py); the fleet in float32 against
    ``_fleet_program`` with the JAX weights, permutations, noise and salts:
    with float32 storage to the bounds of the float32 lockstep in
    tests/test_torch_fleet.py (every member within HIST_RTOL and MOVE_RTOL
    of each tensor's movement, the median member within 5e-5 and 2e-3);
    with bfloat16 storage every member's history within HIST_RTOL and nine
    in ten stored weights bit-equal to the JAX program's (see below)."""
    tprog.reset_counts()
    if form == "trainer":
        n, B, epochs, seed = 20, 8, 3, 3
        ((j_params, j_stats, j_opt), j_hist), tm, perms, noise, (Xm, Xl), start = \
            _jax_trainer(n, B, epochs, seed)
        ttrainer.PROGRAMS.clear()
        hist = ttrainer.train_module(tm, Xm, Xl, n, perms, noise, epochs, B, LR, WD, CLIP)
        np.testing.assert_allclose(hist, np.asarray(j_hist), rtol=1e-8, atol=1e-8)
        want = from_jax_params(_np64(j_params), _np64(j_stats))
        got = tm.state_dict()
        for name, w in want.items():
            np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-8,
                                       err_msg=name)
        # moments: the one-member program's buffers, parameter by parameter
        (program,) = ttrainer.PROGRAMS.programs.values()
        lay = program.state.layout
        for which in ("mu", "nu"):
            m_want = from_jax_params(_np64(j_opt[which]), _np64(j_stats))
            for name, (buf, off, shape) in lay.leaves.items():
                rows = getattr(program.opt, f"{which}_{'w' if buf == 'weights' else 'a'}")
                got_m = rows[0, off:off + m_want[name].numel()].view(shape)
                np.testing.assert_allclose(got_m.numpy(), m_want[name].numpy(), rtol=0,
                                           atol=1e-8, err_msg=f"{which} {name}")
        assert int(program.opt.count) == int(j_opt["count"]) == epochs * 3
        moved = from_jax_params(_np64(start[0]), _np64(start[1]))
        assert max(float((want[k] - moved[k]).abs().max()) for k in want) > 1e-4
        return

    kw = FLEET_FORMS[form.split("_")[1]]
    T, n_pad, B, epochs, seed = 3, 32, 8, 2, 7
    n_real = np.array([32, 27, 18], np.int32)
    rng = np.random.default_rng(3)
    Xm = rng.normal(size=(T, n_pad, SEQ, MC)).astype(np.float32)
    Xl = rng.uniform(size=(T, n_pad, SEQ, LC)).astype(np.float32)
    for i, n in enumerate(n_real):
        Xm[i, n:] = Xl[i, n:] = 0
    store = jnp.bfloat16 if kw else None
    program, module, _ = jb._fleet_program(
        n_pad, SEQ, MC, LC, LAT, epochs, B, LR, WD, CLIP, store_dtype=store,
        flat_opt=kw.get("flat_opt", False))
    keys = jax.random.split(jax.random.PRNGKey(seed), T)
    params_T, stats_T, hist_T = program(jnp.asarray(Xm), jnp.asarray(Xl),
                                        jnp.asarray(n_real), keys)

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
    salts = torch.tensor([int(jax.random.bits(jax.random.fold_in(k, 7), (), jnp.uint32))
                          for k in keys], dtype=torch.int64)
    lay = layout(**HYPER)
    state = FleetState.from_state_dicts(sds, lay, torch.float32, kw.get("store_dtype"),
                                        "cpu")
    start = {name: t.float().clone() for name, t in state.leaves.items()}
    prog = tb.fleet_program(lay, T, n_pad, epochs, B, LR, WD, CLIP, kw.get("store_dtype"),
                            None, kw.get("flat_opt", False), "cpu", torch.float32)
    hist = prog.run(state, salts, torch.from_numpy(Xm), torch.from_numpy(Xl),
                    torch.from_numpy(n_real.astype(np.int64)),
                    torch.from_numpy(np.stack(perms)),
                    torch.from_numpy(np.stack(noise))).numpy()

    hist_err = np.abs(hist / np.asarray(hist_T) - 1).max(axis=(1, 2))
    leaf_err = np.zeros(T)
    for i in range(T):
        take = lambda t: jax.tree.map(lambda a: np.asarray(a[i], np.float32), t)  # noqa: E731
        want = from_jax_params(take(params_T), take(stats_T))
        got = state.state_dict(i)
        for name, w in want.items():
            w0 = start[name][i] if name in start else sds[i][name]
            moved = float((w - w0).norm())
            assert moved > 0, name
            leaf_err[i] = max(leaf_err[i], float((got[name] - w).norm()) / moved)
    assert hist_err.max() < HIST_RTOL, hist_err
    if not kw:
        assert np.median(hist_err) < 5e-5, hist_err
        assert leaf_err.max() < MOVE_RTOL and np.median(leaf_err) < 2e-3, leaf_err
        return
    # bfloat16 storage: the stochastic-rounding noise is the JAX program's
    # bit for bit, so most stored weights are the same bf16 values; where
    # the two float32 sums differ a rounding may flip by a whole bf16 step
    # (read: 94.3% and 94.8% of the weight elements equal, flat and per-leaf
    # noise; with the salts shifted by one, 21%)
    flat = lambda sd: np.concatenate([np.asarray(sd[n], np.float32).reshape(-1)  # noqa: E731
                                      for n in lay.names("weights")])
    member = lambda t, i: jax.tree.map(lambda a: np.asarray(a[i], np.float32), t)  # noqa: E731
    same = np.mean([flat(from_jax_params(member(params_T, i), member(stats_T, i)))
                    == flat(state.state_dict(i)) for i in range(T)])
    assert same > 0.9, same


# ------------------------------------------------------------ (b) against the loop
@pytest.mark.parametrize("form", ["trainer", "fleet_f32", "fleet_bf16", "fleet_flat"])
def test_program_equals_the_eager_loop_bit_for_bit(form):
    """The program form and the eager loop run the same operations in the
    same order: parameters, moments, step counts, BatchNorm statistics and
    history equal bit for bit (the single trainer's one-member program
    against ``train_fleet`` at one member)."""
    if form == "trainer":
        c = _trainer_case()
        got, h_got, program = _run_trainer_program(c)
        want, h_want, opt = _run_trainer_loop(c)
        np.testing.assert_array_equal(h_got, h_want)
        for name, w in want.items():
            assert torch.equal(got[name], w), name
        for name in ("mu_w", "nu_w", "mu_a", "nu_a", "count"):
            assert torch.equal(getattr(program.opt, name), getattr(opt, name)), name
        assert int(program.opt.count) == c["epochs"] * 3
        return
    c = _fleet_case(form.split("_")[1])
    state, h_got, program = _run_fleet_program(c)
    ref, h_want, opt = _run_fleet_loop(c)
    assert torch.equal(h_got, h_want)
    for name, t in _fleet_tensors(ref).items():
        assert torch.equal(_fleet_tensors(state)[name], t), name
    for name in ("mu_w", "nu_w", "mu_a", "nu_a", "count"):
        assert torch.equal(getattr(program.opt, name), getattr(opt, name)), name
    assert program.opt.count.tolist() == [c["epochs"] * 2] * c["T"]
    assert not torch.equal(state.weights, _fresh_state(c).weights)


@pytest.mark.parametrize("n,batch_size,epochs", [(20, 8, 3), (13, 4, 2)])
def test_the_single_trainer_equals_the_eager_module_route_f64(n, batch_size, epochs):
    """``train_module`` (the one-member fleet program: the fleet's
    convolutions, masked BatchNorm and optimizer) against ``train_loop``
    (the module's convolutions, ``MaskedBatchNorm`` and ``ClipDecayAdam``)
    from the same weights and draws, a partial batch of pad rows each epoch:
    history, weights and BatchNorm statistics to 1e-10 in float64."""
    c = _trainer_case(n=n, batch_size=batch_size, epochs=epochs)
    got, h_got, _program = _run_trainer_program(c)
    want, h_want = _run_module_loop(c)
    np.testing.assert_allclose(h_got, h_want, rtol=1e-10, atol=1e-10)
    assert list(got) == list(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0, atol=1e-10,
                                   err_msg=name)
    start = c["module"].state_dict()
    assert max(float((want[k] - start[k]).abs().max()) for k in want) > 1e-4


# ------------------------------------------------------------ (c) fixed storage
def _ptrs(tensors):
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("form", ["trainer", "fleet_f32", "fleet_bf16"])
def test_every_buffer_keeps_its_storage_across_an_epoch(form):
    """A graph replays fixed addresses: one epoch of the body writes every
    buffer in place (parameters, moments, step counts, statistics, history,
    the counter), and the leaves stay views of the state's buffers."""
    if form == "trainer":
        c = _trainer_case()
        program = _trainer_program(c)
        program.load(_member_state(c), None, *_member_inputs(c))
        extra = list(program.state.leaves.values()) + list(program.state.stats.values())
    else:
        c = _fleet_case(form.split("_")[1])
        program = _fleet_program(c)
        program.load(_fresh_state(c), c["salts"], c["Xm"], c["Xl"], c["n_real"],
                     c["perms"], c["noise"])
        extra = list(program.state.leaves.values()) + list(program.state.stats.values())
    before = _ptrs(program.buffers() + extra)
    state0 = [t.clone() for t in program.graph.state]
    program.epoch()
    assert _ptrs(program.buffers() + extra) == before
    assert int(program.ep) == 1
    # the epoch did write the state in place
    assert not all(torch.equal(a, b) for a, b in zip(program.graph.state, state0))
    for name, leaf in program.state.leaves.items():
        buf = getattr(program.state, program.state.layout.leaves[name][0])
        assert buf.data_ptr() <= leaf.data_ptr()
        assert leaf.data_ptr() < buf.data_ptr() + buf.numel() * buf.element_size()


# ------------------------------------------------------------ (d) the warm-up
@pytest.mark.parametrize("form", ["trainer", "fleet_bf16"])
def test_warm_up_leaves_the_state_bit_identical(form):
    """The run before a capture advances Adam, the statistics, the weights
    and the counter; snapshot and restore put every state tensor back, so
    the run that follows equals a run without the warm-up."""
    if form == "trainer":
        c = _trainer_case()
        program = _trainer_program(c)
        program.load(_member_state(c), None, *_member_inputs(c))
    else:
        c = _fleet_case("bf16")
        program = _fleet_program(c)
        program.load(_fresh_state(c), c["salts"], c["Xm"], c["Xl"], c["n_real"],
                     c["perms"], c["noise"])
    calls = []
    body = program.graph.body
    program.graph.body = lambda: (calls.append(1), body())
    before = [t.clone() for t in program.graph.state]
    program.graph.warm_up()
    assert calls == [1]
    for a, b in zip(program.graph.state, before):
        assert torch.equal(a, b)
    program.graph.body = body
    program.graph.run(c["epochs"])
    if form == "trainer":
        want, h_want, _ = _run_trainer_loop(c)
        np.testing.assert_array_equal(program.hist[0].numpy(), h_want)
        for name, w in want.items():
            assert torch.equal(program.state.state_dict(0)[name], w), name
    else:
        ref, h_want, _ = _run_fleet_loop(c)
        assert torch.equal(program.hist, h_want)
        assert torch.equal(program.state.weights, ref.weights)


# ------------------------------------------------------------ (e) the counter
@pytest.mark.parametrize("form", ["trainer", "fleet_f32"])
def test_the_epoch_counter_selects_each_epochs_draws(form):
    """Two calls of the body, the counter advanced by the body itself, equal
    two epochs of the loop (each epoch its own permutation, noise and KLD
    weight); the counter reads 2 and the history holds both rows."""
    if form == "trainer":
        c = _trainer_case(epochs=2)
        program = _trainer_program(c)
        program.load(_member_state(c), None, *_member_inputs(c))
        program.epoch()
        program.epoch()
        _, h_want, _ = _run_trainer_loop(c)
        got = program.hist[0].numpy()
    else:
        c = _fleet_case("f32", epochs=2)
        program = _fleet_program(c)
        program.load(_fresh_state(c), c["salts"], c["Xm"], c["Xl"], c["n_real"],
                     c["perms"], c["noise"])
        program.epoch()
        program.epoch()
        _, h_want, _ = _run_fleet_loop(c)
        got, h_want = program.hist.numpy(), h_want.numpy()
    assert int(program.ep) == 2
    np.testing.assert_array_equal(got, h_want)
    assert not np.array_equal(got[..., 0, :], got[..., 1, :])
    np.testing.assert_allclose(got[..., :, 3], np.broadcast_to([0.1, 2.0], got.shape[:-1]),
                               rtol=1e-6)


# ------------------------------------------------------------ (f) the cache
@pytest.mark.parametrize("form", ["trainer", "fleet_bf16"])
def test_a_cached_program_run_again_equals_a_fresh_one(form):
    """A second launch of one configuration with other data reuses the
    cached program (no new program, as no new capture on the card) and
    ends where a fresh program ends."""
    cache = ttrainer.PROGRAMS if form == "trainer" else tb.PROGRAMS
    if form == "trainer":
        case = lambda seed: _trainer_case(seed=seed)  # noqa: E731
        run = _run_trainer_program
    else:
        case = lambda seed: _fleet_case("bf16", seed=seed)  # noqa: E731
        run = _run_fleet_program
    first, second = case(1), case(2)
    out_first = run(first)
    out_again = run(second)
    assert out_again[2] is out_first[2]
    cache.clear()
    out_fresh = run(second)
    assert out_fresh[2] is not out_first[2]
    hist = [np.asarray(out[1]) for out in (out_first, out_again, out_fresh)]
    np.testing.assert_array_equal(hist[1], hist[2])
    assert not np.array_equal(hist[0], hist[2])
    def tensors(out):
        return out[0] if form == "trainer" else _fleet_tensors(out[0])

    for name, t in tensors(out_fresh).items():
        assert torch.equal(tensors(out_again)[name], t), name


def test_program_cache_evicts_and_frees_the_least_recent():
    freed = []

    class Prog:
        def __init__(self, k):
            self.k = k

        def free(self):
            freed.append(self.k)

    cache = tprog.ProgramCache(2)
    a = cache.get("a", lambda: Prog("a"))
    cache.get("b", lambda: Prog("b"))
    assert cache.get("a", lambda: Prog("a2")) is a      # a is now the most recent
    cache.get("c", lambda: Prog("c"))
    assert freed == ["b"] and len(cache) == 2
    cache.clear()
    assert sorted(freed) == ["a", "b", "c"] and len(cache) == 0


def test_launch_many_vaes_runs_through_one_cached_program():
    """Two launches of one configuration: one program, trained members and
    history as the program leaves them; a launch of another configuration
    adds a program."""
    c = _fleet_case("f32", dtype=torch.float32)
    tb.PROGRAMS.clear()
    Xm, Xl = c["Xm"].numpy(), c["Xl"].numpy()
    kw = dict(latent_dim=LAT, epochs=2, batch_size=8, device="cpu", seed=4)
    h1 = tb.launch_many_vaes(Xm, Xl, c["n_real"].numpy(), **kw)
    h2 = tb.launch_many_vaes(Xm, Xl, c["n_real"].numpy(), **kw)
    assert len(tb.PROGRAMS) == 1
    assert torch.equal(h1.hist, h2.hist) and torch.equal(h1.state.weights, h2.state.weights)
    # the handles own their results: the program's buffers are its own
    program = next(iter(tb.PROGRAMS.programs.values()))
    assert h2.hist.data_ptr() != program.hist.data_ptr()
    assert h2.state.weights.data_ptr() != program.state.weights.data_ptr()
    tb.launch_many_vaes(Xm, Xl, c["n_real"].numpy(), **dict(kw, epochs=3))
    assert len(tb.PROGRAMS) == 2
