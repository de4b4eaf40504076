"""The members ``FleetHandle.fetch`` returns, built on the fleet's device from
the trained state with no init (``FleetState.member``): bit for bit the
state's ``state_dict(i)`` in float32, with bfloat16 storage (widened
exactly), in chunks, with injected weights and in float64; the dtype,
device, mode and keys of a module built as usual; each member owns one
storage of its own bytes, shared with no other member and not with the
handle's state; ``save_vae`` and ``load_vae`` carry one across; a
``warm_compile`` launch and a real one with no fetch between them give the
members two separate runs give.  On a machine with a card the same checks
run on ``cuda`` too."""

import io

import numpy as np
import pytest
import torch

from lesionvae_tpu_torch.models.fleet import layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train.checkpoint import load_vae, save_vae

torch.set_num_threads(1)

T, N, L, CM, CL, LAT, B, E = 4, 16, 8, 3, 2, 2, 8, 2
HYPER = dict(seq_len=L, micro_ch=CM, lesion_ch=CL, latent=LAT)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    """Each check on the CPU and, where there is one, on the card."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _cohort(seed=0):
    rng = np.random.default_rng(seed)
    Xm = rng.normal(size=(T, N, L, CM)).astype(np.float32)
    Xl = rng.uniform(size=(T, N, L, CL)).astype(np.float32)
    sham = np.zeros((T, N), np.float32)
    sham[:, :4] = 1.0
    subj = np.tile(np.arange(N, dtype=np.int64) % 3, (T, 1))
    return Xm, Xl, np.array([N, N - 3, N - 5, N], np.int32), (sham, subj, 3, 7)


def _launch(device, seed=5, **kw):
    Xm, Xl, n_real, spec = _cohort()
    kw = dict(dict(latent_dim=LAT, epochs=E, batch_size=B, seed=seed, device=device,
                   summary_spec=spec, normalize_on_device=True), **kw)
    return tb.launch_many_vaes(Xm, Xl, n_real, **kw)


FORMS = {"f32": {}, "bf16_storage": {"store_dtype": torch.bfloat16},
         "chunks": {"upload_chunks": 2}, "injected": {}, "f64": {"dtype": torch.float64}}


@pytest.mark.parametrize("form", FORMS)
def test_fetched_members_are_the_trained_state(device, form):
    if device == "cuda" and form == "f64":
        pytest.skip("the fleet trains float32 on cuda")
    kw = dict(FORMS[form])
    if form == "injected":
        kw["state_dicts"] = tb.init_state_dicts(T, HYPER, 77)
    handle = _launch(device, **kw)
    models, _hist = handle.fetch()
    state = handle.state
    built = LesionConditionedVAE(**HYPER).to(device=device, dtype=state.dtype)
    assert len(models) == T
    for i, m in enumerate(models):
        module = m.module
        want = state.state_dict(i)
        got = module.state_dict()
        assert list(got) == list(built.state_dict())
        for k, w in want.items():
            assert got[k].dtype == state.dtype and torch.equal(got[k], w), (i, k)
        assert m.dtype == state.dtype and m.device == state.device
        assert [(n, type(p), p.requires_grad) for n, p in module.named_parameters()] == [
            (n, type(p), p.requires_grad) for n, p in built.named_parameters()]
        assert [mod.training for mod in module.modules()] == [
            mod.training for mod in built.modules()]
    if form == "bf16_storage":
        assert state.weights.dtype == torch.bfloat16
        leaf = state.leaves["fc_dec.weight"][1]
        assert torch.equal(models[1].module.fc_dec.weight.detach(), leaf.float())


def _storage(t):
    s = t.untyped_storage()
    return s.data_ptr(), s.nbytes()


def test_each_member_owns_one_storage_of_its_own_bytes(device):
    handle = _launch(device, store_dtype=torch.bfloat16)
    models, _hist = handle.fetch()
    state, lay = handle.state, layout(**HYPER)
    member_bytes = lay.width * state.dtype.itemsize
    held = {_storage(t)[0] for t in (state.weights, state.affine, *state.stats.values())}
    seen = set()
    for m in models:
        tensors = [*m.module.parameters(), *m.module.buffers()]
        storages = {_storage(t) for t in tensors}
        assert len(storages) == 1
        (ptr, nbytes), = storages
        assert nbytes == member_bytes and ptr not in held and ptr not in seen
        seen.add(ptr)
        buf = io.BytesIO()
        torch.save(m.module.state_dict(), buf)
        assert member_bytes <= len(buf.getvalue()) < member_bytes + 65536
    # writes, modes and hooks of one member reach no other and not the state
    before = [state.state_dict(i) for i in range(T)]
    with torch.no_grad():
        models[0].module.fc_dec.weight.add_(1.0)
        models[0].module.micro_b1.running_var.mul_(3.0)
    models[0].module.eval()
    models[0].module.micro_c1.register_forward_hook(lambda *a: None)
    for i in range(T):
        for k, v in state.state_dict(i).items():
            assert torch.equal(v, before[i][k]), (i, k)
    assert torch.equal(models[1].module.fc_dec.weight.detach(), before[1]["fc_dec.weight"])
    assert not torch.equal(models[0].module.fc_dec.weight.detach(),
                           before[0]["fc_dec.weight"])
    assert all(mod.training for mod in models[1].module.modules())
    assert not models[1].module.micro_c1._forward_hooks


def test_a_fetched_member_survives_save_and_load(device, tmp_path):
    models, _hist = _launch(device).fetch()
    save_vae(tmp_path / "m2", models[2], norm_stats={"median": np.ones(3)})
    loaded, norm = load_vae(tmp_path / "m2", device=device)
    want = models[2].module.state_dict()
    got = loaded.module.state_dict()
    assert list(got) == list(want) and np.array_equal(norm["median"], np.ones(3))
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def _members(handle):
    models, hist = handle.fetch()
    return [m.module.state_dict() for m in models], hist


def test_warm_then_real_launch_with_no_fetch_between(device):
    tb.PROGRAMS.clear()
    warm = _launch(device, seed=3, warm_compile=True)
    real = _launch(device, seed=4)
    together = [_members(warm), _members(real)]
    apart = []
    for kw in ({"seed": 3, "warm_compile": True}, {"seed": 4}):
        tb.PROGRAMS.clear()
        apart.append(_members(_launch(device, **kw)))
    for (got, got_hist), (want, want_hist) in zip(together, apart):
        assert np.array_equal(got_hist, want_hist)
        for g, w in zip(got, want):
            for k, v in w.items():
                assert torch.equal(g[k], v), k
    tb.PROGRAMS.clear()
