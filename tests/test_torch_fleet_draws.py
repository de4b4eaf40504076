"""The fleet's initial weights drawn into one stacked host buffer
(``train.batched.draw_init``): bit for bit what building the members as
``LesionConditionedVAE`` modules one after the other from the seed draws,
what the benchmark's plain reference replays (``portbench/reference/
draws.py``), and the same rows in a block of the canonical fleet
(``member_draws``); a launch and its fetch leave torch's global generator as
they found it."""

import numpy as np
import pytest
import torch

from lesionvae_tpu_torch.models.fleet import layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.train import batched as tb
from portbench.reference import draws as rdraws

torch.set_num_threads(1)

SEQ, MC, LC, LAT = 24, 5, 3, 4
HYPER = dict(seq_len=SEQ, micro_ch=MC, lesion_ch=LC, latent=LAT)


def _modules_drawn(T, hyper, seed):
    """The members' initial ``state_dict``s as modules built one after the
    other draw them."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return [LesionConditionedVAE(**hyper).state_dict() for _ in range(T)]


def _assert_same_dicts(got, want):
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and torch.equal(got[k], w), k


@pytest.mark.parametrize("T", [1, 3, 8])
@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
def test_stacked_draw_is_the_module_init(T, seed):
    lay = layout(**HYPER)
    rows = tb.draw_init(lay, T, seed)
    assert rows.shape == (T, lay.width) and rows.dtype == torch.float32
    want = _modules_drawn(T, HYPER, seed)
    got = tb.init_state_dicts(T, HYPER, seed)
    for i in range(T):
        _assert_same_dicts(lay.split(rows[i]), want[i])
        _assert_same_dicts(got[i], want[i])


def test_stacked_draw_at_the_published_widths():
    hyper = dict(seq_len=100, micro_ch=13, lesion_ch=3, latent=10)
    lay = layout(**hyper)
    rows = tb.draw_init(lay, 2, 42)
    for i, want in enumerate(_modules_drawn(2, hyper, 42)):
        _assert_same_dicts(lay.split(rows[i]), want)


def test_stacked_draw_into_a_given_buffer_overwrites_it():
    lay = layout(**HYPER)
    out = torch.full((3, lay.width), float("nan"))
    assert tb.draw_init(lay, 3, 4, out) is out
    assert torch.equal(out, tb.draw_init(lay, 3, 4))


def test_stacked_draw_is_the_reference_replay():
    T, n_pad, epochs, B, seed = 5, 32, 2, 16, 123
    members = [0, 2, 4]
    params, stats, perms, noise = rdraws.fleet(T, n_pad, epochs, B, HYPER, seed, members)
    lay = layout(**HYPER)
    rows = lay.split(tb.draw_init(lay, T, seed))
    for j, i in enumerate(members):
        for k, v in {**params[j], **stats[j]}.items():
            assert torch.equal(rows[k][i], v), (i, k)
    d = tb.member_draws(T, n_pad, HYPER, epochs, B, seed)
    assert torch.equal(d["perms"][members], perms)
    assert torch.equal(d["noise"][members], noise)


@pytest.mark.parametrize("block", [slice(0, 2), slice(2, 5), slice(4, 5)])
def test_member_draws_block_is_rows_of_the_whole_draw(block):
    T, n_pad, epochs, B, seed = 5, 32, 2, 16, 8
    whole = tb.member_draws(T, n_pad, HYPER, epochs, B, seed)
    part = tb.member_draws(T, n_pad, HYPER, epochs, B, seed, block=block)
    assert len(part["state_dicts"]) == len(range(T)[block])
    for got, want in zip(part["state_dicts"], whole["state_dicts"][block]):
        _assert_same_dicts(got, want)
    for k in ("perms", "noise", "salts"):
        assert torch.equal(part[k], whole[k][block]), k


@pytest.mark.parametrize("form", [{}, {"upload_chunks": 2}, {"store_dtype": torch.bfloat16}])
def test_launch_and_fetch_leave_the_global_generator_alone(form):
    T, n_pad, L = 2, 16, 8
    rng = np.random.default_rng(0)
    Xm = rng.normal(size=(T, n_pad, L, 3)).astype(np.float32)
    Xl = rng.uniform(size=(T, n_pad, L, 2)).astype(np.float32)
    sham = np.zeros((T, n_pad), np.float32)
    sham[:, :4] = 1.0
    subj = np.tile(np.arange(n_pad, dtype=np.int64) % 3, (T, 1))
    torch.manual_seed(2024)
    before = torch.get_rng_state()
    tb.launch_many_vaes(Xm, Xl, np.array([n_pad, n_pad - 3], np.int32), latent_dim=2,
                        epochs=1, batch_size=8, seed=5, device="cpu",
                        summary_spec=(sham, subj, 3, 7), normalize_on_device=True,
                        **form).fetch()
    assert torch.equal(torch.get_rng_state(), before)
