"""The fleet's initial weights drawn into one stacked host buffer
(``train.batched.draw_init``), by both routes (the native pass over torch's
CPU stream and the plain loop of torch's init calls): bit for bit what
building the members as ``LesionConditionedVAE`` modules one after the other
from the seed draws, what the benchmark's plain reference replays
(``portbench/reference/draws.py``), and the same rows in a block of the
canonical fleet (``member_draws``); a draw, a launch and its fetch leave
torch's global generator as they found it."""

import numpy as np
import pytest
import torch

from lesionvae_tpu_torch.models.fleet import layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.ops import cuda_build
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train.program import COUNTS
from portbench.reference import draws as rdraws

torch.set_num_threads(1)

SEQ, MC, LC, LAT = 24, 5, 3, 4
HYPER = dict(seq_len=SEQ, micro_ch=MC, lesion_ch=LC, latent=LAT)
#: the cohort's layout (the published widths)
COHORT = dict(seq_len=100, micro_ch=13, lesion_ch=3, latent=10)
ROUTES = ("native", "plain")


@pytest.fixture(params=ROUTES)
def route(request, monkeypatch):
    """``draw_init`` by the native pass (this host builds it) or by the
    plain version, as on a host that cannot build the native pass."""
    if request.param == "native":
        assert tb.init_library() is not None
    else:
        monkeypatch.setattr(tb, "init_library", lambda: None)
    return request.param


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
def test_stacked_draw_is_the_module_init(T, seed, route):
    lay = layout(**HYPER)
    rows = tb.draw_init(lay, T, seed)
    assert rows.shape == (T, lay.width) and rows.dtype == torch.float32
    want = _modules_drawn(T, HYPER, seed)
    got = tb.init_state_dicts(T, HYPER, seed)
    for i in range(T):
        _assert_same_dicts(lay.split(rows[i]), want[i])
        _assert_same_dicts(got[i], want[i])


def test_stacked_draw_at_the_published_widths(route):
    lay = layout(**COHORT)
    rows = tb.draw_init(lay, 2, 42)
    for i, want in enumerate(_modules_drawn(2, COHORT, 42)):
        _assert_same_dicts(lay.split(rows[i]), want)


def test_stacked_draw_into_a_given_buffer_overwrites_it(route):
    lay = layout(**HYPER)
    out = torch.full((3, lay.width), float("nan"))
    assert tb.draw_init(lay, 3, 4, out) is out
    assert torch.equal(out, tb.draw_init(lay, 3, 4))


def test_stacked_draw_is_the_reference_replay(route):
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
def test_member_draws_block_is_rows_of_the_whole_draw(block, route):
    T, n_pad, epochs, B, seed = 5, 32, 2, 16, 8
    whole = tb.member_draws(T, n_pad, HYPER, epochs, B, seed)
    part = tb.member_draws(T, n_pad, HYPER, epochs, B, seed, block=block)
    assert len(part["state_dicts"]) == len(range(T)[block])
    for got, want in zip(part["state_dicts"], whole["state_dicts"][block]):
        _assert_same_dicts(got, want)
    for k in ("perms", "noise", "salts"):
        assert torch.equal(part[k], whole[k][block]), k


@pytest.mark.parametrize("form", [{}, {"upload_chunks": 2}, {"store_dtype": torch.bfloat16}])
def test_launch_and_fetch_leave_the_global_generator_alone(form, route):
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


def _bits(rows):
    return rows.view(torch.int32)


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 2**32 + 5, 3523000027])
def test_native_pass_is_the_plain_version_at_the_cohort_layout(seed):
    lay = layout(**COHORT)
    assert torch.equal(_bits(tb.draw_init_native(lay, 2, seed)),
                       _bits(tb.draw_init_plain(lay, 2, seed)))


@pytest.mark.parametrize("seed", [3, -7])
def test_native_pass_across_the_stream_blocks(seed):
    """Leaves and members that end off the generator's 624-word blocks (and
    one leaf that ends on one): the stream runs on across them as torch's
    does (a negative seed mapped as torch maps it)."""
    lay = layout(**HYPER)
    _off, count, _lo, _hi = tb.init_segments(lay)
    ends = np.cumsum(count) % 624
    assert (ends != 0).sum() == len(ends) - 1 and lay.n_weights % 624 != 0
    assert torch.equal(_bits(tb.draw_init_native(lay, 5, seed)),
                       _bits(tb.draw_init_plain(lay, 5, seed)))


def test_segments_cover_the_weight_leaves_in_row_order():
    lay = layout(**COHORT)
    offset, count, lo, hi = tb.init_segments(lay)
    assert len(offset) == len(lay.names("weights")) == 22
    assert offset[0] == 0 and (offset[1:] == offset[:-1] + count[:-1]).all()
    assert count.sum() == lay.n_weights == 2_741_153
    assert (lo == -hi).all() and (hi > 0).all() and hi.dtype == np.float32
    assert tb.init_segments(lay) is tb.init_segments(lay)


@pytest.mark.parametrize("draw", [tb.draw_init_native, tb.draw_init_plain])
def test_a_draw_leaves_the_global_generator_alone(draw):
    torch.manual_seed(77)
    before = torch.get_rng_state()
    draw(layout(**HYPER), 3, 5)
    assert torch.equal(torch.get_rng_state(), before)


@pytest.mark.parametrize("route_name", ROUTES)
def test_each_route_counts_its_draws(route_name):
    lay = layout(**HYPER)
    draw = tb.draw_init_native if route_name == "native" else tb.draw_init_plain
    before = {k: COUNTS[k] for k in ("init_draws_native", "init_draws_plain")}
    draw(lay, 3, 1)
    other = "init_draws_plain" if route_name == "native" else "init_draws_native"
    assert COUNTS[f"init_draws_{route_name}"] - before[f"init_draws_{route_name}"] == 3 * lay.n_weights
    assert COUNTS[other] == before[other]


def test_native_pass_refuses_rows_it_cannot_fill():
    lay = layout(**HYPER)
    for out in (torch.empty((3, lay.width), dtype=torch.float64),
                torch.empty((lay.width, 3)).t(), torch.empty((2, lay.width))):
        with pytest.raises(ValueError, match="init rows"):
            tb.draw_init_native(lay, 3, 0, out)


def test_a_launch_to_cuda_needs_the_native_pass(monkeypatch):
    """On a host that cannot build the native pass only CPU launches take
    the plain version; a launch to cuda says why it cannot run."""
    monkeypatch.setattr(tb, "init_library", lambda: None)
    Xm = np.zeros((2, 16, 8, 3), np.float32)
    with pytest.raises(RuntimeError, match="native pass"):
        tb.launch_many_vaes(Xm, Xm[..., :2], np.array([16, 16], np.int32), latent_dim=2,
                            epochs=1, batch_size=8, device="cuda")


def test_host_library_is_none_where_it_cannot_be_built(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="no host C\\+\\+ compiler"):
        cuda_build.build(["init_draws"])

    def fail(name):
        raise RuntimeError("no compiler")

    monkeypatch.setattr(cuda_build, "load", fail)
    assert cuda_build.load_host.__wrapped__("init_draws") is None


def test_host_source_is_built_without_contraction_for_its_machine():
    assert "-ffp-contract=off" in cuda_build.flags("init_draws")
    assert "init_draws" not in cuda_build.SOURCES
    path = cuda_build.library_path("init_draws")
    assert path.parent == cuda_build.BUILD_DIR and path.name.startswith("libinit_draws_")


@pytest.mark.parametrize("lo,hi", [(-0.3, 0.3), (0.0, 1.0), (-2.5, 7.1), (1e-3, 3.0),
                                   (-0.0, 0.0), (-1e-30, 1e-30)])
def test_native_stream_is_torch_uniform(lo, hi):
    """The native pass's transform is ``Tensor.uniform_``'s on torch's CPU
    generator, at bounds beyond the init's too (asymmetric, zero-width),
    over three of the generator's 624-word blocks, in two segments."""
    n, cut, seed = 1900, 700, 2**32 + 17
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        want = torch.empty(n).uniform_(lo, hi)
    out = torch.full((n,), float("nan"))
    offset, count = np.array([0, cut], np.int64), np.array([cut, n - cut], np.int64)
    lo32, hi32 = np.full(2, lo, np.float32), np.full(2, hi, np.float32)
    drawn = tb.init_library().draw_segments(
        seed & 0xFFFFFFFF, out.data_ptr(), 1, n, offset.ctypes.data, count.ctypes.data,
        lo32.ctypes.data, hi32.ctypes.data, 2)
    assert drawn == n
    assert torch.equal(_bits(out), _bits(want))
