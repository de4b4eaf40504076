"""The step profile's device time by layer
(``benchmarks/vae_step_profile.py``): the layer ranges of
``models.fleet`` and ``train.batched.fleet_step``, and the attribution of
device events to them, eager and through graph replays, on Chrome traces
written out here (the card's own traces come only from a chip run)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lesionvae_tpu_torch.benchmarks import vae_step_profile as prof
from lesionvae_tpu_torch.models import fleet
from lesionvae_tpu_torch.models.fleet import FleetState, layout
from lesionvae_tpu_torch.train.batched import fleet_step, init_state_dicts
from lesionvae_tpu_torch.train.lowmem import LowmemOptimizer

torch.set_num_threads(1)


def _ev(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


# an eager step: two ranges on the host, launches inside and outside them,
# the backward's launch from another thread inside the calling thread's range
EAGER = [_ev("user_annotation", "layer:conv", 0, 10),
         _ev("user_annotation", "layer:bn_relu", 10, 10),
         _ev("user_annotation", "layer:backward", 30, 20),
         _ev("cuda_runtime", "cudaLaunchKernel", 2, 1, 1),
         _ev("cuda_runtime", "cudaLaunchKernel", 12, 1, 2),
         _ev("cuda_runtime", "cudaMemsetAsync", 25, 1, 3),
         _ev("cuda_driver", "cuLaunchKernel", 40, 1, 4),
         _ev("kernel", "gemm", 100, 5, 1), _ev("kernel", "bn_apply", 106, 3, 2),
         _ev("gpu_memset", "Memset", 110, 1, 3), _ev("kernel", "grad", 112, 4, 4)]


def test_eager_events_take_the_range_open_at_their_launch():
    got = prof.eager_layers(EAGER)
    assert got == [("gemm", "conv", 5.0), ("bn_apply", "bn_relu", 3.0),
                   ("Memset", "other", 1.0), ("grad", "backward", 4.0)]
    ms = prof.layer_ms([(k, d) for _n, k, d in got], steps=1)
    assert ms["conv"] == 0.005 and ms["backward"] == 0.004 and ms["other"] == 0.001
    assert ms["total"] == pytest.approx(0.013)
    assert set(ms) == set(prof.LAYER_KINDS) | {"other", "total"}


def test_replayed_events_take_the_kind_at_their_place_in_the_epoch():
    """Two replays of the eager body, an eager memset between them: each
    replayed event takes the kind of its eager counterpart by place, and an
    event the walk does not find is ``other``."""
    eager = prof.eager_layers(EAGER)
    seq = ["gemm", "bn_apply", "Memset", "grad", "fill", "gemm", "bn_apply", "Memset",
           "grad"]
    replay = [_ev("kernel", n, 10 * i, 2, 99) for i, n in enumerate(seq)]
    got = prof.replay_layers(eager, replay)
    assert [k for _n, k, _d in got] == ["conv", "bn_relu", "other", "backward", "other",
                                        "conv", "bn_relu", "other", "backward"]


@pytest.mark.parametrize("on", [True, False])
def test_fleet_step_opens_its_layer_ranges_only_when_asked(on, monkeypatch):
    lay = layout(24, 5, 3, 4)
    state = FleetState.from_state_dicts(init_state_dicts(2, lay.hyper, 0), lay, device="cpu")
    opt = LowmemOptimizer(state, 2e-4, 1e-3, 2.0)
    g = torch.Generator().manual_seed(0)
    xm, xl = torch.randn(2, 8, 24, 5, generator=g), torch.rand(2, 8, 24, 3, generator=g)
    monkeypatch.setattr(fleet, "LAYER_RANGES", on)
    with profile(activities=[ProfilerActivity.CPU]) as p:
        fleet_step(state, opt, xm, xl, torch.ones(2, 8), torch.randn(2, 8, 4, generator=g),
                   1.0)
    names = {e["name"] for e in prof.trace_events(p) if e.get("cat") == "user_annotation"}
    layers = {n for n in names if n.startswith("layer:")}
    assert layers == ({f"layer:{k}" for k in prof.LAYER_KINDS} if on else set())


def test_a_launch_takes_the_innermost_range_open_at_it():
    """The convolutions' backward ranges open inside ``layer:backward``: a
    launch inside one is ``conv_backward``, one after it ``backward`` again,
    one outside every range ``other``."""
    events = [_ev("user_annotation", "layer:conv", 0, 10),
              _ev("user_annotation", "layer:backward", 20, 40),
              _ev("user_annotation", "layer:conv_backward", 25, 10),
              _ev("user_annotation", "layer:conv_backward", 40, 5),
              _ev("cuda_runtime", "cudaLaunchKernel", 22, 1, 1),
              _ev("cuda_runtime", "cudaLaunchKernel", 30, 1, 2),
              _ev("cuda_runtime", "cudaLaunchKernel", 38, 1, 3),
              _ev("cuda_runtime", "cudaLaunchKernel", 42, 1, 4),
              _ev("cuda_runtime", "cudaLaunchKernel", 55, 1, 5),
              _ev("cuda_runtime", "cudaLaunchKernel", 70, 1, 6)]
    assert prof.launch_kinds(events) == {1: "backward", 2: "conv_backward", 3: "backward",
                                         4: "conv_backward", 5: "backward"}
