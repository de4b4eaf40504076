"""The program's spans and counters (``utils/profiling.span``,
``train.program.COUNTS``) on the CPU under ``torch.profiler``: a fleet
launch and fetch and the single trainer open their spans once each, in
order and nested as documented, as host ranges but for the two launches
read on the device; the span totals equal the profiler's range counts; a
span whose body raises is closed and counted; the modules built with an
init on the CPU (none for a fleet), the members built from device state at
``fetch`` and the bytes staged to the device match what the shapes give."""

import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lesionvae_tpu_torch.models.fleet import layout
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train import program as tprog
from lesionvae_tpu_torch.train import trainer as ttrainer
from lesionvae_tpu_torch.train.quantize import quantize_u16
from lesionvae_tpu_torch.utils import profiling

torch.set_num_threads(1)

T, N, L, CM, CL, LAT, B, E = 2, 16, 8, 3, 2, 2, 8, 2
SPANS = {"fleet.init", "fleet.draws", "fleet.upload", "fleet.normalize", "fleet.state",
         "fleet_train", "member_summary", "fetch.history", "fetch.members", "vae.init",
         "vae.upload", "vae_train", "program.load", "program.epoch", "program.capture",
         "program.history"}
BLOCK = ["fleet.upload", "fleet.normalize", "fleet.state", "fleet_train", "member_summary"]


def _cohort(seed=0):
    rng = np.random.default_rng(seed)
    Xm = rng.normal(size=(T, N, L, CM)).astype(np.float32)
    Xl = rng.uniform(size=(T, N, L, CL)).astype(np.float32)
    sham = np.zeros((T, N), np.float32)
    sham[:, :4] = 1.0
    subj = np.tile(np.arange(N, dtype=np.int64) % 3, (T, 1))
    return Xm, Xl, np.array([N, N - 3], np.int32), (sham, subj, 3, 7)


def _fleet(**kw):
    Xm, Xl, n_real, spec = _cohort()
    kw = dict(dict(latent_dim=LAT, epochs=E, batch_size=B, seed=5, device="cpu",
                   summary_spec=spec, normalize_on_device=True), **kw)
    return tb.launch_many_vaes(Xm, Xl, n_real, **kw).fetch()


def _single(epochs=E):
    Xm, Xl, _n, _spec = _cohort()
    return ttrainer.train_lesion_vae(Xm[0, :N - 3], Xl[0, :N - 3], latent_dim=LAT,
                                     epochs=epochs, batch_size=B, seed=5, device="cpu")


def _profiled(fn):
    """The spans ``fn`` opens, as (name, start, end) in start order, and the
    host's span totals."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    events = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
              for e in prof.profiler.kineto_results.events() if e.name() in SPANS]
    return sorted(events, key=lambda r: (r[1], -r[2])), profiling.counts()


def _children(events, parent=None):
    """Names of the spans directly inside ``parent`` (None: outside every
    span), in order."""
    def inside(a, b):
        return a is not b and b[1] <= a[1] and a[2] <= b[2]

    def enclosing(ev):
        outer = [o for o in events if inside(ev, o)]
        return max(outer, key=lambda o: o[1]) if outer else None

    return [ev for ev in events if enclosing(ev) is parent]


def _names(evs):
    return [name for name, _s, _e in evs]


@pytest.mark.parametrize("chunks", [1, 2])
def test_a_fleet_launch_opens_its_spans_in_order(chunks):
    events, _counts = _profiled(lambda: _fleet(upload_chunks=chunks))
    top = _children(events)
    assert _names(top) == (["fleet.init", "fleet.draws"] + BLOCK * chunks
                           + ["fetch.members", "fetch.history"])
    for train in (ev for ev in top if ev[0] == "fleet_train"):
        assert _names(_children(events, train)) == ["program.load"] + ["program.epoch"] * E


@pytest.mark.parametrize("epochs", [1, 3])
def test_the_single_trainer_opens_its_spans_in_order(epochs):
    """A single job, through its one-member fleet program: the spans in
    order, one module built on the host, no member fetched, and the bytes
    of the module, the real rows and the draws staged, no more."""
    tprog.reset_counts()
    events, _counts = _profiled(lambda: _single(epochs))
    top = _children(events)
    assert _names(top) == ["vae.init", "vae.upload", "vae_train"]
    assert _names(_children(events, top[2])) == (
        ["program.load"] + ["program.epoch"] * epochs + ["program.history"])
    assert (tprog.COUNTS["host_modules"], tprog.COUNTS["fetched_members"]) == (1, 0)
    assert tprog.COUNTS["h2d_bytes"] == _single_bytes(epochs)


@pytest.mark.parametrize("run", [_fleet, _single])
def test_span_totals_equal_the_profilers_ranges(run):
    events, counts = _profiled(run)
    assert counts == dict(Counter(_names(events)))
    seconds = profiling.report()
    assert set(seconds) == set(counts) and all(s >= 0.0 for s in seconds.values())


@pytest.mark.parametrize("run,user", [(_fleet, {"fleet_train", "member_summary"}),
                                      (_single, set())])
def test_only_the_launches_read_on_the_device_are_user_ranges(run, user, tmp_path):
    """The profiler gives each kernel to the innermost user range open at
    its launch: every other span is a host range, so ``fleet_train`` keeps
    the kernels of the whole run and no new range appears on the device."""
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    cats = {}
    for ev in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]:
        if ev.get("name") in SPANS and ev.get("ph") == "X":
            cats.setdefault(ev["name"], set()).add(ev.get("cat"))
    assert set(cats) == set(profiling.counts())
    assert {n for n, c in cats.items() if "user_annotation" in c} == user
    assert all(c <= {"user_annotation", "cpu_op"} for c in cats.values())


@pytest.mark.parametrize("opener", [profiling.span, profiling.stage])
def test_a_span_whose_body_raises_is_closed_and_counted(opener):
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            with opener("fails"):
                raise ValueError("inside")
        with opener("fails"):
            pass
    ranges = [e for e in prof.profiler.kineto_results.events() if e.name() == "fails"]
    assert len(ranges) == 2 and all(e.duration_ns() >= 0 for e in ranges)
    assert profiling.counts() == {"fails": 2}
    assert set(profiling.report()) == {"fails"}


@pytest.mark.parametrize("run,modules,fetched", [(_fleet, 0, T),
                                                 (lambda: _fleet(upload_chunks=2), 0, T),
                                                 (_single, 1, 0)])
def test_modules_built_on_the_host(run, modules, fetched):
    """A fleet builds no module on the host (its initial weights are drawn
    into rows, its members built on the device at ``fetch``); the single
    trainer builds its one."""
    tprog.reset_counts()
    run()
    assert tprog.COUNTS["host_modules"] == modules
    assert tprog.COUNTS["fetched_members"] == fetched


def _member_bytes():
    """A member's weights and BatchNorm statistics, float32, as staged."""
    lay = layout(L, CM, CL, LAT)
    sizes = [int(np.prod(shape)) for _w, _o, shape in lay.leaves.values()]
    sizes += [int(np.prod(shape)) for shape in lay.stats.values()]
    return 4 * sum(sizes)


def _draw_bytes(members, lowmem=False, epochs=E):
    """Permutations (int64), noise (float32) and, with bf16 storage, salts."""
    perms = 8 * members * epochs * N
    noise = 4 * members * epochs * (N // B) * B * LAT
    return perms + noise + (8 * members if lowmem else 0)


def _fleet_bytes(**kw):
    Xm, Xl, _n, _spec = _cohort()
    if kw.get("quantize_upload"):
        blocks = sum(c.nbytes + lo.nbytes + s.nbytes
                     for c, lo, s in (quantize_u16(Xm), quantize_u16(Xl)))
    else:
        blocks = Xm.nbytes + Xl.nbytes
    lowmem = kw.get("store_dtype") == torch.bfloat16
    return blocks + 8 * T + T * _member_bytes() + _draw_bytes(T, lowmem)


def _single_bytes(epochs=E):
    module = LesionConditionedVAE(seq_len=L, micro_ch=CM, lesion_ch=CL, latent=LAT)
    weights = sum(t.nbytes for t in (*module.parameters(), *module.buffers()))
    n = N - 3
    return weights + 4 * n * L * (CM + CL) + _draw_bytes(1, epochs=epochs)


@pytest.mark.parametrize("form", [{}, {"upload_chunks": 2}, {"quantize_upload": True},
                                  {"store_dtype": torch.bfloat16}, "single"])
def test_bytes_staged_to_the_device_follow_the_shapes(form):
    tprog.reset_counts()
    if form == "single":
        _single()
        want = _single_bytes()
    else:
        _fleet(**form)
        want = _fleet_bytes(**form)
    assert tprog.COUNTS["h2d_bytes"] == want
