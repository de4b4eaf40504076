"""The readers of the program's spans (``portbench/program_spans.py`` and
the four ``*_idle_pct`` metrics) on canned captures of each job kind: the
idle seconds they put down to each span, the partition of the harness's
own label they refine, None against a program without the spans, the
capture found in the calling frame, and every metric the benchmark already
had reading the same values with and without the program's span names."""

import types
from pathlib import Path

import pytest

from portbench import program_spans
from portbench.cost import counts
from portbench.jobs import fleet, single
from portbench.spec import Bench
from portbench.trace import WINDOW, Capture, Event, Trace

BENCH = Bench(Path(__file__).resolve().parents[2])
NEW = ("launch.host_idle_pct", "fetch.host_idle_pct", "vae.host_idle_pct",
       "program.epoch_idle_pct")
OLD = ("device.idle_pct", "device.rows_per_busy_s", "step_mfu", "launch.outside_train_pct",
       "conv1d_roofline", "masked_bn_roofline", "adam_roofline")


def t(ms: float) -> int:
    return int(round(ms * 1_000_000))


def host(name, a, b, corr=0):
    return Event(name, False, t(a), t(b), corr=corr)


def inner(name, a, b):
    """A span opened 1 ns after the one it is nested in, which opens at ``a``."""
    return Event(name, False, t(a) + 1, t(b))


def device(name, a, b, corr, kind="kernel"):
    return Event(name, True, t(a), t(b), corr=corr, kind=kind)


def fleet_events(spans=True):
    """A 20 ms window of one fleet job; the card idles [0, 3.5], [4, 4.5],
    [5, 7.5] and [14, 20] ms."""
    ev = [host(WINDOW, 0, 20), host("draws+launch", 0, 10), host("fetch", 10, 18),
          host("readback", 18, 20), host("fleet_train", 6, 9), host("member_summary", 9, 10),
          host("cudaMemcpyAsync", 3.2, 3.3, corr=1), host("cudaLaunchKernel", 4.1, 4.2, corr=2),
          host("cudaGraphLaunch", 7.2, 7.3, corr=3), host("cudaLaunchKernel", 9.1, 9.2, corr=4),
          device("Memcpy HtoD (Pageable -> Device)", 3.5, 4, 1, "gpu_memcpy"),
          device("void norm_tiles_kernel(float const*)", 4.5, 5, 2),
          device("void (anonymous namespace)::conv_fwd_f32(float const*)", 7.5, 10, 3),
          device("void (anonymous namespace)::adam_kernel(float*)", 10, 12, 3),
          device("void (anonymous namespace)::apply_kernel<float>(float const*)", 12, 13, 3),
          device("void member_summary_kernel(float*)", 13, 14, 4),
          device("fleet_train", 7.5, 13, 0, "gpu_user_annotation")]
    if spans:
        ev += [inner("fleet.init", 0, 2), host("fleet.draws", 2, 3), host("fleet.upload", 3, 4),
               host("fleet.normalize", 4, 5), host("fleet.state", 5, 6),
               inner("program.load", 6, 7), host("program.epoch", 7, 8),
               inner("fetch.history", 10, 14), host("fetch.members", 14, 18),
               device("program.epoch", 7.5, 13, 0, "gpu_user_annotation")]
    return ev


def single_events(spans=True):
    """A 10 ms window of one single job; the card idles [0, 2.5], [3, 4.2],
    [5.2, 5.8], [6.8, 8.5] and [9, 10] ms."""
    ev = [host(WINDOW, 0, 10), host("normalize", 0, 1), host("train", 1, 8),
          host("normative", 8, 9), host("readback", 9, 10),
          host("cudaMemcpyAsync", 2.1, 2.2, corr=1), host("cudaGraphLaunch", 4.1, 4.2, corr=2),
          host("cudaGraphLaunch", 5.6, 5.7, corr=3), host("cudaLaunchKernel", 8.1, 8.2, corr=4),
          device("Memcpy HtoD (Pageable -> Device)", 2.5, 3, 1, "gpu_memcpy"),
          device("void (anonymous namespace)::adam_kernel(float*)", 4.2, 5.2, 2),
          device("void (anonymous namespace)::adam_kernel(float*)", 5.8, 6.8, 3),
          device("void at::native::reduce_kernel(float*)", 8.5, 9, 4)]
    if spans:
        ev += [inner("vae.init", 1, 2), host("vae.upload", 2, 3), host("vae_train", 3, 8),
               Event("program.load", False, t(3) + 2, t(4)), host("program.epoch", 4, 5),
               host("program.epoch", 5.5, 6.5), host("program.history", 6.5, 8)]
    return ev


KINDS = {"fleet.cohort64": (fleet, fleet_events), "single.tract": (single, single_events)}
WORK = {"fleet.cohort64": {"members": 64, "batch": 64, "train_steps": 600,
                           "eval_rows": [960, 960], "encode_rows": [], "flat_params": False},
        "single.tract": {"members": 1, "batch": 64, "train_steps": 600,
                         "eval_rows": [925, 925], "encode_rows": [925], "flat_params": True}}


def ctx_of(cell, events, ranges, with_events=True):
    w = BENCH.cell(cell)
    ctx = types.SimpleNamespace(trace=Trace(events, ranges), work=WORK[cell], jobs=1,
                                rows=2368000, config=BENCH.config(w["config"]),
                                traffic=BENCH.traffic(w["traffic"]), cost=counts)
    if with_events:
        ctx.events = events
    return ctx


def read(name, ctx):
    return BENCH.reader(name).read(ctx)


def idle(cell, ranges):
    kind, events = KINDS[cell]
    return dict(Trace(events(), ranges).breakdown(top=99)["idle_gaps"])


@pytest.mark.parametrize("name,cell,want", [
    ("launch.host_idle_pct", "fleet.cohort64", 100 * (2 + 1 + 0.5 + 0.5 + 1 + 1) / 20),
    ("fetch.host_idle_pct", "fleet.cohort64", 100 * 4 / 20),
    ("program.epoch_idle_pct", "fleet.cohort64", 100 * 0.5 / 20),
    ("vae.host_idle_pct", "single.tract", 100 * (1 + 0.5 + 1 + 1.2) / 10),
    ("program.epoch_idle_pct", "single.tract", 100 * (0.2 + 0.3) / 10)])
def test_span_readers_on_canned_events(name, cell, want):
    kind, events = KINDS[cell]
    assert cell in next(m for m in BENCH.spec["per_layer"] if m["name"] == name)["workloads"]
    assert read(name, ctx_of(cell, events(), kind.RANGES)) == pytest.approx(want)


@pytest.mark.parametrize("cell,label", [("fleet.cohort64", "draws+launch"),
                                        ("fleet.cohort64", "fetch"),
                                        ("single.tract", "train")])
def test_the_program_spans_split_the_harness_label(cell, label):
    """The idle seconds of a harness span (and of ``fleet_train``) are the
    sum of those the program's spans inside it take, and of what is left
    to the harness span itself."""
    kind = KINDS[cell][0]
    old, new = idle(cell, kind.RANGES), idle(cell, kind.RANGES + program_spans.PROGRAM)
    inside = {"draws+launch": ("fleet.init", "fleet.draws", "fleet.upload",
                               "fleet.normalize", "fleet.state", "program.load",
                               "program.epoch", "fleet_train", "member_summary"),
              "fetch": ("fetch.history", "fetch.members"),
              "train": ("vae.init", "vae.upload", "vae_train", "program.load",
                        "program.epoch", "program.history")}[label]
    before = old.get(label, 0.0) + sum(old.get(s, 0.0) for s in inside
                                       if s in kind.RANGES)
    after = new.get(label, 0.0) + sum(new.get(s, 0.0) for s in inside)
    assert after == pytest.approx(before) and before > 0
    assert new.get(label, 0.0) == pytest.approx(0.0, abs=1e-8)  # no host work left unnamed
    assert sum(new.values()) == pytest.approx(sum(old.values()))


def cells_of(names):
    """(metric, cell) of each cell that lists the metric."""
    return [(n, c) for n in names for c in KINDS
            if c in next(m for m in BENCH.spec["per_layer"] if m["name"] == n)["workloads"]]


@pytest.mark.parametrize("name,cell", cells_of(NEW))
def test_span_readers_give_none_without_the_spans(name, cell):
    kind, events = KINDS[cell]
    assert read(name, ctx_of(cell, events(spans=False), kind.RANGES)) is None
    window_only = [Event(WINDOW, False, 0, 10)]
    assert read(name, ctx_of(cell, window_only, ())) is None


def test_the_capture_is_found_in_a_calling_frame():
    """The harness keeps its capture in ``cap`` while it reads the metrics;
    a context without ``events`` takes them from there."""
    kind, events = KINDS["fleet.cohort64"]
    cap = Capture()
    cap.events = events()
    ctx = ctx_of("fleet.cohort64", cap.events, kind.RANGES, with_events=False)
    assert read("fetch.host_idle_pct", ctx) == pytest.approx(20.0)
    assert ctx.program_trace is not None
    del cap
    lost = ctx_of("fleet.cohort64", events(), kind.RANGES, with_events=False)
    assert read("fetch.host_idle_pct", lost) is None


@pytest.mark.parametrize("name,cell", cells_of(OLD))
def test_existing_metrics_read_the_same_with_the_program_spans(name, cell):
    kind, events = KINDS[cell]
    old = read(name, ctx_of(cell, events(), kind.RANGES))
    new = read(name, ctx_of(cell, events(), kind.RANGES + program_spans.PROGRAM))
    assert old is not None and new == pytest.approx(old, rel=1e-12)
