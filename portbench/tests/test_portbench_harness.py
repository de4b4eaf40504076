"""The harness on the CPU: cells and their files found by name, new files
taken with no edit, the result line's shape, the traced window's arithmetic
on a canned event list, and ``correct`` coming out false with the program
broken underneath."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import run
from portbench.cost import counts
from portbench.spec import Bench
from portbench.trace import WINDOW, Event, Trace

ROOT = Path(__file__).resolve().parents[2]
BENCH = Bench(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TINY = {"norm": 1e-4, "hist1": 1e-4, "hist1_loss_recon": 1e-4, "hist1_median": 1e-4,
        "hist": 1e-4, "stats": 1e-4, "stats_change": 1e-3, "change": 1e-3, "summary": 1e-4}
# the tiny bfloat16 fleet on the CPU, compared as its cell on the card is:
# the program's bfloat16 sums part from the reference's by about 2e-3
# (hist1) and, over its four steps of stochastic rounding, by 0.19-0.25 in
# the change; the faults read 0.03-0.12 (half_batch, hist1), 0.2 (altered,
# norm) and 1 (a state left unchanged)
TINY_BF16 = {"norm": 1e-4, "hist1": 0.01, "hist1_median": 0.005, "stats_change": 0.01,
             "change": 0.45}
TINY_CELLS = ["tiny.fleet", "tiny.single", "tiny.fleet-bf16"]
LIMITS = {"tiny.fleet": TINY, "tiny.single": TINY, "tiny.fleet-bf16": TINY_BF16}


def test_the_cells_and_their_files_are_found_by_name():
    spec = BENCH.spec
    assert [w["name"] for w in spec["workloads"]] == [
        "fleet.cohort64", "single.tract", "fleet.pair8", "fleet.cohort64-bf16"]
    for w in spec["workloads"]:
        config = BENCH.config(w["config"])
        job = BENCH.job(config["job"])
        assert hasattr(job, "Job") and job.RANGES
        assert BENCH.traffic(w["traffic"])["loop"] == "closed"
        limits = set(BENCH.limits(w["name"]))
        assert {"norm", "hist1", "change", "stats_change"} <= limits
        # a bfloat16 summary is printed, not compared (portbench/check.py)
        assert ("summary" in limits) == (config["compute"] == "float32")
        assert w["chips"] == 1
        assert {m["name"] for m in BENCH.metrics(w["name"], "end_to_end")} == {
            "train_rows_per_s", "setup_s"}
        assert BENCH.metrics(w["name"], "per_layer")
    for m in spec["per_layer"]:
        reader = BENCH.reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.SOURCE, reader.MOVES) == (
            m["layer"], m["unit"], m["source"], m["moves"])


def test_benchmark_json_keeps_the_contracts_forms():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["paths"] == ["portbench"] and 1 <= spec["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/") and (ROOT / c["file"]).exists()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and len(w["why"]) <= 200
    for m in spec["end_to_end"]:
        assert set(m) == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in [e["name"] for e in spec["end_to_end"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def tiny_copy(tmp_path: Path) -> Path:
    """The benchmark's files in a new directory, with a tiny configuration
    of each job kind and of the bfloat16 fleet, their mixes and limits, a new
    metric and three new cells added as new files and entries only."""
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copytree(ROOT / "portbench", root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    fleet = {"tracts": 1, "timepoints": ["2d", "9d"], "check_members": 2}
    for kind, source, members, limits in (
            ("fleet", "fleet-f32", fleet, TINY),
            ("single", "single-f32", {"tracts": 1, "timepoints": ["9d"], "check_members": 1},
             TINY),
            ("fleet-bf16", "fleet-bf16", fleet, TINY_BF16)):
        base = json.loads((ROOT / f"portbench/configs/lcvae-{source}.json").read_text())
        base.update(name=f"tiny-{kind}", seq_len=16, epochs=2, batch_size=16)
        (root / f"portbench/configs/tiny-{kind}.json").write_text(json.dumps(base))
        (root / f"portbench/traffic/tiny-{kind}.json").write_text(json.dumps(
            {"groups": {"Sham": 1, "TBI": 1, "PTE": 1}, "streamlines": 10, "loop": "closed",
             "trace_jobs": 2, **members}))
        (root / f"portbench/limits/tiny.{kind}.json").write_text(json.dumps(limits))
        spec["configs"].append({"name": f"tiny-{kind}", "source": "a test",
                                "file": f"portbench/configs/tiny-{kind}.json",
                                "reduced": ["seq_len", "epochs", "batch_size"], "why": "a test"})
        spec["workloads"].append({"name": f"tiny.{kind}", "config": f"tiny-{kind}",
                                  "traffic": f"tiny-{kind}", "chips": 1, "why": "a test"})
    (root / "portbench/metrics/jobs_in_window.py").write_text(
        'LAYER = "harness"\nUNIT, SOURCE, MOVES = "jobs", "program_counter", '
        '"train_rows_per_s"\n\n\ndef read(ctx):\n    return ctx.jobs\n')
    spec["per_layer"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher",
                              "source": "program_counter", "layer": "harness",
                              "moves": "train_rows_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    return root


def run_copy(root: Path, cell: str, trace: bool, seed: int = 2 ** 33 + 5) -> dict:
    """One run of ``cell`` on the CPU in the copy, in a process of its own."""
    code = ("import json, sys; from pathlib import Path; from portbench import run; "
            "from portbench.spec import Bench; "
            f"r = run.run_cell(Bench(Path('.')), {cell!r}, {seed}, 0.01, {trace}, 'cpu', "
            "log=lambda *a: None); print(json.dumps(r))")
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "HOME": str(root)}
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny_copy(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", TINY_CELLS)
def test_new_files_run_with_no_edit(copy, cell):
    r = run_copy(copy, cell, False)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert r["correct"] is True and r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_rows_per_s", "setup_s"}      # no per-layer metric
    assert all(m["value"] > 0 for m in r["metrics"].values())
    assert set(r["checks"]) == set(LIMITS[cell])
    assert all(c["value"] < c["limit"] for c in r["checks"].values()), r["checks"]


def test_a_traced_run_reports_per_layer_metrics_only(copy):
    r = run_copy(copy, "tiny.fleet", True)
    assert list(r) == ["correct", "attempted", "failed", "metrics", "breakdown", "device",
                       "checks"]
    # the CPU has no device operations: the trace readers find nothing, the
    # new metric reads the harness's count
    assert r["metrics"] == {"jobs_in_window": {"value": 1.0, "unit": "jobs"}}
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert r["device"]["busy_s"] == 0 and r["device"]["window_s"] > 0


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "fleet.cohort64",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_the_run_fails(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    code = ("import sys, types, torch; torch.cuda.is_available = lambda: True; "
            "torch.cuda.device_count = lambda: 1; from portbench import run; "
            "sys.exit(run.main(['--workload', 'single.tract', '--seed', '1', '--seconds', '1']))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "lesionvae_tpu_torch" in out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lesionvae_tpu_torchlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "lesionvae_tpu.sub", sys)
    assert run.forbidden_modules() == ["lesionvae_tpu"]


# ------------------------------------------------------------ trace arithmetic
def canned(annotate: bool):
    """A 10 ms window: fleet_train launches two kernels (corr 1, 2), the
    summary one (corr 3); a copy overlaps the first kernel."""
    ms = 1_000_000
    ev = [Event(WINDOW, False, 0, 10 * ms),
          Event("draws+launch", False, 0, 9 * ms), Event("fleet_train", False, 1 * ms, 2 * ms),
          Event("cudaGraphLaunch", False, 1 * ms + 10, 1 * ms + 20, corr=1),
          Event("cudaLaunchKernel", False, 1 * ms + 30, 1 * ms + 40, corr=2),
          Event("member_summary", False, 2 * ms, 3 * ms),
          Event("cudaLaunchKernel", False, 2 * ms + 10, 2 * ms + 20, corr=3),
          Event("fetch", False, 9 * ms, 10 * ms),
          Event("void (anonymous namespace)::conv_fwd_f32(float const*)", True, 2 * ms, 4 * ms,
                corr=1, kind="kernel"),
          Event("void (anonymous namespace)::adam_kernel(float*)", True, 4 * ms, 5 * ms, corr=2,
                kind="kernel"),
          Event("Memcpy HtoD (Pageable -> Device)", True, 3 * ms, 4500_000, corr=9,
                kind="gpu_memcpy"),
          Event("void (anonymous namespace)::apply_kernel<float>(float const*)", True, 6 * ms,
                7 * ms, corr=3, kind="kernel")]
    if annotate:
        ev.append(Event("fleet_train", True, 2 * ms, 5 * ms, kind="gpu_user_annotation"))
    return ev


@pytest.mark.parametrize("annotate", [True, False])
def test_trace_arithmetic_on_canned_events(annotate):
    tr = Trace(canned(annotate), ("draws+launch", "fetch", "fleet_train", "member_summary"))
    assert tr.window_s == pytest.approx(0.010)
    assert tr.busy_s == pytest.approx(0.004)                  # [2, 5] and [6, 7] ms
    assert tr.range_seconds("fleet_train") == pytest.approx(0.003)
    assert tr.range_seconds("member_summary") == pytest.approx(0.001)
    assert tr.range_seconds("nothing") is None
    assert tr.op_seconds(BENCH.reader("conv1d_roofline").PATTERN) == pytest.approx(0.002)
    assert tr.op_seconds(BENCH.reader("adam_roofline").PATTERN) == pytest.approx(0.001)
    assert tr.op_seconds(BENCH.reader("masked_bn_roofline").PATTERN) == pytest.approx(0.001)
    b = tr.breakdown()
    assert b["device_ops"][0] == ["conv_fwd_f32", pytest.approx(0.002)]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle == {"fleet_train": pytest.approx(0.001), "draws+launch": pytest.approx(0.004),
                    "fetch": pytest.approx(0.001)}
    assert sum(idle.values()) == pytest.approx(tr.window_s - tr.busy_s)


def ctx_of(tr, cell):
    import types

    w = BENCH.cell(cell)
    config = BENCH.config(w["config"])
    work = {"fleet.cohort64": {"members": 64, "batch": 64, "train_steps": 600,
                               "eval_rows": [960, 960], "encode_rows": [], "flat_params": False},
            "single.tract": {"members": 1, "batch": 64, "train_steps": 600,
                             "eval_rows": [925, 925], "encode_rows": [925],
                             "flat_params": True}}[cell]
    return types.SimpleNamespace(trace=tr, work=work, jobs=2, rows=2368000, config=config,
                                 traffic=BENCH.traffic(w["traffic"]), cost=counts)


def test_metric_readers_on_canned_events():
    tr = Trace(canned(True), ("draws+launch", "fetch", "fleet_train", "member_summary"))
    ctx = ctx_of(tr, "fleet.cohort64")
    read = lambda name: BENCH.reader(name).read(ctx)  # noqa: E731
    assert read("device.idle_pct") == pytest.approx(60.0)
    assert read("device.rows_per_busy_s") == pytest.approx(2 * 2368000 / 0.004)
    assert read("launch.outside_train_pct") == pytest.approx(70.0)
    conv = 2 * (600 * counts.conv_bound_ms(64, 64)["bound_ms"]
                + 2 * counts.conv_bound_ms(64, 960)["forward"]) / 1e3
    assert read("conv1d_roofline") == pytest.approx(100 * conv / 0.002)
    bn = counts.masked_bn_bytes(64, 64)
    bn_s = 2 * (600 * (bn["forward_bytes"] + bn["backward_bytes"])
                + 2 * counts.masked_bn_bytes(64, 960)["forward_bytes"]) / counts.HBM_BYTES_PER_S
    assert read("masked_bn_roofline") == pytest.approx(100 * bn_s / 0.001)
    opt = counts.optimizer_bytes(64)
    assert read("adam_roofline") == pytest.approx(
        100 * 2 * 600 * (opt["grad_sq_norm"] + opt["optimizer"]) / counts.HBM_BYTES_PER_S / 0.001)
    flops = 600 * counts.step_flops(64) + 2 * counts.forward_flops(64, 960)
    assert read("step_mfu") == pytest.approx(100 * 2 * flops / (0.010 * 67e12))
    single = ctx_of(tr, "single.tract")
    flat = counts.flat_optimizer_bytes(2742241)
    assert BENCH.reader("adam_roofline").read(single) == pytest.approx(
        100 * 2 * 600 * (flat["grad_sq_norm"] + flat["optimizer"]) / counts.HBM_BYTES_PER_S / 0.001)
    empty = Trace([Event(WINDOW, False, 0, 10)], ())
    ctx.trace = empty
    for name in ("device.idle_pct", "device.rows_per_busy_s", "step_mfu",
                 "launch.outside_train_pct", "conv1d_roofline", "masked_bn_roofline",
                 "adam_roofline"):
        assert read(name) is None, name


# ------------------------------------------------- faults under the timed path
def _freeze_fleet(monkeypatch):
    from lesionvae_tpu_torch.train import lowmem, trainer

    monkeypatch.setattr(lowmem.LowmemOptimizer, "step", lambda self, grads, finite: None)
    monkeypatch.setattr(trainer.ClipDecayAdam, "step", lambda self, grads, finite: None)


def _freeze_stats(monkeypatch):
    from lesionvae_tpu_torch.models import fleet, layers

    def kept(self, h, name):
        y = call(self, h, name)
        for k in ("running_mean", "running_var"):
            self.new_stats[f"{name}.{k}"] = self.stats[f"{name}.{k}"]
        return y

    def kept_single(self, x, mask=None):
        saved = self.running_mean.clone(), self.running_var.clone()
        y = forward(self, x, mask)
        with torch.no_grad():
            self.running_mean.copy_(saved[0])
            self.running_var.copy_(saved[1])
        return y

    call, forward = fleet._Norm.__call__, layers.MaskedBatchNorm.forward
    monkeypatch.setattr(fleet._Norm, "__call__", kept)
    monkeypatch.setattr(layers.MaskedBatchNorm, "forward", kept_single)


def _half_batch(monkeypatch):
    from lesionvae_tpu_torch.train import batched, trainer

    fleet_step, train_step = batched.fleet_step, trainer.train_step

    def half_fleet(state, opt, xb_m, xb_l, mask, eps, beta, compute_dtype=None):
        h = xb_m.shape[1] // 2
        return fleet_step(state, opt, xb_m[:, :h], xb_l[:, :h], mask[:, :h], eps[:, :h], beta,
                          compute_dtype)

    def half_single(module, opt, xb_m, xb_l, mask, eps, beta, axis=None):
        h = xb_m.shape[0] // 2
        return train_step(module, opt, xb_m[:h], xb_l[:h], mask[:h], eps[:h], beta, axis)

    monkeypatch.setattr(batched, "fleet_step", half_fleet)
    monkeypatch.setattr(trainer, "train_step", half_single)


def _alter_answer(monkeypatch):
    from lesionvae_tpu_torch.train import batched, normative

    summary, zscores = batched.member_summary, normative.normative_zscores_fused

    def altered_summary(*a, **k):
        out = list(summary(*a, **k))
        out[3] = out[3].clone()
        out[3][0, 0, 0] += 0.05
        return tuple(out)

    def altered_z(*a, **k):
        out = list(zscores(*a, **k))
        out[2] = out[2].copy()
        out[2][0, 0, 0] += 0.05
        return tuple(out)

    monkeypatch.setattr(batched, "member_summary", altered_summary)
    monkeypatch.setattr(normative, "normative_zscores_fused", altered_z)


def _alter_normalization(monkeypatch):
    """The fleet's normalization median moved by 5% of its scale, as the
    reference's ``altered`` moves it: the answer a cell that compares no
    summary (bfloat16) is held to."""
    from lesionvae_tpu_torch.train import data

    normalize = data.normalize_on_device

    def altered(*a, **k):
        Xm, Xl, stats = normalize(*a, **k)
        stats = {**stats, "median": stats["median"].clone()}
        stats["median"][0, 0] += 0.05 * max(float(stats["median"].abs().max()), 1.0)
        return Xm, Xl, stats

    monkeypatch.setattr(data, "normalize_on_device", altered)


@pytest.mark.parametrize("fault", [_freeze_fleet, _freeze_stats, _half_batch, _alter_answer])
@pytest.mark.parametrize("cell", TINY_CELLS)
def test_a_broken_timed_path_is_not_correct(copy, monkeypatch, fault, cell):
    from lesionvae_tpu_torch.train import batched, trainer

    monkeypatch.chdir(copy)
    for cache in (batched.PROGRAMS, trainer.PROGRAMS):
        cache.clear()
    fault(monkeypatch)
    if fault is _alter_answer and "summary" not in LIMITS[cell]:
        _alter_normalization(monkeypatch)
    try:
        r = run.run_cell(Bench(copy), cell, 2 ** 35 + 11, 0.01, False, "cpu",
                         log=lambda *a: None)
    finally:
        for cache in (batched.PROGRAMS, trainer.PROGRAMS):
            cache.clear()
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


# ------------------------------------------- settings the harness must honour
@pytest.mark.parametrize("cell,part,key,value", [
    ("fleet.cohort64", "config", "normalization", "host"),
    ("fleet.cohort64", "config", "storage", "float16"),
    ("fleet.cohort64", "traffic", "loop", "open"),
    ("single.tract", "config", "storage", "bfloat16"),
    ("single.tract", "config", "compute", "bfloat16")])
def test_settings_a_job_kind_does_not_run_are_refused(cell, part, key, value):
    w = BENCH.cell(cell)
    config, traffic = BENCH.config(w["config"]), BENCH.traffic(w["traffic"])
    {"config": config, "traffic": traffic}[part][key] = value
    with pytest.raises(ValueError):
        BENCH.job(config["job"]).Job(config, traffic, 1, "cpu")


def test_the_fleet_runs_the_precisions_it_states():
    """The bfloat16 cell's configuration is taken (and the reference's
    arithmetic is its own, its control one step below); the fleet passes
    its dtypes to the launch."""
    from portbench.jobs import fleet

    w = BENCH.cell("fleet.cohort64-bf16")
    config = BENCH.config(w["config"])
    assert (config["storage"], config["compute"], config["reduced"]) == (
        "bfloat16", "bfloat16", [])
    job = fleet.Job(config, {**BENCH.traffic(w["traffic"]), "tracts": 1}, 1, "cpu")
    assert (job.mode, job.control) == ("bfloat16", "fp8")
    assert fleet.DTYPES[config["storage"]] is torch.bfloat16
    assert fleet.DTYPES["float32"] is None


def test_tf32_in_force_is_held_to_the_configuration(monkeypatch):
    from portbench.jobs import common

    job = object.__new__(common.Job)
    job.device, job.config = torch.device("cuda"), {"tf32": False}
    monkeypatch.setattr(common.precision, "math_mode", lambda: (False, True, "highest"))
    with pytest.raises(ValueError):
        job.check_precision()
    monkeypatch.setattr(common.precision, "math_mode", lambda: (False, False, "highest"))
    job.check_precision()
    job.config = {"tf32": True}
    with pytest.raises(ValueError):
        job.check_precision()
