"""The port's trace reader (``utils/device_trace.py``) on Chrome traces of
``torch.profiler``: the five cases of tests/test_device_trace.py rebuilt on
synthetic traces with the categories the profiler writes (device ranges
``gpu_user_annotation``, kernels ``kernel``, host ``cpu_op`` /
``user_annotation`` / ``python_function``); nested ranges counted once and
the port's spans folded into the stages; and a real CPU trace of a tiny
fleet launch, which holds no device event."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.utils import profiling
from lesionvae_tpu_torch.utils.device_trace import device_exec_by_module, stage_breakdown

torch.set_num_threads(1)

US = 1_000_000  # microseconds per second


def _ev(cat, name, seconds, ts=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": seconds * US,
            "pid": 0, "tid": 0}


def _write(tmp_path: Path, events) -> str:
    d = tmp_path / "trace"
    d.mkdir(exist_ok=True)
    (d / "trace.json").write_text(json.dumps({"traceEvents": events}))
    return str(d)


def test_device_ranges_preferred_and_host_excluded(tmp_path):
    """Device ranges are summed, not the kernels nested in them; host events
    are ignored whatever their names."""
    pm = device_exec_by_module(_write(tmp_path, [
        _ev("gpu_user_annotation", "fleet_train", 3),
        _ev("gpu_user_annotation", "sh_fit", 1, ts=4 * US),
        _ev("kernel", "void sgemm_kernel<128>(float*)", 2),
        _ev("user_annotation", "fleet_train", 9),
        _ev("cpu_op", "aten::bmm", 9)]))
    assert pm == {"fleet_train": 3.0, "sh_fit": 1.0}
    stages = stage_breakdown(pm)
    assert stages["fleet"] == 3.0 and stages["sh"] == 1.0
    assert stages["total"] == 4.0 and stages["other"] == 0.0


def test_suffixes_aggregate(tmp_path):
    pm = device_exec_by_module(_write(tmp_path, [
        _ev("gpu_user_annotation", "streamline_metrics.1", 2),
        _ev("gpu_user_annotation", "streamline_metrics(777)", 1, ts=3 * US)]))
    assert pm == {"streamline_metrics": 3.0}
    assert stage_breakdown(pm)["geometry"] == 3.0


def test_nested_ranges_count_a_device_second_once(tmp_path):
    """``program.epoch`` replays inside ``fleet_train`` (and a range of
    ``fleet.upload`` beside it): each second goes to the innermost range,
    and the stages' total is the device time under any range."""
    pm = device_exec_by_module(_write(tmp_path, [
        _ev("gpu_user_annotation", "fleet.upload", 1),
        _ev("gpu_user_annotation", "fleet_train", 10, ts=2 * US),
        _ev("gpu_user_annotation", "program.load", 1, ts=2 * US),
        _ev("gpu_user_annotation", "program.epoch", 3, ts=3 * US),
        _ev("gpu_user_annotation", "program.epoch", 4, ts=7 * US),
        _ev("gpu_user_annotation", "member_summary", 1, ts=12 * US)]))
    assert pm == {"fleet.upload": 1.0, "fleet_train": 2.0, "program.load": 1.0,
                  "program.epoch": 7.0, "member_summary": 1.0}
    stages = stage_breakdown(pm)
    assert stages["fleet"] == 10.0 and stages["launch"] == 1.0
    assert stages["normative"] == 1.0 and stages["total"] == 12.0


def test_the_single_trainers_range_is_the_training_stage(tmp_path):
    pm = device_exec_by_module(_write(tmp_path, [
        _ev("gpu_user_annotation", "vae_train", 5),
        _ev("gpu_user_annotation", "program.epoch", 4, ts=US // 2),
        _ev("gpu_user_annotation", "program.history", 0.25, ts=9 * US // 2)]))
    stages = stage_breakdown(pm)
    assert stages["fleet"] == 5.0 and stages["other"] == 0.0 and stages["total"] == 5.0


@pytest.mark.parametrize("name", ["fleet.init", "fleet.draws", "fleet.upload",
                                  "fleet.normalize", "fleet.state", "fetch.history",
                                  "fetch.members", "vae.init", "vae.upload"])
def test_the_launches_host_spans_are_the_launch_stage(name):
    stages = stage_breakdown({name: 2.0, "fleet_train": 3.0})
    assert stages["launch"] == 2.0 and stages["fleet"] == 3.0
    assert stages["other"] == 0.0 and stages["total"] == 5.0


def test_fallback_to_kernels_without_device_ranges(tmp_path):
    pm = device_exec_by_module(_write(tmp_path, [
        _ev("kernel", "geometry_kernel", 5), _ev("kernel", "small_op", 1),
        _ev("cpu_op", "aten::add", 7)]))
    assert pm == {"geometry_kernel": 5.0, "small_op": 1.0}


def test_host_only_trace_yields_nothing(tmp_path):
    assert device_exec_by_module(_write(tmp_path, [
        _ev("cpu_op", "aten::bmm", 9), _ev("user_annotation", "fleet_train", 9),
        _ev("python_function", "train_fleet", 9)])) == {}


def test_empty_dir_yields_nothing(tmp_path):
    assert device_exec_by_module(str(tmp_path)) == {}


def test_real_cpu_trace_of_a_fleet_launch_yields_nothing(tmp_path):
    """``utils/profiling.trace`` on the CPU records the named ranges on the
    host only: no device time is reported."""
    rng = np.random.default_rng(0)
    Xm = rng.normal(size=(2, 8, 8, 3)).astype(np.float32)
    Xl = rng.uniform(size=(2, 8, 8, 2)).astype(np.float32)
    with profiling.trace(str(tmp_path / "t"), device="cpu"):
        tb.launch_many_vaes(Xm, Xl, np.array([8, 6], np.int32), latent_dim=2, epochs=1,
                            batch_size=8, device="cpu").fetch()
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any(e.get("name") == "fleet_train" for e in events)
    assert device_exec_by_module(str(tmp_path / "t")) == {}
