"""The check's control on the card, at a size a test run holds: the plain
reference computed one step below the configuration's arithmetic (TF32
below float32, float8 operands below the fleet's bfloat16) and put in the
program's place reads gaps well above the sound program's on the same
inputs, in each job kind and precision.  At the cells' own sizes the
readings come from ``python3 -m portbench.control`` (``PERF.md``)."""

import json
from pathlib import Path

import pytest

from portbench import inputs

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = {"tracts": 1, "groups": {"Sham": 4, "TBI": 4, "PTE": 2}, "streamlines": 10,
           "loop": "closed", "trace_jobs": 1}


@pytest.mark.card
@pytest.mark.parametrize("kind,config,timepoints,check", [
    ("fleet", "fleet-f32", ["2d", "9d"], 2), ("single", "single-f32", ["9d"], 1),
    ("fleet", "fleet-bf16", ["2d", "9d"], 2)])
def test_the_control_reads_above_the_program(card, kind, config, timepoints, check):
    from portbench.jobs import fleet, single

    config = json.loads((ROOT / f"portbench/configs/lcvae-{config}.json").read_text())
    config["epochs"] = 3
    traffic = {**TRAFFIC, "timepoints": timepoints, "check_members": check}
    Job = {"fleet": fleet.Job, "single": single.Job}[kind]
    ratios = []
    for seed in (2 ** 32 + 1, 2 ** 32 + 2, 2 ** 32 + 3):
        job = Job(config, traffic, seed, card)
        js = inputs.job_seed(seed, 0)
        program = job.readings(job.run(js), js)
        control = job.readings(job.reference(js, job.control), js)
        ratios.append(max(control[k] / max(program[k], 1e-12) for k in program))
    job.release()
    assert min(ratios) >= 3, ratios
