"""The single VAE trains as a fleet of one member: ``train_lesion_vae`` and
``train_module`` without a mesh run the cached one-member ``FleetProgram``
(in ``train.trainer.PROGRAMS``), one program (one capture on the card) a
configuration; the module passed in is trained in place; no module layer
(``MaskedBatchNorm``, the library's convolutions) runs while training; on
the card every step launches the fleet's convolution, masked BatchNorm and
optimizer kernels.  On a machine with a card the checks run on ``cuda``
too."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from lesionvae_tpu_torch.models.fleet import FleetState
from lesionvae_tpu_torch.models.layers import MaskedBatchNorm
from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.ops import adam, conv1d, masked_bn
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.train import program as tprog
from lesionvae_tpu_torch.train import trainer as ttrainer

torch.set_num_threads(1)

N, L, CM, CL, LAT, B, E = 13, 8, 3, 2, 2, 4, 2
HYPER = dict(seq_len=L, micro_ch=CM, lesion_ch=CL, latent=LAT)
STEPS_AN_EPOCH = -(-N // B)


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.card)])
def device(request):
    """Each check on the CPU and, where there is one, on the card."""
    if request.param == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return request.param


def _data(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(N, L, CM)).astype(np.float32),
            rng.uniform(size=(N, L, CL)).astype(np.float32))


def _train(device, epochs=E, **kw):
    Xm, Xl = _data()
    return ttrainer.train_lesion_vae(Xm, Xl, latent_dim=LAT, epochs=epochs, batch_size=B,
                                     seed=3, device=device, **kw)


def test_one_member_fleet_program_a_configuration(device):
    """Two runs of one configuration share one cached one-member fleet
    program (on the card one capture, an epoch a replay); another
    configuration adds one; the fleet's own cache stays empty."""
    ttrainer.PROGRAMS.clear()
    tb.PROGRAMS.clear()
    tprog.reset_counts()
    _train(device)
    _train(device)
    assert len(ttrainer.PROGRAMS) == 1 and len(tb.PROGRAMS) == 0
    (program,) = ttrainer.PROGRAMS.programs.values()
    assert isinstance(program, tb.FleetProgram) and program.state.members == 1
    on_card = device == "cuda"
    assert tprog.COUNTS["captures"] == int(on_card)
    assert tprog.COUNTS["replays"] == (2 * E if on_card else 0)
    _train(device, epochs=E + 1)
    assert len(ttrainer.PROGRAMS) == 2
    assert tprog.COUNTS["captures"] == 2 * int(on_card)
    ttrainer.PROGRAMS.clear()


def test_the_module_is_trained_in_place(device):
    """The module passed in comes back holding the trained weights and
    statistics in its own parameter and buffer objects, bit for bit the
    program's trained member."""
    ttrainer.PROGRAMS.clear()
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(3)
        module = LesionConditionedVAE(**HYPER).to(device)
    tensors = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    ptrs = {k: t.data_ptr() for k, t in tensors.items()}
    start = {k: t.detach().clone() for k, t in tensors.items()}
    model, _hist = _train(device, module=module)
    assert model.module is module
    after = {**dict(module.named_parameters()), **dict(module.named_buffers())}
    assert all(after[k] is t and t.data_ptr() == ptrs[k] for k, t in tensors.items())
    (program,) = ttrainer.PROGRAMS.programs.values()
    trained = program.state.state_dict(0)
    for k, t in after.items():
        assert torch.equal(t.detach(), trained[k]), k
    assert not torch.equal(after["fc_dec.weight"].detach(), start["fc_dec.weight"])
    assert not torch.equal(after["micro_b1.running_var"], start["micro_b1.running_var"])


def test_a_job_builds_no_state_beside_the_program(device, monkeypatch):
    """Once the configuration's program exists, a job copies the module's
    parameters and statistics straight into the program's state and back:
    no ``FleetState`` is built for it."""
    ttrainer.PROGRAMS.clear()
    _train(device)
    built = []
    init = FleetState.__init__

    def counted(self, *args, **kwargs):
        built.append(args)
        init(self, *args, **kwargs)

    monkeypatch.setattr(FleetState, "__init__", counted)
    _model, hist = _train(device, epochs=E)
    assert built == [] and len(ttrainer.PROGRAMS) == 1
    assert np.isfinite(hist.to_numpy()).all()


def test_the_fleet_does_not_import_the_single_trainer():
    """The dependency runs one way: the single trainer uses the fleet's
    program, and ``train.batched`` loads nothing of ``train.trainer``."""
    code = ("import sys, lesionvae_tpu_torch.train.batched; "
            "print('lesionvae_tpu_torch.train.trainer' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[1], timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "False"

def test_training_runs_no_module_layer(device, monkeypatch):
    """Without a mesh no ``MaskedBatchNorm`` forward and no library
    convolution runs while the VAE trains: the fleet's layers do the work."""
    def refuse(*_a, **_k):
        raise AssertionError("a module layer ran while training")

    for owner, name in ((MaskedBatchNorm, "forward"), (torch.nn.Conv1d, "forward"),
                        (torch.nn.ConvTranspose1d, "forward"), (F, "conv1d"),
                        (F, "conv_transpose1d")):
        monkeypatch.setattr(owner, name, refuse)
    _model, hist = _train(device)
    assert np.isfinite(hist.to_numpy()).all()


@pytest.mark.card
def test_a_step_launches_the_fleet_kernels():
    """On the card each training step (the graph's replays and the warm-up
    epoch before its capture) launches the masked BatchNorm cluster kernels
    seven times each, ``conv_fwd`` 14 and ``conv_wgrad`` 8 times, the
    gradient gather once and the update twice (weights, BatchNorm leaves),
    and nothing of the masked BatchNorm's general route."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ttrainer.PROGRAMS.clear()
    for wrapper in masked_bn.WRAPPERS + conv1d.WRAPPERS + adam.WRAPPERS:
        wrapper.launches = 0
    tprog.reset_counts()
    _train("cuda")
    steps = (E + tprog.COUNTS["captures"]) * STEPS_AN_EPOCH
    got = {w.__name__: w.launches
           for w in masked_bn.WRAPPERS + conv1d.WRAPPERS + adam.WRAPPERS}
    want = {"bn_cluster_forward": 7, "bn_cluster_backward": 7, "bn_stats": 0,
            "bn_apply": 0, "bn_grad_sums": 0, "bn_grad_apply": 0, "conv_fwd": 14,
            "conv_wgrad": 8, "grad_sq_norm": 1, "adam_step": 2}
    assert {k: v for k, v in got.items() if k in want} == {
        k: v * steps for k, v in want.items()}
    ttrainer.PROGRAMS.clear()
