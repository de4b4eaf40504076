"""The reference's bfloat16 path (``portbench/reference``) against the port's
CPU path at a tiny size: the stochastic store bit for bit, its flax-layout
noise index, the salts, the mixed-precision forward and one step's
gradients; and the faults of the bfloat16 cell read as numbers."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from lesionvae_tpu_torch.models import fleet
from lesionvae_tpu_torch.models.elbo import elbo_fleet
from lesionvae_tpu_torch.ops import sr_adam
from lesionvae_tpu_torch.train import batched, lowmem
from portbench import inputs
from portbench.reference import draws, model, store

ROOT = Path(__file__).resolve().parents[2]
HYPER = {"seq_len": 16, "micro_ch": 13, "lesion_ch": 3, "latent": 4}
LAY = fleet.layout(**HYPER)
BF16 = torch.bfloat16


def members(S: int, seed: int):
    torch.manual_seed(seed)
    parts = [model.init_member(**HYPER) for _ in range(S)]
    p = model.stack([m[0] for m in parts], "cpu")
    p = {k: v.to(BF16) if store.is_weight(k) else v for k, v in p.items()}
    return p, model.stack([m[1] for m in parts], "cpu")


def weight_shapes():
    p, _s = model.init_member(**HYPER)
    return {k: v.shape for k, v in p.items() if store.is_weight(k)}


def test_the_noise_index_is_the_programs():
    """Leaf by leaf, the reference's flax-layout index words equal the
    port's table (``train.lowmem.sr_index_table``)."""
    table = lowmem.sr_index_table(LAY).to(torch.int64) & store.MASK32
    ours = store.index_base(weight_shapes(), HYPER["seq_len"])
    offset = 0
    for name, shape in weight_shapes().items():
        n = int(np.prod(shape))
        _which, at, theirs = LAY.leaves[name]
        assert tuple(theirs) == tuple(shape), name
        assert torch.equal(ours[offset:offset + n], table[at:at + n]), name
        offset += n
    assert offset == LAY.n_weights


@pytest.mark.parametrize("seed", [3, 2 ** 33 + 1])
def test_the_stochastic_store_is_the_programs_bit_for_bit(seed):
    """One update of seeded bfloat16 rows, a member above the clip and one
    skipped, against ``ops.sr_adam.sr_adam_step_plain``."""
    g = torch.Generator().manual_seed(seed)
    S, n = 3, 4099
    p = (torch.randn(S, n, generator=g) * 0.1).to(BF16)
    m = (torch.randn(S, n, generator=g) * 1e-2).to(BF16)
    v = (torch.rand(S, n, generator=g) * 1e-4).to(BF16)
    grad = (torch.randn(S, n, generator=g) * 0.5).to(BF16)
    base = store.index_base(weight_shapes(), HYPER["seq_len"])[:n]
    norm = torch.tensor([0.5, 3.0, 1.0])
    bc1, bc2 = torch.tensor([0.1, 0.19, 0.271]), torch.tensor([1e-3, 2e-3, 3e-3])
    salt = torch.randint(0, 2 ** 32, (S,), generator=g, dtype=torch.int64)
    finite = torch.tensor([True, True, False])
    want = [t.clone() for t in (p, m, v)]
    sr_adam.sr_adam_step_plain(*want, grad, base, norm, bc1, bc2, salt, finite,
                               sr_adam.consts(2e-4, 1e-3, 2.0))
    got = store.step(p, m, v, grad.float(), base, norm[:, None], bc1[:, None], bc2[:, None],
                     salt, finite, 2e-4, 1e-3, 2.0, 0.9, 0.999, 1e-8)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(got[0][2], p[2])
    nearest = store.step(p, m, v, grad.float(), base, norm[:, None], bc1[:, None],
                         bc2[:, None], salt, finite, 2e-4, 1e-3, 2.0, 0.9, 0.999, 1e-8,
                         "nearest")
    assert not torch.equal(nearest[0], got[0])


def test_round_bf16_saturates_and_keeps_nan():
    x = torch.tensor([3.3895e38, -3.3895e38, float("nan"), 1 + 2 ** -10, 1.0])
    up = store.round_bf16(x, torch.full((5,), 0xFFFF, dtype=torch.int64))
    down = store.round_bf16(x, torch.zeros(5, dtype=torch.int64))
    assert up[0] == store.BF16_MAX and up[1] == -store.BF16_MAX and torch.isnan(up[2])
    assert up[3] == 1 + 2 ** -7 and down[3] == 1.0         # the two neighbours
    assert up[4] == down[4] == 1.0                          # a bfloat16 value stays


def test_the_salts_are_the_programs():
    want = batched.member_draws(5, 32, HYPER, 2, 16, 2 ** 41 + 3)["salts"]
    got = draws.fleet_salts(5, 32, 2, 16, HYPER["latent"], 2 ** 41 + 3, [1, 4])
    assert torch.equal(got, want[[1, 4]])


# The program's bfloat16 convolutions and BatchNorm on the CPU round as the
# reference does in the forward (the gaps read 0 here), but its closed-form
# BatchNorm backward and its bfloat16 input gradients round apart from
# autograd's through the folded affine: gradients part by up to 1.2% of a
# leaf's largest element (a convolution's bias ahead of a BatchNorm, whose
# gradient is nought to rounding, left out).
FORWARD_TOL, GRAD_TOL = 0.02, 0.05


def rel(a, b) -> float:
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("training", [True, False])
def test_the_mixed_precision_forward_and_step_are_the_programs(training):
    S, N = 3, 16
    p, stats = members(S, 7)
    state = fleet.FleetState(LAY, S, torch.float32, BF16, "cpu")
    with torch.no_grad():
        for k, v in p.items():
            state.leaves[k].copy_(v)
        for k, v in stats.items():
            state.stats[k].copy_(v)
    g = torch.Generator().manual_seed(1)
    xm, xl = torch.randn(S, N, 16, 13, generator=g), torch.rand(S, N, 16, 3, generator=g)
    eps = torch.randn(S, N, 4, generator=g)
    mask = (torch.rand(S, N, generator=g) > 0.2).float() if training else None
    leaves = state.grad_leaves()
    got = fleet.fleet_forward(LAY, leaves, state.stats, xm, xl, mask, eps, training, BF16)
    ref_leaves = {k: v.clone().requires_grad_() for k, v in p.items()}
    with model.precision("bfloat16"):
        want = model.forward(ref_leaves, {k: v.clone() for k, v in stats.items()}, xm, xl,
                             mask, eps, training)
    assert got[0].dtype == want[0].dtype == BF16
    for a, b in zip(got[:3], want[:3]):
        assert rel(a, b) <= FORWARD_TOL
    if not training:
        return
    for k in want[3]:
        assert rel(got[3][k], want[3][k]) <= FORWARD_TOL, k
    loss = elbo_fleet(got[0].float(), xm, got[1].float(), got[2].float(), 0.5, mask)[0]
    ref_loss = model.elbo(want[0].float(), xm, want[1].float(), want[2].float(), 0.5, mask)[0]
    grads = torch.autograd.grad(loss.sum(), list(leaves.values()))
    ref_grads = torch.autograd.grad(ref_loss.sum(), [ref_leaves[k] for k in leaves])
    ahead_of_bn = {f"{c}.bias" for c in ("micro_c1", "micro_c2", "micro_c3", "lesion_c1",
                                         "lesion_c2", "dec_t1", "dec_t2")}
    for k, a, b in zip(leaves, grads, ref_grads):
        assert a.dtype == b.dtype, k
        if k not in ahead_of_bn:
            assert rel(a, b) <= GRAD_TOL, k


def test_the_bfloat16_cells_faults_read_as_numbers():
    """The tiny bfloat16 fleet: the reference with the store rounding to
    nearest, and the float8 control, give finite readings; the control reads
    above the program."""
    from portbench.jobs import fleet as fleet_job

    config = json.loads((ROOT / "portbench/configs/lcvae-fleet-bf16.json").read_text())
    config.update(seq_len=16, epochs=2, batch_size=16)
    traffic = {"groups": {"Sham": 1, "TBI": 1, "PTE": 1}, "streamlines": 10,
               "loop": "closed", "tracts": 1, "timepoints": ["2d", "9d"], "check_members": 2}
    seed = 2 ** 33 + 5
    job = fleet_job.Job(config, traffic, seed, "cpu")
    js = inputs.job_seed(seed, 0)
    program = job.readings(job.run(js), js)
    nearest = job.readings(job.reference(js, fault="nearest_store"), js)
    control = job.readings(job.reference(js, job.control), js)
    job.release()
    for r in (program, nearest, control):
        assert all(np.isfinite(v) for v in r.values()), r
    assert control["hist1"] > 10 * program["hist1"]
    assert control["summary"] > 10 * program["summary"]
