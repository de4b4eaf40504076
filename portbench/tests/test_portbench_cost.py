"""The frozen counts (``portbench/cost/counts.py``) against the program's
cost model, at both cells' shapes, wherever the two count the same thing."""

import pytest
import torch

from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.utils import cost_model as m
from portbench.cost import counts as c

SHAPES = [(64, 64), (1, 64), (64, 256), (64, 192), (1, 925)]   # (members, rows)


def test_parameters_match_the_model():
    par = c.parameters()
    assert par["total"] == sum(p.numel() for p in LesionConditionedVAE().parameters()) == 2742241
    assert par["total"] == m.fleet_step_cost(1)["params_per_member"]


@pytest.mark.parametrize("T,rows", SHAPES)
def test_conv_counts_match(T, rows):
    assert c.conv_flops(T, rows) == m.conv_flops(T, rows)
    assert c.conv_bytes(T, rows) == m.conv_bytes(T, rows)
    ours, theirs = c.conv_bound_ms(T, rows), m.conv_bound_ms(T, rows)
    assert ours["bound_ms"] == pytest.approx(theirs["bound_ms"], rel=1e-12)
    assert ours["forward"] == pytest.approx(theirs["forward"], rel=1e-12)
    assert ours["bound_by"] == theirs["bound_by"]
    assert c.conv_bound_ms(T, rows, compute="bfloat16")["bound_ms"] == pytest.approx(
        m.conv_bound_ms(T, rows, compute_dtype=torch.bfloat16)["bound_ms"], rel=1e-12)


@pytest.mark.parametrize("T,rows", SHAPES)
def test_masked_bn_bytes_match(T, rows):
    ours, theirs = c.masked_bn_bytes(T, rows), m.masked_bn_bytes(T, rows)
    for k in ("elements", "forward_bytes", "backward_bytes"):
        assert ours[k] == theirs[k]
    assert ours["forward_ms"] == pytest.approx(theirs["forward_ms"], rel=1e-12)


@pytest.mark.parametrize("T", [1, 64])
def test_optimizer_bytes_match(T):
    assert c.optimizer_bytes(T) == m.optimizer_bytes(T, store_dtype=None)
    assert c.optimizer_bytes(T, store="bfloat16") == m.optimizer_bytes(T)
    flat = c.flat_optimizer_bytes(c.parameters()["total"])
    one = m.optimizer_bytes(1, store_dtype=None)
    assert flat == {"grad_sq_norm": one["grad_sq_norm"], "optimizer": one["optimizer"]}


def test_step_flops_count_the_models_own_lengths():
    """The cost model's ``_matmul_flops`` runs the decoder's transposed
    convolutions at L // 4 = 25 and L // 2 = 50 where the model runs 2 x 12
    = 24 and 4 x 12 = 48; and it counts every layer three times, where a
    step has no input gradient for the two convolutions that take the data.
    The frozen count differs from it by exactly those terms."""
    B, k = 64, 5
    forward = c.forward_flops(1, 1)
    theirs = m._matmul_flops(100, 13, 3, 10)
    decoder = lambda l2, l3: 2 * k * (l2 * 64 * 64 + l3 * 64 * 13)  # noqa: E731
    assert theirs - forward == decoder(25, 50) - decoder(24, 48)
    input_dx = 2 * k * 100 * (13 * 64 + 3 * 32)
    assert c.step_flops(1, B) == B * (3 * forward - input_dx)
    assert c.step_flops(64, B) == pytest.approx(212.2317824e9, rel=1e-12)
    assert c.step_flops(1, B) == pytest.approx(3.3161216e9, rel=1e-12)
    assert c.forward_flops(1, 1, encoder_only=True) < forward
