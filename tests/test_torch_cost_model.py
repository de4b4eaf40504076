"""The port's cost model (``utils/cost_model.py``) and launch ledger
(``train.batched.FLEET_LAUNCH_LEDGER``) against the JAX package's
(tests/test_cost_model.py): the same bytes in every category, FLOPs and
parameters a member from the port's own layout, the H100's peaks; one
ledger entry a block launch of a single, a 4-chunk, a uint16 and a mesh
launch."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lesionvae_tpu.utils import cost_model as jcm
from lesionvae_tpu_torch.parallel.mesh import Mesh
from lesionvae_tpu_torch.train import batched as tb
from lesionvae_tpu_torch.utils import cost_model as tcm

torch.set_num_threads(1)

DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32, jnp.float32)}


@pytest.mark.parametrize("store", ["bf16", "f32"])
@pytest.mark.parametrize("compute", ["bf16", "f32"])
@pytest.mark.parametrize("T,dims", [(1, {}), (64, {}),
                                    (3, dict(seq_len=12, micro_ch=3, lesion_ch=2, latent=2))])
def test_fleet_step_cost_matches_jax(store, compute, T, dims):
    got = tcm.fleet_step_cost(T, store_dtype=DTYPES[store][0],
                              compute_dtype=DTYPES[compute][0], **dims)
    want = jcm.fleet_step_cost(T, store_dtype=DTYPES[store][1],
                               compute_dtype=DTYPES[compute][1], **dims)
    assert got["bytes_by_category"] == want["bytes_by_category"]
    assert got["bytes_total"] == want["bytes_total"]
    assert got["flops_total"] == want["flops_total"]
    assert got["params_per_member"] == want["params_per_member"]
    assert got["peak_tflops"] == (989.0 if compute == "bf16" else 67.0)


# the seven BatchNorm + ReLU layers of the step at full width (seq 100), L x C
BN_SHAPES = {"micro_b1": (100, 64), "micro_b2": (50, 128), "micro_b3": (25, 128),
             "lesion_b1": (100, 32), "lesion_b2": (50, 64), "dec_b1": (12, 64),
             "dec_b2": (24, 64)}


@pytest.mark.parametrize("compute,item", [("f32", 4), ("bf16", 2)])
def test_masked_bn_bytes_of_the_seven_layers(compute, item):
    """64 members x batch 64: 101.2 M elements, 404.8 MB a pass in float32;
    the forward moves two passes (x in, y out), the backward three (x and
    dy in, dx out): 0.242 and 0.362 ms at 3.35 TB/s in float32."""
    from lesionvae_tpu_torch.models.fleet import layout

    got = tcm.masked_bn_bytes(64, compute_dtype=DTYPES[compute][0])
    assert {k: (v["length"], v["channels"]) for k, v in got["layers"].items()} == BN_SHAPES
    for name, (L, C) in BN_SHAPES.items():
        n = 64 * 64 * L * C
        assert got["layers"][name]["elements"] == n
        assert got["layers"][name]["forward_bytes"] == 2 * item * n
        assert got["layers"][name]["backward_bytes"] == 3 * item * n
    # the widths are the model's own
    stats = layout(100, 13, 3, 10).stats
    assert all(stats[f"{k}.running_mean"] == (C,) for k, (_L, C) in BN_SHAPES.items())
    assert got["elements"] == 101_187_584
    assert got["forward_bytes"] == 2 * item * 101_187_584
    assert got["backward_bytes"] == 3 * item * 101_187_584
    assert got["forward_ms"] == pytest.approx(2 * item * 101_187_584 / 3.35e9)
    if compute == "f32":
        assert got["forward_ms"] == pytest.approx(0.2416, abs=1e-4)
        assert got["backward_ms"] == pytest.approx(0.3624, abs=1e-4)


@pytest.mark.parametrize("store,item", [("f32", 4), ("bf16", 2)])
def test_optimizer_bytes_of_the_two_kernels(store, item):
    """64 members at full width (2,741,153 weight and 1,088 BatchNorm
    elements a member): the gather reads and writes each gradient once, in
    the storage dtype for the weights and in float32 for the BatchNorm
    leaves; the update is the step's ``optimizer`` category, the JAX
    package's count; both equal the wrappers' own counts on tensors of the
    path's shapes."""
    from lesionvae_tpu_torch.models.fleet import layout
    from lesionvae_tpu_torch.ops import adam

    dtype = DTYPES[store][0]
    got = tcm.optimizer_bytes(64, store_dtype=dtype)
    w, a = 2_741_153, 1_088
    assert got["grad_sq_norm"] == 64 * 2 * (item * w + 4 * a)
    assert got["update_weights"] == 64 * 7 * item * w
    assert got["update_affine"] == 64 * 7 * 4 * a
    assert got["optimizer"] == got["update_weights"] + got["update_affine"]
    want = jcm.fleet_step_cost(64, store_dtype=DTYPES[store][1])["bytes_by_category"]
    assert got["optimizer"] == want["optimizer"]
    lay = layout(100, 13, 3, 10)
    grads = [torch.empty((64, *shape), device="meta",
                         dtype=dtype if which == "weights" else torch.float32)
             for which, _off, shape in lay.leaves.values()]
    assert adam.norm_bytes(grads, grads) == got["grad_sq_norm"]
    assert adam.norm_bytes(grads, [None] * len(grads)) == got["grad_sq_norm"] // 2
    if store == "f32":
        bound = adam.adam_bound_ms(64 * w)
        assert bound["bound_by"] == "bytes"
        assert bound["bound_ms"] == pytest.approx(1e3 * got["update_weights"] / 3.35e12)
        assert bound["bound_ms"] == pytest.approx(1.4663, abs=1e-4)
        # 35 instructions an element at 132 SMs x 128 lanes x 1.98 GHz issue
        # in 0.18 ms: the bytes set the issue bound too
        assert 1e3 * 35 * 64 * w / (132 * 128 * 1.98e9) == pytest.approx(0.1835, abs=1e-4)
        assert bound["issue_bound_ms"] == bound["bound_ms"]
        norm = adam.norm_bound_ms(grads, grads)
        assert norm["bound_ms"] == pytest.approx(1e3 * got["grad_sq_norm"] / 3.35e12)
        assert norm["issue_bound_ms"] == norm["bound_ms"]


# the H100 SXM data sheet's figures, written out: HBM3 bytes/s, FP32 and bf16
# FLOP/s, SMs, FP32 and special-function lanes an SM a clock, boost clock
HBM, FP32, BF16, SMS, LANES, SFU, CLOCK = 3.35e12, 67e12, 989e12, 132, 128, 16, 1.98e9


def _formula(nbytes, ops, instructions=None, special=0.0, peak=FP32):
    """max(bytes / bandwidth, operations / peak) and the issue bound,
    max(bytes / bandwidth, special / (SMs x 16 x clock), instructions /
    (SMs x 128 x clock)), in ms."""
    t_bytes, t_ops = 1e3 * nbytes / HBM, 1e3 * ops / peak
    issue = None if instructions is None else max(
        t_bytes, 1e3 * special / (SMS * SFU * CLOCK),
        1e3 * instructions / (SMS * LANES * CLOCK))
    return max(t_bytes, t_ops), ("operations" if t_ops > t_bytes else "bytes"), issue


def test_the_card_is_the_data_sheet():
    assert (tcm.H100_HBM_GBPS * 1e9, tcm.H100_FP32_TFLOPS * 1e12,
            tcm.H100_BF16_TFLOPS * 1e12) == (HBM, FP32, BF16)
    assert (tcm.H100_SMS, tcm.H100_ISSUE_LANES, tcm.H100_SFU_LANES,
            tcm.H100_CLOCK_GHZ * 1e9) == (SMS, LANES, SFU, CLOCK)
    # a tie goes to the bytes; no instruction count, no issue bound
    assert tcm.kernel_bound_ms(HBM, FP32) == {"bound_ms": 1e3, "bound_by": "bytes",
                                              "issue_bound_ms": None}
    assert tcm.kernel_bound_ms(HBM, FP32 * 1.001)["bound_by"] == "operations"


def _kernel_cases():
    """{kernel: (its module's bound, [(bytes, operations, instructions,
    special, peak)] from the kernel's own counts)} at the paths' shapes."""
    from lesionvae_tpu_torch.benchmarks import opt_probe
    from lesionvae_tpu_torch.models.fleet import layout
    from lesionvae_tpu_torch.ops import adam, geometry, masked_bn, sr_adam

    el = 64 * 2_741_153
    lay = layout(100, 13, 3, 10)
    grads = [torch.empty((64, *shape), device="meta") for _w, _o, shape in lay.leaves.values()]
    g_el = sum(g.numel() for g in grads)
    bn = tcm.masked_bn_bytes(64)
    ins = masked_bn.MIN_INSTRUCTIONS
    bn_instr = {"forward": ins["stats0"] + ins["stats1"] + ins["apply"],
                "backward": ins["grad_sums"] + ins["grad_apply"]}
    lens = np.random.default_rng(64).integers(3, 65, size=4096)
    S, points = len(lens), int(lens.sum())
    out = {
        "adam_update": (adam.adam_bound_ms(el), [(
            adam.UPDATE_BYTES_PER_ELEMENT * el, adam.UPDATE_OPS_PER_ELEMENT * el,
            adam.UPDATE_MIN_INSTRUCTIONS * el, 0, FP32)]),
        "adam_norm": (adam.norm_bound_ms(grads, grads), [(
            2 * 4 * g_el, adam.NORM_OPS_PER_ELEMENT * g_el,
            (adam.NORM_OPS_PER_ELEMENT + 2) * g_el, 0, FP32)]),
        "sr_adam": (sr_adam.bound_ms(el), [(
            sr_adam.BYTES_PER_ELEMENT * el, sr_adam.OPS_PER_ELEMENT * el,
            sr_adam.MIN_INSTRUCTIONS_PER_ELEMENT * el, 0, FP32)]),
        "geometry_f32": (geometry.bound_ms(lens, 64), [(
            12 * points + 80 * S,
            geometry.OPS_PER_POINT * points + geometry.OPS_PER_STREAMLINE * S,
            geometry.ISSUE_PER_POINT * points + geometry.ISSUE_PER_STREAMLINE * S, 0, FP32)]),
        "geometry_u16": (geometry.bound_ms(lens, 64, u16=True), [(
            6 * (points - S) + 36 * S + 80 * S,
            geometry.OPS_PER_POINT_U16 * points + geometry.OPS_PER_STREAMLINE * S,
            geometry.ISSUE_PER_POINT_U16 * points + geometry.ISSUE_PER_STREAMLINE * S,
            0, FP32)]),
        "opt_probe_k30": (opt_probe.bound_ms(64 * 2867200, 30), [(
            opt_probe.BYTES_PER_ELEMENT * 64 * 2867200,
            opt_probe.OPS_PER_ELEMENT_STEP * 64 * 2867200 * 30,
            opt_probe.MIN_INSTRUCTIONS_PER_ELEMENT_STEP["ieee"] * 64 * 2867200 * 30,
            opt_probe.SFU_PER_ELEMENT_STEP["ieee"] * 64 * 2867200 * 30, FP32)]),
    }
    for part, ops in (("forward", masked_bn.OPS_FORWARD), ("backward", masked_bn.OPS_BACKWARD)):
        out[f"masked_bn_{part}"] = (masked_bn.bound_ms(64)[part], [(
            bn[f"{part}_bytes"], ops * bn["elements"], bn_instr[part] * bn["elements"], 0,
            FP32)])
    for dt, peak in (("f32", FP32), ("bf16", BF16)):
        dtype = DTYPES[dt][0] if dt == "bf16" else None
        flops, nbytes = tcm.conv_flops(64), tcm.conv_bytes(64, compute_dtype=dtype)
        out[f"conv_{dt}"] = (tcm.conv_bound_ms(64, compute_dtype=dtype), [
            (nbytes["layers"][name][p], flops["layers"][name][p], None, 0, peak)
            for name in flops["layers"] for p in tcm.CONV_PASSES])
    return out


@pytest.mark.parametrize("kernel", ["adam_update", "adam_norm", "sr_adam", "masked_bn_forward",
                                    "masked_bn_backward", "geometry_f32", "geometry_u16",
                                    "conv_f32", "conv_bf16", "opt_probe_k30"])
def test_kernel_bounds_are_the_one_formula(kernel):
    """Every kernel module's bound is the data sheet's formula over that
    kernel's own counts: a dict of the nominal bound, what sets it and the
    issue bound (the convolutions: summed over their layers' passes)."""
    got, counts = _kernel_cases()[kernel]
    want = [_formula(b, o, i, s, peak) for b, o, i, s, peak in counts]
    assert got["bound_ms"] == pytest.approx(sum(w[0] for w in want), rel=1e-12)
    if len(want) == 1:
        assert set(got) == {"bound_ms", "bound_by", "issue_bound_ms"}
        assert got["bound_by"] == want[0][1]
        assert got["issue_bound_ms"] == pytest.approx(want[0][2], rel=1e-12)
    else:
        f_ms = sum(1e3 * o / peak for _b, o, _i, _s, peak in counts)
        b_ms = sum(1e3 * b / HBM for b, *_rest in counts)
        assert (got["flops_ms"], got["bytes_ms"]) == (pytest.approx(f_ms, rel=1e-12),
                                                      pytest.approx(b_ms, rel=1e-12))
        assert got["bound_by"] == ("operations" if f_ms > b_ms else "bytes")


def _cohort(T=4, n=16, L=8):
    rng = np.random.default_rng(0)
    Xm = rng.normal(size=(T, n, L, 3)).astype(np.float32)
    Xl = rng.uniform(size=(T, n, L, 2)).astype(np.float32)
    sham = np.ones((T, n), np.float32)
    subj = np.zeros((T, n), np.int64)
    return Xm, Xl, np.full(T, n, np.int32), (sham, subj, 2, 3)


def _ledger_of(**kw):
    Xm, Xl, n_real, spec = _cohort()
    tb.reset_fleet_ledger()
    tb.launch_many_vaes(Xm, Xl, n_real, latent_dim=2, epochs=1, batch_size=8,
                        device="cpu", summary_spec=spec, **kw)
    return list(tb.FLEET_LAUNCH_LEDGER)


def test_ledger_records_one_entry_a_block_launch():
    one = _ledger_of()
    assert [name for name, _ in one] == ["fleet_train"]
    assert [s.shape for s in one[0][1]] == [(4, 16, 8, 3), (4, 16, 8, 2), (4,), (4, 16),
                                            (4, 16)]
    assert [s.dtype for s in one[0][1]] == ["float32", "float32", "int32", "float32",
                                            "int32"]
    chunks = _ledger_of(upload_chunks=4)
    assert len(chunks) == 4 and all(specs[0].shape[0] == 1 for _, specs in chunks)
    codes = _ledger_of(normalize_on_device=True, quantize_upload=True)
    assert codes[0][1][0].dtype == "uint16"
    # a mesh rank records its own block: four ranks' ledgers make the fleet
    ranks = []
    for r in range(4):
        ranks += _ledger_of(mesh=Mesh(4, 1, r, "cpu"))
    assert len(ranks) == 4 and all(specs[0].shape[0] == 1 for _, specs in ranks)
