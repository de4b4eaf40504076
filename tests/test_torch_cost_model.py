"""The port's cost model (``utils/cost_model.py``) and launch ledger
(``train.batched.FLEET_LAUNCH_LEDGER``) against the JAX package's
(tests/test_cost_model.py): the same bytes in every category, FLOPs and
parameters a member from the port's own layout; the same member-steps from
the port's ledger of a single, a 4-chunk and a mesh launch; only the peaks
differ, and they are the H100's."""

import jax
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


def test_traffic_summary_uses_the_h100_peaks():
    cost = tcm.fleet_step_cost(T=64)
    s = tcm.traffic_summary(cost, n_steps=600, device_s=7.0)
    w = jcm.traffic_summary(jcm.fleet_step_cost(T=64), n_steps=600, device_s=7.0)
    assert s["fleet_bytes_per_step_mb"] == w["fleet_bytes_per_step_mb"]
    assert s["fleet_hbm_gbps"] == w["fleet_hbm_gbps"]
    assert s["fleet_hbm_frac_peak"] == round(s["fleet_hbm_gbps"] / 3350.0, 3)
    tf = cost["flops_total"] * 600 / 1e12
    assert s["fleet_mfu"] == round(tf / 7.0 / 989.0, 4)
    f32 = tcm.fleet_step_cost(T=64, store_dtype=torch.float32, compute_dtype=torch.float32)
    assert tcm.traffic_summary(f32, 600, 7.0)["fleet_mfu"] == round(
        f32["flops_total"] * 600 / 1e12 / 7.0 / 67.0, 4)


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


def _jax_fields(ledger, device_s):
    """The JAX reader over the same launches (its ledger holds avals)."""
    jledger = [(None, tuple(jax.ShapeDtypeStruct(s.shape, jnp.dtype(s.dtype)) for s in specs))
               for _name, specs in ledger]
    return jcm.bench_traffic_fields(jledger, 3, 8, jnp.bfloat16, jnp.bfloat16, device_s,
                                    latent=2)


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


@pytest.mark.parametrize("form", ["one", "chunks", "mesh"])
def test_bench_traffic_fields_from_the_ledger(form):
    if form == "mesh":
        ledger = [e for r in range(4) for e in _ledger_of(mesh=Mesh(4, 1, r, "cpu"))]
    else:
        ledger = _ledger_of(upload_chunks=4 if form == "chunks" else 1)
    got = tcm.bench_traffic_fields(ledger, 3, 8, torch.bfloat16, torch.bfloat16, 0.5,
                                   latent=2)
    want = _jax_fields(ledger, 0.5)
    per_member = tcm.fleet_step_cost(1, seq_len=8, micro_ch=3, lesion_ch=2,
                                     latent=2, batch_size=8)["bytes_total"]
    member_steps = 4 * 3 * 2          # 4 members x 3 epochs x 16 / 8 steps
    assert got["fleet_traffic_gb"] == want["fleet_traffic_gb"] == round(
        per_member * member_steps / 1e9, 1)
    assert got["fleet_hbm_gbps"] == want["fleet_hbm_gbps"]
    assert got["fleet_hbm_frac_peak"] == round(got["fleet_hbm_gbps"] / 3350.0, 3)
    assert tcm.bench_traffic_fields([], 3, 8, torch.bfloat16, torch.bfloat16, 1.0) == {}
    assert tcm.bench_traffic_fields(ledger, 3, 8, torch.bfloat16, torch.bfloat16, 0.0) == {}
