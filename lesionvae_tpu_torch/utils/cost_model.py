"""Static memory-traffic and FLOP model of one fleet training step (the
port of lesionvae_tpu/utils/cost_model.py).

It counts, per fleet step (one batch of all T members), the bytes the step
must move through device memory and the matrix FLOPs it must execute, so

    achieved GB/s = bytes_per_step * n_steps / measured fleet device seconds

can sit next to the card's peaks.  The counts are *the work the step must
do*, walked as the JAX package walks it (its layer list, one round trip a
fusion-boundary tensor), not what the eager port moves: the port runs more,
smaller kernels and writes more intermediates than that.

- **Parameter streams** come from the port's own layout
  (``models.fleet.layout`` and ``is_weight_leaf``): the weight leaves in the
  storage dtype, the BatchNorm scales and shifts in float32; forward read +
  backward read + gradient write + optimizer (read g, p, m, v; write p, m, v).
- **Activation streams**: each fusion-boundary tensor (conv / dense / pool /
  upsample outputs) once for the forward write, once for the backward read
  and once each for the gradient's write and read.
- **Data gather**: ``batch_size`` rows of the float32 blocks a step.
- **FLOPs**: matrix and convolution MACs x 2 (forward) x 3 (forward +
  backward).

Peaks: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet
(dense, no sparsity), not readings: 3.35 TB/s of HBM3, 989 TFLOP/s in bf16,
67 TFLOP/s in float32 outside the tensor cores (the port computes float32
with TF32 off).  The key names are the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch

H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0
H100_FP32_TFLOPS = 67.0


def peak_tflops(compute_dtype: Optional[torch.dtype]) -> float:
    """The card's peak for the step's matrix products."""
    return H100_BF16_TFLOPS if compute_dtype == torch.bfloat16 else H100_FP32_TFLOPS


def _param_bytes(seq_len, micro_ch, lesion_ch, latent, store_dtype):
    """(weight-leaf bytes, other float32 bytes, parameters) of one member."""
    from ..models.fleet import is_weight_leaf, layout

    lay = layout(seq_len, micro_ch, lesion_ch, latent)
    w_elems = o_elems = 0
    for name, (_which, _off, shape) in lay.leaves.items():
        n = 1
        for s in shape:
            n *= s
        if is_weight_leaf(name, lay):
            w_elems += n
        else:
            o_elems += n
    w_itemsize = 2 if store_dtype == torch.bfloat16 else 4
    return w_elems * w_itemsize, o_elems * 4, w_elems + o_elems


def _activation_elems(seq_len, micro_ch, lesion_ch, latent):
    """Fusion-boundary activation elements per sample for one forward pass,
    over the layers of models/lesion_vae.py."""
    L = seq_len
    acts = 0
    for lo, c in ((L, 64), (L // 2, 128), (L // 4, 128)):     # micro encoder
        acts += lo * c + (lo // 2) * c
    for lo, c in ((L, 32), (L // 2, 64)):                     # lesion encoder
        acts += lo * c + (lo // 2) * c
    h_les = (L // 4) * 64
    h = (L // 8) * 128 + h_les        # concatenated encoder features
    acts += h + 3 * latent            # mu, logv, z
    acts += (L // 8) * 128            # fc_dec out
    for lo, c in ((L // 8, 64), (L // 4, 64), (L // 2, 13)):  # convT + upsample
        acts += lo * c + 2 * lo * c
    acts += L * 13                    # final resize + reconstruction terms
    return acts


def _matmul_flops(seq_len, micro_ch, lesion_ch, latent):
    """Forward conv / dense MACs x 2 per sample (k = 5 convolutions)."""
    L, k = seq_len, 5
    f = 0
    for lo, ci, co in ((L, micro_ch, 64), (L // 2, 64, 128), (L // 4, 128, 128),
                       (L, lesion_ch, 32), (L // 2, 32, 64)):
        f += 2 * lo * k * ci * co
    h_in = (L // 8) * 128 + (L // 4) * 64
    f += 2 * 2 * h_in * latent                                # fc_mu, fc_logv
    f += 2 * (latent + (L // 4) * 64) * ((L // 8) * 128)      # fc_dec
    for lo, ci, co in ((L // 8, 128, 64), (L // 4, 64, 64), (L // 2, 64, 13)):
        f += 2 * lo * k * ci * co
    return f


def fleet_step_cost(T: int, seq_len: int = 100, micro_ch: int = 13,
                    lesion_ch: int = 3, latent: int = 10, batch_size: int = 64,
                    store_dtype: Optional[torch.dtype] = torch.bfloat16,
                    compute_dtype: Optional[torch.dtype] = torch.bfloat16) -> dict:
    """Bytes and FLOPs of ONE fleet step (one batch of T members): bytes by
    category, their total, the FLOPs, the parameters of a member and the
    card's peak for the compute dtype (``peak_tflops``).  Feed it to
    ``traffic_summary`` with the measured device seconds."""
    w_b, o_b, n_params = _param_bytes(seq_len, micro_ch, lesion_ch, latent,
                                      store_dtype)
    p_b = w_b + o_b
    act_itemsize = 2 if compute_dtype == torch.bfloat16 else 4
    act_b = (_activation_elems(seq_len, micro_ch, lesion_ch, latent)
             * act_itemsize * batch_size)
    per_member = {
        "weights_fwd_bwd": 2 * p_b + p_b,
        "optimizer": p_b + 3 * p_b + 3 * p_b,
        "activations": 4 * act_b,
        "data_gather": batch_size * seq_len * (micro_ch + lesion_ch) * 4,
    }
    bytes_step = {k: v * T for k, v in per_member.items()}
    flops_step = (3 * _matmul_flops(seq_len, micro_ch, lesion_ch, latent)
                  * batch_size * T)
    return {"bytes_by_category": bytes_step,
            "bytes_total": float(sum(bytes_step.values())),
            "flops_total": float(flops_step),
            "params_per_member": int(n_params),
            "peak_tflops": peak_tflops(compute_dtype)}


def bn_layers(seq_len: int = 100) -> dict:
    """The fleet step's seven masked BatchNorm layers, each followed by a
    ReLU (models/fleet.py::fleet_forward): {name: (length, channels)}."""
    L = seq_len
    return {"micro_b1": (L, 64), "micro_b2": (L // 2, 128), "micro_b3": (L // 4, 128),
            "lesion_b1": (L, 32), "lesion_b2": (L // 2, 64),
            "dec_b1": (L // 8, 64), "dec_b2": (2 * (L // 8), 64)}


def masked_bn_bytes(T: int, batch_size: int = 64, seq_len: int = 100,
                    compute_dtype: Optional[torch.dtype] = None) -> dict:
    """The least device-memory bytes of the step's masked BatchNorm + ReLU
    layers (``ops/csrc/masked_bn.cu``) for T members: forward x read and y
    written once, backward x and dy read and dx written once, in the
    activations' dtype (bfloat16 with ``compute_dtype`` bf16, else float32);
    the (T, C) statistics and parameters are left out.  By layer and summed,
    with the time those bytes take at the card's bandwidth."""
    item = 2 if compute_dtype == torch.bfloat16 else 4
    layers = {}
    for name, (L, C) in bn_layers(seq_len).items():
        n = T * batch_size * L * C
        layers[name] = {"length": L, "channels": C, "elements": n,
                        "forward_bytes": 2 * item * n, "backward_bytes": 3 * item * n}
    out = {key: sum(v[key] for v in layers.values())
           for key in ("elements", "forward_bytes", "backward_bytes")}
    rate = H100_HBM_GBPS * 1e9
    return {"layers": layers, **out, "forward_ms": 1e3 * out["forward_bytes"] / rate,
            "backward_ms": 1e3 * out["backward_bytes"] / rate}


def traffic_summary(cost: dict, n_steps: int, device_s: float) -> dict:
    """Achieved bandwidth and MFU against the H100's peaks."""
    gb = cost["bytes_total"] * n_steps / 1e9
    tf = cost["flops_total"] * n_steps / 1e12
    gbps = gb / device_s if device_s > 0 else 0.0
    tfps = tf / device_s if device_s > 0 else 0.0
    return {
        "fleet_bytes_per_step_mb": round(cost["bytes_total"] / 1e6, 1),
        "fleet_hbm_gbps": round(gbps, 1),
        "fleet_hbm_frac_peak": round(gbps / H100_HBM_GBPS, 3),
        "fleet_mfu": round(tfps / cost["peak_tflops"], 4),
    }


def bench_traffic_fields(ledger, epochs: int, batch_size: int, store_dtype,
                         compute_dtype, fleet_device_s: float,
                         latent: int = 10) -> dict:
    """Traffic fields from a ``train.batched.FLEET_LAUNCH_LEDGER`` capture.

    Each entry is one block launch; its staged arguments carry the member
    count (Tc), the row padding (n_pad, which fixes the steps an epoch) and
    the tensor widths, so the member-steps run are exact however the fleet
    was split into chunks, blocks or mesh ranks."""
    if not ledger or fleet_device_s <= 0:
        return {}
    member_steps = 0
    for _prog, specs in ledger:
        Tc, n_pad = specs[0].shape[0], specs[0].shape[1]
        member_steps += Tc * epochs * max(1, n_pad // batch_size)
    seq_len, micro_ch = ledger[0][1][0].shape[2], ledger[0][1][0].shape[3]
    lesion_ch = ledger[0][1][1].shape[3]
    cost = fleet_step_cost(T=1, seq_len=seq_len, micro_ch=micro_ch,
                           lesion_ch=lesion_ch, latent=latent,
                           batch_size=batch_size, store_dtype=store_dtype,
                           compute_dtype=compute_dtype)
    gb = cost["bytes_total"] * member_steps / 1e9
    tf = cost["flops_total"] * member_steps / 1e12
    return {
        "fleet_traffic_gb": round(gb, 1),
        "fleet_hbm_gbps": round(gb / fleet_device_s, 1),
        "fleet_hbm_frac_peak": round(gb / fleet_device_s / H100_HBM_GBPS, 3),
        "fleet_mfu": round(tf / fleet_device_s / cost["peak_tflops"], 4),
    }
