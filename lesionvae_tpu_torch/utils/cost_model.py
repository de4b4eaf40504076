"""Static memory-traffic and FLOP model of one fleet training step (the
port of lesionvae_tpu/utils/cost_model.py).

It counts, per fleet step (one batch of all T members), the bytes the step
must move through device memory and the matrix FLOPs it must execute.
The counts are *the work the step must
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

The card: one NVIDIA H100 SXM at its 700 W limit, from NVIDIA's data sheet
(dense, no sparsity), not readings: 3.35 TB/s of HBM3, 989 TFLOP/s in bf16,
67 TFLOP/s in float32 outside the tensor cores (the port computes float32
with TF32 off), 132 SMs, each issuing 128 FP32 lanes and 16 special-function
lanes a clock at the 1.98 GHz boost clock.  This module is the one place
that holds them: every kernel's least time is ``kernel_bound_ms`` over the
kernel's own counts.  The key names are the JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch

H100_HBM_GBPS = 3350.0
H100_BF16_TFLOPS = 989.0
H100_FP32_TFLOPS = 67.0
H100_SMS = 132
H100_ISSUE_LANES = 128     # FP32 lanes an SM issues a clock: 4 schedulers x 32
H100_SFU_LANES = 16        # special-function lanes an SM a clock
H100_CLOCK_GHZ = 1.98      # boost clock


def peak_tflops(compute_dtype: Optional[torch.dtype]) -> float:
    """The card's peak for the step's matrix products."""
    return H100_BF16_TFLOPS if compute_dtype == torch.bfloat16 else H100_FP32_TFLOPS


def _bytes_ms(nbytes: float) -> float:
    return 1e3 * nbytes / (H100_HBM_GBPS * 1e9)


def _ops_ms(ops: float, compute_dtype: Optional[torch.dtype] = None) -> float:
    return 1e3 * ops / (peak_tflops(compute_dtype) * 1e12)


def kernel_bound_ms(nbytes: float, ops: float, instructions: Optional[float] = None,
                    special: float = 0.0,
                    compute_dtype: Optional[torch.dtype] = None) -> dict:
    """The least time of a kernel's work on the card, from the kernel's own
    counts: ``nbytes`` of device memory, ``ops`` operations (FP32, or the
    compute dtype's), and where the kernel has them its least
    ``instructions`` (a lane's issue slot each) and ``special``-function
    operations.  ``bound_ms``: the larger of the bytes over the bandwidth
    and the operations over the peak, ``bound_by`` the larger ("bytes" on a
    tie).  ``issue_bound_ms``: the larger of the same bytes, the special
    operations over SMs x 16 lanes x the clock and the instructions over
    SMs x 128 lanes x the clock; None without an instruction count."""
    t_bytes, t_ops = _bytes_ms(nbytes), _ops_ms(ops, compute_dtype)
    issue = None
    if instructions is not None:
        clock = H100_CLOCK_GHZ * 1e9
        issue = max(t_bytes, 1e3 * special / (H100_SMS * H100_SFU_LANES * clock),
                    1e3 * instructions / (H100_SMS * H100_ISSUE_LANES * clock))
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "operations" if t_ops > t_bytes else "bytes",
            "issue_bound_ms": issue}


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
    card's peak for the compute dtype (``peak_tflops``)."""
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


def optimizer_bytes(T: int, seq_len: int = 100, micro_ch: int = 13,
                    lesion_ch: int = 3, latent: int = 10,
                    store_dtype: Optional[torch.dtype] = torch.bfloat16) -> dict:
    """The least device-memory bytes of the fleet step's optimizer kernels
    for T members.  ``grad_sq_norm`` (``ops/csrc/adam.cu``): every leaf's
    gradient read once and written once into the packed rows, the weight
    leaves in the storage dtype, the BatchNorm leaves in float32.  The
    update: g, p, m, v read and p, m, v written once (``fleet_step_cost``'s
    ``optimizer``), split into the weight buffer (``adam_step`` with float32
    storage, ``sr_adam`` with bfloat16) and the affine buffer
    (``adam_step``)."""
    w_b, o_b, _ = _param_bytes(seq_len, micro_ch, lesion_ch, latent, store_dtype)
    return {"grad_sq_norm": T * 2 * (w_b + o_b), "update_weights": T * 7 * w_b,
            "update_affine": T * 7 * o_b, "optimizer": T * 7 * (w_b + o_b)}


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
    return {"layers": layers, **out, "forward_ms": _bytes_ms(out["forward_bytes"]),
            "backward_ms": _bytes_ms(out["backward_bytes"])}


def conv_layers(seq_len: int = 100, micro_ch: int = 13, lesion_ch: int = 3) -> dict:
    """The fleet step's eight convolutions, k = 5 (models/fleet.py::
    fleet_forward): {name: (length, C_in, C_out, transposed)}.  micro_c1 and
    lesion_c1 take the input data, so their backward has no input gradient
    (``CONV_INPUT_LAYERS``)."""
    L = seq_len
    return {"micro_c1": (L, micro_ch, 64, False), "micro_c2": (L // 2, 64, 128, False),
            "micro_c3": (L // 4, 128, 128, False), "lesion_c1": (L, lesion_ch, 32, False),
            "lesion_c2": (L // 2, 32, 64, False), "dec_t1": (L // 8, 128, 64, True),
            "dec_t2": (2 * (L // 8), 64, 64, True),
            "dec_t3": (4 * (L // 8), 64, micro_ch, True)}


CONV_INPUT_LAYERS = ("micro_c1", "lesion_c1")
CONV_PASSES = ("forward", "dx", "dw")


def conv_flops(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
               lesion_ch: int = 3) -> dict:
    """FLOPs of the step's convolutions for T members (a multiply-add is 2):
    by layer, each pass (forward; dx, none for the input layers; dw), and
    summed by pass and in all."""
    layers = {}
    for name, (L, cin, cout, _t) in conv_layers(seq_len, micro_ch, lesion_ch).items():
        f = 2 * T * batch_size * L * cin * cout * 5
        layers[name] = {"forward": f, "dx": 0 if name in CONV_INPUT_LAYERS else f, "dw": f}
    out = {p: sum(v[p] for v in layers.values()) for p in CONV_PASSES}
    return {"layers": layers, **out, "total": sum(out.values())}


def conv_bytes(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
               lesion_ch: int = 3, compute_dtype: Optional[torch.dtype] = None) -> dict:
    """The least device-memory bytes of the step's convolutions
    (``ops/csrc/conv1d.cu``) for T members, each input read once and each
    output written once, in the compute dtype (bfloat16 with
    ``compute_dtype`` bf16, else float32): forward x, w, b in and y out; dx
    dy and w in and dx out; dw x and dy in, dw and db out.  By layer and
    pass, and summed."""
    item = 2 if compute_dtype == torch.bfloat16 else 4
    layers = {}
    for name, (L, cin, cout, _t) in conv_layers(seq_len, micro_ch, lesion_ch).items():
        x, y = T * batch_size * L * cin, T * batch_size * L * cout
        w, b = T * cin * cout * 5, T * cout
        layers[name] = {"forward": item * (x + w + b + y),
                        "dx": 0 if name in CONV_INPUT_LAYERS else item * (y + w + x),
                        "dw": item * (x + y + w + b)}
    out = {p: sum(v[p] for v in layers.values()) for p in CONV_PASSES}
    return {"layers": layers, **out, "total": sum(out.values())}


def conv_bound_ms(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
                  lesion_ch: int = 3, compute_dtype: Optional[torch.dtype] = None) -> dict:
    """The least time of the step's convolutions on an H100 SXM: each layer's
    pass ``kernel_bound_ms`` of its bytes (``conv_bytes``) and its FLOPs
    (``conv_flops``) at the compute dtype's peak; by layer and pass, summed
    by pass, ``bound_ms`` over every pass, the two terms summed over every
    pass (``flops_ms``, ``bytes_ms``) and ``bound_by`` the larger."""
    flops = conv_flops(T, batch_size, seq_len, micro_ch, lesion_ch)
    nbytes = conv_bytes(T, batch_size, seq_len, micro_ch, lesion_ch, compute_dtype)
    layers = {name: {p: kernel_bound_ms(nbytes["layers"][name][p], f[p],
                                        compute_dtype=compute_dtype)["bound_ms"]
                     for p in CONV_PASSES}
              for name, f in flops["layers"].items()}
    out = {p: sum(v[p] for v in layers.values()) for p in CONV_PASSES}
    return {"layers": layers, **out, "bound_ms": sum(out.values()),
            "flops_ms": _ops_ms(flops["total"], compute_dtype),
            "bytes_ms": _bytes_ms(nbytes["total"]),
            "bound_by": kernel_bound_ms(nbytes["total"], flops["total"],
                                        compute_dtype=compute_dtype)["bound_by"]}
