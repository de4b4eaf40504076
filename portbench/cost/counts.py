"""Least-work counts of the lesion VAE's training step and eval forward on an
NVIDIA H100 SXM, from the shapes alone.

A frozen copy of ``lesionvae_tpu_torch/utils/cost_model.py`` (``conv_*``,
``bn_layers``, ``masked_bn_bytes``, ``optimizer_bytes``), with the parameter
counts worked out from the architecture here instead of the program's
layout, and with a whole-step FLOP count (``step_flops``) at the lengths
the model runs: the decoder's three transposed convolutions at L/8, L/4
and L/2 rounded as the model rounds them (12, 24, 48 for L = 100; the
program's ``_matmul_flops`` counts 12, 25, 50).

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense, no
sparsity: 3.35 TB/s of HBM3, 67 TFLOP/s in float32 outside the tensor cores
(every cell computes float32 with TF32 off), 989 TFLOP/s in bf16.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12
TAPS = 5

#: the two convolutions that take the data: no input gradient
CONV_INPUT_LAYERS = ("micro_c1", "lesion_c1")
CONV_PASSES = ("forward", "dx", "dw")
ENCODER_CONVS = ("micro_c1", "micro_c2", "micro_c3", "lesion_c1", "lesion_c2")


def peak_flops(compute: str = "float32") -> float:
    return BF16_FLOPS_PER_S if compute == "bfloat16" else FP32_FLOPS_PER_S


def itemsize(compute: str = "float32") -> int:
    return 2 if compute == "bfloat16" else 4


def conv_layers(seq_len: int = 100, micro_ch: int = 13, lesion_ch: int = 3) -> dict:
    """The eight convolutions, k = 5: {name: (length, C_in, C_out, transposed)}.
    The decoder's lengths are the model's: L // 8 doubled twice."""
    L, d = seq_len, seq_len // 8
    return {"micro_c1": (L, micro_ch, 64, False), "micro_c2": (L // 2, 64, 128, False),
            "micro_c3": (L // 4, 128, 128, False), "lesion_c1": (L, lesion_ch, 32, False),
            "lesion_c2": (L // 2, 32, 64, False), "dec_t1": (d, 128, 64, True),
            "dec_t2": (2 * d, 64, 64, True), "dec_t3": (4 * d, 64, micro_ch, True)}


def dense_layers(seq_len: int = 100, latent: int = 10) -> dict:
    """The three dense layers: {name: (d_in, d_out)}."""
    L = seq_len
    h_micro, h_lesion = 128 * (L // 8), 64 * (L // 4)
    return {"fc_mu": (h_micro + h_lesion, latent), "fc_logv": (h_micro + h_lesion, latent),
            "fc_dec": (latent + h_lesion, h_micro)}


def bn_layers(seq_len: int = 100) -> dict:
    """The seven masked BatchNorm layers, each followed by a ReLU:
    {name: (length, channels)}."""
    L = seq_len
    return {"micro_b1": (L, 64), "micro_b2": (L // 2, 128), "micro_b3": (L // 4, 128),
            "lesion_b1": (L, 32), "lesion_b2": (L // 2, 64),
            "dec_b1": (L // 8, 64), "dec_b2": (2 * (L // 8), 64)}


def parameters(seq_len: int = 100, micro_ch: int = 13, lesion_ch: int = 3,
               latent: int = 10) -> dict:
    """One VAE's parameters: the convolution and dense leaves ("weights"),
    the BatchNorm scales and shifts ("affine") and their sum."""
    w = sum(cin * cout * TAPS + cout
            for _L, cin, cout, _t in conv_layers(seq_len, micro_ch, lesion_ch).values())
    w += sum(i * o + o for i, o in dense_layers(seq_len, latent).values())
    a = sum(2 * c for _L, c in bn_layers(seq_len).values())
    return {"weights": w, "affine": a, "total": w + a}


def conv_flops(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
               lesion_ch: int = 3) -> dict:
    """FLOPs of the convolutions of T members' training step of ``batch_size``
    rows (a multiply-add is 2): by layer and pass (forward; dx, none for the
    input layers; dw), summed by pass and in all."""
    layers = {}
    for name, (L, cin, cout, _t) in conv_layers(seq_len, micro_ch, lesion_ch).items():
        f = 2 * T * batch_size * L * cin * cout * TAPS
        layers[name] = {"forward": f, "dx": 0 if name in CONV_INPUT_LAYERS else f, "dw": f}
    out = {p: sum(v[p] for v in layers.values()) for p in CONV_PASSES}
    return {"layers": layers, **out, "total": sum(out.values())}


def conv_bytes(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
               lesion_ch: int = 3, compute: str = "float32") -> dict:
    """The least device-memory bytes of the convolutions, each input read
    once and each output written once: forward x, w, b in and y out; dx: dy
    and w in, dx out; dw: x and dy in, dw and db out."""
    item = itemsize(compute)
    layers = {}
    for name, (L, cin, cout, _t) in conv_layers(seq_len, micro_ch, lesion_ch).items():
        x, y = T * batch_size * L * cin, T * batch_size * L * cout
        w, b = T * cin * cout * TAPS, T * cout
        layers[name] = {"forward": item * (x + w + b + y),
                        "dx": 0 if name in CONV_INPUT_LAYERS else item * (y + w + x),
                        "dw": item * (x + y + w + b)}
    out = {p: sum(v[p] for v in layers.values()) for p in CONV_PASSES}
    return {"layers": layers, **out, "total": sum(out.values())}


def conv_bound_ms(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
                  lesion_ch: int = 3, compute: str = "float32") -> dict:
    """The least time of the convolutions: each layer's pass the larger of
    its bytes over the bandwidth and its FLOPs over the peak; by layer and
    pass, summed by pass, ``bound_ms`` over every pass, and ``bound_by`` the
    term that is larger in the sum."""
    flops = conv_flops(T, batch_size, seq_len, micro_ch, lesion_ch)
    nbytes = conv_bytes(T, batch_size, seq_len, micro_ch, lesion_ch, compute)
    peak = peak_flops(compute)
    layers, t_ops, t_bytes = {}, 0.0, 0.0
    for name in flops["layers"]:
        layers[name] = {}
        for p in CONV_PASSES:
            f_ms = 1e3 * flops["layers"][name][p] / peak
            b_ms = 1e3 * nbytes["layers"][name][p] / HBM_BYTES_PER_S
            layers[name][p] = max(f_ms, b_ms)
            t_ops += f_ms
            t_bytes += b_ms
    out = {p: sum(v[p] for v in layers.values()) for p in CONV_PASSES}
    return {"layers": layers, **out, "bound_ms": sum(out.values()),
            "flops_ms": t_ops, "bytes_ms": t_bytes,
            "bound_by": "operations" if t_ops > t_bytes else "bytes"}


def masked_bn_bytes(T: int, batch_size: int = 64, seq_len: int = 100,
                    compute: str = "float32") -> dict:
    """The least device-memory bytes of the masked BatchNorm + ReLU layers:
    forward x read and y written once, backward x and dy read and dx
    written once; the (T, C) statistics and parameters left out.  An eval
    forward is one apply: the forward's bytes."""
    item = itemsize(compute)
    layers = {}
    for name, (L, C) in bn_layers(seq_len).items():
        n = T * batch_size * L * C
        layers[name] = {"length": L, "channels": C, "elements": n,
                        "forward_bytes": 2 * item * n, "backward_bytes": 3 * item * n}
    out = {key: sum(v[key] for v in layers.values())
           for key in ("elements", "forward_bytes", "backward_bytes")}
    return {"layers": layers, **out,
            "forward_ms": 1e3 * out["forward_bytes"] / HBM_BYTES_PER_S,
            "backward_ms": 1e3 * out["backward_bytes"] / HBM_BYTES_PER_S}


def optimizer_bytes(T: int, seq_len: int = 100, micro_ch: int = 13, lesion_ch: int = 3,
                    latent: int = 10, store: str = "float32") -> dict:
    """The least device-memory bytes of one optimizer step of T members: the
    gather with the norm (every gradient element read once and written once
    into the packed rows: weights in the storage dtype, BatchNorm leaves in
    float32), and the update (g, p, m, v read and p, m, v written once)."""
    par = parameters(seq_len, micro_ch, lesion_ch, latent)
    w_b, o_b = par["weights"] * itemsize(store), par["affine"] * 4
    return {"grad_sq_norm": T * 2 * (w_b + o_b), "update_weights": T * 7 * w_b,
            "update_affine": T * 7 * o_b, "optimizer": T * 7 * (w_b + o_b)}


def flat_optimizer_bytes(elements: int) -> dict:
    """The same for one member whose parameters are one flat float32 buffer
    (the single VAE's ``ClipDecayAdam``)."""
    return {"grad_sq_norm": 2 * 4 * elements, "optimizer": 7 * 4 * elements}


def dense_flops(T: int, rows: int, seq_len: int = 100, latent: int = 10,
                encoder_only: bool = False) -> int:
    """Forward FLOPs of the dense layers for T members' ``rows`` rows."""
    layers = dense_layers(seq_len, latent)
    names = ("fc_mu", "fc_logv") if encoder_only else tuple(layers)
    return sum(2 * T * rows * layers[n][0] * layers[n][1] for n in names)


def forward_flops(T: int, rows: int, seq_len: int = 100, micro_ch: int = 13,
                  lesion_ch: int = 3, latent: int = 10, encoder_only: bool = False) -> int:
    """Convolution and dense FLOPs of one forward of T members' ``rows`` rows;
    ``encoder_only``: the encoders and fc_mu / fc_logv (an ``encode``)."""
    per = conv_flops(T, rows, seq_len, micro_ch, lesion_ch)["layers"]
    conv = sum(v["forward"] for n, v in per.items()
               if not encoder_only or n in ENCODER_CONVS)
    return conv + dense_flops(T, rows, seq_len, latent, encoder_only)


def step_flops(T: int, batch_size: int = 64, seq_len: int = 100, micro_ch: int = 13,
               lesion_ch: int = 3, latent: int = 10) -> int:
    """Convolution and dense FLOPs of T members' training step: the forward,
    the input gradient of every layer but the two convolutions that take the
    data, and every weight gradient (a dense layer's three products)."""
    conv = conv_flops(T, batch_size, seq_len, micro_ch, lesion_ch)["total"]
    return conv + 3 * dense_flops(T, batch_size, seq_len, latent)
