"""The VAE as plain PyTorch on stacked members, channel-last.

Parameters are a dict ``name -> (S, *shape)`` in the published module's
layouts: Conv1d (out, in, 5), ConvTranspose1d (in, out, 5), Linear (out,
in), BatchNorm scale and shift (C,); running statistics likewise.  A
convolution (k = 5, padding 2, stride 1) is its five shifted copies of the
input laid side by side times the kernel; a transposed one at stride 1 is
the same with the kernel reversed and its (in, out) swapped.  BatchNorm
normalises over the real rows only (``mask``): biased variance to
normalise, unbiased in the running update, momentum 0.1, eps 1e-5.
Linear resizes are align_corners=False, as ``nn.Upsample`` computes them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

TAPS, PAD = 5, 2
MOMENTUM, EPS = 0.1, 1e-5
ENCODERS = {"micro": (("micro_c1", "micro_b1"), ("micro_c2", "micro_b2"),
                      ("micro_c3", "micro_b3")),
            "lesion": (("lesion_c1", "lesion_b1"), ("lesion_c2", "lesion_b2"))}
TRANSPOSED = ("dec_t1", "dec_t2", "dec_t3")
BATCH_NORMS = ("micro_b1", "micro_b2", "micro_b3", "lesion_b1", "lesion_b2",
               "dec_b1", "dec_b2")


@contextlib.contextmanager
def precision(mode: str = "float32"):
    """float32 products with TF32 off ("float32"), or TF32 ("tf32")."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    tf32 = mode == "tf32"
    if mode not in ("float32", "tf32"):
        raise ValueError(f"unknown precision {mode!r}")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def init_member(seq_len: int, micro_ch: int, lesion_ch: int, latent: int):
    """One member's initial parameters and running statistics, drawn from
    torch's global generator in the published module's construction order
    (every convolution and dense layer with torch's default init; the
    BatchNorms draw nothing)."""
    L = seq_len
    h_micro, h_lesion = 128 * (L // 8), 64 * (L // 4)
    conv = lambda i, o: nn.Conv1d(i, o, TAPS, padding=PAD)  # noqa: E731
    convt = lambda i, o: nn.ConvTranspose1d(i, o, TAPS, padding=PAD)  # noqa: E731
    layers = [("micro_c1", conv(micro_ch, 64)), ("micro_b1", 64),
              ("micro_c2", conv(64, 128)), ("micro_b2", 128),
              ("micro_c3", conv(128, 128)), ("micro_b3", 128),
              ("lesion_c1", conv(lesion_ch, 32)), ("lesion_b1", 32),
              ("lesion_c2", conv(32, 64)), ("lesion_b2", 64),
              ("fc_mu", nn.Linear(h_micro + h_lesion, latent)),
              ("fc_logv", nn.Linear(h_micro + h_lesion, latent)),
              ("fc_dec", nn.Linear(latent + h_lesion, h_micro)),
              ("dec_t1", convt(128, 64)), ("dec_b1", 64),
              ("dec_t2", convt(64, 64)), ("dec_b2", 64),
              ("dec_t3", convt(64, micro_ch))]
    params, stats = {}, {}
    for name, layer in layers:
        if isinstance(layer, int):
            params[f"{name}.weight"] = torch.ones(layer)
            params[f"{name}.bias"] = torch.zeros(layer)
            stats[f"{name}.running_mean"] = torch.zeros(layer)
            stats[f"{name}.running_var"] = torch.ones(layer)
        else:
            params[f"{name}.weight"] = layer.weight.detach().clone()
            params[f"{name}.bias"] = layer.bias.detach().clone()
    return params, stats


def stack(members, device) -> Dict[str, torch.Tensor]:
    """Members' dicts stacked on a leading axis, on ``device``."""
    return {k: torch.stack([m[k] for m in members]).to(device) for k in members[0]}


def conv(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, transposed: bool) -> torch.Tensor:
    """h (S, N, L, C_in) -> (S, N, L, C_out)."""
    if transposed:
        w = w.flip(-1).transpose(1, 2)              # (S, in, out, k) -> (S, out, in, k)
    cols = F.pad(h, (0, 0, PAD, PAD)).unfold(2, TAPS, 1)     # (S, N, L, C_in, k)
    return torch.einsum("snlck,sock->snlo", cols, w) + b[:, None, None, :]


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x (S, N, in) -> (S, N, out) with w (S, out, in)."""
    return torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))


def batch_norm_relu(x, w, b, rm, rv, mask: Optional[torch.Tensor], training: bool):
    """relu(BatchNorm(x)) of x (S, N, L, C); returns (y, new running mean,
    new running var)."""
    if training:
        m = mask[:, :, None, None]
        cnt = torch.clamp(mask.sum(dim=1) * x.shape[2], min=1.0)[:, None]
        mean = (x * m).sum(dim=(1, 2)) / cnt
        var = (((x - mean[:, None, None]) ** 2) * m).sum(dim=(1, 2)) / cnt
        with torch.no_grad():
            unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
            rm = (1 - MOMENTUM) * rm + MOMENTUM * mean
            rv = (1 - MOMENTUM) * rv + MOMENTUM * unbiased
    else:
        mean, var = rm, rv
    y = (x - mean[:, None, None]) / torch.sqrt(var[:, None, None] + EPS)
    return F.relu(y * w[:, None, None] + b[:, None, None]), rm, rv


def pool(h: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(2), floor mode, along L."""
    L2 = (h.shape[2] // 2) * 2
    return 0.5 * (h[:, :, 0:L2:2] + h[:, :, 1:L2:2])


def resize(h: torch.Tensor, out: int) -> torch.Tensor:
    """Linear resize along L, align_corners=False, edges clamped."""
    L = h.shape[2]
    src = ((torch.arange(out, dtype=torch.float64) + 0.5) * (L / out) - 0.5).clamp(0, L - 1)
    lo = src.floor().long()
    hi = torch.clamp(lo + 1, max=L - 1)
    frac = (src - lo).to(device=h.device, dtype=h.dtype)[:, None]
    return h[:, :, lo.to(h.device)] * (1 - frac) + h[:, :, hi.to(h.device)] * frac


def flat(h: torch.Tensor) -> torch.Tensor:
    """(S, N, L, C) -> (S, N, C*L), channel-major as the published module
    flattens (N, C, L)."""
    return h.transpose(2, 3).reshape(h.shape[0], h.shape[1], -1)


def encode(p, stats, xm, xl, mask, training: bool, new_stats: dict
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (mu, logv, h_lesion)."""
    out = {}
    for path, h in (("micro", xm), ("lesion", xl)):
        for c, bn in ENCODERS[path]:
            h = conv(h, p[f"{c}.weight"], p[f"{c}.bias"], False)
            h, rm, rv = batch_norm_relu(h, p[f"{bn}.weight"], p[f"{bn}.bias"],
                                        stats[f"{bn}.running_mean"],
                                        stats[f"{bn}.running_var"], mask, training)
            new_stats[f"{bn}.running_mean"], new_stats[f"{bn}.running_var"] = rm, rv
            h = pool(h)
        out[path] = flat(h)
    hcat = torch.cat([out["micro"], out["lesion"]], dim=2)
    return (dense(hcat, p["fc_mu.weight"], p["fc_mu.bias"]),
            dense(hcat, p["fc_logv.weight"], p["fc_logv.bias"]), out["lesion"])


def forward(p, stats, xm, xl, mask, eps, training: bool):
    """-> (xh (S, N, L, C_micro), mu, logv, new running statistics).  eps:
    (S, N, latent) or (N, latent) shared by the members."""
    L = xm.shape[2]
    new_stats: dict = {}
    mu, logv, h_lesion = encode(p, stats, xm, xl, mask, training, new_stats)
    z = mu + eps * torch.exp(0.5 * logv)
    h = dense(torch.cat([z, h_lesion], dim=2), p["fc_dec.weight"], p["fc_dec.bias"])
    S, N = h.shape[:2]
    h = h.view(S, N, 128, L // 8).transpose(2, 3)
    for t, bn in (("dec_t1", "dec_b1"), ("dec_t2", "dec_b2"), ("dec_t3", None)):
        h = conv(h, p[f"{t}.weight"], p[f"{t}.bias"], True)
        if bn is not None:
            h, rm, rv = batch_norm_relu(h, p[f"{bn}.weight"], p[f"{bn}.bias"],
                                        stats[f"{bn}.running_mean"],
                                        stats[f"{bn}.running_var"], mask, training)
            new_stats[f"{bn}.running_mean"], new_stats[f"{bn}.running_var"] = rm, rv
        h = resize(h, 2 * h.shape[2])
    if h.shape[2] != L:
        h = resize(h, L)
    return h, mu, logv, new_stats


def elbo(xh, x, mu, logv, beta, mask):
    """Per member (loss, recon, kld) over its real rows: the mean squared
    error over every element plus beta times the KL term averaged over
    (rows, latent)."""
    m = mask
    n = m.sum(dim=1)
    recon = (((xh - x) ** 2) * m[:, :, None, None]).sum(dim=(1, 2, 3)) / torch.clamp(
        n * x[0, 0].numel(), min=1.0)
    kld = -0.5 * ((1 + logv - mu ** 2 - torch.exp(logv)) * m[:, :, None]).sum(
        dim=(1, 2)) / torch.clamp(n * mu.shape[2], min=1.0)
    return recon + beta * kld, recon, kld
