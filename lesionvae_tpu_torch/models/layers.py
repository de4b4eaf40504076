"""Layers of the lesion VAE, channel-first as cuDNN wants: (N, C, L).

``MaskedBatchNorm`` is BatchNorm1d with a validity mask on the batch rows,
so that the pad rows of a partial batch never touch the statistics: biased
batch variance to normalise, unbiased variance in the running-stat update,
momentum 0.1, eps 1e-5, statistics in float32 (float64 for float64 input).
On bfloat16 input (the mixed-precision recipe) mean, variance and affine fold
into one scale and shift per channel, computed in float32 and applied in
bfloat16, as lesionvae_tpu/models/layers.py:101-110 does.
The stacked model of ``models.fleet`` runs the same layer for T members at
once, with the ReLU after it, as ``ops.masked_bn.masked_bn_relu``.
``interp_linear`` is ``F.interpolate(mode="linear", align_corners=False)``
computed, as in the JAX package, as a product with a constant (L_out, L_in)
interpolation matrix: on the card PyTorch's upsample_linear1d kernels took
58% of a training step's device time (benchmarks/vae_step_profile.py).
Ported from lesionvae_tpu/models/layers.py, which keeps the same semantics
channel-last.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

KERNEL, PADDING = 5, 2


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (N, L) per channel with a validity mask on N.

    ``axis``: a mesh axis (``parallel.mesh.Axis``) whose ranks hold the other
    rows of the batch.  The count, the sum and then the squared deviations
    are summed over it, differentiably, where the JAX package psums them
    (lesionvae_tpu/models/layers.py:80-91), so the statistics, and the
    running ones, are the whole batch's.  ``None``: this rank's rows only."""

    def __init__(self, features: int, momentum: float = 0.1, eps: float = 1e-5,
                 axis=None):
        super().__init__()
        self.momentum, self.eps, self.axis = momentum, eps, axis
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        # x: (N, C, L); mask: (N,) in {0, 1} or None
        stat_dtype = torch.float64 if x.dtype == torch.float64 else torch.float32
        x32 = x.to(stat_dtype)
        if self.training:
            if mask is None:
                m = x32.new_ones((x.shape[0], 1, 1))
            else:
                m = mask.to(stat_dtype)[:, None, None]
            cnt = m.sum() * x.shape[2]
            s1 = (x32 * m).sum(dim=(0, 2))
            if self.axis is not None:
                cnt, s1 = self.axis.psum(cnt), self.axis.psum(s1)
            cnt = torch.clamp(cnt, min=1.0)
            mean = s1 / cnt
            s2 = (((x32 - mean[None, :, None]) ** 2) * m).sum(dim=(0, 2))
            if self.axis is not None:
                s2 = self.axis.psum(s2)
            var = s2 / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                self.running_mean.copy_((1 - self.momentum) * self.running_mean
                                        + self.momentum * mean)
                self.running_var.copy_((1 - self.momentum) * self.running_var
                                       + self.momentum * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        if x.dtype == torch.bfloat16:
            a = self.weight / torch.sqrt(var + self.eps)
            b = self.bias - mean * a
            return x * a.to(x.dtype)[None, :, None] + b.to(x.dtype)[None, :, None]
        y = (x32 - mean[None, :, None]) / torch.sqrt(var[None, :, None] + self.eps)
        return (y * self.weight[None, :, None] + self.bias[None, :, None]).to(x.dtype)


def avg_pool_half(x: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(kernel=2, stride=2), floor mode: an odd tail element is
    dropped (25 -> 12 in the micro encoder)."""
    N, C, L = x.shape
    L2 = (L // 2) * 2
    return 0.5 * x[:, :, :L2].reshape(N, C, L2 // 2, 2).sum(dim=3)


@functools.lru_cache(maxsize=None)
def interp_matrix(L_in: int, out_size: int, device: torch.device,
                   dtype: torch.dtype) -> torch.Tensor:
    """(out_size, L_in) linear-interpolation matrix with align_corners=False
    semantics: src(i) = (i + 0.5)*L_in/L_out - 0.5, clamped; each row holds
    the (1-w, w) pair.  Built in float64 as the JAX package builds it, then
    cast; cached on the device and never evicted: a captured training graph
    reads it at its address (train/program.py)."""
    src = np.clip((np.arange(out_size) + 0.5) * (L_in / out_size) - 0.5,
                  0.0, L_in - 1.0)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, L_in - 1)
    w = src - lo
    W = np.zeros((out_size, L_in))
    np.add.at(W, (np.arange(out_size), lo), 1.0 - w)
    np.add.at(W, (np.arange(out_size), hi), w)
    return torch.from_numpy(W).to(device=device, dtype=dtype)


def interp_linear(x: torch.Tensor, out_size: int) -> torch.Tensor:
    """Linear resize along the last axis of (N, C, L), align_corners=False
    (edge clamping included)."""
    W = interp_matrix(x.shape[2], out_size, x.device, x.dtype)
    return torch.matmul(x, W.T)


def upsample2_linear(x: torch.Tensor) -> torch.Tensor:
    """nn.Upsample(scale_factor=2, mode='linear', align_corners=False)."""
    return interp_linear(x, 2 * x.shape[2])


# Convolutions and dense layers with torch's default init (U(+-1/sqrt(fan_in))
# for weight and bias), as the JAX package's torch_linear_init reproduces.
def conv1d(c_in: int, c_out: int) -> nn.Conv1d:
    return nn.Conv1d(c_in, c_out, KERNEL, padding=PADDING)


def conv_transpose1d(c_in: int, c_out: int) -> nn.ConvTranspose1d:
    return nn.ConvTranspose1d(c_in, c_out, KERNEL, padding=PADDING)


def dense(d_in: int, d_out: int) -> nn.Linear:
    return nn.Linear(d_in, d_out)
