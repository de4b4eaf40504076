"""Lesion-conditioned dual-pathway 1-D convolutional VAE.

The architecture of lesionvae_tpu/models/lesion_vae.py:44-121:
- micro encoder: Conv1d(13->64->128->128, k=5, p=2) + BatchNorm + ReLU +
  AvgPool/2 after each block (L 100 -> 50 -> 25 -> 12), flattened;
- lesion encoder: Conv1d(3->32->64), two such blocks (100 -> 50 -> 25);
- concat -> fc_mu / fc_logv -> latent;
- decoder: Linear(latent + lesion context -> 128*(L/8)) ->
  [ConvT + BN + ReLU + Up x2] x2 -> ConvT(->13) + Up x2 (12 -> 24 -> 48 ->
  96) -> linear resize to L.

Inside, tensors are channel-first (cuDNN's layout), so flattening is
channel-major where the JAX model flattens l-major; ``models/convert.py``
permutes the dense layers to match.  Public tensors are (N, L, C), as in
the JAX package.  Train or eval mode follows ``module.train()`` /
``module.eval()``; every layer takes the batch-row mask.  The
reparameterisation noise is ``eps=`` when given, else drawn from the
``generator`` passed in.

``compute_dtype=torch.bfloat16`` is the mixed-precision recipe of
lesionvae_tpu/models/lesion_vae.py:36-39: parameters and BatchNorm
statistics stay float32, the inputs and every convolution and dense layer
compute in bfloat16, and the outputs come back in bfloat16 (the trainer
takes the loss in float32).

``axis`` (a ``parallel.mesh.Axis``; the JAX model's ``axis_name``): every
BatchNorm sums its statistics over the ranks of that axis, which hold the
other rows of the batch (``MaskedBatchNorm``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..utils.precision import full_fp32
from .layers import (MaskedBatchNorm, avg_pool_half, conv1d, conv_transpose1d,
                     dense, interp_linear, upsample2_linear)


class LesionConditionedVAE(nn.Module):
    def __init__(self, seq_len: int = 100, micro_ch: int = 13,
                 lesion_ch: int = 3, latent: int = 10,
                 compute_dtype: Optional[torch.dtype] = None, axis=None):
        super().__init__()
        self.seq_len, self.micro_ch = seq_len, micro_ch
        self.lesion_ch, self.latent = lesion_ch, latent
        self.compute_dtype = compute_dtype
        L = seq_len
        self.micro_out = 128 * (L // 8)
        self.lesion_out = 64 * (L // 4)

        self.micro_c1 = conv1d(micro_ch, 64)
        self.micro_b1 = MaskedBatchNorm(64)
        self.micro_c2 = conv1d(64, 128)
        self.micro_b2 = MaskedBatchNorm(128)
        self.micro_c3 = conv1d(128, 128)
        self.micro_b3 = MaskedBatchNorm(128)

        self.lesion_c1 = conv1d(lesion_ch, 32)
        self.lesion_b1 = MaskedBatchNorm(32)
        self.lesion_c2 = conv1d(32, 64)
        self.lesion_b2 = MaskedBatchNorm(64)

        self.fc_mu = dense(self.micro_out + self.lesion_out, latent)
        self.fc_logv = dense(self.micro_out + self.lesion_out, latent)
        self.fc_dec = dense(latent + self.lesion_out, self.micro_out)

        self.dec_t1 = conv_transpose1d(128, 64)
        self.dec_b1 = MaskedBatchNorm(64)
        self.dec_t2 = conv_transpose1d(64, 64)
        self.dec_b2 = MaskedBatchNorm(64)
        self.dec_t3 = conv_transpose1d(64, micro_ch)
        self.set_axis(axis)

    def set_axis(self, axis) -> None:
        """Sum every BatchNorm's statistics over ``axis`` (None: not)."""
        for mod in self.modules():
            if isinstance(mod, MaskedBatchNorm):
                mod.axis = axis

    def hyperparameters(self) -> dict:
        return {"seq_len": self.seq_len, "micro_ch": self.micro_ch,
                "lesion_ch": self.lesion_ch, "latent": self.latent}

    def _layer(self, layer: nn.Module, h: torch.Tensor) -> torch.Tensor:
        """A convolution or dense layer in the compute dtype."""
        cd = self.compute_dtype
        if cd is None:
            return layer(h)
        w, b = layer.weight.to(cd), layer.bias.to(cd)
        if isinstance(layer, nn.Linear):
            return F.linear(h, w, b)
        op = F.conv_transpose1d if isinstance(layer, nn.ConvTranspose1d) else F.conv1d
        return op(h, w, b, padding=layer.padding[0])

    # ------------------------------------------------------------------
    def encode(self, x_micro: torch.Tensor, x_lesion: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, L, C) inputs -> (mu, logv, h_lesion); h_lesion is flattened
        channel-major, (N, 64 * L/4)."""
        if self.compute_dtype is not None:
            x_micro = x_micro.to(self.compute_dtype)
            x_lesion = x_lesion.to(self.compute_dtype)
        h = x_micro.transpose(1, 2)
        for conv, bn in ((self.micro_c1, self.micro_b1),
                         (self.micro_c2, self.micro_b2),
                         (self.micro_c3, self.micro_b3)):
            h = avg_pool_half(F.relu(bn(self._layer(conv, h), mask)))
        h_micro = h.reshape(h.shape[0], -1)
        h = x_lesion.transpose(1, 2)
        for conv, bn in ((self.lesion_c1, self.lesion_b1),
                         (self.lesion_c2, self.lesion_b2)):
            h = avg_pool_half(F.relu(bn(self._layer(conv, h), mask)))
        h_lesion = h.reshape(h.shape[0], -1)
        hcat = torch.cat([h_micro, h_lesion], dim=1)
        return self._layer(self.fc_mu, hcat), self._layer(self.fc_logv, hcat), h_lesion

    def decode(self, z: torch.Tensor, h_lesion: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> (N, L, micro_ch)"""
        h = self._layer(self.fc_dec, torch.cat([z, h_lesion], dim=1))
        h = h.reshape(h.shape[0], 128, self.seq_len // 8)
        h = upsample2_linear(F.relu(self.dec_b1(self._layer(self.dec_t1, h), mask)))
        h = upsample2_linear(F.relu(self.dec_b2(self._layer(self.dec_t2, h), mask)))
        h = upsample2_linear(self._layer(self.dec_t3, h))
        if h.shape[2] != self.seq_len:
            h = interp_linear(h, self.seq_len)
        return h.transpose(1, 2)

    def forward(self, x_micro: torch.Tensor, x_lesion: torch.Tensor,
                mask: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        """-> (xh, mu, logv); z = mu + eps * exp(logv / 2)."""
        mu, logv, h_lesion = self.encode(x_micro, x_lesion, mask)
        if eps is None:
            where = generator.device if generator is not None else mu.device
            eps = torch.randn(mu.shape, generator=generator, dtype=mu.dtype,
                              device=where)
        z = mu + eps.to(mu.device, mu.dtype) * torch.exp(0.5 * logv)
        return self.decode(z, h_lesion, mask), mu, logv


@dataclasses.dataclass
class TrainedVAE:
    """A trained model: the module holds the weights and the BatchNorm
    running stats."""

    module: LesionConditionedVAE

    @property
    def device(self) -> torch.device:
        return next(self.module.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.module.parameters()).dtype

    def as_tensor(self, x) -> torch.Tensor:
        if not isinstance(x, torch.Tensor):
            x = torch.from_numpy(np.array(x))
        return x.to(device=self.device, dtype=self.dtype)

    def apply(self, x_micro, x_lesion, eps=None, generator=None):
        """Eval-mode forward (running BN stats), sampling z ~ q(z|x) with
        ``eps`` or the generator; the reference's eval forward samples too."""
        full_fp32(self.device)
        self.module.eval()
        with torch.no_grad():
            return self.module(self.as_tensor(x_micro), self.as_tensor(x_lesion),
                               eps=eps, generator=generator)

    def encode(self, x_micro, x_lesion):
        full_fp32(self.device)
        self.module.eval()
        with torch.no_grad():
            return self.module.encode(self.as_tensor(x_micro),
                                      self.as_tensor(x_lesion))
