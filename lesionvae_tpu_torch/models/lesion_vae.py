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
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .layers import (MaskedBatchNorm, avg_pool_half, conv1d, conv_transpose1d,
                     dense, interp_linear, upsample2_linear)


class LesionConditionedVAE(nn.Module):
    def __init__(self, seq_len: int = 100, micro_ch: int = 13,
                 lesion_ch: int = 3, latent: int = 10):
        super().__init__()
        self.seq_len, self.micro_ch = seq_len, micro_ch
        self.lesion_ch, self.latent = lesion_ch, latent
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

    def hyperparameters(self) -> dict:
        return {"seq_len": self.seq_len, "micro_ch": self.micro_ch,
                "lesion_ch": self.lesion_ch, "latent": self.latent}

    # ------------------------------------------------------------------
    def encode(self, x_micro: torch.Tensor, x_lesion: torch.Tensor,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(N, L, C) inputs -> (mu, logv, h_lesion); h_lesion is flattened
        channel-major, (N, 64 * L/4)."""
        h = x_micro.transpose(1, 2)
        for conv, bn in ((self.micro_c1, self.micro_b1),
                         (self.micro_c2, self.micro_b2),
                         (self.micro_c3, self.micro_b3)):
            h = avg_pool_half(F.relu(bn(conv(h), mask)))
        h_micro = h.reshape(h.shape[0], -1)
        h = x_lesion.transpose(1, 2)
        for conv, bn in ((self.lesion_c1, self.lesion_b1),
                         (self.lesion_c2, self.lesion_b2)):
            h = avg_pool_half(F.relu(bn(conv(h), mask)))
        h_lesion = h.reshape(h.shape[0], -1)
        hcat = torch.cat([h_micro, h_lesion], dim=1)
        return self.fc_mu(hcat), self.fc_logv(hcat), h_lesion

    def decode(self, z: torch.Tensor, h_lesion: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """-> (N, L, micro_ch)"""
        h = self.fc_dec(torch.cat([z, h_lesion], dim=1))
        h = h.reshape(h.shape[0], 128, self.seq_len // 8)
        h = upsample2_linear(F.relu(self.dec_b1(self.dec_t1(h), mask)))
        h = upsample2_linear(F.relu(self.dec_b2(self.dec_t2(h), mask)))
        h = upsample2_linear(self.dec_t3(h))
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
