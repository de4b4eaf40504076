"""VAE training: the port of lesionvae_tpu/train/trainer.py.

Semantics kept from the JAX package (itself the reference's
src/vae/vae_model.py:140-222):
- optimizer = global-norm clip 2.0 -> additive weight decay 1e-3 -> Adam ->
  -lr, with optax's clip select (g, or g/‖g‖·clip), not clip_grad_norm_'s
  +1e-6 (``ClipDecayAdam``);
- a batch whose loss is not finite skips the parameter/optimizer update,
  while its forward has already advanced the BatchNorm running stats;
- real rows are shuffled each epoch with the pad rows kept at the tail, so
  there is one partial batch, masked out of BatchNorm and the ELBO;
- epoch averages weight each batch by its real row count.

Every permutation and every reparameterisation draw of the run is made up
front from one CPU generator seeded with ``seed`` and moved to the device
once, so a ``cuda`` and a ``cpu`` run with the same seed see the same
numbers; tests inject the JAX package's own draws (``perms=``, ``noise=``).
The loop never waits for the device: losses, the finite check and the
epoch sums stay on it until the history is read at the end.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ..models.elbo import elbo
from ..models.lesion_vae import LesionConditionedVAE
from ..utils.logging import get_logger
from ..utils.precision import full_fp32

log = get_logger("train")


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


class ClipDecayAdam:
    """The JAX package's ``make_optimizer`` (trainer.py:98-122) as one pass
    over a flat buffer that holds every parameter of the module.

    The module's parameters become views of that buffer, so the update is a
    few elementwise kernels over 2.7 M elements rather than a few per
    parameter tensor.  ``step`` applies it only where ``finite`` holds, on
    the device, without a host round trip."""

    def __init__(self, module: torch.nn.Module, lr: float, weight_decay: float,
                 grad_clip: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.lr, self.weight_decay, self.grad_clip = lr, weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.params = list(module.parameters())
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        offset = 0
        for p in self.params:
            p.data = self.flat[offset:offset + p.numel()].view_as(p)
            offset += p.numel()
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=self.flat.device)
        # the bias corrections are powers in the parameters' dtype
        self._b1 = torch.tensor(b1, dtype=self.flat.dtype, device=self.flat.device)
        self._b2 = torch.tensor(b2, dtype=self.flat.dtype, device=self.flat.device)

    @torch.no_grad()
    def step(self, grads, finite: torch.Tensor) -> None:
        g = torch.cat([x.reshape(-1) for x in grads])
        g_norm = torch.sqrt(torch.sum(g * g))
        g = torch.where(g_norm < self.grad_clip, g, (g / g_norm) * self.grad_clip)
        g = g + self.weight_decay * self.flat
        m2 = (1 - self.b1) * g + self.b1 * self.mu
        v2 = (1 - self.b2) * (g * g) + self.b2 * self.nu
        count_inc = self.count + 1
        bc1 = 1 - torch.pow(self._b1, count_inc)
        bc2 = 1 - torch.pow(self._b2, count_inc)
        u = -self.lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + self.eps))
        self.flat.copy_(torch.where(finite, self.flat + u, self.flat))
        self.mu.copy_(torch.where(finite, m2, self.mu))
        self.nu.copy_(torch.where(finite, v2, self.nu))
        self.count = torch.where(finite, count_inc, self.count)


def betas(epochs: int):
    """Per-epoch KLD weights as float32 values, as the JAX program holds
    them (trainer.py:138-140)."""
    return [float(np.float32(0.1 + 1.9 * (ep / (epochs - 1))))
            if epochs > 1 else 1.0 for ep in range(epochs)]


def train_step(module: LesionConditionedVAE, opt: ClipDecayAdam, xb_m, xb_l,
               mask, eps, beta: float) -> torch.Tensor:
    """One batch: train-mode forward (advances BN running stats), ELBO,
    gradients, and the update unless the loss is not finite.  Returns
    [loss*n, recon*n, kld*n, n] for the real rows n, zeroed for a skipped
    batch (NaN times zero stays NaN, as in the JAX program)."""
    module.train()
    xh, mu, logv = module(xb_m, xb_l, mask=mask, eps=eps)
    # nan_to_num on outputs, as the reference does (vae_model.py:189-191)
    xh = torch.nan_to_num(xh, nan=0.0)
    mu = torch.nan_to_num(mu, nan=0.0)
    logv = torch.nan_to_num(logv, nan=0.0)
    loss, recon, kld = elbo(xh, xb_m, mu, logv, beta=beta, mask=mask)
    grads = torch.autograd.grad(loss, opt.params)
    finite = torch.isfinite(loss)
    opt.step(grads, finite)
    n_valid = mask.sum()
    loss, recon, kld = loss.detach(), recon.detach(), kld.detach()
    return finite.to(loss.dtype) * torch.stack(
        [loss * n_valid, recon * n_valid, kld * n_valid, n_valid])


def draw_run(n: int, n_pad: int, epochs: int, batch_size: int, latent: int,
             generator: torch.Generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every permutation (epochs, n_pad) and reparameterisation draw
    (epochs, n_batches, batch_size, latent) of a run, on the CPU."""
    tail = torch.arange(n, n_pad)
    perms = torch.stack([torch.cat([torch.randperm(n, generator=generator), tail])
                         for _ in range(epochs)])
    noise = torch.randn((epochs, n_pad // batch_size, batch_size, latent),
                        generator=generator)
    return perms, noise


def train_module(module: LesionConditionedVAE, Xm: torch.Tensor,
                 Xl: torch.Tensor, n: int, perms: torch.Tensor,
                 noise: torch.Tensor, epochs: int, batch_size: int, lr: float,
                 weight_decay: float, grad_clip: float) -> np.ndarray:
    """Train ``module`` in place on padded device tensors (n_pad, L, C)
    whose first ``n`` rows are real.  Returns the (epochs, 4) history
    [loss, recon, kld, beta]."""
    n_pad = Xm.shape[0]
    n_batches = n_pad // batch_size
    opt = ClipDecayAdam(module, lr, weight_decay, grad_clip)
    perms = perms.to(Xm.device)
    noise = noise.to(Xm.device, Xm.dtype)
    beta_t = torch.tensor(betas(epochs), dtype=Xm.dtype, device=Xm.device)
    hist = []
    for ep, beta in enumerate(betas(epochs)):
        perm = perms[ep]
        Xm_ep, Xl_ep = Xm[perm], Xl[perm]
        mask_ep = (perm < n).to(Xm.dtype)
        sums = Xm.new_zeros(4)
        for b in range(n_batches):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            sums = sums + train_step(module, opt, Xm_ep[sl], Xl_ep[sl],
                                     mask_ep[sl], noise[ep, b], beta)
        seen = sums[3]
        avg = torch.where(seen > 0, sums[:3] / seen, torch.nan)
        hist.append(torch.cat([avg, beta_t[ep:ep + 1]]))
    return torch.stack(hist).cpu().numpy()


def train_lesion_vae(X_micro: np.ndarray, X_lesion: np.ndarray,
                     latent_dim: int = 10, epochs: int = 40,
                     batch_size: int = 64, lr: float = 2e-4,
                     weight_decay: float = 1e-3, grad_clip: float = 2.0,
                     seed: int = 42, device="cuda",
                     dtype: torch.dtype = torch.float32,
                     module: Optional[LesionConditionedVAE] = None,
                     perms: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None
                     ) -> Tuple[TrainedVAE, pd.DataFrame]:
    """Returns (model, history DataFrame with columns loss/recon/kld/beta,
    one row per epoch), like vae_model.py:140-222.

    The initial weights (torch default init), permutations and noise all
    come from ``seed`` on the CPU; ``module``, ``perms`` and ``noise``
    replace them when given (initial weights are then taken from
    ``module``, which is trained in place).  On ``cuda`` the run is
    float32."""
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"the VAE trains float32 on cuda, got {dtype}")
    full_fp32(device)
    X_micro = np.nan_to_num(np.asarray(X_micro, np.float32), nan=0.0)
    X_lesion = np.nan_to_num(np.asarray(X_lesion, np.float32), nan=0.0)
    n, seq_len, micro_ch = X_micro.shape
    lesion_ch = X_lesion.shape[2]
    n_batches = max(1, -(-n // batch_size))
    n_pad = n_batches * batch_size

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if module is None:
            module = LesionConditionedVAE(seq_len=seq_len, micro_ch=micro_ch,
                                          lesion_ch=lesion_ch, latent=latent_dim)
        if perms is None or noise is None:
            drawn = draw_run(n, n_pad, epochs, batch_size, module.latent,
                             torch.default_generator)
            perms = drawn[0] if perms is None else perms
            noise = drawn[1] if noise is None else noise
    module.to(device=device, dtype=dtype)

    def padded(X):
        out = torch.zeros((n_pad,) + X.shape[1:], dtype=dtype, device=device)
        out[:n] = torch.from_numpy(X).to(device=device, dtype=dtype)
        return out

    hist = train_module(module, padded(X_micro), padded(X_lesion), n, perms,
                        noise, epochs, batch_size, lr, weight_decay, grad_clip)
    hist_df = pd.DataFrame(hist, columns=["loss", "recon", "kld", "beta"])
    for ep in (1, 10, 20, 30, 40):
        if ep <= epochs:
            r = hist_df.iloc[ep - 1]
            log.info("[%02d/%d] loss=%.3f | recon=%.3f | kld=%.3f | beta=%.2f",
                     ep, epochs, r.loss, r.recon, r.kld, r.beta)
    return TrainedVAE(module), hist_df
