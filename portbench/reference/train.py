"""A training run of S stacked members, step by step: per batch a
train-mode forward (each member's BatchNorm statistics advance), the ELBO
with the epoch's KLD weight, the gradients, and clip -> decay -> Adam by
each member's global gradient norm over all its parameters, skipped for a
member whose loss is not finite.  Each epoch's history row is the batches'
[loss, recon, kld] weighted by their real rows, and the KLD weight.

With ``store`` "bfloat16" the convolution and dense leaves and their
moments are held in bfloat16 and written back with stochastic rounding
(``reference.store``), with each member's salt; the BatchNorm leaves stay
float32.  The forward's arithmetic is ``model.precision``'s.

``fault`` plants one of the faults the benchmark's check has to see, in
the reference put in the program's place: "frozen" (a step that returns
the parameters unchanged), "half_batch" (half of each batch's rows left
out of the forward, the means taken over the rest) or "nearest_store" (the
bfloat16 store rounds to nearest).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from . import store as rstore
from .model import elbo, forward


def betas(epochs: int) -> List[float]:
    """The KLD weight of each epoch, 0.1 to 2.0 linearly, as float32."""
    return [float(np.float32(0.1 + 1.9 * (ep / (epochs - 1)))) if epochs > 1 else 1.0
            for ep in range(epochs)]


class Adam:
    """Clip by the member's global norm (g, or g / |g| * clip where |g| >=
    clip) -> g + weight_decay * p -> Adam -> -lr, per member, with its own
    step count that a skipped step does not advance.  The parameters become
    views of one (S, P) buffer, so a step is a few passes over it; with
    ``store`` "bfloat16", of a bfloat16 buffer of the weight leaves and a
    float32 one of the BatchNorm leaves."""

    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 grad_clip: float, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 store: str = "float32", salts: Optional[torch.Tensor] = None,
                 rounding: str = "stochastic", seq_len: int = 0):
        self.lr, self.wd, self.clip = lr, weight_decay, grad_clip
        self.b1, self.b2, self.eps = b1, b2, eps
        self.names = list(params)
        S = params[self.names[0]].shape[0]
        dev = params[self.names[0]].device
        self.count = torch.zeros(S, dtype=torch.int32, device=dev)
        self.rounding = rounding
        if store == "float32":
            self.groups = [self._group(params, self.names, None)]
        elif store == "bfloat16":
            weights = [k for k in self.names if rstore.is_weight(k)]
            self.groups = [self._group(params, weights, torch.bfloat16),
                           self._group(params, [k for k in self.names if k not in weights],
                                       None)]
            self.base = rstore.index_base({k: params[k].shape[1:] for k in weights},
                                          seq_len).to(dev)
            self.salt = salts.to(dev, torch.int64)
        else:
            raise ValueError(f"unknown storage {store!r}")

    @staticmethod
    def _group(params, names, dtype) -> dict:
        """``names``' leaves as views of one (S, n) buffer (in ``dtype``, round
        to nearest, or their own), with zeroed moments."""
        S = params[names[0]].shape[0]
        flat = torch.cat([params[k].reshape(S, -1) for k in names], dim=1)
        flat = flat if dtype is None else flat.to(dtype)
        offset = 0
        for k in names:
            n = params[k][0].numel()
            params[k] = flat[:, offset:offset + n].view(params[k].shape)
            offset += n
        return {"names": names, "flat": flat, "m": torch.zeros_like(flat),
                "v": torch.zeros_like(flat), "stored": dtype is not None}

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor], finite: torch.Tensor) -> None:
        S = self.count.shape[0]
        gs = [torch.cat([grads[k].reshape(S, -1) for k in grp["names"]], dim=1)
              for grp in self.groups]
        gs = [g.float() if grp["stored"] else g for g, grp in zip(gs, self.groups)]
        norm = torch.sqrt(sum((g * g).sum(dim=1) for g in gs))[:, None]
        count = self.count + 1
        bc1 = (1 - torch.pow(norm.new_tensor(self.b1), count))[:, None]
        bc2 = (1 - torch.pow(norm.new_tensor(self.b2), count))[:, None]
        keep = finite[:, None]
        for g, grp in zip(gs, self.groups):
            p = grp["flat"]
            if grp["stored"]:
                salt = (self.salt + count.to(torch.int64) * rstore.STEP_SALT) & rstore.MASK32
                new = rstore.step(p, grp["m"], grp["v"], g, self.base, norm, bc1, bc2, salt,
                                  finite, self.lr, self.wd, self.clip, self.b1, self.b2,
                                  self.eps, self.rounding)
                p.copy_(new[0])
                grp["m"], grp["v"] = new[1], new[2]
                continue
            g = torch.where(norm < self.clip, g, g / norm * self.clip)
            g = g + self.wd * p
            m = (1 - self.b1) * g + self.b1 * grp["m"]
            v = (1 - self.b2) * (g * g) + self.b2 * grp["v"]
            u = -self.lr * ((m / bc1) / (torch.sqrt(v / bc2) + self.eps))
            p.copy_(torch.where(keep, p + u, p))
            grp["m"] = torch.where(keep, m, grp["m"])
            grp["v"] = torch.where(keep, v, grp["v"])
        self.count = torch.where(finite, count, self.count)


def train(params: Dict[str, torch.Tensor], stats: Dict[str, torch.Tensor],
          Xm: torch.Tensor, Xl: torch.Tensor, n_real: torch.Tensor, perms: torch.Tensor,
          noise: torch.Tensor, epochs: int, batch_size: int, lr: float,
          weight_decay: float, grad_clip: float, fault: Optional[str] = None,
          store: str = "float32", salts: Optional[torch.Tensor] = None):
    """Train the stacked members in place (``params``' values become views of
    the optimizer's buffers).  Xm, Xl (S, n_pad, L, C) on the device; perms
    (S, epochs, n_pad); noise (S, epochs, n_batches, batch, latent); salts
    (S,), with ``store`` "bfloat16".  Returns (history (S, epochs, 4) on the
    host, each leaf's gradient norm per member at the first step {name:
    (S,)})."""
    S, n_pad = Xm.shape[:2]
    dev = Xm.device
    rows = torch.arange(S, device=dev)[:, None]
    perms, noise, n_real = perms.to(dev), noise.to(dev, Xm.dtype), n_real.to(dev)
    opt = Adam(params, lr, weight_decay, grad_clip, store=store, salts=salts,
               rounding="nearest" if fault == "nearest_store" else "stochastic",
               seq_len=Xm.shape[2])
    names = list(params)
    hist, first = [], None
    for ep, beta in enumerate(betas(epochs)):
        sums = Xm.new_zeros((S, 4))
        for b in range(n_pad // batch_size):
            idx = perms[:, ep, b * batch_size:(b + 1) * batch_size]
            eps = noise[:, ep, b]
            if fault == "half_batch":
                idx, eps = idx[:, : batch_size // 2], eps[:, : batch_size // 2]
            mask = (idx < n_real[:, None]).to(Xm.dtype)
            leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
            xh, mu, logv, new_stats = forward(leaves, stats, Xm[rows, idx], Xl[rows, idx],
                                              mask, eps, True)
            xh, mu, logv = (torch.nan_to_num(t.to(Xm.dtype), nan=0.0) for t in (xh, mu, logv))
            loss, recon, kld = elbo(xh, Xm[rows, idx], mu, logv, beta, mask)
            grads = dict(zip(names, torch.autograd.grad(loss.sum(), [leaves[k] for k in names])))
            if first is None:
                first = {k: g.reshape(S, -1).to(Xm.dtype).norm(dim=1).cpu()
                         for k, g in grads.items()}
            stats.update(new_stats)
            finite = torch.isfinite(loss)
            if fault != "frozen":
                opt.step(grads, finite)
            n = mask.sum(dim=1)
            sums = sums + finite.to(Xm.dtype)[:, None] * torch.stack(
                [loss.detach() * n, recon.detach() * n, kld.detach() * n, n], dim=1)
        seen = sums[:, 3:4]
        avg = torch.where(seen > 0, sums[:, :3] / seen, torch.nan)
        hist.append(torch.cat([avg, Xm.new_full((S, 1), beta)], dim=1))
    return torch.stack(hist, dim=1).cpu().numpy(), first
