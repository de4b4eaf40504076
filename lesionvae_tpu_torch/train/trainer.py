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
The run never waits for the device: losses, the finite check and the
epoch sums stay on it until the history is read at the end.

The run is one device program: the module trains as a fleet of one member,
on the cached one-member ``train.batched.FleetProgram`` of its
configuration (the counterpart of the JAX package's ``_train_program``).
Its step is the fleet's step (``train.batched.fleet_step``): the port's
convolution, masked BatchNorm + ReLU and optimizer kernels on the card,
their plain versions on the CPU, with the module's arithmetic (the masked
ELBO, clip -> decay -> Adam, the unbiased running variance), so a fleet
member equals the module trained by ``train_loop``
(tests/test_torch_fleet.py).  Every tensor an epoch touches lives in the
program's buffers, the epoch body reads its permutation, noise and KLD
weight through a device epoch counter, and on ``cuda`` each epoch is one
replay of a captured CUDA graph (``train.program``).  ``train_loop`` is the
module's arithmetic as a Python loop of eager launches (cuDNN convolutions,
``MaskedBatchNorm``): the data-parallel steps (``axis``), with a collective
in every step, run it, and it is the reference the program is held
against.

Spans (``utils.profiling.span``): ``vae.init`` (the module's init and the
draws, on the CPU), ``vae.upload`` (module, blocks and draws to the device),
``vae_train`` (the run, the counterpart of the fleet's ``fleet_train``;
a host range only, like the others) and, inside it, the program's
``program.load`` and ``program.epoch`` and ``program.history`` (the
history's read, where the host waits for the card).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ..models.elbo import elbo
from ..models.fleet import layout
from ..models.lesion_vae import LesionConditionedVAE, TrainedVAE
from ..ops import adam
from ..utils.logging import get_logger
from ..utils.precision import full_fp32
from ..utils.profiling import span
from .batched import fleet_program
from .program import COUNTS, ProgramCache, betas, count_h2d

log = get_logger("train")


class ClipDecayAdam:
    """The JAX package's ``make_optimizer`` (trainer.py:98-122) as two passes
    over a flat buffer that holds every parameter of the module.

    The module's parameters become views of that buffer.  ``step`` gathers
    the parameters' gradients into the flat gradient buffer ``g`` with their
    global norm (``ops.adam.grad_sq_norm``) and updates every parameter in
    one pass (``ops.adam.adam_step``, one member): the hand-written kernels
    on the card, their plain versions on the CPU.  The update applies only
    where ``finite`` holds, on the device, without a host round trip."""

    def __init__(self, module: torch.nn.Module, lr: float, weight_decay: float,
                 grad_clip: float, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.hyper = adam.Hyper(lr, weight_decay, grad_clip, b1, b2, eps)
        self.params = list(module.parameters())
        self.flat = torch.cat([p.detach().reshape(-1) for p in self.params])
        self.g = torch.zeros_like(self.flat)
        self._dsts = []
        offset = 0
        for p in self.params:
            p.data = self.flat[offset:offset + p.numel()].view_as(p)
            self._dsts.append(self.g[offset:offset + p.numel()].view(1, *p.shape))
            offset += p.numel()
        dev = self.flat.device
        self.mu = torch.zeros_like(self.flat)
        self.nu = torch.zeros_like(self.flat)
        self.count = torch.zeros((), dtype=torch.int32, device=dev)
        # the bias corrections and the norm are in the parameters' dtype
        self._b1 = torch.tensor(b1, dtype=self.flat.dtype, device=dev)
        self._b2 = torch.tensor(b2, dtype=self.flat.dtype, device=dev)
        self.sq, self.g_norm = (torch.zeros(1, dtype=self.flat.dtype, device=dev)
                                for _ in range(2))
        # the norm's workspaces: the parameters' gradients, and one flat
        # gradient as a one-leaf table (``step_flat``)
        self._work = adam.norm_work([p.shape for p in self.params], 1, dev)
        self._work_flat = adam.norm_work([self.flat.shape], 1, dev)

    @torch.no_grad()
    def step(self, grads, finite: torch.Tensor) -> None:
        adam.grad_sq_norm([x[None] for x in grads], self._dsts, self._work, self.sq,
                          self.g_norm)
        self._update(self.g, self.g_norm, finite)

    def grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        """The global norm the update clips by, of a flat gradient."""
        adam.grad_sq_norm([g[None]], [None], self._work_flat, self.sq, self.g_norm)
        return self.g_norm

    @torch.no_grad()
    def step_flat(self, g: torch.Tensor, finite: torch.Tensor) -> None:
        """``step`` with the gradients as one flat buffer laid out as
        ``self.flat``."""
        self._update(g, self.grad_norm(g), finite)

    def _update(self, g: torch.Tensor, g_norm: torch.Tensor,
                finite: torch.Tensor) -> None:
        count_inc = self.count + 1
        bc1 = 1 - torch.pow(self._b1, count_inc)
        bc2 = 1 - torch.pow(self._b2, count_inc)
        one = lambda x: x.reshape(1)  # noqa: E731
        adam.adam_step(self.flat[None], self.mu[None], self.nu[None], g[None],
                       one(g_norm), one(bc1), one(bc2), one(finite), self.hyper)
        self.count.copy_(torch.where(finite, count_inc, self.count))


def train_step(module: LesionConditionedVAE, opt: ClipDecayAdam, xb_m, xb_l,
               mask, eps, beta, axis=None) -> torch.Tensor:
    """One batch: train-mode forward (advances BN running stats), ELBO with
    the KLD weight ``beta`` (a float or a 0-dim tensor),
    gradients, and the update unless the loss is not finite.  Returns
    [loss*n, recon*n, kld*n, n] for the real rows n, zeroed for a skipped
    batch (NaN times zero stays NaN, as in the JAX program).

    ``axis`` (a ``parallel.mesh.Axis``; the module's BatchNorms must sum
    over it too): the rows given are this rank's part of the batch.  The
    loss and n are the whole batch's, and the gradients are summed over the
    axis in one all-reduce of the flat buffer.  Every rank seeds the same
    global loss and ``psum``'s gradient sums the ranks' gradients, so that
    sum holds the gradient ``axis.size`` times: it is divided once."""
    module.train()
    xh, mu, logv = module(xb_m, xb_l, mask=mask, eps=eps)
    # nan_to_num on outputs, as the reference does (vae_model.py:189-191)
    xh = torch.nan_to_num(xh, nan=0.0)
    mu = torch.nan_to_num(mu, nan=0.0)
    logv = torch.nan_to_num(logv, nan=0.0)
    loss, recon, kld = elbo(xh, xb_m, mu, logv, beta=beta, mask=mask, axis=axis)
    grads = torch.autograd.grad(loss, opt.params)
    finite = torch.isfinite(loss)
    n_valid = mask.sum()
    if axis is None:
        opt.step(grads, finite)
    else:
        g = axis.total_(torch.cat([x.reshape(-1) for x in grads]))
        opt.step_flat(g / axis.size, finite)
        n_valid = axis.total_(n_valid.detach().clone())
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


def train_loop(module: LesionConditionedVAE, Xm: torch.Tensor, Xl: torch.Tensor,
               n: int, perms: torch.Tensor, noise: torch.Tensor, epochs: int,
               batch_size: int, lr: float, weight_decay: float, grad_clip: float,
               axis=None) -> np.ndarray:
    """``train_module`` as a Python loop of eager launches over the module,
    epoch by epoch (``train_step``: cuDNN convolutions, ``MaskedBatchNorm``,
    ``ClipDecayAdam``): the form of the data-parallel steps (``axis``: this
    rank trains its block of each batch's rows), and the reference the
    one-member program is held against (the same arithmetic in other
    kernels)."""
    n_pad = Xm.shape[0]
    n_batches = n_pad // batch_size
    opt = ClipDecayAdam(module, lr, weight_decay, grad_clip)
    perms = perms.to(Xm.device)
    noise = noise.to(Xm.device, Xm.dtype)
    beta_t = torch.tensor(betas(epochs), dtype=Xm.dtype, device=Xm.device)
    hist = []
    for ep in range(epochs):
        perm = perms[ep]
        Xm_ep, Xl_ep = Xm[perm], Xl[perm]
        mask_ep = (perm < n).to(Xm.dtype)
        sums = Xm.new_zeros(4)
        for b in range(n_batches):
            sl = slice(b * batch_size, (b + 1) * batch_size)
            eps = noise[ep, b]
            if axis is not None:
                own = axis.block(batch_size)
                sl = slice(sl.start + own.start, sl.start + own.stop)
                eps = eps[own]
            sums = sums + train_step(module, opt, Xm_ep[sl], Xl_ep[sl],
                                     mask_ep[sl], eps, beta_t[ep], axis)
        seen = sums[3]
        avg = torch.where(seen > 0, sums[:3] / seen, torch.nan)
        hist.append(torch.cat([avg, beta_t[ep:ep + 1]]))
    return torch.stack(hist).cpu().numpy()


#: the trainer's one-member fleet programs by static configuration, as
#: lru_cache(maxsize=16) holds the JAX package's
PROGRAMS = ProgramCache(16)


def train_module(module: LesionConditionedVAE, Xm: torch.Tensor,
                 Xl: torch.Tensor, n: int, perms: torch.Tensor,
                 noise: torch.Tensor, epochs: int, batch_size: int, lr: float,
                 weight_decay: float, grad_clip: float, axis=None) -> np.ndarray:
    """Train ``module`` in place on padded device tensors (n_pad, L, C)
    whose first ``n`` rows are real.  Returns the (epochs, 4) history
    [loss, recon, kld, beta].  The run is the cached one-member
    ``FleetProgram`` of its configuration (in ``PROGRAMS``; one graph replay
    an epoch on ``cuda``), loaded with ``module``'s weights and statistics;
    the trained ones are copied back into ``module``'s own tensors.
    ``axis``: this rank trains its block of each batch's rows with a
    collective every step, which a graph cannot hold over gloo:
    ``train_loop``."""
    if axis is not None:
        return train_loop(module, Xm, Xl, n, perms, noise, epochs, batch_size, lr,
                          weight_decay, grad_clip, axis)
    program = fleet_program(layout(**module.hyperparameters()), 1, Xm.shape[0], epochs,
                            batch_size, lr, weight_decay, grad_clip, None,
                            module.compute_dtype, False, Xm.device, Xm.dtype,
                            cache=PROGRAMS)
    return program.run_module(module, Xm, Xl, n, perms, noise)


def train_lesion_vae(X_micro: np.ndarray, X_lesion: np.ndarray,
                     latent_dim: int = 10, epochs: int = 40,
                     batch_size: int = 64, lr: float = 2e-4,
                     weight_decay: float = 1e-3, grad_clip: float = 2.0,
                     seed: int = 42, device="cuda",
                     dtype: torch.dtype = torch.float32,
                     module: Optional[LesionConditionedVAE] = None,
                     perms: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None, mesh=None
                     ) -> Tuple[TrainedVAE, pd.DataFrame]:
    """Returns (model, history DataFrame with columns loss/recon/kld/beta,
    one row per epoch), like vae_model.py:140-222.

    The initial weights (torch default init), permutations and noise all
    come from ``seed`` on the CPU; ``module``, ``perms`` and ``noise``
    replace them when given (initial weights are then taken from
    ``module``, which is trained in place).  On ``cuda`` the run is
    float32.

    ``mesh`` (``parallel.mesh.make_mesh``): data-parallel over the rows of
    each batch, as GSPMD runs the JAX trainer
    (lesionvae_tpu/train/trainer.py:250-255).  Every rank draws the same
    weights, permutations and noise from ``seed`` and trains its block of
    each batch (``batch_size`` must divide by the data axis); BatchNorm
    statistics and the masked ELBO are the whole batch's and the gradients
    are summed in one all-reduce a step, so the run is the one-process run.
    The mesh's device is used; ``device`` must be of its type."""
    axis = None
    if mesh is not None:
        from ..parallel.mesh import mesh_device
        device = mesh_device(mesh, device)
        axis = mesh.axis("data")
        axis.block(batch_size)          # raises unless it divides
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"the VAE trains float32 on cuda, got {dtype}")
    full_fp32(device)
    n, seq_len, micro_ch = np.shape(X_micro)
    lesion_ch = np.shape(X_lesion)[2]
    n_batches = max(1, -(-n // batch_size))
    n_pad = n_batches * batch_size

    with span("vae.init"), torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        if module is None:
            module = LesionConditionedVAE(seq_len=seq_len, micro_ch=micro_ch,
                                          lesion_ch=lesion_ch, latent=latent_dim)
            COUNTS["host_modules"] += 1
        if perms is None or noise is None:
            drawn = draw_run(n, n_pad, epochs, batch_size, module.latent,
                             torch.default_generator)
            perms = drawn[0] if perms is None else perms
            noise = drawn[1] if noise is None else noise

    def padded(X):
        out = torch.zeros((n_pad,) + X.shape[1:], dtype=dtype, device=device)
        out[:n] = torch.from_numpy(X).to(device=device, dtype=dtype)
        return out

    with span("vae.upload"):
        X_micro = np.nan_to_num(np.asarray(X_micro, np.float32), nan=0.0)
        X_lesion = np.nan_to_num(np.asarray(X_lesion, np.float32), nan=0.0)
        count_h2d(*(t for t in (*module.parameters(), *module.buffers(), perms, noise)
                    if t.device.type == "cpu"), X_micro, X_lesion)
        module.to(device=device, dtype=dtype)
        Xm_d, Xl_d = padded(X_micro), padded(X_lesion)
        perms, noise = perms.to(device), noise.to(device, dtype)
    module.set_axis(axis)
    try:
        with span("vae_train"):
            hist = train_module(module, Xm_d, Xl_d, n, perms, noise, epochs, batch_size,
                                lr, weight_decay, grad_clip, axis)
    finally:
        module.set_axis(None)
    hist_df = pd.DataFrame(hist, columns=["loss", "recon", "kld", "beta"])
    for ep in (1, 10, 20, 30, 40):
        if ep <= epochs:
            r = hist_df.iloc[ep - 1]
            log.info("[%02d/%d] loss=%.3f | recon=%.3f | kld=%.3f | beta=%.2f",
                     ep, epochs, r.loss, r.recon, r.kld, r.beta)
    return TrainedVAE(module), hist_df
