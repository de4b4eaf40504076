"""Multi-rank execution paths (the port of lesionvae_tpu/parallel/sharded.py).

- geometry: the streamline axis split over ``data``; no collective but the
  exact gather of the results (``sharded_streamline_metrics``).
- VAE training: data-parallel batches with an optional tensor-parallel split
  of the three large dense layers over ``model`` (fc_mu / fc_logv:
  combined_dim x latent; fc_dec: (latent + lesion_out) x micro_out), each
  model rank holding its block of output features (``param_shardings``).
  Where XLA infers the collectives of the JAX steps, the port issues them
  itself (``parallel.mesh``): BatchNorm statistics and the ELBO's sums and
  counts with a differentiable sum over ``data``, one all-reduce of the
  flat gradient buffer a step, and, under tensor parallelism, the gathered
  activations of the split layers and one sum of their squared gradients
  for the global-norm clip.

The steps take pre-drawn reparameterisation noise (lesionvae_tpu/parallel/
sharded.py:107) and update the module and its ``ClipDecayAdam`` in place.
The dryruns start their own ranks with ``parallel.mesh.spawn``: on the card
by default (every rank on ``cuda:{rank % cards}``; gloo lets two ranks share
one card), on the CPU with ``device="cpu"``.
"""

from __future__ import annotations

import time
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..models.elbo import elbo
from ..models.lesion_vae import LesionConditionedVAE
from ..ops.geometry import streamline_metrics_stacked, unstack_metrics
from ..train.trainer import ClipDecayAdam, train_step
from ..utils.precision import full_fp32
from .mesh import Axis, Mesh, make_mesh, pad_to_multiple, spawn

#: the column-parallel layers (lesionvae_tpu/parallel/sharded.py:44)
TP_LAYERS = ("fc_mu", "fc_logv", "fc_dec")
LR, WEIGHT_DECAY, GRAD_CLIP = 2e-4, 1e-3, 2.0


def sharded_streamline_metrics(points: np.ndarray, lengths: np.ndarray,
                               mesh: Mesh, dtype: torch.dtype = torch.float32
                               ) -> Dict[str, np.ndarray]:
    """The streamline metrics of a padded (S, P, 3) bundle with the
    streamline axis split over ``data``: each rank takes its rows (S padded
    to a multiple of the axis by repeating the last one), the (19, S) results
    are gathered exactly, and every rank returns the whole bundle's."""
    axis = mesh.axis("data")
    pts, S = pad_to_multiple(np.asarray(points), axis.size)
    lens, _ = pad_to_multiple(np.asarray(lengths), axis.size)
    rows = axis.block(len(lens))
    stacked = streamline_metrics_stacked(
        torch.from_numpy(np.ascontiguousarray(pts[rows])).to(mesh.device),
        torch.from_numpy(np.ascontiguousarray(lens[rows])).to(mesh.device),
        dtype=dtype)
    return unstack_metrics(axis.gather(stacked, dim=1)[:, :S].cpu().numpy())


def param_shardings(module: LesionConditionedVAE) -> Dict[str, tuple]:
    """Parameter name -> its split: ("model", None) for the weight of a
    column-parallel layer (its output features, the rows of the (out, in)
    weight), ("model",) for its bias, () for every other parameter
    (replicated)."""
    specs = {}
    for name, p in module.named_parameters():
        layer = name.rsplit(".", 1)[0]
        specs[name] = (("model",) + (None,) * (p.dim() - 1)
                       if layer in TP_LAYERS else ())
    return specs


class ColumnParallelLinear(nn.Module):
    """A dense layer whose output features are split over a mesh axis: this
    rank holds its rows of the weight and the bias, computes its features
    and gathers the others exactly; the input's gradient is summed over the
    axis (every rank's features depend on the whole input)."""

    def __init__(self, layer: nn.Linear, axis: Axis):
        super().__init__()
        rows = axis.block(layer.out_features)
        self.axis = axis
        self.weight = nn.Parameter(layer.weight.detach()[rows].clone())
        self.bias = nn.Parameter(layer.bias.detach()[rows].clone())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.linear(self.axis.shared_input(x), self.weight, self.bias)
        return self.axis.gather(y, dim=1)


class ShardedClipDecayAdam(ClipDecayAdam):
    """``ClipDecayAdam`` over a module whose column-parallel leaves hold one
    block each: the global norm counts the split leaves' squares once,
    summed over ``model``, and the replicated leaves' once, not once a
    rank."""

    def __init__(self, module: nn.Module, model_axis: Axis, lr: float,
                 weight_decay: float, grad_clip: float):
        split = {id(m.weight) for m in module.modules()
                 if isinstance(m, ColumnParallelLinear)}
        split |= {id(m.bias) for m in module.modules()
                  if isinstance(m, ColumnParallelLinear)}
        sizes = [(p.numel(), id(p) in split) for p in module.parameters()]
        super().__init__(module, lr, weight_decay, grad_clip)
        self.model_axis = model_axis
        self.split = torch.cat([torch.full((n,), s, dtype=torch.bool) for n, s in sizes]
                               ).to(self.flat.device)

    def grad_norm(self, g: torch.Tensor) -> torch.Tensor:
        own = torch.sum(g[self.split] ** 2)
        return torch.sqrt(torch.sum(g[~self.split] ** 2)
                          + self.model_axis.total_(own))


def _dp_step(module, opt, axis: Axis):
    def step(xm, xl, mask, eps, beta):
        """One step on the global batch: this rank's rows of xm, xl (N, L, C),
        mask (N,) and eps (N, latent).  Returns (loss, recon, kld) of the
        whole batch (0 for a skipped non-finite batch)."""
        rows = axis.block(xm.shape[0])
        out = train_step(module, opt, xm[rows], xl[rows], mask[rows], eps[rows],
                         beta, axis)
        return tuple(out[:3] / out[3])
    return step


def build_sharded_train_step(module: LesionConditionedVAE, mesh: Mesh,
                             batch_size: int, lr: float = LR,
                             weight_decay: float = WEIGHT_DECAY,
                             grad_clip: float = GRAD_CLIP):
    """One data-parallel (+ tensor-parallel) training step over the mesh.

    The module (on the mesh's device, the same weights on every rank) is
    changed in place: its BatchNorms sum over ``data`` and, with a
    ``model`` axis of more than one rank, ``TP_LAYERS`` become
    ``ColumnParallelLinear`` blocks.  Returns (step, optimizer);
    ``step(xm, xl, mask, eps, beta)`` takes the global batch
    (``batch_size`` rows, divisible by the data axis) and returns the
    whole batch's (loss, recon, kld)."""
    data, model = mesh.axis("data"), mesh.axis("model")
    data.block(batch_size)
    module.set_axis(data)
    if model.size > 1:
        for name in TP_LAYERS:
            setattr(module, name, ColumnParallelLinear(getattr(module, name), model))
        opt = ShardedClipDecayAdam(module, model, lr, weight_decay, grad_clip)
    else:
        opt = ClipDecayAdam(module, lr, weight_decay, grad_clip)
    return _dp_step(module, opt, data), opt


def build_shardmap_train_step(module: LesionConditionedVAE, mesh: Mesh,
                              lr: float = LR, weight_decay: float = WEIGHT_DECAY,
                              grad_clip: float = GRAD_CLIP):
    """The data-parallel step with its collectives spelled out, as the JAX
    ``shard_map`` step has them (sharded.py:94-149): BatchNorm statistics
    summed over ``data`` inside the model, the masked ELBO from summed sse /
    n_x / kl_sum / n_z, the gradients summed before the optimizer.  Returns
    (step, optimizer) as ``build_sharded_train_step``."""
    data = mesh.axis("data")
    module.set_axis(data)
    opt = ClipDecayAdam(module, lr, weight_decay, grad_clip)
    return _dp_step(module, opt, data), opt


def full_state_dict(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's ``state_dict`` with every column-parallel block gathered:
    the weights of the one-process model."""
    sd = {}
    for name, t in module.state_dict().items():
        layer = module.get_submodule(name.rsplit(".", 1)[0])
        sd[name] = layer.axis.gather(t, 0) if isinstance(
            layer, ColumnParallelLinear) else t.detach().clone()
    return sd


# ---------------------------------------------------------------- dryruns
def _init(kw: dict, seed: int, device) -> LesionConditionedVAE:
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return LesionConditionedVAE(**kw).to(device)


def _toy_batch(kw: dict, batch: int, seed: int, device, steps: int = 0):
    """xm, xl (batch, L, C) normal, mask with 3 pad rows, eps (batch,
    latent) or (steps, batch, latent), from a seeded CPU generator."""
    g = torch.Generator().manual_seed(seed)
    xm = torch.randn((batch, kw["seq_len"], kw["micro_ch"]), generator=g)
    xl = torch.randn((batch, kw["seq_len"], kw["lesion_ch"]), generator=g)
    eps = torch.randn(((steps,) if steps else ()) + (batch, kw["latent"]), generator=g)
    mask = torch.ones(batch)
    mask[-3:] = 0.0
    return tuple(t.to(device) for t in (xm, xl, mask, eps))


def _shardmap_rank(device, kw: dict, batch: int) -> Tuple[float, float]:
    full_fp32(device)
    mesh = make_mesh(device=device)
    xm, xl, mask, eps = _toy_batch(kw, batch, 0, device)
    module = _init(kw, 0, device)
    single = _init(kw, 0, device)
    single.train()
    xh, mu, logv = single(xm, xl, mask=mask, eps=eps)
    loss_single, _, _ = elbo(torch.nan_to_num(xh, nan=0.0), xm,
                             torch.nan_to_num(mu, nan=0.0),
                             torch.nan_to_num(logv, nan=0.0), beta=0.7, mask=mask)
    step, _ = build_shardmap_train_step(module, mesh)
    before = module.fc_dec.weight.detach().clone()
    loss_sm = step(xm, xl, mask, eps, 0.7)[0]
    delta = float(torch.linalg.norm(module.fc_dec.weight.detach() - before))
    assert delta > 0, "shard_map step did not update parameters"
    return float(loss_sm), float(loss_single.detach())


def dryrun_shardmap_step(n_devices: int, seq_len: int = 16, micro_ch: int = 4,
                         lesion_ch: int = 2, latent: int = 4, batch: int = 32,
                         device: str = "cuda", backend: str = "gloo"
                         ) -> Tuple[float, float]:
    """One explicit data-parallel step on ``n_devices`` ranks and the loss
    of the same batch in one process.  Returns (sharded_loss,
    single_loss): they must agree (same reductions, same pre-drawn eps)."""
    kw = dict(seq_len=seq_len, micro_ch=micro_ch, lesion_ch=lesion_ch, latent=latent)
    return spawn(_shardmap_rank, n_devices, backend, device, kw, batch)[0]


def _train_step_rank(device, model_parallel: int, kw: dict, batch: int
                     ) -> Tuple[float, float]:
    full_fp32(device)
    mesh = make_mesh(model_parallel=model_parallel, device=device)
    module = _init(kw, 0, device)
    xm, xl, mask, eps = _toy_batch(kw, batch, 1, device)
    mask[:] = 1.0
    step, _ = build_sharded_train_step(module, mesh, batch)
    old = full_state_dict(module)["fc_dec.weight"]
    loss = float(step(xm, xl, mask, eps, 0.1)[0])
    delta = float(torch.linalg.norm(full_state_dict(module)["fc_dec.weight"] - old))
    assert np.isfinite(loss), "sharded step produced non-finite loss"
    assert delta > 0, "sharded step did not update parameters"
    return loss, delta


def dryrun_train_step(n_devices: int, model_parallel: int = 2, seq_len: int = 16,
                      micro_ch: int = 4, lesion_ch: int = 2, latent: int = 4,
                      batch: int = 16, device: str = "cuda", backend: str = "gloo"
                      ) -> Tuple[float, float]:
    """One data- and tensor-parallel step on ``n_devices`` ranks at tiny
    shapes.  Returns (loss, norm of the change of fc_dec's weight)."""
    mp = model_parallel if n_devices % model_parallel == 0 else 1
    kw = dict(seq_len=seq_len, micro_ch=micro_ch, lesion_ch=lesion_ch, latent=latent)
    return spawn(_train_step_rank, n_devices, backend, device, mp, kw, batch)[0]


def _flagship_rank(device, n_devices: int, steps: int, epochs: int, seed: int,
                   batch_per_device: int, fleet_rows: int, fleet_members,
                   verbose: bool) -> dict:
    from ..train.batched import launch_many_vaes, pad_datasets
    from .mesh import collectives_issued, reset_collectives

    full_fp32(device)
    t_start = time.perf_counter()
    mesh = make_mesh(n_devices, device=device)

    def _phase(msg):
        if verbose and mesh.is_main:
            print(f"FLAGSHIP phase: {msg} (t+{time.perf_counter() - t_start:.0f}s)",
                  flush=True)

    kw = dict(seq_len=100, micro_ch=13, lesion_ch=3, latent=10)
    batch = batch_per_device * n_devices
    xm, xl, mask, eps_all = _toy_batch(kw, batch, seed, device, steps=steps)
    betas = np.linspace(0.1, 2.0, steps).astype(np.float32)

    # path 1a: the data-parallel step of build_sharded_train_step (the GSPMD
    # step's counterpart); 1b: the explicit shard_map form; same init, noise
    runs = {}
    for label, build in (("sharded", lambda m: build_sharded_train_step(m, mesh, batch)),
                         ("shardmap", lambda m: build_shardmap_train_step(m, mesh))):
        module = _init(kw, seed, device)
        step, _ = build(module)
        losses = [float(step(xm, xl, mask, eps_all[i], float(betas[i]))[0])
                  for i in range(steps)]
        runs[label] = (module, losses)
        _phase(f"{label} dp={n_devices}: {steps} steps done, loss={losses[-1]:.4f}")
    (m_g, losses_g), (m_s, losses_s) = runs["sharded"], runs["shardmap"]

    early = [abs(a - b) / max(abs(b), 1e-12)
             for a, b in zip(losses_g[:4], losses_s[:4])]
    assert max(early) < 1e-5, (
        f"flagship sharded vs shard_map diverge at early steps: {early} "
        f"(same-math violation, not FP drift)")
    rel = abs(losses_g[-1] - losses_s[-1]) / max(abs(losses_s[-1]), 1e-12)
    assert rel < 5e-2, (
        f"flagship sharded loss {losses_g[-1]} vs shard_map {losses_s[-1]} "
        f"after {steps} steps (rel {rel:.2e} exceeds drift bound)")
    max_dp = 0.0
    for (name, a), b in zip(m_g.named_parameters(), m_s.parameters()):
        d = float((a - b).detach().abs().max())
        scale = float(b.detach().abs().max()) + 1e-8
        assert np.isfinite(d) and d / scale < 0.5, (
            f"flagship param divergence {d:.3e} (scale {scale:.3e}) at {name} "
            f"after {steps} steps")
        max_dp = max(max_dp, d / scale)

    # path 2: the member-sharded fleet at flagship dims
    T = fleet_members if fleet_members is not None else 2 * n_devices
    assert T % n_devices == 0, "fleet members must tile the device mesh"
    rng = np.random.default_rng(seed)
    tensors = [(rng.normal(size=(fleet_rows, 100, 13)).astype(np.float32),
                rng.uniform(size=(fleet_rows, 100, 3)).astype(np.float32))
               for _ in range(T)]
    Xm_T, Xl_T, n_real = pad_datasets(tensors, batch_size=64)
    sham_T = np.zeros((T, Xm_T.shape[1]), np.float32)
    sham_T[:, :fleet_rows // 2] = 1.0
    subj_T = np.full((T, Xm_T.shape[1]), 5, np.int32)
    reset_collectives()
    h = launch_many_vaes(Xm_T, Xl_T, n_real, latent_dim=10, epochs=epochs,
                         batch_size=64, seed=seed + 1,
                         summary_spec=(sham_T, subj_T, 6, 7),
                         normalize_on_device=True, mesh=mesh, device=device)
    train_collectives = collectives_issued()
    _models, hist = h.fetch()
    assert train_collectives == 0, f"the fleet issued {train_collectives} collectives"
    assert hist.shape == (T, epochs, 4) and np.isfinite(hist).all(), (
        f"flagship fleet history bad: shape {hist.shape}")
    mag_T = h.summary[2].cpu().numpy()
    assert mag_T.shape[0] == T and np.isfinite(mag_T).all()
    _phase(f"fleet x{T}: {epochs} epochs done, "
           f"mean_loss={float(hist[:, -1, 0].mean()):.4f}")
    return {"dims": kw, "steps": steps, "batch": batch,
            "gspmd_loss": losses_g[-1], "shardmap_loss": losses_s[-1],
            "early_step_rel": max(early), "max_param_rel_div": max_dp,
            "fleet_members": T, "fleet_epochs": epochs,
            "fleet_mean_loss": float(hist[:, -1, 0].mean())}


def dryrun_flagship(n_devices: int, steps: int = 10, epochs: int = 2,
                    seed: int = 0, batch_per_device: int = 4,
                    fleet_rows: int = 40, fleet_members: int | None = None,
                    verbose: bool = False, device: str = "cuda",
                    backend: str = "gloo") -> dict:
    """Flagship-shape multi-rank validation at the real model dims (seq 100,
    13 + 3 channels, latent 10), with the JAX function's assertions:

    1. ``steps`` data-parallel steps through ``build_sharded_train_step``
       and the same steps through ``build_shardmap_train_step``, from one
       init and one pre-drawn noise: losses within 1e-5 on the first four
       steps and 5e-2 at the end, every parameter within half its scale;
    2. a member-sharded fleet, T = ``fleet_members`` (default 2 a rank) x
       ``epochs`` epochs through normalize -> train -> summary, with no
       collective in training: finite history and summary.

    ``verbose`` prints a timed line after each phase.  Returns rank 0's
    summary dict (the keys of the JAX function's)."""
    return spawn(_flagship_rank, n_devices, backend, device, n_devices, steps,
                 epochs, seed, batch_per_device, fleet_rows, fleet_members,
                 verbose)[0]
