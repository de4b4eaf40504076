"""Cohort-batched VAE training: many (tract x timepoint) VAEs trained as one
program (the port of lesionvae_tpu/train/batched.py).

The cohort has 16 tracts x 4 timepoints of independent VAEs.  Their datasets
are padded to one (T, n_pad, L, C) block on the device and one Python step
drives all T members: the stacked model of ``models.fleet`` runs every
member's forward and backward in the same kernels (launches a step do not
grow with T), and ``train.lowmem.LowmemOptimizer`` updates the stacked
buffers.  Every member sees only its own rows, mask, noise, BatchNorm
statistics, gradient norm, finite flag and step count, so a member of the
fleet equals the same member trained alone with the same draws.

Kept from the JAX package (documented there as distributional-parity safe):
each epoch permutes all ``n_pad`` rows, so masked pad rows are scattered
through the batches rather than collected in one tail batch
(``mask = perm < n_i``); BatchNorm statistics and the ELBO stay mask-exact.
Batches are gathered by index from the device-resident block.

Every permutation, every reparameterisation draw, the initial weights and
the stochastic-rounding salts come from CPU generators seeded from ``seed``
and move to the device once, so a ``cuda`` and a ``cpu`` run see the same
numbers; ``perms=``, ``noise=``, ``salts=`` and ``state_dicts=`` inject
others (the tests pass the JAX package's).  No member exists as a module on
the host: the initial weights are drawn (``draw_init``: one native pass
over torch's CPU generator stream, bit for bit the calls torch's module
init makes) or the injected ``state_dicts``
stacked into one (T, width) row a member (``models.fleet.Layout``), pinned
and reused across launches on ``cuda``, and cross to the device as one
copy; ``FleetHandle.fetch`` builds each member on the device from the
trained state (``FleetState.member``).  Nothing inside training waits for
the device: history, finite flags and epoch sums stay on it until
``FleetHandle.fetch``.

Training is one device program (``FleetProgram``, the counterpart of the
JAX package's ``_fleet_program``): the members' state, data, draws, history
and a device epoch counter live in the program's buffers, the epoch body
takes the epoch's permutations, noise and KLD weight through the counter,
and on ``cuda`` each epoch is one replay of a captured CUDA graph
(``train.program``).  Programs are cached by static configuration, so the
chunks of a chunked launch, the blocks of a split one and a real launch
after a ``warm_compile`` one replay one program with no new capture.
``train_fleet`` is the same arithmetic as a Python loop of eager launches,
the reference the graph is held against.  Normalization before training and
the normative summary after it run eagerly.

``FLEET_LAUNCH_LEDGER`` records one entry a block launch, as the JAX
package's does a program dispatch: the program's name and the (shape,
dtype) of each staged argument.  With ``mesh=`` each data rank trains its
own block of members with no collective (lesionvae_tpu/train/batched.py:58-66),
and ``fetch`` assembles the fleet on every rank.

Spans (``utils.profiling.span``) cut the launch's host work at its
boundaries: ``fleet.init`` (the members' initial weights drawn into their
host rows, or the injected ones stacked there), ``fleet.draws``, then a
block's ``fleet.upload``, ``fleet.normalize``, ``fleet.state`` (its rows'
one copy to the device, and the summary's inputs), ``fleet_train`` (the
program's run, which the launch does not wait for) and
``member_summary``; ``fetch.members`` (a mesh's blocks assembled, the
members built on the device behind the training still queued there) and
``fetch.history`` (where the host waits for the card).
A chunked launch opens a block's spans once a chunk.  ``fleet_train`` and
``member_summary`` are also device ranges (every kernel they launch).
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import namedtuple
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.nn import init

from ..models.elbo import elbo_fleet
from ..models.fleet import FleetState, fleet_forward, layer_range, layout
from ..models.lesion_vae import LesionConditionedVAE, TrainedVAE
from ..ops import cuda_build
from ..utils.logging import get_logger
from ..utils.precision import full_fp32, math_mode
from ..utils.profiling import span
from . import data as vdata
from .lowmem import FlatLowmemOptimizer, LowmemOptimizer, draw_salts
from .normative import fleet_noise, member_summary
from .program import COUNTS, EpochGraph, ProgramCache, betas, count_h2d
from .quantize import codes_to_tensor, dequantize_u16, quantize_u16

log = get_logger("batched")

#: one ("fleet_train", (ArgSpec, ...)) entry a block launch since the last
#: reset: the staged arguments' shapes and dtypes (the raw or uint16 blocks
#: Xm and Xl, n_real and, with a summary, sham and the subject index), as
#: lesionvae_tpu/train/batched.py:505 records them.  A chunked launch adds
#: one entry a chunk, a mesh rank one for its own block.
FLEET_LAUNCH_LEDGER: list = []
ArgSpec = namedtuple("ArgSpec", "shape dtype")


def reset_fleet_ledger() -> None:
    FLEET_LAUNCH_LEDGER.clear()


def pad_datasets(tensors, batch_size: int = 64, min_rows: int = 0
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack a list of (Xm_i, Xl_i) pairs into common-shape padded blocks
    (pad rows zero); the row axis is padded to a multiple of ``batch_size``
    and to at least ``min_rows``.  Returns (Xm, Xl, n_real)."""
    n_max = max(max(x.shape[0] for x, _ in tensors), min_rows)
    n_pad = -(-n_max // batch_size) * batch_size
    L, Cm = tensors[0][0].shape[1:]
    Cl = tensors[0][1].shape[2]
    T = len(tensors)
    Xm = np.zeros((T, n_pad, L, Cm), np.float32)
    Xl = np.zeros((T, n_pad, L, Cl), np.float32)
    n_real = np.zeros(T, np.int32)
    for i, (xm, xl) in enumerate(tensors):
        n = xm.shape[0]
        Xm[i, :n] = xm
        Xl[i, :n] = xl
        n_real[i] = n
    return Xm, Xl, n_real


def draw_fleet(members: int, n_pad: int, epochs: int, batch_size: int,
               latent: int, generator: torch.Generator
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every permutation (T, epochs, n_pad) of all padded rows and every
    reparameterisation draw (T, epochs, n_batches, batch_size, latent) of a
    fleet run, on the CPU."""
    perms = torch.rand((members, epochs, n_pad), generator=generator).argsort(dim=-1)
    noise = torch.randn((members, epochs, n_pad // batch_size, batch_size, latent),
                        generator=generator)
    return perms, noise


def fleet_step(state: FleetState, opt: LowmemOptimizer, xb_m: torch.Tensor,
               xb_l: torch.Tensor, mask: torch.Tensor, eps: torch.Tensor,
               beta, compute_dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """One batch of every member: train-mode forward (advances each member's
    BatchNorm statistics, written in place), ELBO in the data's dtype with
    the KLD weight ``beta`` (a float or a 0-dim tensor), gradients, and the
    update of every member whose loss is finite.  xb_m (T, B, L, Cm), xb_l
    (T, B, L, Cl), mask (T, B), eps (T, B, latent).  Returns (T, 4):
    [loss*n, recon*n, kld*n, n] for the member's real rows n, zeroed for a
    skipped member (NaN times zero stays NaN, as in the JAX program)."""
    leaves = state.grad_leaves()
    xh, mu, logv, new_stats = fleet_forward(
        state.layout, leaves, state.stats, xb_m, xb_l, mask, eps, True,
        compute_dtype)
    wide = xb_m.dtype
    with layer_range("loss"):
        xh = torch.nan_to_num(xh.to(wide), nan=0.0)
        mu = torch.nan_to_num(mu.to(wide), nan=0.0)
        logv = torch.nan_to_num(logv.to(wide), nan=0.0)
        loss, recon, kld = elbo_fleet(xh, xb_m, mu, logv, beta, mask)
    names = list(leaves)
    with layer_range("backward"):
        grads = torch.autograd.grad(loss.sum(), [leaves[n] for n in names])
    with layer_range("optimizer"):
        finite = torch.isfinite(loss)
        with torch.no_grad():
            for k, v in new_stats.items():
                state.stats[k].copy_(v)
        opt.step(dict(zip(names, grads)), finite)
    n_valid = mask.to(wide).sum(dim=1)
    loss, recon, kld = loss.detach(), recon.detach(), kld.detach()
    return finite.to(wide)[:, None] * torch.stack(
        [loss * n_valid, recon * n_valid, kld * n_valid, n_valid], dim=1)


def train_fleet(state: FleetState, opt: LowmemOptimizer, Xm: torch.Tensor,
                Xl: torch.Tensor, n_real: torch.Tensor, perms: torch.Tensor,
                noise: torch.Tensor, epochs: int, batch_size: int,
                compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Train ``state`` in place on the device blocks Xm, Xl (T, n_pad, L, C)
    as a Python loop of eager launches, epoch by epoch: the reference the
    program is held against (``FleetProgram``, the same operations in the
    same order).  Returns the (T, epochs, 4) history [loss, recon, kld,
    beta] on the device."""
    T, n_pad = Xm.shape[:2]
    rows = torch.arange(T, device=Xm.device)[:, None]
    beta_t = torch.tensor(betas(epochs), dtype=Xm.dtype, device=Xm.device)
    hist = []
    for ep in range(epochs):
        sums = Xm.new_zeros((T, 4))
        for b in range(n_pad // batch_size):
            idx = perms[:, ep, b * batch_size:(b + 1) * batch_size]
            sums = sums + fleet_step(
                state, opt, Xm[rows, idx], Xl[rows, idx],
                (idx < n_real[:, None]).to(Xm.dtype), noise[:, ep, b], beta_t[ep],
                compute_dtype)
        seen = sums[:, 3:4]
        avg = torch.where(seen > 0, sums[:, :3] / seen, torch.nan)
        hist.append(torch.cat([avg, beta_t[ep].expand(T, 1)], dim=1))
    return torch.stack(hist, dim=1)


class FleetProgram:
    """The training of T members of one static configuration as one device
    program: the counterpart of lesionvae_tpu/train/batched.py:48-258
    (its training scan; normalization and the summary run beside it).

    Buffers: a ``FleetState`` and its optimizer (moments, step counts, the
    stochastic-rounding salts), the device blocks ``Xm`` / ``Xl`` and the
    real row counts, the permutations and noise of every epoch, the KLD
    weights, the (T, epochs, 4) history and the epoch counter ``ep``.
    ``epoch`` is the body of one epoch (the ``n_batches`` fleet steps
    unrolled, the epoch's draws and history column taken through ``ep``,
    which it advances); ``run`` copies a launch's state, salts, data and
    draws in, runs the epochs (one graph replay each on ``cuda``) and
    copies the trained state out."""

    def __init__(self, lay, members: int, n_pad: int, epochs: int, batch_size: int,
                 lr: float, weight_decay: float, grad_clip: float,
                 store_dtype: Optional[torch.dtype],
                 compute_dtype: Optional[torch.dtype], flat_opt: bool,
                 device: torch.device, dtype: torch.dtype):
        self.epochs, self.batch_size = epochs, batch_size
        self.n_batches = n_pad // batch_size
        self.compute_dtype = compute_dtype
        self.state = FleetState(lay, members, dtype, store_dtype, device)
        self.opt = (FlatLowmemOptimizer if flat_opt else LowmemOptimizer)(
            self.state, lr, weight_decay, grad_clip,
            salts=torch.zeros(members, dtype=torch.int64))
        h = lay.hyper
        new = lambda *shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)  # noqa: E731
        self.Xm = new(members, n_pad, h["seq_len"], h["micro_ch"])
        self.Xl = new(members, n_pad, h["seq_len"], h["lesion_ch"])
        self.n_real = new(members, dt=torch.int64)
        self.perms = new(members, epochs, n_pad, dt=torch.int64)
        self.noise = new(members, epochs, self.n_batches, batch_size, h["latent"])
        self.rows = torch.arange(members, device=device)[:, None]
        self.beta_t = torch.tensor(betas(epochs), dtype=dtype, device=device)
        self.hist = new(members, epochs, 4)
        self.ep = new(1, dt=torch.int64)
        self.graph = EpochGraph(self.epoch, self.state_tensors(), device)

    def state_tensors(self) -> List[torch.Tensor]:
        """The tensors an epoch carries to the next (the optimizer's
        gradient buffer is scratch, written before each read)."""
        st, o = self.state, self.opt
        return [st.weights, st.affine, *st.stats.values(), o.mu_w, o.nu_w, o.mu_a,
                o.nu_a, o.count, self.hist, self.ep]

    def buffers(self) -> List[torch.Tensor]:
        """Every tensor the body reads or writes."""
        o = self.opt
        extra = [o.salt] if o.lowmem else []
        return self.state_tensors() + extra + [
            o.g_w, o.g_a, o._work, o.sq, o.g_norm, self.Xm, self.Xl, self.n_real,
            self.perms, self.noise, self.rows, self.beta_t]

    def epoch(self) -> None:
        B, T = self.batch_size, self.Xm.shape[0]
        perm = self.perms.index_select(1, self.ep)[:, 0]
        noise = self.noise.index_select(1, self.ep)[:, 0]
        beta = self.beta_t.index_select(0, self.ep)
        sums = self.Xm.new_zeros((T, 4))
        for b in range(self.n_batches):
            idx = perm[:, b * B:(b + 1) * B]
            sums = sums + fleet_step(
                self.state, self.opt, self.Xm[self.rows, idx], self.Xl[self.rows, idx],
                (idx < self.n_real[:, None]).to(self.Xm.dtype), noise[:, b], beta[0],
                self.compute_dtype)
        seen = sums[:, 3:4]
        avg = torch.where(seen > 0, sums[:, :3] / seen, torch.nan)
        row = torch.cat([avg, beta.expand(T, 1)], dim=1)
        self.hist.index_copy_(1, self.ep, row[:, None])
        self.ep.add_(1)

    @torch.no_grad()
    def load(self, state: FleetState, salts: Optional[torch.Tensor], Xm: torch.Tensor,
             Xl: torch.Tensor, n_real: torch.Tensor, perms: torch.Tensor,
             noise: torch.Tensor) -> None:
        """A launch's start: its members' weights and statistics, then
        ``start``."""
        st = self.state
        for name in ("weights", "affine"):
            getattr(st, name).copy_(getattr(state, name))
        for k, t in st.stats.items():
            t.copy_(state.stats[k])
        self.start(salts, Xm, Xl, n_real, perms, noise)

    @torch.no_grad()
    def start(self, salts: Optional[torch.Tensor], Xm: torch.Tensor, Xl: torch.Tensor,
              n_real: torch.Tensor, perms: torch.Tensor, noise: torch.Tensor) -> None:
        """Zero moments and step counts, a launch's salts (read with
        bfloat16 storage only), epoch 0, its data and draws."""
        o = self.opt
        for t in (o.mu_w, o.nu_w, o.mu_a, o.nu_a, o.count, self.hist, self.ep):
            t.zero_()
        if o.lowmem:
            o.salt.copy_(salts)
        for dst, src in ((self.Xm, Xm), (self.Xl, Xl), (self.n_real, n_real),
                         (self.perms, perms), (self.noise, noise)):
            dst.copy_(src)

    def run(self, state: FleetState, salts: Optional[torch.Tensor], Xm: torch.Tensor,
            Xl: torch.Tensor, n_real: torch.Tensor, perms: torch.Tensor,
            noise: torch.Tensor) -> torch.Tensor:
        """Train ``state`` in place; returns its (T, epochs, 4) history."""
        with span("program.load"):
            self.load(state, salts, Xm, Xl, n_real, perms, noise)
        self.graph.run(self.epochs)
        with torch.no_grad():
            for name in ("weights", "affine"):
                getattr(state, name).copy_(getattr(self.state, name))
            for k, t in state.stats.items():
                t.copy_(self.state.stats[k])
        return self.hist.clone()

    def run_module(self, module: LesionConditionedVAE, Xm: torch.Tensor,
                   Xl: torch.Tensor, n: int, perms: torch.Tensor,
                   noise: torch.Tensor) -> np.ndarray:
        """A one-member program trains ``module`` in place on padded blocks
        (n_pad, L, C) whose first ``n`` rows are real, with its draws
        (epochs, n_pad) and (epochs, n_batches, B, latent): the module's
        parameters and running statistics are copied straight into the
        program's state and, trained, back into the module's own tensors.
        Returns the (epochs, 4) history, read under ``program.history``."""
        own = module.state_dict()
        views = {name: t[0] for name, t in {**self.state.leaves,
                                            **self.state.stats}.items()}
        with span("program.load"), torch.no_grad():
            for name, t in own.items():
                views[name].copy_(t)
            self.start(None, Xm[None], Xl[None], torch.full_like(self.n_real, n),
                       perms[None], noise[None])
        self.graph.run(self.epochs)
        with span("program.history"), torch.no_grad():
            for name, t in own.items():
                t.copy_(views[name])
            # a copy: on the CPU ``.cpu()`` would alias the program's buffer
            return self.hist[0].to("cpu", copy=True).numpy()

    def free(self) -> None:
        self.graph.free()


#: the fleet's programs by static configuration, as lru_cache(maxsize=8)
#: holds the JAX package's
PROGRAMS = ProgramCache(8)


def fleet_program(lay, members: int, n_pad: int, epochs: int, batch_size: int,
                  lr: float, weight_decay: float, grad_clip: float,
                  store_dtype: Optional[torch.dtype],
                  compute_dtype: Optional[torch.dtype], flat_opt: bool, device,
                  dtype: torch.dtype, cache: Optional[ProgramCache] = None
                  ) -> FleetProgram:
    """The cached program of this configuration, in ``cache`` (default
    ``PROGRAMS``; the single trainer keeps its one-member programs in
    ``train.trainer.PROGRAMS``)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    key = (tuple(sorted(lay.hyper.items())), members, n_pad, epochs, batch_size, lr,
           weight_decay, grad_clip, store_dtype, compute_dtype, bool(flat_opt),
           device, dtype, math_mode())
    cache = PROGRAMS if cache is None else cache
    return cache.get(key, lambda: FleetProgram(
        lay, members, n_pad, epochs, batch_size, lr, weight_decay, grad_clip,
        store_dtype, compute_dtype, flat_opt, device, dtype))


class FleetHandle:
    """A trained fleet.  ``fetch()`` (or calling it) returns ``(list of
    TrainedVAE, (T, epochs, 4) history array)``.  The stacked ``state``
    (parameters and statistics), the device-resident blocks ``Xm`` / ``Xl``
    (normalized, when the launch normalized them), the per-member
    normalization statistics ``norm_stats`` and the fused normative summary
    ``summary`` (mean, std, magnitude, per-subject profile, counts) stay on
    the device for the programs that follow."""

    def __init__(self, state: FleetState, hist: torch.Tensor, epochs: int,
                 n_batches: int, Xm: torch.Tensor, Xl: torch.Tensor,
                 summary=None, norm_stats: Optional[Dict[str, torch.Tensor]] = None,
                 mesh=None):
        self.state, self.hist = state, hist
        self.Xm, self.Xl = Xm, Xl
        self.summary, self.norm_stats = summary, norm_stats
        self._epochs, self._n_batches = epochs, n_batches
        self.mesh = mesh

    def assemble(self) -> None:
        """A mesh rank's handle holds its own block of members.  This
        gathers every block over the data axis, bit for bit, so that state,
        history, summary and normalization statistics hold all T members on
        every rank (the device blocks ``Xm`` / ``Xl`` stay the rank's own).
        Every rank of the mesh must call it; ``fetch`` does."""
        if self.mesh is None:
            return
        axis = self.mesh.axis("data")
        gather = lambda t: axis.gather(t, 0)  # noqa: E731
        own = self.state
        state = FleetState(own.layout, own.members * axis.size, own.dtype,
                           own.store_dtype, own.device)
        state.weights.copy_(gather(own.weights))
        state.affine.copy_(gather(own.affine))
        state.stats = {k: gather(v) for k, v in own.stats.items()}
        self.state, self.hist = state, gather(self.hist)
        if self.summary is not None:
            self.summary = tuple(gather(t) for t in self.summary)
        if self.norm_stats is not None:
            self.norm_stats = {k: gather(v) for k, v in self.norm_stats.items()}
        self.mesh = None

    def fetch(self) -> Tuple[List[TrainedVAE], np.ndarray]:
        """The members, built on the device from the trained state (every
        one before this returns), then the history, the first read that
        waits for the card: the members' host work overlaps the training
        still queued there."""
        with span("fetch.members"):
            self.assemble()
            models = [TrainedVAE(m) for m in self.state.modules()]
            COUNTS["fetched_members"] += len(models)
        with span("fetch.history"):
            hist = self.hist.cpu().numpy()
        log.info("trained %d VAEs concurrently (%d epochs, %d batches/epoch)",
                 len(models), self._epochs, self._n_batches)
        return models, hist

    __call__ = fetch


@functools.lru_cache(maxsize=16)
def init_segments(lay) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Where a member's initial-weight draws go in its row, in draw order:
    (offset, count, lo, hi), one entry a weight leaf, each leaf followed by
    its bias.  The bounds are those of the calls each layer's
    ``reset_parameters`` makes (``kaiming_uniform_(a=sqrt(5))``, then the
    bias ``uniform_`` over its weight's fan-in), worked out by torch's own
    helpers and cast to float32 as ``uniform_`` casts them."""
    views = lay.split(torch.empty(lay.width, device="meta"))
    weights = lay.names("weights")
    gain = init.calculate_gain("leaky_relu", math.sqrt(5))
    table = []
    for w, b in zip(weights[0::2], weights[1::2]):
        fan_in, _ = init._calculate_fan_in_and_fan_out(views[w])
        std = gain / math.sqrt(fan_in)
        bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
        for name, limit in ((w, math.sqrt(3.0) * std), (b, bound)):
            if not views[name].is_contiguous():
                raise ValueError(f"{name} is not contiguous in a member's row")
            table.append((views[name].storage_offset(), views[name].numel(), -limit, limit))
    offset, count, lo, hi = zip(*table)
    out = (np.array(offset, np.int64), np.array(count, np.int64),
           np.array(lo, np.float32), np.array(hi, np.float32))
    for a in out:
        a.flags.writeable = False
    return out


@functools.lru_cache(maxsize=None)
def init_library() -> Optional[ctypes.CDLL]:
    """The native pass of ``draw_init`` (``ops/csrc/init_draws.cpp``), built
    on first use; None on a host that cannot build it."""
    lib = cuda_build.load_host("init_draws")
    if lib is not None:
        ptr, i64 = ctypes.c_void_p, ctypes.c_int64
        lib.draw_segments.argtypes = [ctypes.c_uint32, ptr, i64, i64, ptr, ptr, ptr, ptr, i64]
        lib.draw_segments.restype = i64
    return lib


def _init_rows(lay, members: int, out: Optional[torch.Tensor]) -> torch.Tensor:
    rows = torch.empty((members, lay.width)) if out is None else out
    if (rows.shape != (members, lay.width) or rows.dtype != torch.float32
            or rows.device.type != "cpu" or rows.stride(1) != 1
            or (members > 1 and rows.stride(0) < lay.width)):
        raise ValueError(f"init rows must be ({members}, {lay.width}) float32 on the "
                         f"CPU with unit stride, got {tuple(rows.shape)} {rows.dtype} "
                         f"on {rows.device}")
    return rows


def _fill_batchnorm(lay, views: Mapping[str, torch.Tensor]) -> None:
    """BatchNorm scales and running variances 1, shifts and running means
    0 (no draws)."""
    for name in (*lay.names("affine"), *lay.stats):
        views[name].fill_(1.0 if name.endswith((".weight", ".running_var")) else 0.0)


def draw_init(lay, members: int, seed: int,
              out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Initial weights of ``members`` VAEs as (members, ``lay.width``)
    float32 rows on the CPU (into ``out`` when given), bit for bit the
    ``state_dict``s of modules built one after the other from torch's
    global generator seeded with ``seed``, with no module built and the
    global generator left as it was: one native pass over torch's CPU
    stream (``draw_init_native``), or, on a host that cannot build it, the
    calls the modules' init makes (``draw_init_plain``)."""
    if init_library() is None:
        return draw_init_plain(lay, members, seed, out)
    return draw_init_native(lay, members, seed, out)


def draw_init_native(lay, members: int, seed: int,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``draw_init`` as one pass of ``ops/csrc/init_draws.cpp``: torch's
    mt19937 seeded as ``torch.manual_seed(seed)`` seeds it and read through
    ``uniform_``'s float32 transform, member after member, into the leaves
    of ``init_segments``; torch's generators are not touched."""
    rows = _init_rows(lay, members, out)
    offset, count, lo, hi = init_segments(lay)
    # the seed as torch's generator takes it (its range checked, a negative
    # one mapped), of which mt19937 keeps the low 32 bits
    seed32 = torch.Generator().manual_seed(seed).initial_seed() & 0xFFFFFFFF
    COUNTS["init_draws_native"] += init_library().draw_segments(
        seed32, rows.data_ptr(), members, rows.stride(0), offset.ctypes.data,
        count.ctypes.data, lo.ctypes.data, hi.ctypes.data, len(offset))
    _fill_batchnorm(lay, lay.split(rows))
    return rows


def draw_init_plain(lay, members: int, seed: int,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version of ``draw_init``: member after member from torch's
    global generator seeded with ``seed`` inside ``fork_rng``, each
    convolution and dense layer with the calls its ``reset_parameters``
    makes, in the module's construction order, one leaf a call."""
    rows = _init_rows(lay, members, out)
    views = lay.split(rows)
    weights = lay.names("weights")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for i in range(members):
            for w, b in zip(weights[0::2], weights[1::2]):
                weight = views[w][i]
                init.kaiming_uniform_(weight, a=math.sqrt(5))
                fan_in, _ = init._calculate_fan_in_and_fan_out(weight)
                bound = 1 / math.sqrt(fan_in) if fan_in > 0 else 0
                init.uniform_(views[b][i], -bound, bound)
    COUNTS["init_draws_plain"] += members * lay.n_weights
    _fill_batchnorm(lay, views)
    return rows


class HostRows:
    """The pinned (members, width) float32 rows a fleet's initial weights
    are drawn into on ``cuda``, kept in ``PROGRAMS`` across the launches of
    one layout and fleet size.  ``FleetState.from_rows`` copies them to the
    device synchronously, so a launch's draws never overwrite a copy still
    pending (a ``warm_compile`` launch, then a real one)."""

    def __init__(self, lay, members: int):
        self.rows = torch.empty((members, lay.width), pin_memory=True)

    def free(self) -> None:
        self.rows = None


def host_rows(lay, members: int, device: torch.device) -> Optional[torch.Tensor]:
    """The cached pinned rows on ``cuda``; None (fresh rows) elsewhere."""
    if device.type != "cuda":
        return None
    key = ("host_rows", tuple(sorted(lay.hyper.items())), members)
    return PROGRAMS.get(key, lambda: HostRows(lay, members)).rows


def init_state_dicts(members: int, hyper: Mapping[str, int], seed: int):
    """Initial weights of ``members`` VAEs (torch default init, ``draw_init``)
    as ``state_dict``s: views of one row a member."""
    lay = layout(**hyper)
    return [lay.split(row) for row in draw_init(lay, members, seed)]


def member_draws(members: int, n_pad: int, hyper: Mapping[str, int], epochs: int,
                 batch_size: int, seed: int, block: slice = slice(None)
                 ) -> Dict[str, object]:
    """The canonical fleet's per-member draws, what ``launch_many_vaes``
    draws from ``seed`` for a ``members``-member fleet of ``n_pad`` padded
    rows (``hyper``: ``models.fleet.layout(...).hyper``), cut to the members
    ``block``: initial weights, permutations, noise and stochastic-rounding
    salts, as the keyword arguments of that name.  Launching the blocks of
    one logical fleet with these (each block padded to the same ``n_pad``)
    trains every member as the single launch does (the counterpart of the
    JAX package's ``member_keys``: lesionvae_tpu/train/batched.py:401-420)."""
    gen = torch.Generator().manual_seed(seed)
    perms, noise = draw_fleet(members, n_pad, epochs, batch_size, hyper["latent"], gen)
    return {"state_dicts": init_state_dicts(members, hyper, seed)[block],
            "perms": perms[block], "noise": noise[block],
            "salts": draw_salts(members, gen)[block]}


def resolve_chunks(upload_chunks, members: int) -> int:
    """``upload_chunks`` as a count: an int >= 1 that divides the fleet, or
    ``"auto"``, the largest divisor of the fleet size that is <= 8."""
    if upload_chunks == "auto":
        return max(k for k in range(1, 9) if members % k == 0)
    if not isinstance(upload_chunks, int) or upload_chunks < 1:
        raise ValueError("upload_chunks must be >= 1 or 'auto'")
    if members % upload_chunks != 0:
        raise ValueError(f"fleet size {members} not divisible by "
                         f"upload_chunks ({upload_chunks})")
    return upload_chunks


def cat_handles(handles: Sequence[FleetHandle]) -> FleetHandle:
    """One handle of the members of ``handles`` (chunks or blocks of one
    fleet) in order: every output is member-leading, so each is the
    handles' outputs stacked."""
    first = handles[0]
    cat = lambda ts: torch.cat(list(ts), dim=0)  # noqa: E731
    state = FleetState(first.state.layout, sum(h.state.members for h in handles),
                       first.state.dtype, first.state.store_dtype, first.state.device)
    for name in ("weights", "affine"):
        getattr(state, name).copy_(cat(getattr(h.state, name) for h in handles))
    state.stats = {k: cat(h.state.stats[k] for h in handles) for k in first.state.stats}
    summary = (None if first.summary is None else
               tuple(cat(parts) for parts in zip(*(h.summary for h in handles))))
    norm_stats = (None if first.norm_stats is None else
                  {k: cat(h.norm_stats[k] for h in handles) for k in first.norm_stats})
    return FleetHandle(state, cat(h.hist for h in handles), first._epochs,
                       first._n_batches, cat(h.Xm for h in handles),
                       cat(h.Xl for h in handles), summary=summary,
                       norm_stats=norm_stats)


def launch_many_vaes(Xm: np.ndarray, Xl: np.ndarray, n_real: np.ndarray,
                     latent_dim: int = 10, epochs: int = 40,
                     batch_size: int = 64, lr: float = 2e-4,
                     weight_decay: float = 1e-3, grad_clip: float = 2.0,
                     seed: int = 42, compute_dtype: Optional[torch.dtype] = None,
                     summary_spec=None, normalize_on_device: bool = False,
                     store_dtype: Optional[torch.dtype] = None,
                     quantize_upload: bool = False, flat_opt: bool = False,
                     upload_chunks: "int | str" = 1, device="cuda",
                     dtype: torch.dtype = torch.float32,
                     state_dicts: Optional[Sequence[Mapping]] = None,
                     perms: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     salts: Optional[torch.Tensor] = None,
                     summary_noise=None, mesh=None,
                     warm_compile: bool = False) -> FleetHandle:
    """Train T VAEs as one program on ``device``; returns a FleetHandle.

    Xm: (T, n_pad, L, Cm) padded microstructure tensors (pad rows zero), Xl:
    (T, n_pad, L, Cl), n_real: (T,) real row counts.
    ``summary_spec`` = (sham_T, subj_idx_T, n_seg, norm_seed) appends the
    normative summary (``train.normative.member_summary``) to the run;
    ``summary_noise`` = (draw A, draw B), each (n_pad, latent), replaces its
    seeded noise.
    ``normalize_on_device``: Xm / Xl are raw and the reference's fit + apply
    normalization runs on the device first
    (``train.data.normalize_on_device``); non-finite values are kept for its
    median imputation.  Otherwise NaN -> 0 as in the single trainer.
    ``store_dtype=torch.bfloat16``: weight leaves and their Adam moments
    stored in bfloat16 with stochastic rounding (``train.lowmem``);
    ``flat_opt`` takes the noise of the JAX package's flat optimizer
    (``train.lowmem.FlatLowmemOptimizer``) and needs ``store_dtype``.
    ``compute_dtype=torch.bfloat16``: mixed precision, parameters and
    BatchNorm statistics float32, convolutions and dense layers in
    bfloat16, loss in float32.
    ``quantize_upload``: the raw blocks cross to the device as uint16 codes
    (``train.quantize``); needs ``normalize_on_device``.
    ``upload_chunks``: split the launch into this many member-axis chunks,
    each its own copy to the device and its own training run (``"auto"``:
    the largest divisor of T that is <= 8).  The draws are made once for
    all T members and sliced, and normalization, quantization ranges and
    the summary are per member, so every member trains as in one launch.
    ``state_dicts``, ``perms``, ``noise`` and ``salts`` replace the seeded
    draws (``member_draws`` gives the canonical fleet's for a block of it).
    ``dtype`` is the arithmetic's (float64 on the CPU for tests); on
    ``cuda`` the fleet is float32.
    ``mesh`` (``parallel.mesh.make_mesh``): each data rank trains the
    members ``[r*T/w, (r+1)*T/w)`` on the mesh's device, with the canonical
    fleet's draws sliced, so the number of ranks changes no draw, and no
    collective until ``fetch`` assembles the fleet (every rank calls it).  T
    must divide by the data axis; ``upload_chunks`` must be 1 (``"auto"``
    gives 1).
    ``warm_compile``: build and capture ahead.  The blocks Xm / Xl are not
    read: a ``batch_size``-row host pattern (standard normal, or random
    uint16 codes with ``quantize_upload``, decoding into [-1, 1]) is tiled
    on the device to their shapes, and the launch runs as a real one would,
    so its program (every epoch graph of its chunks) is captured and the
    kernels it launches built and loaded; a real launch of the same
    configuration then replays it with no new capture.  History and summary
    come back finite and of the real shapes, and are garbage by
    construction (lesionvae_tpu/train/batched.py:361-367, :439-460)."""
    if mesh is not None:
        from ..parallel.mesh import mesh_device
        device = mesh_device(mesh, device)
        if Xm.shape[0] % mesh.shape["data"] != 0:
            raise ValueError(f"fleet size {Xm.shape[0]} not divisible by the mesh's "
                             f"data axis ({mesh.shape['data']})")
        if upload_chunks == "auto":
            upload_chunks = 1
        elif not isinstance(upload_chunks, int) or upload_chunks < 1:
            raise ValueError("upload_chunks must be >= 1 or 'auto'")
        elif upload_chunks > 1:
            raise ValueError("upload_chunks is a single-card option; a mesh fleet "
                             "already splits the member axis across devices")
    device = torch.device(device)
    if device.type == "cuda" and dtype != torch.float32:
        raise ValueError(f"the VAE trains float32 on cuda, got {dtype}")
    if quantize_upload and not normalize_on_device:
        raise ValueError("quantize_upload requires normalize_on_device (the "
                         "decoded raw values feed the on-device normalization; "
                         "see train.quantize)")
    if flat_opt and store_dtype is None:
        raise ValueError("flat_opt is part of the lowmem fast path; set "
                         "store_dtype (torch.bfloat16) to enable it")
    if store_dtype not in (None, torch.bfloat16) or compute_dtype not in (
            None, torch.bfloat16):
        raise ValueError("store_dtype and compute_dtype are None or torch.bfloat16")
    if state_dicts is None and device.type == "cuda" and init_library() is None:
        raise RuntimeError("a launch to cuda draws its initial weights by the native "
                           "pass (ops/csrc/init_draws.cpp), which this host cannot "
                           "build (see the log)")
    T, n_pad, seq_len, micro_ch = Xm.shape
    lesion_ch = Xl.shape[3]
    if (n_pad // batch_size) * batch_size != n_pad:
        raise ValueError("pad the row axis to a multiple of batch_size")
    chunks = resolve_chunks(upload_chunks, T)
    lay = layout(seq_len, micro_ch, lesion_ch, latent_dim)

    # weights, draws and salts: from the seed on the CPU, or injected
    for name, d in (("state_dicts", state_dicts), ("perms", perms), ("noise", noise),
                    ("salts", salts)):
        if d is not None and len(d) != T:
            raise ValueError(f"{name} has {len(d)} members for a {T}-member fleet")
    with span("fleet.init"):
        rows = (draw_init(lay, T, seed, host_rows(lay, T, device)) if state_dicts is None
                else lay.stack(state_dicts))
    with span("fleet.draws"):
        gen = torch.Generator().manual_seed(seed)
        if perms is None or noise is None:
            drawn = draw_fleet(T, n_pad, epochs, batch_size, latent_dim, gen)
            perms = drawn[0] if perms is None else perms
            noise = drawn[1] if noise is None else noise
        if salts is None:
            salts = draw_salts(T, gen)
    draws = {"rows": rows, "perms": perms, "noise": noise, "salts": salts}
    if perms.shape[-1] != n_pad:
        raise ValueError(f"perms permute {perms.shape[-1]} rows, the blocks hold "
                         f"{n_pad}: pad every block of one fleet to the same rows")

    common = dict(epochs=epochs, batch_size=batch_size, lr=lr,
                  weight_decay=weight_decay, grad_clip=grad_clip,
                  compute_dtype=compute_dtype, normalize_on_device=normalize_on_device,
                  store_dtype=store_dtype, quantize_upload=quantize_upload,
                  flat_opt=flat_opt, device=device, dtype=dtype,
                  summary_noise=summary_noise, warm_compile=warm_compile)

    def block(sl: slice) -> FleetHandle:
        spec = None
        if summary_spec is not None:
            sham_T, subj_idx_T, n_seg, norm_seed = summary_spec
            spec = (sham_T[sl], subj_idx_T[sl], n_seg, norm_seed)
        return _launch_block(Xm[sl], Xl[sl], n_real[sl], lay, spec,
                             {k: v[sl] for k, v in draws.items()}, **common)

    if mesh is not None:
        handle = block(mesh.axis("data").block(T))
        handle.mesh = mesh
        return handle
    if chunks == 1:
        return block(slice(None))
    Tc = T // chunks
    return cat_handles([block(slice(j * Tc, (j + 1) * Tc)) for j in range(chunks)])


def _launch_block(Xm, Xl, n_real, lay, summary_spec, draws, epochs, batch_size, lr,
                  weight_decay, grad_clip, compute_dtype, normalize_on_device,
                  store_dtype, quantize_upload, flat_opt, device, dtype,
                  summary_noise, warm_compile) -> FleetHandle:
    """One launch: the members' blocks to the device (or the warm pattern),
    normalization, the training program and the summary, with the given
    draws."""
    full_fp32(device)
    T, n_pad = Xm.shape[:2]
    n_batches = n_pad // batch_size

    # the data, once onto the device
    def put(X):
        host = torch.from_numpy(np.asarray(X, np.float32))
        count_h2d(host)
        return host.to(device)

    def put_codes(codes):
        count_h2d(codes)
        return codes_to_tensor(codes, device)

    with span("fleet.upload"):
        if warm_compile:
            reps = n_pad // batch_size
            rng = np.random.default_rng(0)
            tile = lambda t: t[None].repeat(T, reps, 1, 1)  # noqa: E731
            if quantize_upload:
                pats = [rng.integers(0, 65536, (batch_size,) + X.shape[2:]).astype(np.uint16)
                        for X in (Xm, Xl)]
                Xm_d, Xl_d = (dequantize_u16(tile(put_codes(p)),
                                             torch.full((T, 1, 1, p.shape[2]), -1.0,
                                                        device=device),
                                             torch.full((T, 1, 1, p.shape[2]),
                                                        2.0 / 65535.0, device=device))
                              for p in pats)
            else:
                pats = [rng.standard_normal((batch_size,) + X.shape[2:]).astype(np.float32)
                        for X in (Xm, Xl)]
                Xm_d, Xl_d = (tile(put(p)) for p in pats)
        elif quantize_upload:
            blocks = []
            for X in (Xm, Xl):
                codes, lo, scale = quantize_u16(X)
                blocks.append(dequantize_u16(put_codes(codes), put(lo), put(scale)))
            Xm_d, Xl_d = blocks
        else:
            Xm_d, Xl_d = put(Xm), put(Xl)
        n_host = torch.from_numpy(np.asarray(n_real, np.int64))
        count_h2d(n_host)
        n_d = n_host.to(device)
    # the staged arguments: the raw blocks (uint16 codes with the uint16
    # upload), the row counts and, with a summary, sham and the subject index
    up = "uint16" if quantize_upload else "float32"
    specs = [ArgSpec(tuple(Xm.shape), up), ArgSpec(tuple(Xl.shape), up),
             ArgSpec((T,), "int32")]
    if summary_spec is not None:
        specs += [ArgSpec(tuple(np.shape(summary_spec[0])), "float32"),
                  ArgSpec(tuple(np.shape(summary_spec[1])), "int32")]
    FLEET_LAUNCH_LEDGER.append(("fleet_train", tuple(specs)))
    norm_stats = None
    with span("fleet.normalize"):
        if normalize_on_device:
            Xm_d, Xl_d, norm_stats = vdata.normalize_on_device(Xm_d, Xl_d, n_d)
        else:
            Xm_d, Xl_d = (torch.nan_to_num(X, nan=0.0) for X in (Xm_d, Xl_d))
        Xm_d, Xl_d = Xm_d.to(dtype), Xl_d.to(dtype)

    with span("fleet.state"):
        rows = draws["rows"]
        state = FleetState.from_rows(rows, lay, dtype, store_dtype, device)
        if rows.device.type == "cpu":
            count_h2d(rows)
        if summary_spec is not None:
            # the summary's inputs cross before the training: a copy from
            # host memory waits for the work queued ahead of it, and the
            # launch then returns with the training still queued
            sham_T, subj_idx_T, n_seg, norm_seed = summary_spec
            sham = torch.from_numpy(np.asarray(sham_T, np.float32)).to(device, dtype)
            subj = torch.from_numpy(np.asarray(subj_idx_T, np.int64)).to(device)
            eps = fleet_noise(state, n_pad, int(norm_seed), summary_noise, Xm_d)
    program = fleet_program(lay, T, n_pad, epochs, batch_size, lr, weight_decay,
                            grad_clip, store_dtype, compute_dtype, flat_opt, device,
                            dtype)
    # the state and the blocks are on the device already; the program's load
    # copies the draws from the host (the salts with bfloat16 storage only)
    salts = [draws["salts"]] if store_dtype is not None else []
    count_h2d(*(t for t in (draws["perms"], draws["noise"], *salts)
                if t.device.type == "cpu"))
    with span("fleet_train", device_range=True):
        hist = program.run(state, draws["salts"], Xm_d, Xl_d, n_d, draws["perms"],
                           draws["noise"])
    summary = None
    if summary_spec is not None:
        with span("member_summary", device_range=True):
            summary = member_summary(state, Xm_d, Xl_d, sham, subj, int(n_seg), noise=eps,
                                     compute_dtype=compute_dtype)
    return FleetHandle(state, hist, epochs, n_batches, Xm_d, Xl_d,
                       summary=summary, norm_stats=norm_stats)


def train_many_vaes(Xm, Xl, n_real, **kwargs):
    """``launch_many_vaes(...).fetch()``."""
    return launch_many_vaes(Xm, Xl, n_real, **kwargs)()
