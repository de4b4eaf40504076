"""The (data, model) mesh of the port over ``torch.distributed`` ranks (the
port of lesionvae_tpu/parallel/mesh.py).

One process a rank, one device a rank.  The scaling axis is ``data`` (the
streamlines, the rows of a batch, the members of a fleet); an optional
``model`` axis splits the VAE's three large dense layers by output feature.
Rank r sits at (data r // model_parallel, model r % model_parallel).

Every collective of the port lives here and is counted in ``COUNTS``:
- ``Axis.psum``: a sum over the axis whose gradient is the sum of the
  ranks' gradients (the counterpart of ``jax.lax.psum`` inside a
  differentiated ``shard_map``);
- ``Axis.total_``: the same sum, in place, outside autograd;
- ``Axis.gather``: the ranks' pieces laid side by side along a dimension,
  exactly (one ``broadcast`` a rank: summing pieces into zeros would turn
  -0.0 into +0.0 and change NaN payloads); its gradient is the rank's own
  piece of the incoming gradient;
- ``Axis.shared_input``: the identity, whose gradient is summed over the
  axis (the input of a layer split by output feature).
Only ``broadcast``, ``all_reduce`` and ``barrier`` are used: the gloo
backend takes CUDA tensors for those three alone, and two ranks that share
one card must use gloo (NCCL refuses them).

``spawn`` starts the ranks as processes over a ``FileStore`` in a temporary
directory: the counterpart of the JAX package's virtual CPU mesh, used by
the dryruns and the tests.  ``torchrun`` with one process a card and NCCL is
the other way to start them; either way ``make_mesh`` takes the process
group as it finds it and never starts one.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import tempfile
import time
from datetime import timedelta
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

#: collectives issued by this process since the last ``reset_collectives``
#: (the counterpart of the collective ops that tests/test_zero_collectives.py
#: looks for in the JAX fleet program's text)
COUNTS = {"collectives": 0}


def reset_collectives() -> None:
    COUNTS["collectives"] = 0


def collectives_issued() -> int:
    return COUNTS["collectives"]


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    COUNTS["collectives"] += 1
    dist.all_reduce(t, group=group)
    return t


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return _all_reduce(t.clone(), axis.group)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.axis.group), None


class _SharedInput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis):
        ctx.axis = axis
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g.clone(), ctx.axis.group), None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, axis, dim):
        ctx.axis, ctx.dim, ctx.size = axis, dim, t.shape[dim]
        return axis._gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        i = ctx.axis.index
        return g.narrow(ctx.dim, i * ctx.size, ctx.size).contiguous(), None, None


class Axis:
    """One axis of the mesh as this rank sees it: its ``size``, this rank's
    ``index`` along it, the global ``ranks`` along it (this rank's other
    coordinate fixed) and their process group (``None`` for a one-rank axis
    of a larger world: nothing to communicate)."""

    def __init__(self, name: str, ranks: Sequence[int], index: int, group):
        self.name, self.ranks, self.index = name, list(ranks), index
        self.size = len(self.ranks)
        self.group = group

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis; differentiable (gradient: summed over it)."""
        if self.group is None:
            return t
        return _PSum.apply(t, self)

    def total_(self, t: torch.Tensor) -> torch.Tensor:
        """Sum over the axis in place, outside autograd."""
        if self.group is not None:
            with torch.no_grad():
                _all_reduce(t, self.group)
        return t

    def broadcast_(self, t: torch.Tensor, index: int = 0) -> torch.Tensor:
        """``t`` of the axis's rank ``index`` on every rank, in place."""
        if self.group is not None:
            buf = t.contiguous()
            COUNTS["collectives"] += 1
            dist.broadcast(buf, src=self.ranks[index], group=self.group)
            if buf is not t:
                t.copy_(buf)
        return t

    def shared_input(self, t: torch.Tensor) -> torch.Tensor:
        """The identity; its gradient is summed over the axis."""
        if self.group is None:
            return t
        return _SharedInput.apply(t, self)

    def gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The ranks' pieces (equal shapes) side by side along ``dim``, in
        rank order, bit for bit; differentiable."""
        if self.group is None:
            return t
        return _Gather.apply(t, self, dim)

    def _gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        t = t.detach().contiguous()
        pieces = []
        for i, src in enumerate(self.ranks):
            buf = t.clone() if i == self.index else torch.empty_like(t)
            COUNTS["collectives"] += 1
            dist.broadcast(buf, src=src, group=self.group)
            pieces.append(buf)
        return torch.cat(pieces, dim=dim)

    def block(self, n: int) -> slice:
        """This rank's block of ``n`` items split evenly over the axis."""
        if n % self.size:
            raise ValueError(f"{n} rows not divisible by the mesh's {self.name} "
                             f"axis ({self.size})")
        k = n // self.size
        return slice(self.index * k, (self.index + 1) * k)


class Mesh:
    """A (data, model) grid of ``world`` ranks; ``rank``'s axes, its device.
    ``shape`` reads as the JAX mesh's: {"data": world // mp, "model": mp}."""

    def __init__(self, world: int, model_parallel: int, rank: int, device,
                 groups: Optional[Dict[str, object]] = None):
        if world % model_parallel != 0:
            raise ValueError(f"{world} devices not divisible by model_parallel="
                             f"{model_parallel}")
        mp = model_parallel
        self.world, self.rank, self.device = world, rank, torch.device(device)
        self.shape = {"data": world // mp, "model": mp}
        self.coords = {"data": rank // mp, "model": rank % mp}
        groups = groups or {}
        d, m = self.coords["data"], self.coords["model"]
        self.axes = {
            "data": Axis("data", [i * mp + m for i in range(world // mp)], d,
                         groups.get("data")),
            "model": Axis("model", [d * mp + j for j in range(mp)], m,
                          groups.get("model"))}

    def axis(self, name: str) -> Axis:
        return self.axes[name]

    @property
    def is_main(self) -> bool:
        """Rank 0: the one that writes files."""
        return self.rank == 0


def _axis_groups(world: int, mp: int, rank: int) -> Dict[str, object]:
    """Process groups of this rank's two axes.  Every rank creates every
    group, in one order, as ``new_group`` requires."""
    WORLD = dist.group.WORLD
    groups: Dict[str, object] = {}
    D = world // mp
    for name, size, members in (
            ("data", D, [[i * mp + m for i in range(D)] for m in range(mp)]),
            ("model", mp, [[d * mp + j for j in range(mp)] for d in range(D)])):
        if size == world:
            groups[name] = WORLD
        elif size == 1:
            groups[name] = None
        else:
            for ranks in members:
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[name] = g
    return groups


def make_mesh(n_devices: Optional[int] = None, model_parallel: int = 1,
              device="cuda") -> Mesh:
    """The (data, model) mesh over every rank of the default process group,
    this rank's device on it: ``cuda:{LOCAL_RANK or rank} % cards`` for
    ``device="cuda"`` (an explicit index is kept), or ``cpu``.  Raises
    without a process group, when ``n_devices`` is not the world size, when
    the world size is not divisible by ``model_parallel``, and for a CUDA
    device on a host without one or a CPU device under NCCL."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: start the ranks with "
                           "parallel.mesh.spawn, or torchrun (one process a card)")
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else n_devices
    if n % model_parallel != 0:
        raise ValueError(f"{n} devices not divisible by model_parallel="
                         f"{model_parallel}")
    if n != world:
        raise ValueError(f"a mesh spans every rank of the process group: {n} "
                         f"devices asked, {world} ranks")
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available: make_mesh(device='cuda') "
                               "needs a card; pass device='cpu' for CPU ranks")
        if device.index is None:
            local = int(os.environ.get("LOCAL_RANK", rank))
            device = torch.device("cuda", local % torch.cuda.device_count())
    elif dist.get_backend() == "nccl":
        raise ValueError(f"the nccl backend needs CUDA devices, got {device}")
    return Mesh(world, model_parallel, rank, device,
                _axis_groups(world, model_parallel, rank))


def mesh_device(mesh: Mesh, device) -> torch.device:
    """The device an entry point given ``mesh`` runs on: the mesh's own,
    which must be of the type the call asks for (no fallback)."""
    device = torch.device(device)
    if device.type != mesh.device.type or (
            device.index is not None and device != mesh.device):
        raise ValueError(f"the mesh's rank holds {mesh.device}, the call asks for "
                         f"{device}")
    return mesh.device


def data_sharding(mesh: Mesh, x):
    """This rank's rows of ``x`` along axis 0, split over ``data`` (the
    counterpart of ``NamedSharding(mesh, P("data"))``)."""
    return x[mesh.axis("data").block(x.shape[0])]


def replicated(mesh: Mesh, x):
    """The whole of ``x`` on every rank."""
    return x


def pad_to_multiple(arr: np.ndarray, multiple: int, axis: int = 0
                    ) -> Tuple[np.ndarray, int]:
    """Pad ``axis`` up to a multiple by repeating the last entry (sharded
    dimensions must divide evenly).  Returns (padded, original length)."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, target - n)
    return np.pad(arr, pad_width, mode="edge"), n


# ---------------------------------------------------------------- processes
def _rank_main(rank: int, world: int, backend: str, device_type: str,
               store_path: str, timeout: float, fn, args, results) -> None:
    """Body of a spawned rank: its device, the process group, ``fn``, and its
    result on the queue.  An exception ends the process with a non-zero code
    and its traceback on stderr."""
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
        torch.set_num_threads(1)
    store = dist.FileStore(store_path, world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=timedelta(seconds=timeout))
    try:
        out = fn(device, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    results.put((rank, out))


def spawn(fn, world: int, backend: str = "gloo", device: str = "cuda", *args,
          timeout: float = 900.0) -> List[object]:
    """Run ``fn(rank_device, *args)`` in ``world`` processes that form one
    process group (``backend``) over a ``FileStore`` in a temporary
    directory; returns each rank's result, in rank order.

    ``rank_device`` is ``cuda:{rank % cards}`` for ``device="cuda"`` and
    ``cpu`` for ``device="cpu"``.  ``fn`` and its arguments are pickled: a
    function of this package, never of a module that imports JAX (the
    ``spawn`` start method imports the module that defines it).  A rank that
    exits non-zero, or no result within ``timeout`` seconds, raises, and the
    other ranks are killed."""
    import multiprocessing

    device_type = torch.device(device).type
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: spawn(device='cuda') needs a card")
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="lesionvae_ranks_")
    store_path = os.path.join(tmp, "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, backend, device_type, store_path, timeout,
                               fn, args, results))
             for r in range(world)]
    out: Dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < world:
            try:
                r, value = results.get(timeout=0.2)
                out[r] = value
                continue
            except queue_mod.Empty:
                pass
            failed = [(r, p.exitcode) for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"spawned ranks failed (rank, exit code): {failed}")
            if all(p.exitcode == 0 for p in procs) and results.empty():
                raise RuntimeError(f"ranks {sorted(set(range(world)) - set(out))} "
                                   "exited without a result")
            if time.monotonic() > deadline:
                raise TimeoutError(f"{world} ranks gave no result in {timeout} s")
        for r, p in enumerate(procs):
            p.join(timeout=120)
            if p.exitcode != 0:
                raise RuntimeError(f"spawned rank {r} exited with {p.exitcode}")
    finally:
        for p in procs:
            if p.pid is None:      # never started
                continue
            if p.is_alive():
                p.kill()
            p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
