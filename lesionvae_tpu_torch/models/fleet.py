"""T independent lesion VAEs as one stacked model: what ``jax.vmap`` over the
member axis is to lesionvae_tpu/train/batched.py.

A fleet member is a ``LesionConditionedVAE``; the fleet keeps every member's
parameters in two buffers with the member axis leading, ``weights`` (T, Pw)
for the convolution and dense leaves (float32, or bfloat16 storage) and
``affine`` (T, Pa) for the BatchNorm scales and shifts (always float32), and
the running statistics in a dict of (T, C) tensors.  ``leaves`` are views of
the buffers, one per parameter, shaped (T, *shape) and named as in the
member's ``state_dict``, so an optimizer that writes the buffers in place
has updated the model.

``fleet_forward`` runs all members in one pass whose kernel launches do not
depend on T, on activations (T, N, L, C) with the channels last: a
convolution is the k shifted copies of its input times the member's kernel
as a matrix, one batched product for all members (cuDNN runs a grouped
convolution as one set of kernels a group, so its launches grow with T;
``benchmarks/vae_step_profile.py --fleet --route`` reads that form and the
``torch.func.vmap`` one beside this), the dense layers are batched products too, BatchNorm and
the ReLU after it are ``ops.masked_bn.masked_bn_relu`` (on the card the
hand-written kernels of ``ops/csrc/masked_bn.cu``).  Every member sees only
its own rows, mask, noise and statistics; the new running statistics are
returned, not written.  Stored bfloat16 leaves are widened in the forward,
so autograd's backward of that cast hands the optimizer gradients rounded
to bfloat16, as ``jax.grad`` does for a bfloat16 leaf.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.masked_bn import masked_bn_relu
from ..ops.sr_adam import alloc_rows
from .layers import KERNEL, PADDING, MaskedBatchNorm, interp_matrix
from .lesion_vae import LesionConditionedVAE

ENCODERS = {"micro": ("micro_c1", "micro_b1", "micro_c2", "micro_b2",
                      "micro_c3", "micro_b3"),
            "lesion": ("lesion_c1", "lesion_b1", "lesion_c2", "lesion_b2")}


#: name a ``record_function`` range ``layer:<kind>`` after each layer of
#: ``fleet_forward`` and each phase of ``train.batched.fleet_step`` (conv,
#: bn_relu, pool, resize, dense; loss, backward, optimizer), so a profile
#: of a step reads its device time by layer
#: (``benchmarks/vae_step_profile.py --fleet`` sets it); off, no range is opened
LAYER_RANGES = False


def layer_range(kind: str):
    return record_function(f"layer:{kind}") if LAYER_RANGES else contextlib.nullcontext()


class Layout:
    """Where each parameter of one member lies in the two buffers."""

    def __init__(self, seq_len: int, micro_ch: int, lesion_ch: int, latent: int):
        self.hyper = {"seq_len": seq_len, "micro_ch": micro_ch,
                      "lesion_ch": lesion_ch, "latent": latent}
        with torch.device("meta"):
            module = LesionConditionedVAE(**self.hyper)
        bn = {name for name, mod in module.named_modules()
              if isinstance(mod, MaskedBatchNorm)}
        # name -> (buffer, offset, shape); buffer is "weights" or "affine"
        self.leaves: Dict[str, Tuple[str, int, Tuple[int, ...]]] = {}
        offsets = {"weights": 0, "affine": 0}
        for name, p in module.named_parameters():
            which = "affine" if name.rsplit(".", 1)[0] in bn else "weights"
            self.leaves[name] = (which, offsets[which], tuple(p.shape))
            offsets[which] += p.numel()
        self.n_weights, self.n_affine = offsets["weights"], offsets["affine"]
        self.stats = {name: tuple(b.shape) for name, b in module.named_buffers()}

    def names(self, which: str) -> List[str]:
        return [n for n, (w, _o, _s) in self.leaves.items() if w == which]


@functools.lru_cache(maxsize=16)
def layout(seq_len: int, micro_ch: int, lesion_ch: int, latent: int) -> Layout:
    return Layout(seq_len, micro_ch, lesion_ch, latent)


def is_weight_leaf(name: str, lay: Layout) -> bool:
    """Convolution and dense kernels and biases; BatchNorm scale and shift
    are not (lesionvae_tpu/train/lowmem.py:42-46)."""
    return lay.leaves[name][0] == "weights"


class FleetState:
    """Parameters and running statistics of T members, stacked."""

    def __init__(self, lay: Layout, members: int,
                 dtype: torch.dtype = torch.float32,
                 store_dtype: Optional[torch.dtype] = None, device="cuda"):
        self.layout, self.members, self.dtype = lay, members, dtype
        self.store_dtype = store_dtype
        self.weights = alloc_rows(members, lay.n_weights, store_dtype or dtype, device)
        self.affine = torch.zeros((members, lay.n_affine), dtype=dtype, device=device)
        self.leaves: Dict[str, torch.Tensor] = {}
        for name, (which, off, shape) in lay.leaves.items():
            size = 1
            for s in shape:
                size *= s
            buf = self.weights if which == "weights" else self.affine
            self.leaves[name] = buf[:, off:off + size].view(members, *shape)
        self.stats = {name: torch.zeros((members,) + shape, dtype=dtype, device=device)
                      for name, shape in lay.stats.items()}

    @property
    def device(self) -> torch.device:
        return self.weights.device

    @classmethod
    def from_state_dicts(cls, state_dicts: Sequence[Mapping[str, torch.Tensor]],
                         lay: Layout, dtype: torch.dtype = torch.float32,
                         store_dtype: Optional[torch.dtype] = None,
                         device="cuda") -> "FleetState":
        """Stack members' ``state_dict``s; weight leaves are rounded to the
        storage dtype (round to nearest, as ``cast_params_storage`` does)."""
        self = cls(lay, len(state_dicts), dtype, store_dtype, device)
        for name, dst in {**self.leaves, **self.stats}.items():
            src = torch.stack([sd[name].detach() for sd in state_dicts])
            dst.copy_(src.to(device=device, dtype=dtype))
        return self

    def grad_leaves(self) -> Dict[str, torch.Tensor]:
        """The parameters as the forward of one training step takes them:
        views of the buffers as they stand now, each a leaf of the autograd
        graph, so its gradient comes back in its own shape and dtype."""
        return {name: t.detach().requires_grad_() for name, t in self.leaves.items()}

    def state_dict(self, i: int) -> Dict[str, torch.Tensor]:
        """Member i's ``state_dict`` in the fleet's dtype (a stored bfloat16
        leaf widens exactly)."""
        return {name: t[i].detach().to(self.dtype).clone()
                for name, t in {**self.leaves, **self.stats}.items()}

    def member(self, i: int) -> LesionConditionedVAE:
        module = LesionConditionedVAE(**self.layout.hyper).to(
            device=self.device, dtype=self.dtype)
        module.load_state_dict(self.state_dict(i))
        return module


def _widen(leaf: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """A stored leaf as the forward computes with it."""
    if compute_dtype is not None:
        return leaf.to(compute_dtype)
    return leaf.float() if leaf.dtype == torch.bfloat16 else leaf


def _conv(h: torch.Tensor, leaves, name: str, cd, transpose=False) -> torch.Tensor:
    """Each member's own Conv1d or ConvTranspose1d (k=5, p=2, stride 1) as
    one batched matrix product: the k shifted copies of h (T, N, L, C_in) laid
    side by side, (T, N*L, C_in*k), times the member's kernel as a
    (C_in*k, C_out) matrix.  -> (T, N, L, C_out)."""
    w, b = _widen(leaves[f"{name}.weight"], cd), _widen(leaves[f"{name}.bias"], cd)
    T, N, L, C = h.shape
    if transpose:
        # (T, in, out, k): the transposed convolution at stride 1 is a
        # convolution with the kernel reversed along k
        w = w.flip(3).permute(0, 1, 3, 2)
    else:
        w = w.permute(0, 2, 3, 1)            # (T, out, in, k) -> (T, in, k, out)
    cols = F.pad(h, (0, 0, PADDING, PADDING)).unfold(2, KERNEL, 1)   # (T, N, L, C, k)
    out = torch.baddbmm(b[:, None, :], cols.reshape(T, N * L, C * KERNEL),
                        w.reshape(T, C * KERNEL, -1))
    return out.view(T, N, L, -1)


def _dense(x: torch.Tensor, leaves, name: str, cd) -> torch.Tensor:
    """Each member's own Linear: (T, N, d_in) -> (T, N, d_out)."""
    w, b = _widen(leaves[f"{name}.weight"], cd), _widen(leaves[f"{name}.bias"], cd)
    return torch.baddbmm(b[:, None, :], x, w.transpose(1, 2))


def _pool(h: torch.Tensor) -> torch.Tensor:
    """``avg_pool_half`` along L of (T, N, L, C)."""
    T, N, L, C = h.shape
    L2 = (L // 2) * 2
    return 0.5 * h[:, :, :L2].reshape(T, N, L2 // 2, 2, C).sum(dim=3)


def _resize(h: torch.Tensor, out_size: int) -> torch.Tensor:
    """``interp_linear`` along L of (T, N, L, C): the same matrix."""
    return torch.matmul(interp_matrix(h.shape[2], out_size, h.device, h.dtype), h)


def _flat(h: torch.Tensor) -> torch.Tensor:
    """(T, N, L, C) -> (T, N, C*L), channel-major as the member flattens."""
    return h.transpose(2, 3).reshape(h.shape[0], h.shape[1], -1)


class _Norm:
    """BatchNorm and the ReLU after it of the stacked model
    (``ops.masked_bn.masked_bn_relu``); collects the new statistics."""

    def __init__(self, leaves, stats, mask, training: bool):
        self.leaves, self.stats, self.mask = leaves, stats, mask
        self.training = training
        self.new_stats: Dict[str, torch.Tensor] = {}

    def __call__(self, h: torch.Tensor, name: str) -> torch.Tensor:
        y, mean, var = masked_bn_relu(
            h, self.mask, self.leaves[f"{name}.weight"], self.leaves[f"{name}.bias"],
            self.stats[f"{name}.running_mean"], self.stats[f"{name}.running_var"],
            self.training)
        self.new_stats[f"{name}.running_mean"] = mean
        self.new_stats[f"{name}.running_var"] = var
        return y


def fleet_forward(lay: Layout, leaves: Mapping[str, torch.Tensor],
                  stats: Mapping[str, torch.Tensor], x_micro: torch.Tensor,
                  x_lesion: torch.Tensor, mask: Optional[torch.Tensor],
                  eps: torch.Tensor, training: bool,
                  compute_dtype: Optional[torch.dtype] = None):
    """All members' forward.  x_micro: (T, N, L, Cm); x_lesion: (T, N, L, Cl);
    mask: (T, N) or None; eps: (T, N, latent) or (N, latent) shared by the
    members.  Returns (xh (T, N, L, Cm), mu, logv (T, N, latent), new running
    statistics)."""
    L = x_micro.shape[2]
    cd = compute_dtype
    norm = _Norm(leaves, stats, mask, training)
    if cd is not None:
        x_micro, x_lesion = x_micro.to(cd), x_lesion.to(cd)

    def conv(h, name, transpose=False):
        with layer_range("conv"):
            return _conv(h, leaves, name, cd, transpose)

    def bn_relu(h, name):
        with layer_range("bn_relu"):
            return norm(h, name)

    def pool(h):
        with layer_range("pool"):
            return _pool(h)

    def resize(h, size):
        with layer_range("resize"):
            return _resize(h, size)

    def dense(x, name):
        with layer_range("dense"):
            return _dense(x, leaves, name, cd)

    flat = {}
    for path, h in (("micro", x_micro), ("lesion", x_lesion)):
        names = ENCODERS[path]
        for c, bn in zip(names[0::2], names[1::2]):
            h = pool(bn_relu(conv(h, c), bn))
        flat[path] = _flat(h)
    h_lesion = flat["lesion"]
    hcat = torch.cat([flat["micro"], h_lesion], dim=2)
    mu = dense(hcat, "fc_mu")
    logv = dense(hcat, "fc_logv")
    z = mu + eps.to(mu.dtype) * torch.exp(0.5 * logv)

    h = dense(torch.cat([z, h_lesion], dim=2), "fc_dec")
    T, N = h.shape[:2]
    h = h.view(T, N, 128, L // 8).transpose(2, 3)       # channel-major rows
    up = lambda t: resize(t, 2 * t.shape[2])  # noqa: E731
    h = up(bn_relu(conv(h, "dec_t1", True), "dec_b1"))
    h = up(bn_relu(conv(h, "dec_t2", True), "dec_b2"))
    h = up(conv(h, "dec_t3", True))
    if h.shape[2] != L:
        h = resize(h, L)
    return h, mu, logv, norm.new_stats
