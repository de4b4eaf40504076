"""The fleet's optimizer, with bfloat16 storage of weights and moments as an
option: the port of lesionvae_tpu/train/lowmem.py (``_is_weight_leaf``,
``cast_params_storage``, ``_fused_update``, ``LowmemOptimizer``; its
``_hash_bits`` and ``_store_round`` are ``ops.sr_adam.hash_bits`` and
``store_round``).

One step is clip by the member's global gradient norm -> additive weight
decay -> Adam -> -lr, the formulas and order of ``train.trainer.ClipDecayAdam``,
for all T members at once on the fleet's two stacked buffers, each member
with its own norm, finite flag and step count (a skipped step does not
advance its member's count).  With ``store_dtype=torch.bfloat16`` the
convolution and dense leaves and their moments are stored in bfloat16: the
arithmetic stays float32 and the write-back rounds stochastically, with
noise hashed from (element index, step count, member salt).  That pass is
``ops.sr_adam.sr_adam_step``: the hand-written kernel on the card, its plain
version on the CPU.  The BatchNorm scales and shifts stay float32; they, and
float32-stored weights, take ``ops.adam.adam_step``, and every step's
gradients reach the update through ``ops.adam.grad_sq_norm``, the gather
into the packed rows with each member's norm (kernels on the card, plain
versions on the CPU, as for ``sr_adam``).

The noise is the JAX package's bit for bit.  There an element's index is its
flat position inside its leaf in the flax layout, and the leaf's number is
its place in flax's tree order (sorted keys, the float32 leaves counted
too); the port stores channel-first with permuted dense columns
(``models.convert``), so ``sr_index_table`` carries each element's
``index * 0x9E3779B9 + leaf * 0x9E3779B1`` across with the same maps that
carry the weights.

The JAX package's flat form (``flatten_partition``, ``FlatLowmemOptimizer``,
lesionvae_tpu/train/lowmem.py:162-262) runs the same update on two flat
buffers, ``fw`` (the weight leaves in flax tree order and layout) and
``fo`` (the BatchNorm leaves).  The port's buffers are flat already, so
that form changes the numerics only: an element's noise index is its
position in ``fw`` (``sr_index_table(lay, flat=True)``), the float32 ``fo``
leaves take the update without rounding (as here), and the gradient norm
reduces over the two buffers (as here).  ``flatten_partition`` gives the
order of ``fw`` and ``fo`` in the port's buffers.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch

from ..models.convert import _BNS, _CONV_TS, _CONVS, from_jax_params
from ..models.fleet import FleetState, Layout, is_weight_leaf  # noqa: F401
from ..ops import adam, sr_adam
from ..ops.sr_adam import MASK32

_DENSES = ("fc_dec", "fc_logv", "fc_mu")


def cast_params_storage(state_dict: Mapping[str, torch.Tensor], lay: Layout,
                        dtype: torch.dtype = torch.bfloat16
                        ) -> Dict[str, torch.Tensor]:
    """Round the weight leaves of a member's state dict to the storage dtype
    (round to nearest); BatchNorm leaves and statistics stay as they are."""
    return {k: (v.to(dtype) if k in lay.leaves and is_weight_leaf(k, lay) else v)
            for k, v in state_dict.items()}


def _flax_shape(name: str, shape: Sequence[int]) -> tuple:
    """The flax shape of the port's parameter ``name``."""
    module, kind = name.rsplit(".", 1)
    if kind == "bias" or module in _BNS:
        return tuple(shape)
    if module in _CONVS:            # (out, in, k) <- (k, in, out)
        return (shape[2], shape[1], shape[0])
    if module in _CONV_TS:          # (in, out, k) <- (k, in, out)
        return (shape[2], shape[0], shape[1])
    return (shape[1], shape[0])     # dense (out, in) <- (in, out)


def _carried_codes(lay: Layout, code) -> Dict[str, np.ndarray]:
    """Each parameter of the port's model filled with integer codes made in
    the flax layout and carried across by ``from_jax_params``.  ``code(leaf,
    offset, shape)`` fills one flax leaf: ``leaf`` is its place in flax's
    tree order (every leaf counted), ``offset`` the elements of the leaves of
    its own buffer (``fw`` for a weight leaf, ``fo`` else) before it."""
    params: Dict[str, dict] = {}
    stats: Dict[str, dict] = {}
    leaf = 0
    offsets = {True: 0, False: 0}

    def fill(name: str, weight: bool):
        nonlocal leaf
        shape = _flax_shape(name, lay.leaves[name][2])
        out = code(leaf, offsets[weight], shape)
        leaf += 1
        offsets[weight] += int(np.prod(shape))
        return out

    # flax's tree order: module names sorted, then bias before kernel/scale
    for module in sorted(_BNS + _CONVS + _CONV_TS + _DENSES):
        if module in _BNS:
            params[module] = {"bias": fill(f"{module}.bias", False),
                              "scale": fill(f"{module}.weight", False)}
            stats[module] = {"mean": np.zeros(1), "var": np.zeros(1)}
        else:
            inner = "dense" if module in _DENSES else "conv"
            params[module] = {inner: {
                "bias": fill(f"{module}.bias", True),
                "kernel": fill(f"{module}.weight", True)}}
    return from_jax_params(params, stats)


def _buffer(lay: Layout, carried: Mapping[str, torch.Tensor], which: str) -> np.ndarray:
    """One member's ``which`` buffer ("weights" or "affine") of carried codes."""
    out = np.empty(lay.n_weights if which == "weights" else lay.n_affine, np.int64)
    for name in lay.names(which):
        _w, off, shape = lay.leaves[name]
        assert tuple(carried[name].shape) == shape, name
        out[off:off + carried[name].numel()] = carried[name].numpy().reshape(-1)
    return out


@functools.lru_cache(maxsize=16)
def flatten_partition(lay: Layout):
    """The JAX package's ``flatten_partition`` order in the port's buffers:
    (w_order, o_order), int64 index tensors such that ``weights[:, w_order]``
    is each member's ``fw`` (the weight leaves in flax tree order and flax
    layout, concatenated) and ``affine[:, o_order]`` its ``fo`` (the
    BatchNorm scales and shifts).  Writing ``fw`` back is
    ``weights[:, w_order] = fw``."""
    carried = _carried_codes(
        lay, lambda leaf, offset, shape:
        offset + np.arange(int(np.prod(shape)), dtype=np.int64).reshape(shape))
    return tuple(torch.from_numpy(np.argsort(_buffer(lay, carried, which)))
                 for which in ("weights", "affine"))


@functools.lru_cache(maxsize=32)
def sr_index_table(lay: Layout, flat: bool = False) -> torch.Tensor:
    """int32 (n_weights,): for each element of a member's weight buffer, the
    bit pattern of ``index * 0x9E3779B9 + leaf * 0x9E3779B1`` modulo 2^32,
    where index and leaf are the JAX package's ``LowmemOptimizer``'s (see
    the module docstring); with ``flat``, of ``position * 0x9E3779B9`` for
    the element's position in the flat ``fw`` buffer of its
    ``FlatLowmemOptimizer`` (whose ``fw`` salt offset is 0).
    ``hash_bits(table, step_salt)`` is then the element's noise."""
    def code(leaf, offset, shape):
        n = int(np.prod(shape))
        index = np.arange(n, dtype=np.int64)
        if flat:
            return ((offset + index) * 0x9E3779B9 & MASK32).reshape(shape)
        return ((index * 0x9E3779B9 + ((leaf * 0x9E3779B1) & MASK32))
                & MASK32).reshape(shape)

    table = _buffer(lay, _carried_codes(lay, code), "weights")
    # the uint32 values as int32 bit patterns
    return torch.from_numpy(table.astype(np.uint32).view(np.int32).copy())


def draw_salts(members: int, generator: torch.Generator) -> torch.Tensor:
    """One uint32 salt a member, as int64, from a CPU generator."""
    return torch.randint(0, 2 ** 32, (members,), generator=generator,
                         dtype=torch.int64)


class LowmemOptimizer:
    """Clip -> decay -> Adam on a ``FleetState``'s buffers, in place.

    Every step first gathers the leaves' gradients into the packed rows
    ``g_w`` / ``g_a`` with each member's norm (``ops.adam.grad_sq_norm``).
    float32 (or float64) storage: ``ClipDecayAdam``'s arithmetic per member,
    ``ops.adam.adam_step`` on both buffers.  bfloat16 storage of the weight
    buffer: ``sr_adam_step`` for the weights and ``adam_step`` for the
    BatchNorm leaves."""

    flat = False

    def __init__(self, state: FleetState, lr: float, weight_decay: float,
                 grad_clip: float, salts: Optional[torch.Tensor] = None,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.state = state
        T, dev, lay = state.members, state.device, state.layout
        self.lowmem = state.weights.dtype == torch.bfloat16
        self.hyper = adam.Hyper(lr, weight_decay, grad_clip, b1, b2, eps)
        new = lambda t: sr_adam.alloc_rows(T, t.shape[1], t.dtype, dev)  # noqa: E731
        self.mu_w, self.nu_w, self.g_w = (new(state.weights) for _ in range(3))
        self.mu_a, self.nu_a, self.g_a = (torch.zeros_like(state.affine)
                                          for _ in range(3))
        self.count = torch.zeros(T, dtype=torch.int32, device=dev)
        # the bias corrections and the norm are in the arithmetic's dtype
        math_dtype = torch.float32 if self.lowmem else state.dtype
        self._b1 = torch.tensor(b1, dtype=math_dtype, device=dev)
        self._b2 = torch.tensor(b2, dtype=math_dtype, device=dev)
        if self.lowmem:
            salts = torch.zeros(T, dtype=torch.int64) if salts is None else salts
            self.salt = salts.to(device=dev, dtype=torch.int64)
            self.base = sr_index_table(lay, self.flat).to(dev)
            self.consts = sr_adam.consts(lr, weight_decay, grad_clip, b1, b2, eps)
        # the gather's leaves in the member's parameter order, each with its
        # packed destination rows, and the norm's workspace and outputs
        self._names = list(lay.leaves)
        self._dsts = []
        for name in self._names:
            which, off, shape = lay.leaves[name]
            buf = self.g_w if which == "weights" else self.g_a
            self._dsts.append(buf[:, off:off + math.prod(shape)].view(T, *shape))
        self._work = adam.norm_work([lay.leaves[n][2] for n in self._names], T, dev)
        self.sq, self.g_norm = (torch.zeros(T, dtype=math_dtype, device=dev)
                                for _ in range(2))

    @torch.no_grad()
    def step(self, grads: Mapping[str, torch.Tensor], finite: torch.Tensor) -> None:
        """``grads``: name -> (T, *shape) gradient of each leaf, in the
        leaf's dtype; ``finite``: (T,) bool, false where the member skips."""
        st = self.state
        adam.grad_sq_norm([grads[n] for n in self._names], self._dsts, self._work,
                          self.sq, self.g_norm)
        count_inc = self.count + 1
        bc1 = 1 - torch.pow(self._b1, count_inc)
        bc2 = 1 - torch.pow(self._b2, count_inc)
        if self.lowmem:
            salt = (self.salt + count_inc.to(torch.int64) * 0x01000193) & MASK32
            sr_adam.sr_adam_step(st.weights, self.mu_w, self.nu_w, self.g_w,
                                 self.base, self.g_norm, bc1, bc2, salt, finite,
                                 self.consts)
        else:
            adam.adam_step(st.weights, self.mu_w, self.nu_w, self.g_w, self.g_norm,
                           bc1, bc2, finite, self.hyper)
        adam.adam_step(st.affine, self.mu_a, self.nu_a, self.g_a, self.g_norm, bc1,
                       bc2, finite, self.hyper)
        self.count.copy_(torch.where(finite, count_inc, self.count))


class FlatLowmemOptimizer(LowmemOptimizer):
    """``LowmemOptimizer`` with the JAX package's flat-buffer numerics
    (``FlatLowmemOptimizer``, lesionvae_tpu/train/lowmem.py:211): the noise
    of a weight element is indexed by its position in ``fw``.  It is part of
    the bfloat16-storage path, as there."""

    flat = True

    def __init__(self, state: FleetState, *args, **kwargs):
        if state.weights.dtype != torch.bfloat16:
            raise ValueError("FlatLowmemOptimizer is part of the bfloat16-storage "
                             "path; store the weights in torch.bfloat16")
        super().__init__(state, *args, **kwargs)
