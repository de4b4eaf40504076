"""One clip -> decay -> Adam step on bf16-stored weights and moments of a
whole fleet, written back with stochastic rounding: the CUDA kernel and its
plain version.

For member t and element j (float32 arithmetic, IEEE quotient and root):

    g  = g_norm[t] < clip ? g : (g / g_norm[t]) * clip
    g  = g + wd*p
    m' = (1-b1)*g + b1*m;   v' = (1-b2)*(g*g) + b2*v
    u  = -lr * ((m' / bc1[t]) / (sqrt(v' / bc2[t]) + eps))
    h  = hash_bits(base[j], salt[t])
    p <- sr(p + u, h);  m <- sr(m', h ^ 0x55555555);  v <- sr(v', h + 0x33333333)

This is ``_fused_update`` of lesionvae_tpu/train/lowmem.py:91-108 with its
``_hash_bits`` (:55-66) and ``_store_round`` (:69-88), for every weight leaf
of every member at once.  ``base[j]`` carries what the JAX package derives
from an element's place: ``index * 0x9E3779B9 + leaf_idx * 0x9E3779B1`` in
uint32, with the index inside the leaf in the flax layout
(``train.lowmem.sr_index_table`` builds it), so the noise is the JAX
package's bit for bit; ``salt[t]`` is the member's salt plus
``count * 0x01000193``.

``sr_adam_step`` is the entry point: on CUDA tensors it launches the
hand-written Hopper kernel ``csrc/sr_adam.cu`` and raises on inputs the
kernel does not take; on CPU tensors it computes ``sr_adam_step_plain``.
There is no other route.  Both update p, m and v in place and leave a
member whose ``finite`` is false untouched.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import numpy as np
import torch

from ..utils.cost_model import kernel_bound_ms
from .cuda_build import count_launch, load

MASK32 = 0xFFFFFFFF
BF16_MAX = 3.3895313892515355e38
VEC = 8                   # bf16 per 16-byte load: rows start on such a boundary
# device-memory traffic: p, m, v read and written (6 x 2) and g read (2).
# The 4-byte word of the index table an element is not counted: the members
# share one table (11 MB at full width), which comes from device memory once
# and is then served from L2.
BYTES_PER_ELEMENT = 14
# The least instructions an element can be written in, one issue slot each:
# 4 to widen p, m, v, g (a shift or a mask each); 2 for g + wd*p, 3 for m',
# 4 for v' (each operation rounds on its own, so none fuses into an FMA);
# three correctly rounded quotients at 6 (seed, Newton step in 2 FMAs,
# quotient, exact residual, correction) and one root at 5; + eps, * -lr,
# p + u: 3; the hash 11 (one add, three shift-xor pairs, two products) and
# its two variants 2; three roundings at 4 (mask the noise, add, clear, the
# saturation test) and 1.5 to pack three pairs' halves.  The clip's quotient
# and product are not counted: a step below the clip does not run them.
MIN_INSTRUCTIONS_PER_ELEMENT = 4 + 2 + 3 + 4 + 3 * 6 + 5 + 3 + 11 + 2 + 3 * 4 + 1.5
# FP32 operations an element by the formula alone (2 + 3 + 4 + 7 and the
# eight conversions), for the nominal bound
OPS_PER_ELEMENT = 24


def consts(lr: float, weight_decay: float, grad_clip: float, b1: float = 0.9,
           b2: float = 0.999, eps: float = 1e-8) -> Dict[str, float]:
    """The step's constants as the float32 values both the kernel and the
    plain version compute with.  The complements are rounded from the
    float64 difference, as a framework does when it multiplies a float32
    array by the Python float ``1 - b1``."""
    f = lambda x: float(np.float32(x))  # noqa: E731
    return {"clip": f(grad_clip), "wd": f(weight_decay), "b1": f(b1),
            "one_minus_b1": f(1 - b1), "b2": f(b2), "one_minus_b2": f(1 - b2),
            "neg_lr": f(-lr), "eps": f(eps)}


def padded_width(n: int) -> int:
    """Row stride for ``n`` bf16 elements that keeps every row on a 16-byte
    boundary."""
    return -(-n // VEC) * VEC


def alloc_rows(members: int, n: int, dtype: torch.dtype, device) -> torch.Tensor:
    """A zeroed (members, n) tensor whose rows start ``padded_width(n)``
    elements apart: what the kernel takes for p, m, v and g."""
    return torch.zeros((members, padded_width(n)), dtype=dtype, device=device)[:, :n]


# ------------------------------------------------------------ plain version
def hash_bits(base: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """The murmur-style mixer of lowmem.py:55-66 on ``base + salt``: uint32
    arithmetic with wraparound, carried in int64 and masked.  ``base`` holds
    ``index * 0x9E3779B9`` (plus any leaf offset) modulo 2^32."""
    h = (base.to(torch.int64) + salt.to(torch.int64)) & MASK32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def index_hash_base(n: int, device=None) -> torch.Tensor:
    """``index * 0x9E3779B9`` modulo 2^32 for index 0..n-1, as int64."""
    return (torch.arange(n, dtype=torch.int64, device=device) * 0x9E3779B9) & MASK32


def store_round(x32: torch.Tensor, bits: torch.Tensor,
                dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Stochastic rounding of float32 to bf16 (lowmem.py:69-88): add the low
    16 bits of ``bits`` (int64 holding uint32 values) to the float's bit
    pattern, clear the low 16 bits; a finite value that carried into the
    infinity pattern saturates at ±bf16-max.  A NaN stays a NaN whatever its
    payload.  float32 storage returns the input."""
    if dtype == torch.float32:
        return x32
    if dtype != torch.bfloat16:
        raise TypeError(f"only float32 and bfloat16 storage, got {dtype}")
    x32 = x32.to(torch.float32)
    u = x32.contiguous().view(torch.int32).to(torch.int64) & MASK32
    u = (u + (bits & 0xFFFF)) & 0xFFFF0000
    signed = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32)
    r = signed.view(torch.float32)
    big = torch.copysign(torch.full_like(x32, BF16_MAX), x32)
    r = torch.where(torch.isfinite(x32) & ~torch.isfinite(r), big, r)
    r = torch.where(torch.isnan(x32), x32, r)
    return r.to(torch.bfloat16)


def sr_adam_step_plain(p, m, v, g, base, g_norm, bc1, bc2, salt, finite,
                       c: Dict[str, float]) -> None:
    """Plain PyTorch version of the kernel, in place; the same float32
    operations in the same order."""
    col = lambda x: x.to(torch.float32)[:, None]  # noqa: E731
    p32, m32, v32, g32 = p.float(), m.float(), v.float(), g.float()
    gn = col(g_norm)
    g32 = torch.where(gn < c["clip"], g32, (g32 / gn) * c["clip"])
    g32 = g32 + c["wd"] * p32
    m2 = c["one_minus_b1"] * g32 + c["b1"] * m32
    v2 = c["one_minus_b2"] * (g32 * g32) + c["b2"] * v32
    u = c["neg_lr"] * ((m2 / col(bc1)) / (torch.sqrt(v2 / col(bc2)) + c["eps"]))
    bits = hash_bits(base[None, :], salt[:, None])
    keep = ~finite.to(torch.bool)[:, None]
    p.copy_(torch.where(keep, p, store_round(p32 + u, bits)))
    m.copy_(torch.where(keep, m, store_round(m2, bits ^ 0x55555555)))
    v.copy_(torch.where(keep, v, store_round(v2, (bits + 0x33333333) & MASK32)))


# ------------------------------------------------------------ the kernel
def _check(p, m, v, g, base, g_norm, bc1, bc2, salt, finite) -> Tuple[int, int, int]:
    T, n = p.shape
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"the SR Adam kernel takes {name} as bfloat16, got {t.dtype}")
        if t.shape != (T, n) or t.device != p.device:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, p "
                             f"{(T, n)} on {p.device}")
        if n and t.stride(1) != 1:
            raise ValueError(f"the SR Adam kernel takes rows of {name} contiguous")
        if t.stride(0) != p.stride(0) or t.stride(0) % VEC or t.stride(0) < n:
            raise ValueError(f"{name}: rows {t.stride(0)} elements apart; the kernel "
                             f"takes one stride for p, m, v and g, a multiple of {VEC} "
                             "(ops.sr_adam.alloc_rows)")
        if t.data_ptr() % 16:
            raise ValueError(f"the SR Adam kernel takes {name} aligned to 16 bytes")
    if (base.dtype != torch.int32 or base.shape != (n,) or not base.is_contiguous()
            or base.device != p.device or base.data_ptr() % 16):
        raise ValueError("the index table is int32 (the uint32 bit patterns), (n,), "
                         "contiguous, aligned to 16 bytes, on p's device")
    for name, t, dt in (("g_norm", g_norm, torch.float32), ("bc1", bc1, torch.float32),
                        ("bc2", bc2, torch.float32), ("salt", salt, torch.int64),
                        ("finite", finite, torch.bool)):
        if (t.dtype != dt or t.shape != (T,) or not t.is_contiguous()
                or t.device != p.device):
            raise ValueError(f"{name}: a contiguous ({T},) {dt} tensor on p's device, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return T, n, p.stride(0)


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/sr_adam.cu, built on first use."""
    fn = load("sr_adam").lesionvae_sr_adam
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_longlong,
                                             ctypes.c_longlong]
                   + [ctypes.c_float] * 8 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(p, m, v, g, base, g_norm, bc1, bc2, salt, finite, c) -> None:
    T, n, stride = _check(p, m, v, g, base, g_norm, bc1, bc2, salt, finite)
    fn = _kernel()
    with torch.cuda.device(p.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(),
                 base.data_ptr(), g_norm.data_ptr(), bc1.data_ptr(),
                 bc2.data_ptr(), salt.data_ptr(), finite.data_ptr(), T, n, stride,
                 c["clip"], c["wd"], c["b1"], c["one_minus_b1"], c["b2"],
                 c["one_minus_b2"], c["neg_lr"], c["eps"], stream)
    if err != 0:
        raise RuntimeError(f"SR Adam kernel launch failed: cudaError {err}")
    count_launch(sr_adam_step)


def sr_adam_step(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                 g: torch.Tensor, base: torch.Tensor, g_norm: torch.Tensor,
                 bc1: torch.Tensor, bc2: torch.Tensor, salt: torch.Tensor,
                 finite: torch.Tensor, c: Dict[str, float]) -> None:
    """One step for all members, in place.  p, m, v, g: bf16 (T, n) made by
    ``alloc_rows``; base: int32 (n,), the uint32 table's bit patterns;
    g_norm, bc1, bc2: float32 (T,); salt: int64 (T,), used modulo 2^32;
    finite: bool (T,); c: ``consts(...)``.  CUDA tensors: the kernel,
    counted in ``sr_adam_step.launches``.  CPU tensors: the plain version."""
    if p.device.type == "cpu":
        return sr_adam_step_plain(p, m, v, g, base, g_norm, bc1, bc2, salt, finite, c)
    if p.device.type != "cuda":
        raise ValueError(f"SR Adam runs on cuda or cpu, not {p.device}")
    return _launch(p, m, v, g, base, g_norm, bc1, bc2, salt, finite, c)


# launches of the kernel in this process; a run sets it to 0 and reads it back
# to show its path went through the kernel.  A launch recorded into a CUDA
# graph counts in ``captured`` and joins ``launches`` at every replay
# (train/program.py)
sr_adam_step.launches = 0
sr_adam_step.captured = 0


def bound_ms(elements: int) -> dict:
    """Least time for one step over ``elements`` on the card
    (``utils.cost_model.kernel_bound_ms``): 14 bytes an element (p, m, v,
    g; the shared index table is left out), 24 FP32 operations and the
    least instruction count an element."""
    return kernel_bound_ms(BYTES_PER_ELEMENT * elements, OPS_PER_ELEMENT * elements,
                           MIN_INSTRUCTIONS_PER_ELEMENT * elements)
