"""The bfloat16 store of the cohort fleet's ``--store bf16`` path, written
anew: clip -> decay -> Adam in float32 on weights and moments held in
bfloat16, each written back with stochastic rounding.

The rounding adds the low 16 bits of a per-element noise word to the
float32 bit pattern and clears the low 16 bits; a finite value that carries
into the infinity pattern saturates at +-bf16-max, a NaN stays a NaN.  The
noise is a murmur-style mix of ``index * 0x9E3779B9 + leaf * 0x9E3779B1 +
salt`` in uint32 arithmetic, where ``index`` is the element's flat position
inside its leaf in the flax layout of the JAX original (a convolution's
kernel (k, in, out), a transposed one the same with the taps reversed, a
dense kernel (in, out) with the l-major flatten of its encoder side),
``leaf`` is the leaf's place in flax's tree order (module names sorted,
bias before kernel or scale, the BatchNorm leaves counted too), and
``salt`` the member's salt plus ``step * 0x01000193``; p, m and v take the
word, the word xor 0x55555555 and the word plus 0x33333333.  ``rounding``
"nearest" (a fault the check has to see) rounds to nearest instead.
"""

from __future__ import annotations

import math
from typing import Mapping, Sequence, Tuple

import torch

from .model import BATCH_NORMS, DENSES, ENCODERS, TRANSPOSED

MASK32 = 0xFFFFFFFF
BF16_MAX = 3.3895313892515355e38
STEP_SALT = 0x01000193
CONVS = tuple(conv for layers in ENCODERS.values() for conv, _bn in layers)


def is_weight(name: str) -> bool:
    """A convolution or dense leaf (stored in bfloat16); BatchNorm scales and
    shifts stay float32."""
    return name.rsplit(".", 1)[0] not in BATCH_NORMS


def leaf_number(name: str) -> int:
    """The leaf's place in flax's tree order."""
    module, kind = name.rsplit(".", 1)
    return 2 * sorted(CONVS + TRANSPOSED + DENSES + BATCH_NORMS).index(module) + (
        kind != "bias")


def _l_major(q: torch.Tensor, L: int, C: int) -> torch.Tensor:
    """Position q = c*L + l of a channel-major flatten -> l*C + c."""
    return (q % L) * C + q // L


def flax_index(name: str, shape: Sequence[int], seq_len: int) -> torch.Tensor:
    """int64 of ``shape`` (the published module's layout): each element's flat
    index inside its leaf in the flax layout."""
    module, kind = name.rsplit(".", 1)
    Lm, Cm, Ll, Cl = seq_len // 8, 128, seq_len // 4, 64
    if kind == "bias":
        q = torch.arange(math.prod(shape))
        return _l_major(q, Lm, Cm) if module == "fc_dec" else q
    grid = torch.meshgrid(*(torch.arange(n) for n in shape), indexing="ij")
    if module in CONVS:                        # (out, in, k) <- (k, in, out)
        o, i, t = grid
        n_out, n_in, k = shape
        return (t * n_in + i) * n_out + o
    if module in TRANSPOSED:                      # (in, out, k) <- (k reversed, in, out)
        i, o, t = grid
        n_in, n_out, k = shape
        return ((k - 1 - t) * n_in + i) * n_out + o
    o, q = grid                                # dense (out, in) <- (in, out)
    n_out = shape[0]
    if module == "fc_dec":
        latent = shape[1] - Ll * Cl
        col = torch.where(q < latent, q, latent + _l_major((q - latent).clamp(min=0), Ll, Cl))
        return col * n_out + _l_major(o, Lm, Cm)
    h_micro = Lm * Cm
    col = torch.where(q < h_micro, _l_major(q.clamp(max=h_micro - 1), Lm, Cm),
                      h_micro + _l_major((q - h_micro).clamp(min=0), Ll, Cl))
    return col * n_out + o


def index_base(leaves: Mapping[str, Sequence[int]], seq_len: int) -> torch.Tensor:
    """int64 (sum of the leaves' sizes,): ``index * 0x9E3779B9 + leaf *
    0x9E3779B1`` modulo 2^32 for every element of ``leaves`` (name ->
    shape), laid end to end in their order."""
    return torch.cat([
        (flax_index(name, shape, seq_len).reshape(-1) * 0x9E3779B9
         + ((leaf_number(name) * 0x9E3779B1) & MASK32)) & MASK32
        for name, shape in leaves.items()])


def noise(base: torch.Tensor, salt: torch.Tensor) -> torch.Tensor:
    """The uint32 noise word (in int64) of ``base + salt``."""
    h = (base + salt) & MASK32
    h = h ^ (h >> 16)
    h = (h * 0x85EBCA6B) & MASK32
    h = h ^ (h >> 13)
    h = (h * 0xC2B2AE35) & MASK32
    return h ^ (h >> 16)


def round_bf16(x: torch.Tensor, bits: torch.Tensor, rounding: str = "stochastic"
               ) -> torch.Tensor:
    """float32 ``x`` to bfloat16: stochastically with the low 16 bits of
    ``bits``, or to nearest."""
    if rounding == "nearest":
        return x.to(torch.bfloat16)
    u = x.contiguous().view(torch.int32).to(torch.int64) & MASK32
    u = (u + (bits & 0xFFFF)) & 0xFFFF0000
    r = torch.where(u >= 2 ** 31, u - 2 ** 32, u).to(torch.int32).view(torch.float32)
    r = torch.where(torch.isfinite(x) & ~torch.isfinite(r),
                    torch.copysign(torch.full_like(x, BF16_MAX), x), r)
    return torch.where(torch.isnan(x), x, r).to(torch.bfloat16)


def step(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
         base: torch.Tensor, norm: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
         salt: torch.Tensor, finite: torch.Tensor, lr: float, weight_decay: float,
         grad_clip: float, b1: float, b2: float, eps: float,
         rounding: str = "stochastic") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One update of bfloat16 rows p, m, v (S, n) from float32 gradients g,
    with each member's global norm, bias corrections (S, 1) and step salt
    (S,); a member whose ``finite`` is false keeps its rows.  Returns the new
    (p, m, v)."""
    p32 = p.float()
    g = torch.where(norm < grad_clip, g, g / norm * grad_clip)
    g = g + weight_decay * p32
    m2 = (1 - b1) * g + b1 * m.float()
    v2 = (1 - b2) * (g * g) + b2 * v.float()
    u = -lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + eps))
    bits = noise(base[None, :], salt[:, None])
    keep = finite[:, None]
    return (torch.where(keep, round_bf16(p32 + u, bits, rounding), p),
            torch.where(keep, round_bf16(m2, bits ^ 0x55555555, rounding), m),
            torch.where(keep, round_bf16(v2, (bits + 0x33333333) & MASK32, rounding), v))
