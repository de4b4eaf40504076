"""The fleet's masked BatchNorm followed by ReLU, forward and backward: the
CUDA kernels of ``csrc/masked_bn.cu``, their plain versions, and the
``torch.autograd.Function`` the stacked model calls.

For one BatchNorm layer of T members, channel-last: x (T, N, L, C) float32,
bfloat16 or (plain version only) float64, mask (T, N) of 0/1 or None,
weight and bias (T, C), running mean and variance (T, C); statistics in
float32 (float64 for float64 x).  The forward is ``models.layers.MaskedBatchNorm``
for every member at once followed by ReLU (y < 0 ? 0 : y, NaN kept): the count
``cnt = max(sum(mask) * L, 1)``, the mean, the biased variance of the
squared deviations from it, the running statistics advanced with momentum
0.1 and the unbiased variance, y = ((x - mean) / sqrt(var + eps)) * w + b,
or on bfloat16 x the folded ``x * a + b`` with a and b computed in float32
and applied in bfloat16 (lesionvae_tpu/models/layers.py:41-111; eval mode
normalises with the running statistics).  The backward is the closed form
from x and dy alone: with g = dy where the output was kept (``y <= 0 ? 0 :
dy``, PyTorch's rule for ReLU) and xh = (x - mean) / sd (bfloat16 x:
(x - mean) * (1 / sd)),

    dbias = sum g,  dweight = sum g*xh     over every row, pad rows too
    dx = (w / sd) * (g - (m / cnt) * (sum g + xh * sum g*xh))    (eval: (w / sd) * g)

so the autograd graph keeps x, the mask and the per-(member, channel) mean
and variance, not the chain's intermediates.

Every sum is taken in the kernel's order (``chunk_partials``,
``chunk_total``): rows in chunks of ``CHUNK``, a lane's rows added one
after another, the lanes in a tree, the chunks in order.  The plain
versions repeat it with elementwise adds, so on the card the kernels are
held to them bit for bit; the order is fixed, so two calls give the same
bits.

``masked_bn_relu`` is the entry point.  On CPU tensors its forward and
backward compute the plain versions; on CUDA tensors they launch the
kernels and raise on inputs the kernels do not take.  ``route`` picks the
kernels by shape before any launch: a training layer whose rows fit one
thread-block cluster a (member, channel tile) takes the cluster route, one
launch forward (``bn_cluster_forward``) and one backward
(``bn_cluster_backward``); any other training layer the general route,
two statistics launches and an apply forward (``bn_stats``, ``bn_apply``),
gradient sums and gradient backward (``bn_grad_sums``, ``bn_grad_apply``);
eval one apply launch.  Each wrapper counts its launches.  A launch that
fails raises; no route gives way to another or to the plain version.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.cost_model import kernel_bound_ms, masked_bn_bytes
from .cuda_build import count_launch, load

LANES, ROWS_A_LANE = 32, 8     # csrc/masked_bn.cu: LANES, J (the order of the sums)
CHUNK = LANES * ROWS_A_LANE    # rows a chunk
VECTOR_BYTES = 16              # csrc/masked_bn.cu: VECTOR_BYTES (a thread's load)
VECTORS_A_ROW = 4              # csrc/masked_bn.cu: VECTORS (a channel tile's row)
CHUNKS_A_BLOCK = 2             # csrc/masked_bn.cu: SLOTS
THREADS = CHUNKS_A_BLOCK * LANES * VECTORS_A_ROW   # csrc/masked_bn.cu: THREADS
MAX_CLUSTER = 16               # csrc/masked_bn.cu: MAX_CLUSTER (blocks a cluster)
# elements a thread takes: its ROWS_A_LANE rows of one 16-byte vector
ELEMENTS_A_THREAD = {torch.float32: ROWS_A_LANE * 4, torch.bfloat16: ROWS_A_LANE * 8}
MOMENTUM, EPS = 0.1, 1e-5
# The least instructions an element of each kernel can be written in, one
# issue slot each (a correctly rounded quotient at 6, as ops/sr_adam.py
# counts it; loads and stores 1): stats phase 0 the loads of x and of the
# row's mask, the mask product, the add; phase 1 the two loads, the
# deviation, its square, the mask product, the add; apply a load, the
# deviation, the quotient, the affine 2, the ReLU select, the store (bf16:
# widen, product, round, sum, round, select, store); grad sums two loads,
# the deviation and quotient, the affine 2 and the select that recompute the
# output's sign, the two adds and a product; grad apply two loads, the
# store, the deviation and quotient, the affine 2 and the select, the row's
# mask and the choice of 1/cnt, then xh*S2, +S1, *m/cnt, g-, *w/sd.
MIN_INSTRUCTIONS = {"stats0": 4, "stats1": 6, "apply": 12, "apply_bf16": 8,
                    "grad_sums": 15, "grad_apply": 20}
# FP32 operations an element by the formulas alone: forward 2 + 4 + 5 (mask
# product and sum; deviation, square, mask product, sum; deviation,
# quotient, affine, ReLU), backward 9 + 11
OPS_FORWARD, OPS_BACKWARD = 11, 20


# ------------------------------------------------------------ plain version
def chunk_partials(v: torch.Tensor) -> torch.Tensor:
    """(T, R, C) per-row terms -> (T, K, C) chunk sums in the kernel's
    order: the rows padded with +0 to K*CHUNK (an added +0 changes no sum
    that starts at +0), lane s of a chunk adds its rows s, s+LANES, ... in
    turn from 0, then the LANES lanes are added in a tree."""
    T, R, C = v.shape
    K = -(-R // CHUNK)
    v = F.pad(v, (0, 0, 0, K * CHUNK - R)).view(T, K, ROWS_A_LANE, LANES, C)
    acc = torch.zeros_like(v[:, :, 0])
    for j in range(ROWS_A_LANE):
        acc = acc + v[:, :, j]
    w = LANES // 2
    while w:
        acc = acc[:, :, :w] + acc[:, :, w:2 * w]
        w //= 2
    return acc[:, :, 0]


def chunk_total(part: torch.Tensor) -> torch.Tensor:
    """(T, K, C) chunk sums -> (T, C), added in chunk order."""
    s = part[:, 0]
    for k in range(1, part.shape[1]):
        s = s + part[:, k]
    return s


def _rows(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1, v.shape[-1])


def stat_dtype(x: torch.Tensor) -> torch.dtype:
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _mask4(mask: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if mask is None:
        return x.new_ones((x.shape[0], x.shape[1], 1, 1), dtype=stat_dtype(x))
    return mask.to(stat_dtype(x))[:, :, None, None]


def member_count(mask: Optional[torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """(T, 1) ``max(sum(mask) * L, 1)`` (N * L without a mask)."""
    return torch.clamp(_mask4(mask, x).sum(dim=(1, 2, 3)) * x.shape[2], min=1.0)[:, None]


def stats_plain(x, mask, running_mean, running_var, momentum: float = MOMENTUM):
    """The statistics of a training forward: (mean, var, new running mean,
    new running var), each (T, C)."""
    x32 = x.to(stat_dtype(x))
    m = _mask4(mask, x)
    cnt = member_count(mask, x)
    mean = chunk_total(chunk_partials(_rows(x32 * m))) / cnt
    d = x32 - mean[:, None, None, :]
    var = chunk_total(chunk_partials(_rows((d * d) * m))) / cnt
    unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
    new_rm = (1 - momentum) * running_mean + momentum * mean
    new_rv = (1 - momentum) * running_var + momentum * unbiased
    return mean, var, new_rm, new_rv


def _normalize(x, mean, var, weight, bias, eps: float):
    """(xh in the statistics' dtype, bn(x) in x's dtype) for the statistics
    ``mean``, ``var``."""
    b4 = lambda t: t[:, None, None, :]  # noqa: E731
    sd = torch.sqrt(var + eps)
    if x.dtype == torch.bfloat16:
        # bn(x) is the folded affine; xh, for the backward alone, is the
        # deviation times 1/sd (one product, where float32 divides)
        xh = (x.float() - b4(mean)) * b4(1.0 / sd)
        a = weight / sd
        b = bias - mean * a
        return xh, x * b4(a.to(x.dtype)) + b4(b.to(x.dtype))
    xh = (x.to(stat_dtype(x)) - b4(mean)) / b4(sd)
    return xh, (xh * b4(weight) + b4(bias)).to(x.dtype)


def batch_norm_plain(x, mean, var, weight, bias, eps: float = EPS) -> torch.Tensor:
    """bn(x) in x's dtype, before the ReLU: the layer the JAX package's
    ``MaskedBatchNorm`` computes."""
    return _normalize(x, mean, var, weight, bias, eps)[1]


def relu_plain(y: torch.Tensor) -> torch.Tensor:
    """y < 0 ? 0 : y (a NaN stays a NaN)."""
    return y.masked_fill(y < 0, 0)


def apply_plain(x, mean, var, weight, bias, eps: float = EPS) -> torch.Tensor:
    """relu(bn(x)) in x's dtype."""
    return relu_plain(batch_norm_plain(x, mean, var, weight, bias, eps))


def masked_bn_relu_plain(x, mask, weight, bias, running_mean, running_var,
                         training: bool, momentum: float = MOMENTUM, eps: float = EPS):
    """The forward: (y, mean, var, new running mean, new running var); in
    eval mean and var are the running statistics, returned unchanged."""
    if training:
        mean, var, new_rm, new_rv = stats_plain(x, mask, running_mean, running_var,
                                                momentum)
    else:
        mean, var = new_rm, new_rv = running_mean, running_var
    return apply_plain(x, mean, var, weight, bias, eps), mean, var, new_rm, new_rv


def grad_sums_plain(x, dy, mean, var, weight, bias, eps: float = EPS):
    """(sum g, sum g*xh) over every row, each (T, C)."""
    xh, y = _normalize(x, mean, var, weight, bias, eps)
    g = torch.where(y <= 0, 0, dy.to(xh.dtype))
    T = x.shape[0]
    s = chunk_total(chunk_partials(_rows(torch.cat([g, g * xh]))))
    return s[:T], s[T:]


def grad_apply_plain(x, dy, mask, mean, var, weight, bias, s1, s2, training: bool,
                     eps: float = EPS) -> torch.Tensor:
    """dx in x's dtype from the sums of ``grad_sums_plain``."""
    b4 = lambda t: t[:, None, None, :]  # noqa: E731
    xh, y = _normalize(x, mean, var, weight, bias, eps)
    g = torch.where(y <= 0, 0, dy.to(xh.dtype))
    coef = b4(weight / torch.sqrt(var + eps))
    if training:
        mc = _mask4(mask, x) / member_count(mask, x)[:, :, None, None]
        dx = coef * (g - mc * (b4(s1) + xh * b4(s2)))
    else:
        dx = coef * g
    return dx.to(x.dtype)


def masked_bn_relu_backward_plain(x, dy, mask, weight, bias, mean, var, training: bool,
                                  eps: float = EPS):
    """(dx, dweight, dbias) of ``masked_bn_relu_plain``'s y."""
    s1, s2 = grad_sums_plain(x, dy, mean, var, weight, bias, eps)
    dx = grad_apply_plain(x, dy, mask, mean, var, weight, bias, s1, s2, training, eps)
    return dx, s2, s1


# ------------------------------------------------------------ the route
def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def vectored(C: int, dtype: torch.dtype) -> bool:
    """A row's C channels are a whole number of 16-byte vectors: the
    kernels load VECTOR_BYTES a thread, else one channel."""
    return C * _itemsize(dtype) % VECTOR_BYTES == 0


def cluster_size(N: int, L: int) -> int:
    """Blocks of the cluster that holds one (member, channel tile): every
    chunk of its N*L rows, CHUNKS_A_BLOCK chunks a block."""
    chunks = -(-N * L // CHUNK)
    return -(-chunks // CHUNKS_A_BLOCK)


def route(N: int, L: int, C: int, dtype: torch.dtype, training: bool) -> str:
    """The kernels a layer of (T, N, L, C) activations takes, decided from
    its shape before any launch: ``"apply"`` (eval: one apply launch),
    ``"cluster"`` (training whose N*L rows fit one cluster of at most
    MAX_CLUSTER blocks and whose rows are whole 16-byte vectors: one launch
    forward, one backward) or ``"general"`` (any other training layer: three
    launches forward, two backward).  The backward of a layer takes its
    training route whatever the forward's mode."""
    if not training:
        return "apply"
    if vectored(C, dtype) and cluster_size(N, L) <= MAX_CLUSTER:
        return "cluster"
    return "general"


# ------------------------------------------------------------ the kernels
@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of csrc/masked_bn.cu, built on first use; the
    cluster kernels' attributes are set once here, before any launch."""
    lib = load("masked_bn")
    P, I, LL, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    sig = {"lesionvae_masked_bn_init": [],
           "lesionvae_masked_bn_active_clusters": [I, I, I],
           "lesionvae_masked_bn_cluster_forward": [P, I, P, P, P, P, P, LL, P, LL, P, P, P, P,
                                                   I, I, I, I, I, Fl, Fl, Fl, P],
           "lesionvae_masked_bn_cluster_backward": [P, I, P, P, P, P, P, P, LL, P, LL, P, P,
                                                    I, I, I, I, I, I, Fl, P],
           "lesionvae_masked_bn_stats": [P, I, I, P, P, P, P, I, I, I, I, I, P],
           "lesionvae_masked_bn_apply": [P, I, I, P, P, P, P, P, P, LL, P, LL, P, P, P, P,
                                         I, I, I, I, I, Fl, Fl, Fl, P],
           "lesionvae_masked_bn_grad_sums": [P, I, I, P, P, P, P, LL, P, LL, P, P,
                                             I, I, I, I, Fl, P],
           "lesionvae_masked_bn_grad_apply": [P, I, I, P, P, P, P, P, P, LL, P, LL, P, P,
                                              P, P, I, I, I, I, I, Fl, P]}
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _raise(lib.lesionvae_masked_bn_init(), "attribute")
    return lib


def active_clusters(dtype: torch.dtype, backward: bool, blocks: int) -> int:
    """Clusters of ``blocks`` blocks of a cluster kernel the card holds at
    once (``cudaOccupancyMaxActiveClusters``)."""
    n = _lib().lesionvae_masked_bn_active_clusters(int(dtype == torch.bfloat16),
                                                   int(backward), blocks)
    if n < 0:
        _raise(-n, "occupancy query")
    return n


def _f32(v: float) -> float:
    return float(np.float32(v))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(x, mask, weight, bias, running_mean=None, running_var=None) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"the masked BatchNorm kernels run on cuda, not {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the masked BatchNorm kernels take float32 or bfloat16 x, "
                        f"got {x.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.numel() == 0:
        raise ValueError(f"the masked BatchNorm kernels take x as a non-empty contiguous "
                         f"(T, N, L, C), got {tuple(x.shape)} strides {x.stride()}")
    T, N, L, C = x.shape
    if N * L * C >= 2 ** 31:
        raise ValueError(f"{N * L * C} elements a member: the kernels index a member in "
                         "32 bits")
    if mask is not None and (mask.dtype != torch.float32 or mask.shape != (T, N)
                             or not mask.is_contiguous() or mask.device != x.device):
        raise ValueError(f"mask: a contiguous ({T}, {N}) float32 tensor on x's device, "
                         f"got {tuple(mask.shape)} {mask.dtype} on {mask.device}")
    for name, t in (("weight", weight), ("bias", bias)):
        if (t.dtype != torch.float32 or t.shape != (T, C) or t.stride(1) != 1
                or t.device != x.device):
            raise ValueError(f"{name}: ({T}, {C}) float32 rows on x's device, got "
                             f"{tuple(t.shape)} {t.dtype} strides {t.stride()} on {t.device}")
    for name, t in (("running_mean", running_mean), ("running_var", running_var)):
        if t is not None and (t.dtype != torch.float32 or t.shape != (T, C)
                              or not t.is_contiguous() or t.device != x.device):
            raise ValueError(f"{name}: a contiguous ({T}, {C}) float32 tensor on x's "
                             f"device, got {tuple(t.shape)} {t.dtype} on {t.device}")


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"masked BatchNorm {what} kernel launch failed: cudaError {err}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t, or a copy of it where its data does not start on a 16-byte
    boundary (the kernels' vector loads and cp.async need one)."""
    return t if t.data_ptr() % VECTOR_BYTES == 0 else t.clone()


def _vector(x: torch.Tensor) -> int:
    return int(vectored(x.shape[3], x.dtype))


def _bf16(x: torch.Tensor) -> int:
    return int(x.dtype == torch.bfloat16)


def _stats(x: torch.Tensor, n: int = 1):
    T, C = x.shape[0], x.shape[3]
    return [torch.empty((T, C), dtype=torch.float32, device=x.device) for _ in range(n)]


def _partials(x: torch.Tensor) -> torch.Tensor:
    T, N, L, C = x.shape
    return torch.empty((T, -(-N * L // CHUNK), C), dtype=torch.float32, device=x.device)


def _cluster(x: torch.Tensor) -> int:
    T, N, L, C = x.shape
    if route(N, L, C, x.dtype, True) != "cluster":
        raise ValueError(f"(T, N, L, C) = {tuple(x.shape)} {x.dtype} does not take the "
                         f"cluster route: {cluster_size(N, L)} blocks a cluster (at most "
                         f"{MAX_CLUSTER}), {C} channels of {_itemsize(x.dtype)} bytes")
    return cluster_size(N, L)


def bn_cluster_forward(x, mask, weight, bias, running_mean, running_var,
                       momentum: float = MOMENTUM, eps: float = EPS):
    """One launch of the cluster route's training forward: (y, mean, var,
    new running mean, new running var)."""
    T, N, L, C = x.shape
    blocks = _cluster(x)
    y = torch.empty_like(x)
    mean, var, new_rm, new_rv = _stats(x, 4)
    _raise(_lib().lesionvae_masked_bn_cluster_forward(
        x.data_ptr(), _bf16(x), y.data_ptr(), _ptr(mask), mean.data_ptr(), var.data_ptr(),
        weight.data_ptr(), weight.stride(0), bias.data_ptr(), bias.stride(0),
        running_mean.data_ptr(), running_var.data_ptr(), new_rm.data_ptr(), new_rv.data_ptr(),
        T, N, L, C, blocks, _f32(eps), _f32(momentum), _f32(1 - momentum), _stream(x)),
        "cluster forward")
    count_launch(bn_cluster_forward)
    return y, mean, var, new_rm, new_rv


def bn_cluster_backward(x, dy, mask, mean, var, weight, bias, training: bool,
                        eps: float = EPS):
    """One launch of the cluster route's backward: (dx, dweight, dbias)."""
    T, N, L, C = x.shape
    blocks = _cluster(x)
    dx = torch.empty_like(x)
    dw, db = _stats(x, 2)
    _raise(_lib().lesionvae_masked_bn_cluster_backward(
        x.data_ptr(), _bf16(x), dy.data_ptr(), dx.data_ptr(), _ptr(mask), mean.data_ptr(),
        var.data_ptr(), weight.data_ptr(), weight.stride(0), bias.data_ptr(), bias.stride(0),
        dw.data_ptr(), db.data_ptr(), T, N, L, C, blocks, int(training), _f32(eps),
        _stream(x)), "cluster backward")
    count_launch(bn_cluster_backward)
    return dx, dw, db


def bn_stats(x, mask) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two launches of the general route's statistics kernel: (mean (T, C),
    the chunk partials of the squared deviations (T, K, C)) for
    ``bn_apply``."""
    T, N, L, C = x.shape
    part1, part2 = _partials(x), _partials(x)
    (mean,) = _stats(x)
    fn = _lib().lesionvae_masked_bn_stats
    for phase, (src, dst) in enumerate(((None, part1), (part1, part2))):
        _raise(fn(x.data_ptr(), _bf16(x), _vector(x), _ptr(mask), _ptr(src), dst.data_ptr(),
                  mean.data_ptr(), T, N, L, C, phase, _stream(x)), "stats")
        count_launch(bn_stats)
    return mean, part2


def bn_apply(x, mask, weight, bias, running_mean, running_var, training: bool,
             mean=None, part2=None, momentum: float = MOMENTUM, eps: float = EPS):
    """One launch of the apply kernel: (y, var, new running mean, new
    running var); in eval var and the running statistics are the inputs."""
    T, N, L, C = x.shape
    y = torch.empty_like(x)
    if training:
        var, new_rm, new_rv = _stats(x, 3)
    else:
        mean, var, new_rm, new_rv = running_mean, running_var, running_mean, running_var
    _raise(_lib().lesionvae_masked_bn_apply(
        x.data_ptr(), _bf16(x), _vector(x), y.data_ptr(), _ptr(mask), _ptr(part2),
        mean.data_ptr(), var.data_ptr(), weight.data_ptr(), weight.stride(0),
        bias.data_ptr(), bias.stride(0), running_mean.data_ptr(), running_var.data_ptr(),
        new_rm.data_ptr(), new_rv.data_ptr(), T, N, L, C, int(training), _f32(eps),
        _f32(momentum), _f32(1 - momentum), _stream(x)), "apply")
    count_launch(bn_apply)
    return y, var, new_rm, new_rv


def bn_grad_sums(x, dy, mean, var, weight, bias, eps: float = EPS):
    """One launch of the general route's gradient-sums kernel: the chunk
    partials of sum g and sum g*xh, each (T, K, C)."""
    T, N, L, C = x.shape
    part3, part4 = _partials(x), _partials(x)
    _raise(_lib().lesionvae_masked_bn_grad_sums(
        x.data_ptr(), _bf16(x), _vector(x), dy.data_ptr(), mean.data_ptr(), var.data_ptr(),
        weight.data_ptr(), weight.stride(0), bias.data_ptr(), bias.stride(0),
        part3.data_ptr(), part4.data_ptr(), T, N, L, C, _f32(eps), _stream(x)),
        "gradient sums")
    count_launch(bn_grad_sums)
    return part3, part4


def bn_grad_apply(x, dy, mask, mean, var, weight, bias, part3, part4, training: bool,
                  eps: float = EPS):
    """One launch of the general route's gradient kernel: (dx, dweight,
    dbias)."""
    T, N, L, C = x.shape
    dx = torch.empty_like(x)
    dw, db = _stats(x, 2)
    _raise(_lib().lesionvae_masked_bn_grad_apply(
        x.data_ptr(), _bf16(x), _vector(x), dy.data_ptr(), dx.data_ptr(), _ptr(mask),
        mean.data_ptr(), var.data_ptr(), weight.data_ptr(), weight.stride(0),
        bias.data_ptr(), bias.stride(0), part3.data_ptr(), part4.data_ptr(),
        dw.data_ptr(), db.data_ptr(), T, N, L, C, int(training), _f32(eps), _stream(x)),
        "gradient")
    count_launch(bn_grad_apply)
    return dx, dw, db


def masked_bn_relu_kernel(x, mask, weight, bias, running_mean, running_var,
                          training: bool, momentum: float = MOMENTUM, eps: float = EPS):
    """``masked_bn_relu_plain`` on the card by ``route``: one launch on the
    cluster route, three on the general route, one in eval."""
    _check(x, mask, weight, bias, running_mean, running_var)
    T, N, L, C = x.shape
    path = route(N, L, C, x.dtype, training)
    x = _aligned(x)
    with torch.cuda.device(x.device):
        if path == "cluster":
            return bn_cluster_forward(x, mask, weight, bias, running_mean, running_var,
                                      momentum, eps)
        mean = part2 = None
        if path == "general":
            mean, part2 = bn_stats(x, mask)
        y, var, new_rm, new_rv = bn_apply(x, mask, weight, bias, running_mean,
                                          running_var, training, mean, part2, momentum,
                                          eps)
    return y, (running_mean if mean is None else mean), var, new_rm, new_rv


def masked_bn_relu_backward_kernel(x, dy, mask, weight, bias, mean, var,
                                   training: bool, eps: float = EPS):
    """``masked_bn_relu_backward_plain`` on the card by the layer's training
    ``route``: one launch on the cluster route, two on the general route."""
    _check(x, mask, weight, bias, mean, var)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy: {tuple(dy.shape)} {dy.dtype} on {dy.device}, x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    T, N, L, C = x.shape
    path = route(N, L, C, x.dtype, True)
    x, dy = _aligned(x), _aligned(dy.contiguous())
    with torch.cuda.device(x.device):
        if path == "cluster":
            return bn_cluster_backward(x, dy, mask, mean, var, weight, bias, training, eps)
        part3, part4 = bn_grad_sums(x, dy, mean, var, weight, bias, eps)
        return bn_grad_apply(x, dy, mask, mean, var, weight, bias, part3, part4,
                             training, eps)


# launches of each kernel in this process; a run sets them to 0 and reads
# them back to show its path went through the kernels.  A launch recorded
# into a CUDA graph counts in ``captured`` and joins ``launches`` at every
# replay (train/program.py)
WRAPPERS = (bn_cluster_forward, bn_cluster_backward, bn_stats, bn_apply, bn_grad_sums,
            bn_grad_apply)
for _w in WRAPPERS:
    _w.launches = 0
    _w.captured = 0


def bound_ms(T: int, batch_size: int = 64, seq_len: int = 100,
             compute_dtype: Optional[torch.dtype] = None) -> dict:
    """The least time of the fleet step's seven BatchNorm + ReLU layers on the
    card, forward (training) and backward, each
    ``utils.cost_model.kernel_bound_ms`` of the bytes of
    ``utils.cost_model.masked_bn_bytes`` and the FP32 operations and least
    instructions an element."""
    cost = masked_bn_bytes(T, batch_size, seq_len, compute_dtype)
    n = cost["elements"]
    bf16 = compute_dtype == torch.bfloat16
    instr = {"forward": MIN_INSTRUCTIONS["stats0"] + MIN_INSTRUCTIONS["stats1"]
             + MIN_INSTRUCTIONS["apply_bf16" if bf16 else "apply"],
             "backward": MIN_INSTRUCTIONS["grad_sums"] + MIN_INSTRUCTIONS["grad_apply"]}
    return {part: kernel_bound_ms(cost[f"{part}_bytes"], ops * n, instr[part] * n)
            for part, ops in (("forward", OPS_FORWARD), ("backward", OPS_BACKWARD))}


# ------------------------------------------------------------ autograd
class MaskedBNReLU(torch.autograd.Function):
    """relu(masked BatchNorm(x)) of T members, with its closed-form
    backward; returns (y, new running mean, new running var).  CPU tensors:
    the plain versions; CUDA tensors: the kernels."""

    @staticmethod
    def forward(ctx, x, mask, weight, bias, running_mean, running_var, training,
                momentum, eps):
        fwd = masked_bn_relu_plain if x.device.type == "cpu" else masked_bn_relu_kernel
        y, mean, var, new_rm, new_rv = fwd(x, mask, weight, bias, running_mean,
                                           running_var, training, momentum, eps)
        ctx.save_for_backward(x, mask, weight, bias, mean, var)
        ctx.training, ctx.eps = training, eps
        if training:
            ctx.mark_non_differentiable(new_rm, new_rv)
        return y, new_rm, new_rv

    @staticmethod
    def backward(ctx, dy, _d_rm, _d_rv):
        x, mask, weight, bias, mean, var = ctx.saved_tensors
        bwd = (masked_bn_relu_backward_plain if x.device.type == "cpu"
               else masked_bn_relu_backward_kernel)
        dx, dw, db = bwd(x, dy, mask, weight, bias, mean, var, ctx.training, ctx.eps)
        return dx, None, dw, db, None, None, None, None, None


def masked_bn_relu(x: torch.Tensor, mask: Optional[torch.Tensor], weight: torch.Tensor,
                   bias: torch.Tensor, running_mean: torch.Tensor,
                   running_var: torch.Tensor, training: bool,
                   momentum: float = MOMENTUM, eps: float = EPS):
    """relu(masked BatchNorm(x)) for T members at once.  Returns (y, new
    running mean, new running var); in eval the running statistics come
    back unchanged and the mask is not read."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"masked BatchNorm runs on cuda or cpu, not {x.device}")
    if not training:
        y = MaskedBNReLU.apply(x, None, weight, bias, running_mean, running_var, False,
                               momentum, eps)[0]
        return y, running_mean, running_var
    return MaskedBNReLU.apply(x, mask, weight, bias, running_mean, running_var, True,
                              momentum, eps)
