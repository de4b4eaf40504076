"""The fleet's member-batched convolutions, forward and backward: the CUDA
kernels of ``csrc/conv1d.cu``, their plain versions, and the
``torch.autograd.Function`` the stacked model calls.

For T members at once, channel-last: h (T, N, L, C_in), the member's
weight leaf w in its own layout, (T, out, in, 5) for a Conv1d and (T, in,
out, 5) for a ConvTranspose1d, its bias b (T, C_out); k = 5, padding 2,
stride 1 (lesionvae_tpu/models/layers.py:165-213 under the fleet's
``jax.vmap``).  A ConvTranspose1d at stride 1 is a convolution with the
kernel reversed along k, so both are

    y[n, l, o] = b[o] + sum_{k, i} h[n, l + k - 2, i] * W_k[i, o]

with W_k[i, o] = w[o, i, k] (Conv1d) or w[i, o, 4 - k] (ConvTranspose1d)
and h = 0 outside the sample.  The backward, from h, w and dy alone:

    dh = the same convolution of dy with the kernel read the other way
         (w's (in, out) swapped and the flip negated): ``conv1d_plain(dy, w,
         None, not transpose)``
    dw[o, i, k] = sum over rows of h[row shifted by k - 2, i] * dy[row, o],
         written in the leaf's own layout (contiguous; reversed along k and
         transposed for a ConvTranspose1d)
    db = sum over rows of dy

so the autograd graph keeps h and w, not a column buffer.

``fleet_conv1d`` is the entry point.  On CPU tensors its forward and
backward compute the plain versions (``conv1d_plain``, the pad + unfold +
batched product the stacked model ran before these kernels, and
``conv1d_backward_plain``); on CUDA tensors they launch the kernels
(``conv_fwd`` for the forward and dh, ``conv_wgrad`` for dw and db) and
raise on inputs the kernels do not take; nothing falls back.  Each wrapper
counts its launches, and ``COUNTS`` the float32 ``conv_fwd`` launches that
took a tile smaller than the full one (``fwd_f32_tile``: a grid of few
members, the single VAE's).  The kernels sum in another order than cuBLAS does
(float32: FP32 FMA; bf16: tensor cores with float32 accumulation, one
rounding of each output), so the card holds them to their plain versions
within a tolerance, not bit for bit; their own order is fixed, so two
calls give the same bits.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from .cuda_build import Count, count_launch, load

TAPS, PAD = 5, 2                # the convolutions' kernel size and padding
# csrc/conv1d.cu: the channel tiles of the weight-gradient kernel (float32:
# output channels 16, 32 or 64 by C_out, input channels 16; bf16: 64 x 32,
# or 32 / 16 where C_out / C_in fit) and its split of a member's rows: about
# TARGET_BLOCKS blocks, each range at least MIN_SPLIT_ROWS rows; in bf16
# about WGRAD_BF16_TARGET blocks (four an SM) and at most
# WGRAD_BF16_MAX_SPLITS, the blocks of one thread-block cluster
# (WH_MAX_SPLITS), which add their sums
WGRAD_F32_IN, WGRAD_BF16_OUT, WGRAD_BF16_IN = 16, 64, 32
TARGET_BLOCKS, MIN_SPLIT_ROWS = 1056, 128
WGRAD_BF16_TARGET, WGRAD_BF16_MAX_SPLITS = 528, 8
VECTOR_BYTES = 16               # csrc/conv1d.cu: a staging thread's load
# csrc/conv1d.cu: the float32 conv_fwd's tiles, (output channels, rows a
# thread, threads), 8 output channels a thread: the full tile (fwd_tile's
# channels, 4 rows a thread, 256 threads: 8192 outputs a block) and the
# smaller ones, each with half the outputs of the one before
F32_CHANNELS, F32_FULL_ROWS, F32_FULL_THREADS = 8, 4, 256
F32_SMALL_TILES = ((16, 2, 256), (16, 1, 256), (16, 1, 128), (16, 1, 64), (16, 1, 32))
SMS = 132                       # csrc/conv1d.cu: SMS, the card's (cost_model.H100_SMS)


# ------------------------------------------------------------ plain version
def _columns(h: torch.Tensor) -> torch.Tensor:
    """The k shifted copies of h (T, N, L, C) side by side: (T, N*L, C*k),
    channel-major (column i*k + k')."""
    T, N, L, C = h.shape
    cols = F.pad(h, (0, 0, PAD, PAD)).unfold(2, TAPS, 1)      # (T, N, L, C, k)
    return cols.reshape(T, N * L, C * TAPS)


def conv1d_plain(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
                 transpose: bool) -> torch.Tensor:
    """Each member's own Conv1d or ConvTranspose1d (k=5, p=2, stride 1) as
    one batched matrix product: the k shifted copies of h (T, N, L, C_in)
    laid side by side, (T, N*L, C_in*k), times the member's kernel as a
    (C_in*k, C_out) matrix, plus b (none: no bias).  -> (T, N, L, C_out)."""
    T, N, L, C = h.shape
    if transpose:
        # (T, in, out, k): the transposed convolution at stride 1 is a
        # convolution with the kernel reversed along k
        w = w.flip(3).permute(0, 1, 3, 2)
    else:
        w = w.permute(0, 2, 3, 1)            # (T, out, in, k) -> (T, in, k, out)
    w = w.reshape(T, C * TAPS, -1)
    cols = _columns(h)
    out = torch.bmm(cols, w) if b is None else torch.baddbmm(b[:, None, :], cols, w)
    return out.view(T, N, L, -1)


def conv_wgrad_plain(h: torch.Tensor, dy: torch.Tensor,
                     transpose: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dw in the leaf's own layout, contiguous; db (T, C_out)) of
    ``conv1d_plain``'s y, from h and the gradient dy (T, N, L, C_out)."""
    T, N, L, C = h.shape
    g = torch.bmm(dy.reshape(T, N * L, -1).transpose(1, 2), _columns(h))
    g = g.view(T, -1, C, TAPS)                                # (T, out, in, k)
    dw = g.flip(3).transpose(1, 2).contiguous() if transpose else g
    return dw, dy.sum(dim=(1, 2))


def conv1d_backward_plain(h: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                          transpose: bool, need_dh: bool = True):
    """(dh or None, dw, db) of ``conv1d_plain``'s y."""
    dh = conv1d_plain(dy, w, None, not transpose) if need_dh else None
    return (dh, *conv_wgrad_plain(h, dy, transpose))


# ------------------------------------------------------------ the kernels' geometry
def weight_dims(w: torch.Tensor, transpose: bool) -> Tuple[int, int]:
    """(C_in, C_out) of a leaf (T, out, in, 5), or (T, in, out, 5) when
    ``transpose``."""
    return (w.shape[1], w.shape[2]) if transpose else (w.shape[2], w.shape[1])


def fwd_tile(c_out: int) -> int:
    """Output channels a block of the bf16 ``conv_fwd``, of the float32
    one's full tile and of the float32 ``conv_wgrad`` takes: 16, 32 or 64
    (csrc/conv1d.cu: fwd_bn)."""
    return 16 if c_out <= 16 else (32 if c_out <= 32 else 64)


def fwd_f32_tiles(c_out: int) -> Tuple[Tuple[int, int, int], ...]:
    """(rows, output channels, threads) a block of each float32 ``conv_fwd``
    tile takes at ``c_out`` output channels, in the order ``fwd_f32_tile``
    tries them: the full tile, then F32_SMALL_TILES (csrc/conv1d.cu:
    F32_FNS, f32_rows)."""
    tiles = ((fwd_tile(c_out), F32_FULL_ROWS, F32_FULL_THREADS), *F32_SMALL_TILES)
    return tuple((threads // (bn // F32_CHANNELS) * tm, bn, threads)
                 for bn, tm, threads in tiles)


def fwd_f32_tile(T: int, rows: int, c_out: int) -> Tuple[int, int, int]:
    """The float32 ``conv_fwd`` tile of a launch over T members of ``rows``
    rows (csrc/conv1d.cu: f32_tile): the full tile where its grid has a
    block for every one of the card's SMS SMs, else the first smaller tile
    whose grid has, else the smallest.  A function of the shapes alone;
    every tile sums each output in the same order, so the choice moves no
    bit."""
    tiles = fwd_f32_tiles(c_out)
    for bm, bn, threads in tiles:
        if -(-rows // bm) * -(-c_out // bn) * T >= SMS:
            return bm, bn, threads
    return tiles[-1]


def wgrad_bf16_tile(c_in: int, c_out: int) -> Tuple[int, int]:
    """(output, input) channels a block of the bf16 ``conv_wgrad`` takes:
    WGRAD_BF16_OUT x WGRAD_BF16_IN, or 32 / 16 where C_out / C_in fit
    (csrc/conv1d.cu: wh_bo, wh_bi)."""
    return (32 if c_out <= 32 else WGRAD_BF16_OUT), (16 if c_in <= 16 else WGRAD_BF16_IN)


def wgrad_splits(T: int, rows: int, c_in: int, c_out: int, dtype: torch.dtype) -> int:
    """The contiguous ranges ``conv_wgrad`` cuts each member's ``rows`` rows
    into, one a block: enough blocks to fill the card (about TARGET_BLOCKS
    over every member and channel tile; bf16: WGRAD_BF16_TARGET), each range
    at least MIN_SPLIT_ROWS rows, and in bf16 at most WGRAD_BF16_MAX_SPLITS
    (a cluster's blocks).  A function of the shapes alone, so the sum's
    order is too."""
    if dtype == torch.bfloat16:
        bo, bi = wgrad_bf16_tile(c_in, c_out)
        tiles = -(-c_out // bo) * -(-c_in // bi)
        target, most = WGRAD_BF16_TARGET, WGRAD_BF16_MAX_SPLITS
    else:
        tiles = -(-c_out // fwd_tile(c_out)) * -(-c_in // WGRAD_F32_IN)
        target, most = TARGET_BLOCKS, 65535 // T
    splits = min(-(-target // (T * tiles)), rows // MIN_SPLIT_ROWS, most)
    return max(1, splits)


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of csrc/conv1d.cu, built on first use; the
    kernels' shared-memory limit is set once here, before any launch."""
    lib = load("conv1d")
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    sig = {"lesionvae_conv1d_init": [],
           "lesionvae_conv1d_attributes": [I, P],
           "lesionvae_conv_fwd": [P, I, LL, I, I, I, I, P, LL, LL, LL, LL, I, P, LL, P,
                                  I, I, I, I, I, P],
           "lesionvae_conv_wgrad": [P, I, LL, I, I, I, I, P, I, P, P, P, P, I, I, I, I, I,
                                    I, I, P]}
    for name, argtypes in sig.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
    _raise(lib.lesionvae_conv1d_init(), "attribute")
    return lib


# kernel functions in the order of lesionvae_conv1d_attributes
KERNEL_FUNCTIONS = ("conv_fwd_f32<16,4,256>", "conv_fwd_f32<32,4,256>",
                    "conv_fwd_f32<64,4,256>",
                    "conv_fwd_bf16<16>", "conv_fwd_bf16<32>", "conv_fwd_bf16<64>",
                    "conv_wgrad_f32<16>", "conv_wgrad_f32<32>", "conv_wgrad_f32<64>",
                    "conv_wgrad_bf16<64,32>", "conv_wgrad_bf16<64,16>",
                    "conv_wgrad_bf16<32,32>", "conv_wgrad_bf16<32,16>", "conv_wgrad_finish<float>",
                    *(f"conv_fwd_f32<{bn},{tm},{threads}>"
                      for bn, tm, threads in F32_SMALL_TILES))


def attributes(L: int) -> dict:
    """Per kernel function: registers a thread, local memory bytes a thread
    and blocks an SM holds at the shared memory of a layer of length L
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``; 0 where its shared
    memory does not fit; the finishing kernel uses none)."""
    out = (ctypes.c_int * (3 * len(KERNEL_FUNCTIONS)))()
    _raise(_lib().lesionvae_conv1d_attributes(L, out), "attribute query")
    return {name: {"registers": out[3 * i], "local_bytes": out[3 * i + 1],
                   "blocks_an_sm": out[3 * i + 2]}
            for i, name in enumerate(KERNEL_FUNCTIONS)}


def _raise(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"conv1d {what} kernel launch failed: cudaError {err}")


def _stream(x: torch.Tensor):
    return torch.cuda.current_stream(x.device).cuda_stream


def _vectored(x: torch.Tensor, strides) -> int:
    """1 where every row of x's channels is whole 16-byte vectors from an
    aligned start (the kernels' staging loads 16 bytes a thread)."""
    v = VECTOR_BYTES // x.element_size()
    return int(x.data_ptr() % VECTOR_BYTES == 0 and strides[-1] == 1
               and all(s % v == 0 for s in strides[:-1]) and x.shape[-1] % v == 0)


def _act(h: torch.Tensor):
    """(member, n, l, c strides, vec) of an activation the kernels read."""
    T, N, L, C = h.shape
    s = h.stride()
    if min(s) < 0 or (N - 1) * s[1] + (L - 1) * s[2] + (C - 1) * s[3] >= 2 ** 31:
        raise ValueError(f"the conv1d kernels index a member of h in 32 bits with "
                         f"non-negative strides, got strides {s}")
    return (s[0], s[1], s[2], s[3], _vectored(h, s))


def _check(h: torch.Tensor, c_out: int) -> None:
    if h.device.type != "cuda":
        raise ValueError(f"the conv1d kernels run on cuda, not {h.device}")
    if h.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the conv1d kernels take float32 or bfloat16, got {h.dtype}")
    if h.dim() != 4 or h.numel() == 0:
        raise ValueError(f"the conv1d kernels take h as a non-empty (T, N, L, C), got "
                         f"{tuple(h.shape)}")
    T, N, L, C = h.shape
    if N * L * max(C, c_out) >= 2 ** 31:
        raise ValueError(f"{N * L} rows of {max(C, c_out)} channels a member: the "
                         "kernels index a member in 32 bits")


def _same(name: str, x: torch.Tensor, h: torch.Tensor, shape) -> None:
    if tuple(x.shape) != tuple(shape) or x.dtype != h.dtype or x.device != h.device:
        raise ValueError(f"{name}: {tuple(shape)} {h.dtype} on {h.device}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")


def conv_fwd(h: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor],
             transpose: bool) -> torch.Tensor:
    """One launch of the convolution kernel: ``conv1d_plain(h, w, b,
    transpose)`` (b None: no bias, the backward's dh)."""
    T, N, L, C = h.shape
    c_in, c_out = weight_dims(w, transpose)
    _check(h, c_out)
    _same("w", w, h, (T, c_out, c_in, TAPS) if not transpose else (T, c_in, c_out, TAPS))
    if c_in != C:
        raise ValueError(f"w takes {c_in} input channels, h has {C}")
    if b is not None:
        _same("b", b, h, (T, c_out))
        if b.stride(1) != 1:
            raise ValueError(f"b: rows of contiguous channels, got strides {b.stride()}")
    s_in, s_out = (w.stride(1), w.stride(2)) if transpose else (w.stride(2), w.stride(1))
    y = torch.empty((T, N, L, c_out), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        _raise(_lib().lesionvae_conv_fwd(
            h.data_ptr(), int(h.dtype == torch.bfloat16), *_act(h), w.data_ptr(),
            w.stride(0), s_in, s_out, w.stride(3), int(transpose),
            None if b is None else b.data_ptr(), 0 if b is None else b.stride(0),
            y.data_ptr(), T, N, L, c_in, c_out, _stream(h)), "forward")
    count_launch(conv_fwd)
    if h.dtype == torch.float32 and fwd_f32_tile(T, N * L, c_out) != fwd_f32_tiles(c_out)[0]:
        count_launch(SMALL_TILE_LAUNCHES)
    return y


def conv_wgrad(h: torch.Tensor, dy: torch.Tensor,
               transpose: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """One call of the weight-gradient kernel (float32: its partials launch
    and its finishing launch; bf16: one launch of clusters, which needs no
    partials): ``conv_wgrad_plain(h, dy, transpose)``, (dw in the leaf's
    layout, db)."""
    T, N, L, C = h.shape
    c_out = dy.shape[3]
    shape = (T, C, c_out, TAPS) if transpose else (T, c_out, C, TAPS)
    _check(h, c_out)
    _same("dy", dy, h, (T, N, L, c_out))
    dy = dy.contiguous()
    splits = wgrad_splits(T, N * L, C, c_out, h.dtype)
    lead = (T, splits) if h.dtype == torch.float32 else (0, 0)
    part = torch.empty((*lead, c_out, C * TAPS), dtype=torch.float32, device=h.device)
    dbpart = torch.empty((*lead, c_out), dtype=torch.float64, device=h.device)
    dw = torch.empty(shape, dtype=h.dtype, device=h.device)
    db = torch.empty((T, c_out), dtype=h.dtype, device=h.device)
    with torch.cuda.device(h.device):
        _raise(_lib().lesionvae_conv_wgrad(
            h.data_ptr(), int(h.dtype == torch.bfloat16), *_act(h), dy.data_ptr(),
            _vectored(dy, dy.stride()), part.data_ptr(), dbpart.data_ptr(), dw.data_ptr(),
            db.data_ptr(), T, N, L, C, c_out, splits, int(transpose), _stream(h)),
            "weight gradient")
    count_launch(conv_wgrad)
    return dw, db


# launches of each kernel in this process (conv_wgrad in float32: its
# partials launch and its finishing launch, counted once); a run sets them to 0 and reads
# them back to show its path went through the kernels.  A launch recorded
# into a CUDA graph counts in ``captured`` and joins ``launches`` at every
# replay (train/program.py)
WRAPPERS = (conv_fwd, conv_wgrad)
for _w in WRAPPERS:
    _w.launches = 0
    _w.captured = 0
# the kernels' counts beside their wrappers', shown in train.program.COUNTS:
# the float32 conv_fwd launches that took a tile smaller than the full one
COUNTS = {"conv_fwd_small_tiles": 0}
SMALL_TILE_LAUNCHES = Count(COUNTS, "conv_fwd_small_tiles")


# ------------------------------------------------------------ autograd
class FleetConv1d(torch.autograd.Function):
    """Every member's Conv1d or ConvTranspose1d with its backward; CPU
    tensors: the plain versions, CUDA tensors: the kernels.  The backward
    opens the ``record_function`` range ``backward_range`` when one is
    named."""

    @staticmethod
    def forward(ctx, h, w, b, transpose, backward_range):
        fwd = conv1d_plain if h.device.type == "cpu" else conv_fwd
        y = fwd(h, w, b, transpose)
        ctx.save_for_backward(h, w)
        ctx.transpose, ctx.backward_range = transpose, backward_range
        return y

    @staticmethod
    def backward(ctx, dy):
        h, w = ctx.saved_tensors
        need_dh = ctx.needs_input_grad[0]
        span = (record_function(ctx.backward_range) if ctx.backward_range
                else contextlib.nullcontext())
        with span:
            if h.device.type == "cpu":
                dh, dw, db = conv1d_backward_plain(h, w, dy, ctx.transpose, need_dh)
            else:
                dy = dy.contiguous()
                dh = conv_fwd(dy, w, None, not ctx.transpose) if need_dh else None
                dw, db = conv_wgrad(h, dy, ctx.transpose)
        return dh, dw, db, None, None


def fleet_conv1d(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor, transpose: bool,
                 backward_range: Optional[str] = None) -> torch.Tensor:
    """Every member's Conv1d (``transpose`` False, w (T, out, in, 5)) or
    ConvTranspose1d (w (T, in, out, 5)), k = 5, padding 2, stride 1, on h
    (T, N, L, C_in) with bias b (T, C_out): -> (T, N, L, C_out)."""
    if h.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the fleet's convolutions run on cuda or cpu, not {h.device}")
    return FleetConv1d.apply(h, w, b, transpose, backward_range)
