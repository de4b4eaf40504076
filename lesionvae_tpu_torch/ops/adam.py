"""The clip -> decay -> Adam step with float32 storage, for T members at
once: the gradient gather with each member's norm (``grad_sq_norm``) and the
update (``adam_step``), the CUDA kernels of ``csrc/adam.cu`` and their plain
versions.

``grad_sq_norm(grads, dsts, work, sq, g_norm)``: ``grads`` are the leaves'
gradients as autograd returns them, (T, *shape) each, float32 or bf16, in
any layout whose dims inside a member merge into a row stride and at most
two column strides; each is copied into its destination ``dsts`` (a (T,
*shape) view of packed rows, row-major inside a member, of the gradient's
dtype; None copies nothing), and each member's sum of squares over every
leaf goes to ``sq`` and its root to ``g_norm`` ((T,) float32).  The sum has
one order, the kernel's (``csrc/adam.cu``, header): each leaf as a matrix
(``leaf_grid``) cut into tiles of 32 x 64 (``leaf_tiles``), 8 squares a
logical lane added in turn, 256 lanes in a tree, then each member's tile
partials the same way (``lane_tree``).  ``work`` is the (T, n_tiles) float32
workspace of the partials (``norm_work``), made once beside the buffers it
serves so that a captured launch keeps its address.  How the kernel moves
the tiles (a warp a tile, ``warp_tile``; each leaf's loads and stores,
``leaf_route``) changes none of that order.

``adam_step(p, m, v, g, g_norm, bc1, bc2, finite, hyper)``: in place on
(T, n) rows p, m, v with the gradient g, each member with its own norm,
bias corrections and finite flag; a member whose ``finite`` is false keeps
its p, m and v.  The formula and order are ``train.trainer.ClipDecayAdam``'s
(lesionvae_tpu/train/lowmem.py:97-104, trainer.py:106-115); ``hyper`` holds
the hyperparameters as Python floats (``Hyper``), which the plain version
uses as its tensors' dtype rounds them and the kernel as their float32
values (``ops.sr_adam.consts``).

On CPU tensors both entry points compute their plain versions; on CUDA
tensors they launch the kernels, count the launch (``count_launch``) and
raise on inputs the kernels do not take.  There is no other route.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .cuda_build import count_launch, load
from ..utils.cost_model import kernel_bound_ms
from .sr_adam import consts

THREADS = 256                  # csrc/adam.cu: THREADS (a tile's logical lanes)
TILE_ROWS, TILE_COLS = 32, 64  # csrc/adam.cu: TILE_R, TILE_C
PER_THREAD = TILE_ROWS * TILE_COLS // THREADS
MAX_LEAVES = 48                # csrc/adam.cu: MAX_LEAVES
WARPS = 8                      # csrc/adam.cu: WARPS (tiles a block of the gather)
LOAD_BYTES = 16                # the widest load down a column, and its alignment
VEC = 4                        # float32 per 16-byte load of the update
INT32_MAX = 2 ** 31 - 1
# device-memory traffic of the update: p, m, v read and written, g read
UPDATE_BYTES_PER_ELEMENT = 28
# FP32 operations an element of the update by the formula (the clip's two
# are not counted: a step below the clip does not run them): 2 for g + wd*p,
# 3 for m', 4 for v', 7 for the update and p + u
UPDATE_OPS_PER_ELEMENT = 16
# The least instructions an element of the update can be written in, one
# issue slot each (as ops/sr_adam.py counts them): 2 + 3 + 4 for g, m', v'
# (each operation rounds on its own), three correctly rounded quotients at 6
# and a root at 5, + eps, * -lr and p + u
UPDATE_MIN_INSTRUCTIONS = 2 + 3 + 4 + 3 * 6 + 5 + 3
# a square and an add an element of the norm
NORM_OPS_PER_ELEMENT = 2


class Hyper(NamedTuple):
    """The step's hyperparameters, in ``ops.sr_adam.consts``' order."""

    lr: float
    weight_decay: float
    grad_clip: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


# ------------------------------------------------------------ the norm's order
def leaf_grid(shape: Sequence[int]) -> Tuple[int, int]:
    """(rows, cols) of a leaf of a member's ``shape`` in the sum's order:
    its first dim by the product of the rest, or, for a leaf of one dim
    (or none), rows of ``TILE_COLS``."""
    n = math.prod(shape)
    if len(shape) <= 1:
        return -(-n // TILE_COLS), TILE_COLS
    return shape[0], n // shape[0]


def leaf_tiles(shape: Sequence[int]) -> Tuple[int, int]:
    """(tiles, column tiles) of a leaf of a member's ``shape``."""
    rows, cols = leaf_grid(shape)
    col_tiles = -(-cols // TILE_COLS)
    return -(-rows // TILE_ROWS) * col_tiles, col_tiles


def norm_work(shapes: Sequence[Sequence[int]], members: int, device) -> torch.Tensor:
    """The (members, n_tiles) float32 workspace of ``grad_sq_norm`` for leaves
    of these member shapes."""
    n_tiles = sum(leaf_tiles(s)[0] for s in shapes)
    return torch.zeros((members, n_tiles), dtype=torch.float32, device=device)


def lane_tree(x: torch.Tensor) -> torch.Tensor:
    """(..., K, THREADS) -> (...): each lane adds its K values one after
    another to +0, then the lanes are added in a tree (lane t takes lane
    t + w, w = THREADS/2 .. 1)."""
    acc = torch.zeros_like(x[..., 0, :])
    for k in range(x.shape[-2]):
        acc = acc + x[..., k, :]
    w = THREADS // 2
    while w:
        acc = acc[..., :w] + acc[..., w:2 * w]
        w //= 2
    return acc[..., 0]


def tile_squares(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(T, *shape) -> (T, tiles, PER_THREAD, THREADS): the squares of a leaf in
    ``dtype``, tile by tile, [k, t] the k-th element of thread t (row t //
    TILE_COLS + k * THREADS // TILE_COLS, column t % TILE_COLS of the tile),
    +0 outside the leaf."""
    T, shape = x.shape[0], tuple(x.shape[1:])
    rows, cols = leaf_grid(shape)
    x = x.reshape(T, -1).to(dtype)
    sq = F.pad(x * x, (0, rows * cols - x.shape[1])).view(T, rows, cols)
    nr, nc = -(-rows // TILE_ROWS), -(-cols // TILE_COLS)
    sq = F.pad(sq, (0, nc * TILE_COLS - cols, 0, nr * TILE_ROWS - rows))
    sq = sq.view(T, nr, TILE_ROWS, nc, TILE_COLS).permute(0, 1, 3, 2, 4)
    return sq.reshape(T, nr * nc, PER_THREAD, THREADS)


# ------------------------------------------------------------ plain versions
def grad_sq_norm_plain(grads: Sequence[torch.Tensor],
                       dsts: Sequence[Optional[torch.Tensor]], work: torch.Tensor,
                       sq: torch.Tensor, g_norm: torch.Tensor) -> None:
    """The gather and the norm in the kernel's order, in ``sq``'s dtype
    (float64 for a float64 run, else float32); ``work`` is the kernel's and
    is not used here."""
    for x, d in zip(grads, dsts):
        if d is not None:
            d.copy_(x)
    part = lane_tree(torch.cat([tile_squares(x, sq.dtype) for x in grads], dim=1))
    T, n_tiles = part.shape
    K = -(-n_tiles // THREADS)
    total = lane_tree(F.pad(part, (0, K * THREADS - n_tiles)).view(T, K, THREADS))
    sq.copy_(total)
    g_norm.copy_(torch.sqrt(total))


def adam_step_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
                    g: torch.Tensor, g_norm: torch.Tensor, bc1: torch.Tensor,
                    bc2: torch.Tensor, finite: torch.Tensor, h: Hyper) -> None:
    """The update in plain PyTorch, in place: the same operations in the same
    order as the kernel, each rounding once in the tensors' dtype."""
    col = lambda x: x.reshape(-1, 1)  # noqa: E731
    g_norm, bc1, bc2, finite = col(g_norm), col(bc1), col(bc2), col(finite)
    g = torch.where(g_norm < h.grad_clip, g, (g / g_norm) * h.grad_clip)
    g = g + h.weight_decay * p
    m2 = (1 - h.b1) * g + h.b1 * m
    v2 = (1 - h.b2) * (g * g) + h.b2 * v
    u = -h.lr * ((m2 / bc1) / (torch.sqrt(v2 / bc2) + h.eps))
    p.copy_(torch.where(finite, p + u, p))
    m.copy_(torch.where(finite, m2, m))
    v.copy_(torch.where(finite, v2, v))


# ------------------------------------------------------------ the kernels
class Leaf(ctypes.Structure):
    """One leaf of the kernel's table: ``Leaf`` of csrc/adam.cu."""

    _fields_ = [("src", ctypes.c_void_p), ("dst", ctypes.c_void_p),
                *[(f, ctypes.c_int32) for f in (
                    "src_member", "dst_member", "s0", "s1", "s2", "rows", "cols",
                    "d2", "n", "bf16", "first_tile", "col_tiles", "rows_fast",
                    "src_vec", "dst_vec")]]


def inner_strides(x: torch.Tensor) -> Tuple[int, int, int, int]:
    """(s0, d2, s1, s2) of a gradient (T, *shape): element (r, c) of a
    member's ``leaf_grid`` lies ``r*s0 + (c // d2)*s1 + (c % d2)*s2``
    elements from its first.  Raises where the dims after the first do not
    merge into at most two strided dims."""
    shape, strides = tuple(x.shape[1:]), tuple(x.stride()[1:])
    if len(shape) <= 1:
        s = strides[0] if shape else 1
        return TILE_COLS * s, TILE_COLS, 0, s
    dims: List[List[int]] = []          # [size, stride] of the column dims
    for size, stride in zip(shape[1:], strides[1:]):
        if size == 1:
            continue
        if dims and dims[-1][1] == size * stride:
            dims[-1] = [dims[-1][0] * size, stride]
        else:
            dims.append([size, stride])
    if len(dims) > 2:
        raise ValueError(f"a gradient of shape {tuple(x.shape)} and strides "
                         f"{x.stride()}: its columns take {len(dims)} strides, the "
                         "norm kernel at most 2")
    if not dims:
        return strides[0], 1, 0, 1
    if len(dims) == 1:
        return strides[0], dims[0][0], 0, dims[0][1]
    return strides[0], dims[1][0], dims[0][1], dims[1][1]


def _int32(value: int, what: str) -> int:
    if abs(value) > INT32_MAX:
        raise ValueError(f"{what} {value} does not fit the kernel's 32-bit fields")
    return value


def leaf_route(x: torch.Tensor, d: Optional[torch.Tensor]) -> dict:
    """How the kernel moves a gradient ``x`` (T, *shape) and its destination
    ``d``, lane i of a warp taking columns 2i and 2i + 1 of a tile:
    ``rows_fast`` 1 where the rows are the source's fastest dim (a lane
    loads down its two columns), else 0 (along the rows); ``src_vec`` the
    elements of one load: down a column 16 bytes' worth where every column
    of every member starts 16-byte aligned, along a row 2 (a bf16x2 or
    float2) where every row starts at an even element and its columns are
    contiguous, else 1; ``dst_vec`` 2 where every packed row of every member
    starts at an even element (a lane stores its two columns as one), else
    1."""
    size = x.element_size()
    s0, d2, s1, s2 = inner_strides(x)
    rows, cols = leaf_grid(tuple(x.shape[1:]))
    rows_fast = int(s0 == 1 and s2 != 1)
    vec = LOAD_BYTES // size if rows_fast else 2

    def aligned(ptr: int, member: int, *strides: int) -> bool:
        return (ptr % (vec * size) == 0 and (x.shape[0] == 1 or member % vec == 0)
                and all(s % vec == 0 for s in strides))

    if rows_fast:   # every column's first row aligned
        src = aligned(x.data_ptr(), x.stride(0), s2, *([] if d2 == cols else [s1]))
    else:           # every row contiguous over its columns, its first aligned
        src = (s2 == 1 and d2 == cols
               and aligned(x.data_ptr(), x.stride(0), *([] if rows == 1 else [s0])))
    pairs = d is not None and (d.data_ptr() % (2 * size) == 0
                               and (d.shape[0] == 1 or d.stride(0) % 2 == 0)
                               and (rows == 1 or cols % 2 == 0))
    return {"rows_fast": rows_fast, "src_vec": vec if src else 1,
            "dst_vec": 2 if pairs else 1}


def norm_table(grads: Sequence[torch.Tensor], dsts: Sequence[Optional[torch.Tensor]],
               work: torch.Tensor, sq: torch.Tensor, g_norm: torch.Tensor):
    """The kernel's leaf table for these arguments (a ctypes array of
    ``Leaf``), after every check; raises on what the kernel does not take."""
    if not grads or len(grads) != len(dsts) or len(grads) > MAX_LEAVES:
        raise ValueError(f"the norm kernel takes 1 to {MAX_LEAVES} leaves with one "
                         f"destination each, got {len(grads)} and {len(dsts)}")
    T, device = grads[0].shape[0], grads[0].device
    table = (Leaf * len(grads))()
    first = 0
    for i, (x, d) in enumerate(zip(grads, dsts)):
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"the norm kernel takes float32 or bf16 gradients, got "
                            f"{x.dtype} at leaf {i}")
        if x.dim() < 1 or x.shape[0] != T or x.device != device or x.numel() == 0:
            raise ValueError(f"leaf {i}: shape {tuple(x.shape)} on {x.device}; every "
                             f"leaf is a non-empty ({T}, *shape) tensor on {device}")
        if d is not None:
            if d.dtype != x.dtype or d.shape != x.shape or d.device != device:
                raise ValueError(f"leaf {i}: destination {tuple(d.shape)} {d.dtype} on "
                                 f"{d.device}, gradient {tuple(x.shape)} {x.dtype}")
            if not d[0].is_contiguous():
                raise ValueError(f"leaf {i}: the destination is not contiguous inside "
                                 "a member (packed rows)")
        s0, d2, s1, s2 = inner_strides(x)
        rows, cols = leaf_grid(tuple(x.shape[1:]))
        tiles, col_tiles = leaf_tiles(tuple(x.shape[1:]))
        e = table[i]
        e.src, e.dst = x.data_ptr(), (d.data_ptr() if d is not None else None)
        e.src_member = _int32(x.stride(0), "a gradient's member stride")
        e.dst_member = _int32(d.stride(0) if d is not None else 0,
                              "a destination's member stride")
        e.s0, e.s1, e.s2 = (_int32(s, "a gradient's stride") for s in (s0, s1, s2))
        e.rows, e.cols, e.d2 = rows, cols, d2
        e.n = _int32(x[0].numel(), "a leaf's elements")
        e.bf16 = int(x.dtype == torch.bfloat16)
        e.first_tile, e.col_tiles = first, col_tiles
        for key, value in leaf_route(x, d).items():
            setattr(e, key, value)
        first += tiles
    if (work.dtype != torch.float32 or work.shape != (T, first)
            or not work.is_contiguous() or work.device != device):
        raise ValueError(f"the workspace is a contiguous float32 ({T}, {first}) tensor "
                         f"on {device} (ops.adam.norm_work), got {tuple(work.shape)} "
                         f"{work.dtype}")
    _int32(T * first, "the workspace's elements")
    for name, t in (("sq", sq), ("g_norm", g_norm)):
        if (t.dtype != torch.float32 or t.shape != (T,) or not t.is_contiguous()
                or t.device != device):
            raise ValueError(f"{name}: a contiguous ({T},) float32 tensor on {device}, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    return table


def warp_tile(g: int, n_tiles: int, table) -> Tuple[int, int, int]:
    """(member, leaf, tile of the leaf) of warp ``g`` of the gather (csrc/
    adam.cu: warp g = blockIdx.x * WARPS + warp takes the g-th (member,
    tile) pair, g = member * n_tiles + tile, and writes its partial to
    ``work``'s element g); the leaf is the last whose first tile is at most
    the tile."""
    member, i = divmod(g, n_tiles)
    lo, hi = 0, len(table) - 1
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if table[mid].first_tile <= i:
            lo = mid
        else:
            hi = mid - 1
    return member, lo, i - table[lo].first_tile


def adam_check(p, m, v, g, g_norm, bc1, bc2, finite) -> Tuple[int, int, int, bool]:
    """(T, n, row stride, 16-byte loads) for these arguments of the update
    kernel; raises on what it does not take."""
    if p.dim() != 2:
        raise ValueError(f"the Adam kernel takes (T, n) rows, got p {tuple(p.shape)}")
    T, n = p.shape
    for name, t in (("p", p), ("m", m), ("v", v), ("g", g)):
        if t.dtype != torch.float32:
            raise TypeError(f"the Adam kernel takes {name} as float32, got {t.dtype}")
        if t.shape != (T, n) or t.device != p.device:
            raise ValueError(f"{name}: shape {tuple(t.shape)} on {t.device}, p "
                             f"{(T, n)} on {p.device}")
        if n and t.stride(1) != 1:
            raise ValueError(f"the Adam kernel takes rows of {name} contiguous")
        if T > 1 and (t.stride(0) != p.stride(0) or t.stride(0) < n):
            raise ValueError(f"{name}: rows {t.stride(0)} elements apart, p's "
                             f"{p.stride(0)}; the kernel takes one row stride")
        if t.data_ptr() % 16:
            raise ValueError(f"the Adam kernel takes {name} aligned to 16 bytes")
    for name, t, dt in (("g_norm", g_norm, torch.float32), ("bc1", bc1, torch.float32),
                        ("bc2", bc2, torch.float32), ("finite", finite, torch.bool)):
        if (t.dtype != dt or t.shape != (T,) or not t.is_contiguous()
                or t.device != p.device):
            raise ValueError(f"{name}: a contiguous ({T},) {dt} tensor on p's device, "
                             f"got {tuple(t.shape)} {t.dtype} on {t.device}")
    # one member's row needs no stride: 16-byte loads from its aligned start
    stride = p.stride(0) if T > 1 else n
    return T, n, stride, T == 1 or stride % VEC == 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The C entry points of csrc/adam.cu, built on first use."""
    lib = load("adam")
    lib.lesionvae_grad_sq_norm.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.lesionvae_adam_step.argtypes = ([ctypes.c_void_p] * 8
                                        + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_longlong, ctypes.c_int]
                                        + [ctypes.c_float] * 8 + [ctypes.c_void_p])
    lib.lesionvae_adam_attributes.argtypes = [ctypes.c_void_p]
    lib.lesionvae_norm_blocks_per_sm.argtypes = []
    for fn in (lib.lesionvae_grad_sq_norm, lib.lesionvae_adam_step,
               lib.lesionvae_adam_attributes, lib.lesionvae_norm_blocks_per_sm):
        fn.restype = ctypes.c_int
    return lib


#: the kernel functions of csrc/adam.cu
KERNELS = ("norm_tiles_kernel", "norm_finish_kernel", "adam_kernel")


def kernel_attributes() -> dict:
    """Registers a thread, local memory bytes a thread and static shared
    memory bytes a block of each kernel function, as the build made them
    (``cudaFuncGetAttributes``)."""
    out = (ctypes.c_int * (3 * len(KERNELS)))()
    err = _lib().lesionvae_adam_attributes(ctypes.addressof(out))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: cudaError {err}")
    return {k: {"registers": out[3 * i], "local_bytes": out[3 * i + 1],
                "shared_bytes": out[3 * i + 2]} for i, k in enumerate(KERNELS)}


def norm_blocks_per_sm() -> int:
    """Blocks of the gather (``WARPS`` tiles each) an SM holds at once, as
    the build made it (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)."""
    n = _lib().lesionvae_norm_blocks_per_sm()
    if n <= 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveBlocksPerMultiprocessor failed: "
                           f"cudaError {-n}")
    return n


def _stream(t: torch.Tensor) -> int:
    with torch.cuda.device(t.device):
        return torch.cuda.current_stream().cuda_stream


def _device(t: torch.Tensor, what: str) -> bool:
    """True for a CPU tensor (the plain version), False for CUDA; raises on
    anything else."""
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {t.device}")
    return False


def grad_sq_norm(grads: Sequence[torch.Tensor], dsts: Sequence[Optional[torch.Tensor]],
                 work: torch.Tensor, sq: torch.Tensor, g_norm: torch.Tensor) -> None:
    """The gather into ``dsts`` and each member's sum of squares (``sq``) and
    norm (``g_norm``) over ``grads`` (see the module docstring).  CUDA
    tensors: the kernels (one count in ``grad_sq_norm.launches`` for their
    two launches); CPU tensors: the plain version."""
    if _device(sq, "the gradient norm"):
        return grad_sq_norm_plain(grads, dsts, work, sq, g_norm)
    table = norm_table(grads, dsts, work, sq, g_norm)
    err = _lib().lesionvae_grad_sq_norm(
        ctypes.addressof(table), len(table), sq.shape[0], work.shape[1],
        work.data_ptr(), sq.data_ptr(), g_norm.data_ptr(), _stream(sq))
    if err != 0:
        raise RuntimeError(f"gradient norm kernel launch failed: cudaError {err}")
    count_launch(grad_sq_norm)


def adam_step(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
              g_norm: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
              finite: torch.Tensor, hyper: Hyper) -> None:
    """One step for all members, in place.  p, m, v, g: float32 (T, n) with
    one row stride, contiguous rows, 16-byte aligned; g_norm, bc1, bc2:
    float32 (T,); finite: bool (T,).  CUDA tensors: the kernel, counted in
    ``adam_step.launches``; CPU tensors: the plain version."""
    if _device(p, "the Adam step"):
        return adam_step_plain(p, m, v, g, g_norm, bc1, bc2, finite, hyper)
    T, n, stride, vec = adam_check(p, m, v, g, g_norm, bc1, bc2, finite)
    c = consts(*hyper)
    err = _lib().lesionvae_adam_step(
        p.data_ptr(), m.data_ptr(), v.data_ptr(), g.data_ptr(), g_norm.data_ptr(),
        bc1.data_ptr(), bc2.data_ptr(), finite.data_ptr(), T, n, stride, int(vec),
        c["clip"], c["wd"], c["b1"], c["one_minus_b1"], c["b2"], c["one_minus_b2"],
        c["neg_lr"], c["eps"], _stream(p))
    if err != 0:
        raise RuntimeError(f"Adam kernel launch failed: cudaError {err}")
    count_launch(adam_step)


# launches of the kernels in this process; a run sets them to 0 and reads
# them back to show its path went through the kernels.  A launch recorded
# into a CUDA graph counts in ``captured`` and joins ``launches`` at every
# replay (train/program.py)
WRAPPERS = (grad_sq_norm, adam_step)
for _w in WRAPPERS:
    _w.launches = 0
    _w.captured = 0


def adam_bound_ms(elements: int) -> dict:
    """Least time of the update over ``elements`` on the card
    (``utils.cost_model.kernel_bound_ms``): 28 bytes, 16 FP32 operations and
    the least instruction count an element."""
    return kernel_bound_ms(UPDATE_BYTES_PER_ELEMENT * elements,
                           UPDATE_OPS_PER_ELEMENT * elements,
                           UPDATE_MIN_INSTRUCTIONS * elements)


def norm_bytes(grads: Sequence[torch.Tensor], dsts: Sequence[Optional[torch.Tensor]]
               ) -> int:
    """The least device-memory bytes of ``grad_sq_norm`` on these arguments:
    each gradient element read once and written once where it has a
    destination (the partials, a few per 2,048 elements, are left out)."""
    return sum(x.numel() * x.element_size() * (1 + (d is not None))
               for x, d in zip(grads, dsts))


def norm_bound_ms(grads: Sequence[torch.Tensor],
                  dsts: Sequence[Optional[torch.Tensor]]) -> dict:
    """Least time of ``grad_sq_norm`` on these arguments on the card
    (``utils.cost_model.kernel_bound_ms``): ``norm_bytes``, a square and an
    add an element, and for the issue the same two, a load and a store."""
    elements = sum(x.numel() for x in grads)
    return kernel_bound_ms(norm_bytes(grads, dsts), NORM_OPS_PER_ELEMENT * elements,
                           (NORM_OPS_PER_ELEMENT + 2) * elements)
