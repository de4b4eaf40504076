"""Star-convex radius sampling: the CUDA kernel and its plain version.

    r[b, d] = max_{j < count_b} <dir_d, surface[b, j] - centroid_b>,  r = 0 when count_b == 0

``sample_radii`` is the entry point.  On a CUDA tensor it launches the
hand-written Hopper kernel ``csrc/radius.cu`` (which replaces
``lesionvae_tpu/ops/pallas_radius.py::_radius_kernel``) and raises on inputs
the kernel does not take; on a CPU tensor it computes ``sample_radii_plain``.
There is no other route.  The kernel is bound by FP32 FMA work (K = 3 per
point-direction pair), not by bytes: see the note at the top of the source.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .cuda_build import load

# CUDA's limit on gridDim.y, which carries the lesion index
_MAX_BATCH = 65535


def sample_radii_plain(surface: torch.Tensor, counts: torch.Tensor,
                       centroids: torch.Tensor,
                       directions: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch radius function (ops/sh.py:107-130 of the JAX package).

    surface: (B, N, 3) padded surface points (pad rows arbitrary),
    counts: (B,), centroids: (B, 3), directions: (D, 3).  Returns (B, D).
    Materializes the (B, D, N) projection, so it is for tests and small
    inputs; the kernel never writes it.
    """
    B, N, _ = surface.shape
    if N == 0:
        return surface.new_zeros(B, directions.shape[0])
    centered = surface - centroids[:, None, :]
    proj = directions @ centered.transpose(1, 2)                 # (B, D, N)
    mask = torch.arange(N, device=surface.device) < counts[:, None]  # (B, N)
    proj = proj.masked_fill(~mask[:, None, :], float("-inf"))
    r = proj.amax(dim=2)
    return torch.where((counts > 0)[:, None], r, torch.zeros_like(r))


def _check(surface, counts, centroids, directions) -> None:
    for name, t, dtype in (("surface", surface, torch.float32),
                           ("counts", counts, torch.int32),
                           ("centroids", centroids, torch.float32),
                           ("directions", directions, torch.float32)):
        if t.device != surface.device:
            raise ValueError(f"{name} is on {t.device}, surface on {surface.device}")
        if t.dtype != dtype:
            raise TypeError(f"radius kernel takes {name} as {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"radius kernel takes a contiguous {name}")
    B = surface.shape[0]
    if (surface.dim() != 3 or surface.shape[2] != 3
            or tuple(counts.shape) != (B,)
            or tuple(centroids.shape) != (B, 3)
            or directions.dim() != 2 or directions.shape[1] != 3):
        raise ValueError(
            "radius kernel takes surface (B, N, 3), counts (B,), centroids "
            f"(B, 3), directions (D, 3); got {tuple(surface.shape)}, "
            f"{tuple(counts.shape)}, {tuple(centroids.shape)}, "
            f"{tuple(directions.shape)}")
    if B > _MAX_BATCH:
        raise ValueError(f"radius kernel takes at most {_MAX_BATCH} lesions, got {B}")


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/radius.cu, built on first use."""
    fn = load("radius").lesionvae_radius
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(surface, counts, centroids, directions) -> torch.Tensor:
    _check(surface, counts, centroids, directions)
    fn = _kernel()
    B, N, _ = surface.shape
    D = directions.shape[0]
    out = torch.empty((B, D), dtype=torch.float32, device=surface.device)
    with torch.cuda.device(surface.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(surface.data_ptr(), counts.data_ptr(), centroids.data_ptr(),
                 directions.data_ptr(), out.data_ptr(), B, N, D, stream)
    if err != 0:
        raise RuntimeError(f"radius kernel launch failed: cudaError {err}")
    sample_radii.launches += 1
    return out


def sample_radii(surface: torch.Tensor, counts: torch.Tensor,
                 centroids: torch.Tensor,
                 directions: torch.Tensor) -> torch.Tensor:
    """(B, D) radius function.  CUDA tensors: the radius kernel (float32,
    int32 counts, contiguous, any B, N, D), counted in
    ``sample_radii.launches``.  CPU tensors: ``sample_radii_plain``."""
    if surface.device.type == "cpu":
        return sample_radii_plain(surface, counts, centroids, directions)
    if surface.device.type != "cuda":
        raise ValueError(f"radius sampling runs on cuda or cpu, not {surface.device}")
    return _launch(surface, counts, centroids, directions)


# launches of the radius kernel in this process; a run sets it to 0 and reads
# it back to show its main path went through the kernel
sample_radii.launches = 0
