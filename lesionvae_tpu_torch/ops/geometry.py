"""The 17 streamline geometry metrics of a padded bundle: the CUDA kernel and
its plain version.

A bundle is one dense ``(S, P, 3)`` tensor of points plus ``(S,)`` lengths;
every reduction is exact for ragged lengths.  Semantics are the reference's
(tract_geom_proc.py, file:line per metric below), as the JAX package
reproduces them (lesionvae_tpu/ops/geometry.py):

- derivatives are ``np.gradient`` central differences with one-sided edges
  (tract_geom_proc.py:48-51);
- ``elongation_ratio``/``planarity_ratio`` are +inf when their denominators
  are <= 1e-12 (tract_geom_proc.py:126-136): reproduced, not "fixed";
- covariance uses ddof=1 like ``np.cov`` (tract_geom_proc.py:122);
- streamlines of arc length <= 1e-8 are flagged invalid
  (tract_geom_proc.py:159-161).

Entry points: ``streamline_metrics_stacked`` (points) and
``streamline_metrics_stacked_u16`` (u16 delta codes, ops.geo_codec).  On
CUDA tensors they launch the hand-written Hopper kernel
``csrc/geometry.cu``, float32 only, and raise on inputs it does not take;
on CPU tensors they compute the plain version (``streamline_metrics``),
in float32 or, as the parity route, float64.  There is no other route.

The plain version is written so that its float32 operations are the
kernel's, one rounding each, in the same order: sums over points run in
point order, three-term dot products and norms left to right, division by
a constant is a true division, and minimum, maximum and clip propagate NaN.
So on the card the kernel and the plain version agree bit for bit
(``chip_smoke.py`` fails if any element differs, NaN for NaN).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict

import numpy as np
import torch

from ..utils.cost_model import kernel_bound_ms
from .cuda_build import load

METRIC_NAMES = (
    "length", "end_to_end", "tortuosity", "straightness",
    "curv_mean", "curv_std", "curv_energy", "torsion_mean",
    "bend_angle_mean", "bbox_vol", "elongation_ratio", "planarity_ratio",
    "anisotropy_ratio", "centroid_x", "centroid_y", "centroid_z",
    "ang_dispersion",
)
STACKED_NAMES = (*METRIC_NAMES, "valid", "eigen_ok")

# float32 eigen certificate (see streamline_metrics): the deflated solver's
# float32 eigenvalues are within ~7e-7·λ1 of float64 (the JAX package's
# measurement over 25k adversarial spectra plus the covariance's own
# rounding), so λ2, λ3 > 1e-4·λ1 certifies the reference's 1e-12 inf gate
# with > 100x margin and keeps an unrefined ratio within ~1%.
EIGEN_SAFE_REL = 1e-4
# below λ1 ~ 1e-8 the relative certificate no longer clears the absolute
# 1e-12 gate; the floor sits 10x above that, so point-scale curves always
# take the exact float64 host path
EIGEN_SAFE_ABS = 1e-7


# ------------------------------------------------------------ plain version
def _const(x: torch.Tensor, value: float) -> torch.Tensor:
    """``value`` as a 0-dim tensor of x's type on x's device.  A division by
    it is a true division: PyTorch on CUDA turns ``x / python_float`` into a
    product with the reciprocal, which rounds differently."""
    return torch.full((), value, dtype=x.dtype, device=x.device)


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _norm3(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_dot3(a, a))


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross's formula and order."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _masked_gradient(x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """np.gradient along the point axis over the first ``n`` rows of each
    padded curve: x (S, P, 3), n (S,).  One-sided differences at rows 0 and
    n-1 (and P-1), central elsewhere; row 0 takes precedence."""
    P = x.shape[-2]
    i = torch.arange(P, device=x.device)
    x_next = torch.cat([x[:, 1:], x[:, -1:]], dim=1)
    x_prev = torch.cat([x[:, :1], x[:, :-1]], dim=1)
    central = (x_next - x_prev) * 0.5
    fwd = x_next - x
    bwd = x - x_prev
    is_last = (i[None] == (n - 1)[:, None]) | (i[None] >= P - 1)
    out = torch.where(is_last[..., None], bwd, central)
    return torch.where((i == 0)[None, :, None], fwd, out)


def _seqsum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Masked sum over dim 1 of (S, K[, C]) in index order, one rounding an
    addition, as the kernel's loop adds (a masked term adds 0)."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mask.dim() < x.dim():
        mask = mask[..., None]
    acc = torch.zeros_like(x[:, 0])
    for k in range(x.shape[1]):
        acc = acc + torch.where(mask[:, k], x[:, k], zero)
    return acc


def _maximum(a: torch.Tensor, b) -> torch.Tensor:
    return torch.maximum(a, b if torch.is_tensor(b) else _const(a, b))


def _minimum(a: torch.Tensor, b) -> torch.Tensor:
    return torch.minimum(a, b if torch.is_tensor(b) else _const(a, b))


def _eigh3_trig(c: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Closed-form (trigonometric) eigenvalues of symmetric 3x3 matrices given
    by their six entries, descending (S, 3); [q, q, q] where the shifted
    matrix vanishes.  Accurate to ~sqrt(eps)·|C| for near-degenerate
    spectra."""
    a00, a11, a22 = c["00"], c["11"], c["22"]
    a01, a02, a12 = c["01"], c["02"], c["12"]
    q = (a00 + a11 + a22) / _const(a00, 3.0)
    p1 = (a01 * a01 + a02 * a02) + a12 * a12
    d0, d1, d2 = a00 - q, a11 - q, a22 - q
    p2 = ((d0 * d0 + d1 * d1) + d2 * d2) + 2.0 * p1
    p = torch.sqrt(_maximum(p2 / _const(p2, 6.0), 0.0))
    safe_p = torch.where(p > 0, p, _const(p, 1.0))
    b00, b11, b22 = d0 / safe_p, d1 / safe_p, d2 / safe_p
    b01, b02, b12 = a01 / safe_p, a02 / safe_p, a12 / safe_p
    det = ((b00 * (b11 * b22 - b12 * b12) - b01 * (b01 * b22 - b12 * b02))
           + b02 * (b01 * b12 - b11 * b02))
    r = torch.clamp(det / _const(det, 2.0), -1.0, 1.0)
    phi = torch.acos(r) / _const(r, 3.0)
    e1 = q + (2.0 * p) * torch.cos(phi)
    e3 = q + (2.0 * p) * torch.cos(phi + 2.0 * math.pi / 3.0)
    e2 = (3.0 * q - e1) - e3
    eigs = torch.stack([e1, e2, e3], dim=-1)
    return torch.where((p2 <= 0)[..., None], q[..., None].expand_as(eigs), eigs)


def _eigh3_deflated(c: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Trig solver + one deflation step: accurate small eigenvalues in
    float32 (the JAX package's ``_eigh3_deflated``, op by op).

    The trig estimates pick the better-separated end of the spectrum; that
    end's eigenvector is the largest cross product of rows of (C - shift·I);
    its eigenvalue is re-extracted as the Rayleigh quotient and the other
    two solve the projected 2x2 problem on an orthonormal complement {u, w}.
    Every eigenvalue lands within ~1e-6·λ1 of float64."""
    a00, a11, a22 = c["00"], c["11"], c["22"]
    a01, a02, a12 = c["01"], c["02"], c["12"]
    tiny = _const(a00, 1e-30)
    lam_t = _eigh3_trig(c)
    g1 = lam_t[:, 0] - lam_t[:, 1]
    g3 = lam_t[:, 1] - lam_t[:, 2]
    shift = torch.where(g1 >= g3, lam_t[:, 0], lam_t[:, 2])
    on, off = shift * 1.0, shift * 0.0        # shift · I, as C - shift*eye(3)
    r0 = torch.stack([a00 - on, a01 - off, a02 - off], -1)
    r1 = torch.stack([a01 - off, a11 - on, a12 - off], -1)
    r2 = torch.stack([a02 - off, a12 - off, a22 - on], -1)
    c01, c02, c12 = _cross(r0, r1), _cross(r0, r2), _cross(r1, r2)
    n01, n02, n12 = _dot3(c01, c01), _dot3(c02, c02), _dot3(c12, c12)
    v = torch.where(((n01 >= n02) & (n01 >= n12))[:, None], c01,
                    torch.where((n02 >= n12)[:, None], c02, c12))
    nv = _norm3(v)
    e_x = torch.zeros_like(v)
    e_x[:, 0] = 1.0
    v1 = torch.where((nv > tiny)[:, None], v / _maximum(nv, tiny)[:, None], e_x)
    # the axis least aligned with v1 (argmin, first minimum), orthonormalized
    m = v1.abs()
    k = torch.where((m[:, 0] <= m[:, 1]) & (m[:, 0] <= m[:, 2]), 0,
                    torch.where(m[:, 1] <= m[:, 2], 1, 2))
    e = torch.nn.functional.one_hot(k, 3).to(v1.dtype)
    a = e - _dot3(e, v1)[:, None] * v1
    u = a / _maximum(_norm3(a), tiny)[:, None]
    w = _cross(v1, u)

    def mat(x):   # C @ x
        return torch.stack([(a00 * x[:, 0] + a01 * x[:, 1]) + a02 * x[:, 2],
                            (a01 * x[:, 0] + a11 * x[:, 1]) + a12 * x[:, 2],
                            (a02 * x[:, 0] + a12 * x[:, 1]) + a22 * x[:, 2]], -1)

    cw = mat(w)
    l_v = _dot3(v1, mat(v1))
    m00 = _dot3(u, mat(u))
    m01 = _dot3(u, cw)
    m11 = _dot3(w, cw)
    t = 0.5 * (m00 + m11)
    dm = m00 - m11
    d = torch.sqrt(_maximum(0.25 * (dm * dm) + m01 * m01, 0.0))
    l_a, l_b = t + d, t - d
    hi = _maximum(_maximum(l_v, l_a), l_b)
    lo = _minimum(_minimum(l_v, l_a), l_b)
    mid = _maximum(_minimum(l_v, l_a), _minimum(_maximum(l_v, l_a), l_b))
    return torch.stack([hi, mid, lo], dim=-1)


def _eigh3_descending(c: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eigenvalues λ1 ≥ λ2 ≥ λ3 of the covariances (S, 3).  float64 (the CPU
    parity route): LAPACK's ``eigvalsh``, so the reference's 1e-12 gate
    resolves as numpy's does.  float32: the deflated closed form."""
    if c["00"].dtype == torch.float64:
        C = torch.stack([torch.stack([c["00"], c["01"], c["02"]], -1),
                         torch.stack([c["01"], c["11"], c["12"]], -1),
                         torch.stack([c["02"], c["12"], c["22"]], -1)], -2)
        return torch.linalg.eigvalsh(C).flip(-1)
    return _eigh3_deflated(c)


def streamline_metrics(points: torch.Tensor, lengths: torch.Tensor,
                       dtype: torch.dtype = torch.float32
                       ) -> Dict[str, torch.Tensor]:
    """All 17 per-streamline metrics of a padded bundle, plain PyTorch on
    the inputs' device.

    points: (S, P, 3) padded coordinates; lengths: (S,) point counts, each
    in [1, P] (the reader keeps curves of 3 or more points).  Returns a dict
    of (S,) tensors for every ``METRIC_NAMES`` entry, plus ``valid`` (arc
    length > 1e-8) and ``eigen_ok`` (the float32 certificate; all true in
    float64)."""
    x = points.to(dtype)
    S, P, _ = x.shape
    n = lengths.to(torch.int64).clamp(1, P)
    i = torch.arange(P, device=x.device)
    pt_mask = i[None, :] < n[:, None]                      # (S, P)
    seg_mask = (i[None, :] < (n - 1)[:, None])[:, :P - 1]  # (S, P-1)
    pair_mask = (i[None, :P - 2] < (n - 2)[:, None])       # (S, P-2)
    nf = n.to(dtype)
    zero = _const(x, 0.0)
    eps = _const(x, 1e-8)
    tiny = _const(x, 1e-12)

    def count(mask):
        return mask.sum(dim=1).clamp(min=1).to(dtype)

    # length, end_to_end, tortuosity, straightness (tract_geom_proc.py:31-46)
    d = x[:, 1:] - x[:, :-1]                                # (S, P-1, 3)
    seg_len = _norm3(d)
    L = _seqsum(seg_len, seg_mask)
    last = x[torch.arange(S, device=x.device), n - 1]
    e2e = _norm3(last - x[:, 0])
    tortuosity = L / _maximum(e2e, eps)
    straightness = e2e / _maximum(L, eps)

    # derivatives with np.gradient semantics
    v = _masked_gradient(x, n)
    a = _masked_gradient(v, n)
    b = _cross(v, a)
    bb = _dot3(b, b)
    v_mag = _norm3(v) + tiny

    # curvature mean/std over finite kappa, ddof=0 (tract_geom_proc.py:53-71)
    kappa = torch.sqrt(bb) / ((v_mag * v_mag) * v_mag)
    finite_k = torch.isfinite(kappa)
    kappa_ok = finite_k & pt_mask
    k_cnt = count(kappa_ok)
    k_mean = _seqsum(kappa, kappa_ok) / k_cnt
    dk = kappa - k_mean[:, None]
    k_var = _seqsum(dk * dk, kappa_ok) / k_cnt
    long3 = n >= 3
    curv_mean = torch.where(long3, k_mean, zero)
    curv_std = torch.where(long3, torch.sqrt(_maximum(k_var, 0.0)), zero)

    # curvature energy: sum kappa[:m]^2 * ds[:m], m = n-1, non-finite kappa
    # -> 0 (tract_geom_proc.py:73-83)
    ds = seg_len + tiny
    k0 = torch.where(finite_k, kappa, zero)[:, :P - 1]
    curv_energy = torch.where(long3, _seqsum((k0 * k0) * ds, seg_mask), zero)

    # torsion tau = (b . db)/(|b|^2 + 1e-12), finite-filtered mean, 0 if n < 4
    # (tract_geom_proc.py:85-96)
    db = _masked_gradient(b, n)
    tau = _dot3(b, db) / (bb + tiny)
    tau_ok = torch.isfinite(tau) & pt_mask
    torsion = torch.where(n >= 4, _seqsum(tau, tau_ok) / count(tau_ok), zero)

    # bend angle: mean |arccos(clip(t_i . t_{i+1}))| over n-2 pairs
    # (tract_geom_proc.py:98-106)
    t_hat = d / ds[..., None]
    cosines = _dot3(t_hat[:, :-1], t_hat[:, 1:])
    angles = torch.acos(torch.clamp(cosines, -1.0, 1.0)).abs()
    bend = torch.where(long3, _seqsum(angles, pair_mask) / count(pair_mask), zero)

    # bbox volume (tract_geom_proc.py:114-117)
    big = torch.finfo(dtype).max
    xmax = torch.where(pt_mask[..., None], x, _const(x, -big)).amax(dim=1)
    xmin = torch.where(pt_mask[..., None], x, _const(x, big)).amin(dim=1)
    ext = xmax - xmin
    bbox_vol = (ext[:, 0] * ext[:, 1]) * ext[:, 2]

    # centroid (tract_geom_proc.py:111-112)
    centroid = _seqsum(x, pt_mask) / nf[:, None]

    # PCA eigenvalues of the ddof-1 covariance (tract_geom_proc.py:119-141)
    xc = torch.where(pt_mask[..., None], x - centroid[:, None, :], zero)
    denom = _maximum(nf - 1.0, 1.0)
    cov = {f"{j}{k}": _seqsum(xc[..., j] * xc[..., k], pt_mask) / denom
           for j, k in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}
    lam = _eigh3_descending(cov)
    lam1, lam2, lam3 = lam[:, 0], lam[:, 1], lam[:, 2]
    inf = _const(x, math.inf)
    elongation = torch.where(lam2 <= tiny, inf, lam1 / lam2)
    planarity = torch.where(lam3 <= tiny, inf, lam2 / lam3)
    anisotropy = lam1 / (((lam1 + lam2) + lam3) + tiny)

    # float32 inf-gate certificate: the reference's 1e-12 gate sits far below
    # float32 eigen-noise, so a near-degenerate curve could flip inf <->
    # finite against the float64 reference.  A row whose λ2, λ3 both clear
    # EIGEN_SAFE_REL·λ1 provably keeps the reference's verdict; the pipeline
    # recomputes the others on the host in float64 (eigen_metrics_f64)
    if dtype == torch.float64:
        eigen_ok = torch.ones(S, dtype=torch.bool, device=x.device)
    else:
        eigen_ok = ((lam1 > _const(lam1, EIGEN_SAFE_ABS))
                    & (lam2 > EIGEN_SAFE_REL * lam1)
                    & (lam3 > EIGEN_SAFE_REL * lam1))

    # angular dispersion: variance of unit tangents (tract_geom_proc.py:143-148)
    seg_cnt = count(seg_mask)
    mean_t = _seqsum(t_hat, seg_mask) / seg_cnt[:, None]
    dev = t_hat - mean_t[:, None, :]
    ang_disp = _seqsum(_dot3(dev, dev), seg_mask) / seg_cnt

    return {
        "length": L, "end_to_end": e2e, "tortuosity": tortuosity,
        "straightness": straightness, "curv_mean": curv_mean,
        "curv_std": curv_std, "curv_energy": curv_energy,
        "torsion_mean": torsion, "bend_angle_mean": bend, "bbox_vol": bbox_vol,
        "elongation_ratio": elongation, "planarity_ratio": planarity,
        "anisotropy_ratio": anisotropy, "centroid_x": centroid[:, 0],
        "centroid_y": centroid[:, 1], "centroid_z": centroid[:, 2],
        "ang_dispersion": ang_disp, "valid": L > eps, "eigen_ok": eigen_ok,
    }


def stack_metrics(m: Dict[str, torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The metrics as one (19, S) tensor, rows in ``STACKED_NAMES`` order,
    ``valid`` and ``eigen_ok`` as 0/1."""
    return torch.stack([m[k].to(dtype) for k in STACKED_NAMES])


def streamline_metrics_stacked_plain(points, lengths, dtype=torch.float32):
    """Plain version of the kernel's point mode: (19, S)."""
    return stack_metrics(streamline_metrics(points, lengths, dtype), dtype)


def streamline_metrics_stacked_u16_plain(codes, p0, lo, sc, lengths,
                                         dtype=torch.float32):
    """Plain version of the kernel's u16 mode: decode (ops.geo_codec), then
    the metrics, (19, S)."""
    from .geo_codec import decode_points

    x = decode_points(codes, p0, lo, sc, lengths)
    return stack_metrics(streamline_metrics(x, lengths, dtype), dtype)


# ------------------------------------------------------------ the kernel
# CUDA's opt-in limit of dynamic shared memory a block on an H100
_MAX_SHARED = 232448
# FP32 operations of the formula, counted in csrc/geometry.cu with a
# quotient, a root or an arc cosine as one: a real point takes 96 in pass 1
# (segment 30, derivatives and curvature 42, torsion 19, sums and bbox 5...)
# and 40 in pass 2 (covariance 15, curvature variance 3, dispersion 22);
# the u16 decode adds 12; a streamline's eigenvalues, ratios and means ~200
OPS_PER_POINT, OPS_PER_POINT_U16, OPS_PER_STREAMLINE = 136, 148, 200
# The least instructions (one lane's) the rounding contract needs, with no
# FMA contraction, IEEE quotients and roots at their fast-path lengths (a
# root: seed + 2 FMUL + 2 FFMA = 5; a quotient: seed + 2 FFMA of Newton + FMUL
# + 2 FFMA = 6, or 3 more for another numerator over the same divisor; each
# with 1 range test) and acosf at the CUDA math library's ~20.  A real point:
#   segment: difference 3, squared length 5, root 5+1, + 1e-12 1, tangent
#     (3 quotients over one divisor) 12+3, length and tangent sums 4       = 34
#   derivatives: v 6, a 6, b = v x a 9, |b|^2 5, |v|^2 5, root 5+1,
#     + 1e-12 1, |v|^3 2, root 5+1, curvature quotient 6+1, finite test,
#     select and sum 3, energy (select, 2 products, sum) 4                 = 60
#   torsion: db 6, b . db 5, + 1e-12 1, quotient 6+1, finite and sum 3     = 22
#   bend: t . t' 5, clip 2, acosf 20, sum 1                                = 28
#   bounding box 6, centroid sums 3                                        =  9
#   pass 2: centred point 3, 6 products and 6 sums, curvature deviation 4,
#     dispersion (tangent kept from pass 1) 3 + 5 + 1                      = 28
# 181 a point; the u16 decode adds 3 conversions, 3 products and 9 sums
# (lo +, the running sum, p0 +): 196.  A streamline: the trigonometric
# eigenvalues ~150 (an acosf and two cosf among them), the deflation step
# ~230, the 19 outputs with their 17 quotients and 3 roots ~150, its
# length, 19 stores and the counts ~20: 550.
ISSUE_PER_POINT, ISSUE_PER_POINT_U16, ISSUE_PER_STREAMLINE = 181, 196, 550


def bound_ms(lengths, P: int, u16: bool = False) -> dict:
    """Least time for one launch over a chunk with these ``lengths`` (its
    streamlines' real point counts) at ``P`` points, on the card
    (``utils.cost_model.kernel_bound_ms``): the bytes it must move (each
    real point once: 12 bytes, or in u16 mode 6 a delta and 36 a
    streamline; 4 bytes of length and 19 x 4 of output a streamline), its
    FP32 operations (``OPS_PER_POINT``...) and its least instructions
    (``ISSUE_PER_POINT``... a real point, ``ISSUE_PER_STREAMLINE`` a
    streamline).  Pad points count nothing."""
    n = np.clip(np.asarray(lengths, np.int64), 1, P)
    S, points = len(n), int(n.sum())
    if u16:
        nbytes = 6 * int((n - 1).sum()) + 36 * S
    else:
        nbytes = 12 * points
    nbytes += (4 + 4 * len(STACKED_NAMES)) * S
    ops = (OPS_PER_POINT_U16 if u16 else OPS_PER_POINT) * points + OPS_PER_STREAMLINE * S
    issue = (ISSUE_PER_POINT_U16 if u16 else ISSUE_PER_POINT) * points \
        + ISSUE_PER_STREAMLINE * S
    return kernel_bound_ms(nbytes, ops, issue)


def stream_floats(P: int, lanes: int) -> int:
    """Floats of shared memory a streamline takes in the kernel at ``P``
    with ``lanes`` lanes a streamline (csrc/geometry.cu::Lay): its points
    in 16-byte slots and its curvatures (5P), rings of 2 x lanes 16-byte
    slots for v, b and the unit tangent, 5 term columns of 2 x lanes + 1, 32
    results and 3 of padding; the stride is rounded up to ``lanes`` modulo 32
    so that the streamlines of a warp fall on distinct banks."""
    used = 5 * P + 34 * lanes + 40
    return used + (lanes - used) % 32


def block_streamlines(P: int) -> tuple[int, int, int]:
    """(lanes a streamline, streamlines a block, shared bytes a block) of the
    kernel at ``P``.  16 lanes a streamline up to P = 128 (the path's
    buckets: the sums and the eigen tail keep more lanes busy, measured
    faster on the card, PERF.md), 4 warps a block; 32 lanes and 8 warps
    beyond.  Warps are halved while the block needs more than 48 KB (one
    streamline may use up to the card's 227 KB).  Both modes take the same
    shared memory: the u16 codes are decoded straight into the points."""
    lanes, warps = (16, 4) if P <= 128 else (32, 8)
    per = 4 * stream_floats(P, lanes)
    while warps > 1 and warps * (32 // lanes) * per > 48 * 1024:
        warps //= 2
    spb = warps * (32 // lanes)
    return lanes, spb, spb * per


def max_points() -> int:
    """The largest P whose streamline (32 lanes, one a block) fits in a
    block's shared memory."""
    P = (_MAX_SHARED // 4 - 34 * 32 - 40) // 5
    while 4 * stream_floats(P, 32) > _MAX_SHARED:
        P -= 1
    return P


def _check(points, codes, p0, lo, sc, lengths, dtype) -> tuple[int, int]:
    if dtype != torch.float32:
        raise ValueError(f"the geometry kernel computes float32 on cuda, got {dtype}; "
                         "float64 is the CPU parity route")
    main = points if points is not None else codes
    S = main.shape[0]
    want = [("lengths", lengths, torch.int32, (S,))]
    if points is not None:
        if points.dim() != 3 or points.shape[2] != 3:
            raise ValueError(f"points (S, P, 3), got {tuple(points.shape)}")
        P = points.shape[1]
        want.append(("points", points, torch.float32, (S, P, 3)))
    else:
        if codes.dim() != 3 or codes.shape[2] != 3:
            raise ValueError(f"codes (S, P-1, 3), got {tuple(codes.shape)}")
        P = codes.shape[1] + 1
        want += [("codes", codes, torch.int16, (S, P - 1, 3))]
        want += [(k, t, torch.float32, (S, 3)) for k, t in (("p0", p0), ("lo", lo),
                                                            ("sc", sc))]
    for name, t, dt, shape in want:
        if t.device != main.device:
            raise ValueError(f"{name} is on {t.device}, the bundle on {main.device}")
        if t.dtype != dt or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"the geometry kernel takes {name} as a contiguous "
                             f"{dt} {shape}, got {t.dtype} {tuple(t.shape)}")
    if P < 2:
        raise ValueError(f"the geometry kernel takes P >= 2 points, got {P}")
    if block_streamlines(P)[2] > _MAX_SHARED:
        raise ValueError(f"the geometry kernel takes at most {max_points()} "
                         f"points a streamline in shared memory, got P={P}")
    return S, P


@functools.lru_cache(maxsize=None)
def _kernel():
    """The C entry point of csrc/geometry.cu, built on first use."""
    fn = load("geometry").lesionvae_geometry
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(points, codes, p0, lo, sc, lengths, dtype) -> torch.Tensor:
    S, P = _check(points, codes, p0, lo, sc, lengths, dtype)
    main = points if points is not None else codes
    out = torch.empty((len(STACKED_NAMES), S), dtype=torch.float32,
                      device=main.device)
    if S == 0:
        return out
    lanes, spb, shared = block_streamlines(P)
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(main.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(ptr(points), ptr(codes), ptr(p0), ptr(lo), ptr(sc),
                        lengths.data_ptr(), out.data_ptr(), S, P, lanes, spb,
                        shared, stream)
    if err != 0:
        raise RuntimeError(f"geometry kernel launch failed: cudaError {err}")
    streamline_metrics_stacked.launches += 1
    return out


def streamline_metrics_stacked(points: torch.Tensor, lengths: torch.Tensor,
                               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """All metrics of a padded bundle as one (19, S) tensor (rows in
    ``STACKED_NAMES`` order), for one device-to-host copy.  CUDA tensors:
    the kernel (float32 points, int32 lengths, contiguous), counted in
    ``streamline_metrics_stacked.launches``.  CPU tensors: the plain
    version in ``dtype``."""
    if points.device.type == "cpu":
        return streamline_metrics_stacked_plain(points, lengths, dtype)
    if points.device.type != "cuda":
        raise ValueError(f"geometry runs on cuda or cpu, not {points.device}")
    return _launch(points, None, None, None, None, lengths, dtype)


def streamline_metrics_stacked_u16(codes: torch.Tensor, p0: torch.Tensor,
                                   lo: torch.Tensor, sc: torch.Tensor,
                                   lengths: torch.Tensor,
                                   dtype: torch.dtype = torch.float32
                                   ) -> torch.Tensor:
    """``streamline_metrics_stacked`` over u16 delta codes (ops.geo_codec:
    codes as int16 bit patterns (S, P-1, 3), p0, lo, sc float32 (S, 3)),
    decoded in the same pass.  The pipeline replaces the torsion row with
    the host's float64 value (``geo_codec.torsion_f64``): tau cannot absorb
    the decode noise.  CUDA tensors: the kernel's u16 mode, counted in
    ``streamline_metrics_stacked.launches``; CPU tensors: the plain
    version."""
    if codes.device.type == "cpu":
        return streamline_metrics_stacked_u16_plain(codes, p0, lo, sc, lengths, dtype)
    if codes.device.type != "cuda":
        raise ValueError(f"geometry runs on cuda or cpu, not {codes.device}")
    return _launch(None, codes, p0, lo, sc, lengths, dtype)


# launches of the kernel (either mode) in this process; a run sets it to 0
# and reads it back to show its path went through the kernel
streamline_metrics_stacked.launches = 0


# ------------------------------------------------------------ host side
def unstack_metrics(stacked: np.ndarray) -> Dict[str, np.ndarray]:
    out = {k: np.asarray(stacked[i]) for i, k in enumerate(STACKED_NAMES)}
    out["valid"] = out["valid"] > 0.5
    out["eigen_ok"] = out["eigen_ok"] > 0.5
    return out


def eigen_metrics_f64(streamlines, out_elong: np.ndarray, out_plan: np.ndarray,
                      out_aniso: np.ndarray, idx: np.ndarray) -> None:
    """Exact host float64 eigen-ratio metrics for the rows ``idx``, in place:
    the reference verbatim (tract_geom_proc.py:119-141): ddof-1 covariance
    of the raw points, LAPACK eigvalsh, inf where the ratio's denominator is
    <= 1e-12, anisotropy λ1/(Σλ + 1e-12).  Called for the rows whose
    float32 certificate failed, a small subset of real cohorts."""
    for i in idx:
        sl = np.asarray(streamlines[i], np.float64)
        c = sl - sl.mean(axis=0)
        C = c.T @ c / max(len(sl) - 1, 1)
        l1, l2, l3 = np.linalg.eigvalsh(C)[::-1]
        out_elong[i] = np.inf if l2 <= 1e-12 else l1 / l2
        out_plan[i] = np.inf if l3 <= 1e-12 else l2 / l3
        out_aniso[i] = l1 / (l1 + l2 + l3 + 1e-12)


# bundle-summary quantities and their source metric (tract_geom_proc.py:195-210)
BUNDLE_SUMMARY = (
    ("length_mean", "length"),
    ("tortuosity_mean", "tortuosity"),
    ("curv_mean_avg", "curv_mean"),
    ("curv_energy_mean", "curv_energy"),
    ("torsion_mean_avg", "torsion_mean"),
    ("bend_angle_mean_avg", "bend_angle_mean"),
    ("elongation_ratio_mean", "elongation_ratio"),
    ("planarity_ratio_mean", "planarity_ratio"),
    ("anisotropy_ratio_mean", "anisotropy_ratio"),
    ("ang_dispersion_mean", "ang_dispersion"),
    ("centroid_x_mean", "centroid_x"),
    ("centroid_y_mean", "centroid_y"),
    ("centroid_z_mean", "centroid_z"),
)


def bundle_summary(metrics: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Bundle nanmean over valid streamlines, as _safe_mean
    (tract_geom_proc.py:192-210): NaN is skipped, inf propagates."""
    valid = np.asarray(metrics["valid"])
    out: Dict[str, float] = {"n_streamlines": int(valid.sum())}
    for col, src in BUNDLE_SUMMARY:
        vals = np.asarray(metrics[src])[valid]
        out[col] = float(np.nanmean(vals)) if len(vals) else float("nan")
    return out
