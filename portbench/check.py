"""The numbers that decide ``correct``: how far a job's outputs lie from the
plain reference's (``portbench.reference``), each a scale-free gap.  A
cell's ``limits/<cell>.json`` names those it compares; the others are read
and printed only (``PERF.md`` gives why).

- ``norm``: the normalization statistics (median, mean, std), worst member
  and feature, over the largest reference value of that statistic.
- ``hist1``: the history's loss, recon and kld of the first epoch, worst
  member, each over max(|reference|, 1e-3 x the largest reference value of
  its column).
- ``hist1_loss_recon``: the same of the first epoch's loss and recon alone.
- ``hist1_median``: the median checked member's ``hist1_loss_recon``: the
  worst member's swings from seed to seed (a step on either side of the
  gradient clip parts two roundings), TF32 moves every member.
- ``hist``: the same of the loss and recon of every epoch (the KL term
  falls to nought to rounding as the posterior collapses, so its later
  epochs are left out).
- ``stats``: the trained BatchNorm running variances, worst layer, over the
  layer's largest reference value (a running mean carries the bias of the
  convolution ahead of it, which moves by round-off alone; see ``change``).
- ``stats_change``: how far the running variances moved over the job, by
  the worst layer, as ``change`` reads the parameters: a state left
  unchanged reads 1.
- ``change``: how far the parameters moved over the job, by the worst leaf:
  the gap between the program's norm of the change and the reference's,
  over the larger of the reference's norm of that leaf and of the median
  leaf.  Leaves whose reference gradient at the first step is under a
  thousandth of the median leaf's (a convolution's bias ahead of a
  BatchNorm, whose gradient is nought to rounding) are left out.
- ``summary``: the normative pass worked out again by the reference from
  the program's trained weights, worst output, over its largest reference
  value.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

LEAF_GRAD_FLOOR = 1e-3      # of the median leaf's first gradient: a leaf left out of change


def _np(x) -> np.ndarray:
    return x.detach().cpu().double().numpy() if isinstance(x, torch.Tensor) else \
        np.asarray(x, np.float64)


def rel_gap(got, ref) -> float:
    """max |got - ref| over max |ref|."""
    got, ref = _np(got), _np(ref)
    if got.shape != ref.shape:
        raise ValueError(f"shapes {got.shape} and {ref.shape} differ")
    if not np.isfinite(got).all():
        return float("inf")
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def member_hist_gaps(got, ref, columns: int = 3) -> np.ndarray:
    """History (S, epochs, >= 3): each member's worst of its first
    ``columns`` columns (loss, recon, kld), each element over max(|ref|,
    1e-3 max |ref| of its column)."""
    got, ref = _np(got)[..., :columns], _np(ref)[..., :columns]
    if not np.isfinite(got).all():
        return np.full(got.shape[0], np.inf)
    scale = np.maximum(np.abs(ref), 1e-3 * np.abs(ref).max(axis=(0, 1), keepdims=True))
    return (np.abs(got - ref) / scale).reshape(got.shape[0], -1).max(axis=1)


def hist_gap(got, ref, columns: int = 3) -> float:
    """The worst member's ``member_hist_gaps``."""
    return float(member_hist_gaps(got, ref, columns).max())


def _norms_of_change(w: Mapping[str, torch.Tensor], init: Mapping[str, torch.Tensor],
                     names) -> np.ndarray:
    """(leaves, S): each member's norm of w - init, leaf by leaf."""
    return np.stack([
        _np((w[k].to(init[k].device) - init[k]).reshape(init[k].shape[0], -1).norm(dim=1))
        for k in names])


def _gap_of_norms(dp: np.ndarray, dr: np.ndarray, keep: np.ndarray) -> float:
    """Worst kept leaf's |dp - dr| over max(dr, the member's median kept dr)."""
    if not np.isfinite(dp).all():
        return float("inf")
    med = np.array([np.median(dr[keep[:, s], s]) for s in range(dr.shape[1])])
    scale = np.maximum(dr, med[None])
    return float((np.abs(dp - dr) / scale)[keep].max())


def change_gap(got: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
               init: Mapping[str, torch.Tensor], first_grad: Mapping[str, torch.Tensor]
               ) -> float:
    """Worst leaf's gap of the norms of the change, per member (see above)."""
    names = list(first_grad)
    g0 = np.stack([_np(first_grad[k]) for k in names])               # (leaves, S)
    keep = g0 >= LEAF_GRAD_FLOOR * np.median(g0, axis=0, keepdims=True)
    return _gap_of_norms(_norms_of_change(got, init, names),
                         _norms_of_change(ref, init, names), keep)


def stats_change_gap(got: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor],
                     init: Mapping[str, torch.Tensor]) -> float:
    """Worst layer's gap of the norms of the running variances' change."""
    names = [k for k in ref if k.endswith("running_var")]
    dr = _norms_of_change(ref, init, names)
    return _gap_of_norms(_norms_of_change(got, init, names), dr, np.ones(dr.shape, bool))


def stats_gap(got: Mapping[str, torch.Tensor], ref: Mapping[str, torch.Tensor]) -> float:
    return max(rel_gap(got[k], ref[k]) for k in ref if k.endswith("running_var"))
