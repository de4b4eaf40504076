"""A cohort's VAE inputs made from a seed, straight into arrays.

The distribution is a frozen copy of the port's synthetic profile writer
(``lesionvae_tpu_torch/io/synth.py::write_profile_csv``) as the tensor
builder reads it back (``train/data.py::build_tensor_with_lesion_context``):
feature j of the microstructure channels along the tract position s is
``0.5 sin(2 pi (s + 0.1 j)) + N(0, 0.1^2) + shift exp(-(s - 0.5)^2 / 0.02)``,
with ``shift`` 0.8 for a TBI or PTE subject after the acute timepoint
("2d") and 0 else; the lesion channels are in_lesion (0.4 < s < 0.6 where
shifted), in_cavity (0) and the lesion distance clipped to [0, 15] / 15 (a
Sham subject's imputed 15 reads 1).  A member (tract, timepoint) holds the
subjects' streamlines in cohort order.  The noise is drawn in one call
with a ``torch.Generator`` on ``device`` and copied to the host once.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np
import torch

LESION_SHIFT = 0.8


@dataclasses.dataclass
class Cohort:
    """Raw (unnormalized) blocks of every member, padded to ``n_pad`` rows
    (pad rows zero), with each row's subject and whether it is Sham."""

    Xm: np.ndarray           # (T, n_pad, L, micro_ch) float32
    Xl: np.ndarray           # (T, n_pad, L, lesion_ch) float32
    n_real: np.ndarray       # (T,) int32
    subject: np.ndarray      # (T, n_pad) int32: the row's subject, n_subjects for a pad row
    sham: np.ndarray         # (T, n_pad) float32: 1 on a Sham subject's row
    n_subjects: int


def groups_of(traffic: dict) -> List[str]:
    """Each subject's group, in cohort order."""
    return [g for g, n in traffic["groups"].items() for _ in range(n)]


def make_cohort(traffic: dict, seq_len: int, micro_ch: int, lesion_ch: int,
                batch_size: int, seed: int, device="cuda") -> Cohort:
    """The members of ``traffic`` (its ``tracts`` x ``timepoints``), each with
    every subject's ``streamlines`` rows, padded to a multiple of
    ``batch_size``."""
    groups = groups_of(traffic)
    per = int(traffic["streamlines"])
    tps = [tp for _tract in range(int(traffic["tracts"])) for tp in traffic["timepoints"]]
    T, S, L = len(tps), len(groups), seq_len
    n = S * per
    n_pad = -(-n // batch_size) * batch_size

    gen = torch.Generator(device=device).manual_seed(seed % 2 ** 63)
    noise = torch.randn((T, n, L, micro_ch), generator=gen, device=device)
    pos = np.linspace(0, 1, L)
    base = np.stack([np.sin(2 * np.pi * (pos + 0.1 * j)) * 0.5 for j in range(micro_ch)],
                    axis=1)                                          # (L, C)
    bump = np.exp(-((pos - 0.5) ** 2) / 0.02)                        # (L,)
    lesioned = np.array([[g in ("TBI", "PTE") and tp != "2d" for g in groups]
                         for tp in tps])                             # (T, S)
    shift = np.repeat(np.where(lesioned, LESION_SHIFT, 0.0), per, axis=1)  # (T, n)
    mean = (torch.from_numpy(base).to(device)[None, None]
            + torch.from_numpy(shift).to(device)[:, :, None, None]
            * torch.from_numpy(bump).to(device)[None, None, :, None])
    Xm = np.zeros((T, n_pad, L, micro_ch), np.float32)
    Xm[:, :n] = (mean + 0.1 * noise.double()).float().cpu().numpy()

    les = np.zeros((2, L, lesion_ch), np.float32)                   # [unshifted, shifted]
    les[0, :, 2] = 1.0                                               # distance 15 / 15
    inside = (pos > 0.4) & (pos < 0.6)
    les[1, :, 0] = inside
    les[1, :, 2] = np.clip(np.abs(pos - 0.5) * 30.0, 0, 15) / 15.0
    Xl = np.zeros((T, n_pad, L, lesion_ch), np.float32)
    Xl[:, :n] = les[np.repeat(lesioned, per, axis=1).astype(int)]

    subject = np.full((T, n_pad), S, np.int32)
    subject[:, :n] = np.repeat(np.arange(S), per)[None]
    sham = np.zeros((T, n_pad), np.float32)
    sham[:, :n] = np.repeat(np.array([g == "Sham" for g in groups], np.float32), per)[None]
    return Cohort(Xm, Xl, np.full(T, n, np.int32), subject, sham, S)


def job_seed(seed: int, job: int) -> int:
    """The seed a job of the window passes to the program (``job`` -1: the
    set-up's cold job)."""
    return (seed * 4099 + job + 1) % 2 ** 62


def sample(seed: int, population: int, k: int, salt: int) -> Sequence[int]:
    """``k`` of ``range(population)`` drawn from ``seed``, sorted."""
    rng = np.random.default_rng([seed % 2 ** 63, salt])
    return sorted(rng.choice(population, size=min(k, population), replace=False).tolist())
