"""Ragged → padded conversion for lesion surface point clouds.

Surfaces have variable point counts; the device batch is a dense
``(B, N, 3)`` array plus a count vector, and every consumer masks (or, in the
radius kernel, stops) by count.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_batch(arrays: Sequence[np.ndarray], max_rows: int | None = None,
              pad_multiple: int = 8, dtype=np.float32
              ) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a ragged list of (n_i, D) arrays into ``(B, N, D)`` + counts.

    Pad rows are zero; consumers mask by count.
    """
    B = len(arrays)
    D = arrays[0].shape[1] if B else 3
    counts = np.array([len(a) for a in arrays], dtype=np.int32)
    N = int(max_rows) if max_rows is not None else int(counts.max() if B else 1)
    N = round_up(max(N, 1), pad_multiple)
    out = np.zeros((B, N, D), dtype=dtype)
    for i, a in enumerate(arrays):
        n = min(len(a), N)
        out[i, :n] = a[:n]
        counts[i] = n
    return out, counts
