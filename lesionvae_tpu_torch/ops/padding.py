"""Ragged → padded conversions for streamlines and lesion surface points.

Streamlines and surfaces have variable point counts; the device batch is a
dense ``(S, P, 3)`` / ``(B, N, 3)`` array plus a length vector, and every
consumer masks (or, in the kernels, stops) by length.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch


def round_up(x: int, multiple: int) -> int:
    return ((x + multiple - 1) // multiple) * multiple


def pad_streamlines(streamlines: Sequence[np.ndarray],
                    pad_multiple: int = 8,
                    max_points: int | None = None,
                    dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Pack a ragged list of (n_i, 3) arrays into ``(S, P, 3)`` + lengths.

    Pad rows repeat the last real point (every consumer masks by length, and
    repeated points keep pad values in range).  ``P`` is ``max_points`` (or
    the longest streamline) rounded up to ``pad_multiple``; a longer
    streamline is cut to ``P`` points.
    """
    S = len(streamlines)
    if S == 0:
        return (np.zeros((0, pad_multiple, 3), dtype=dtype),
                np.zeros((0,), dtype=np.int32))
    lengths = np.array([len(s) for s in streamlines], dtype=np.int32)
    P = int(max_points) if max_points is not None else int(lengths.max())
    P = round_up(max(P, 2), pad_multiple)
    out = np.empty((S, P, 3), dtype=dtype)
    for i, sl in enumerate(streamlines):
        n = min(len(sl), P)
        out[i, :n] = sl[:n]
        out[i, n:] = sl[n - 1]
        lengths[i] = n
    return out, lengths


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


def unpad(values, lengths) -> List[np.ndarray]:
    """The inverse of both packers: row i of ``values`` cut to its first
    ``lengths[i]`` entries, as host arrays.  ``values`` and ``lengths`` may
    be numpy arrays or tensors on any device."""
    if isinstance(values, torch.Tensor):
        values = values.detach().cpu().numpy()
    if isinstance(lengths, torch.Tensor):
        lengths = lengths.cpu().numpy()
    return [np.asarray(values[i, :n]) for i, n in enumerate(lengths)]
