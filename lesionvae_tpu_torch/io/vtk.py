"""Legacy VTK polydata reader and writer for tractography streamlines (numpy).

The reference reads ``mesh.points`` / ``mesh.lines`` through pyvista
(src/geometry/tract_geom_proc.py:9-26).  Tractography bundles are legacy
``.vtk`` POLYDATA files holding POINTS and LINES; this module parses both
ASCII and BINARY encodings, both the classic v4 cell-array layout
(``npts id0 id1 ...`` per cell) and the v5.1 OFFSETS/CONNECTIVITY layout, and
inflates ``.vtk.gz`` in memory.  It is the port's own copy of the JAX
package's reader: the same parse, the same filter, byte-identical output from
the writer.  The native C++ parser (``io.vtk_native``) is tried first.
"""

from __future__ import annotations

import gzip
import io as _io
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

_DTYPES = {
    "float": ">f4", "double": ">f8",
    "int": ">i4", "long": ">i8",
    "unsigned_int": ">u4", "unsigned_long": ">u8",
    "vtktypeint32": ">i4", "vtktypeint64": ">i8",
    "vtktypeuint32": ">u4", "vtktypeuint64": ">u8",
    "short": ">i2", "unsigned_short": ">u2",
    "char": ">i1", "unsigned_char": ">u1",
}


def _read_bytes(path: str | Path) -> bytes:
    path = Path(path)
    data = path.read_bytes()
    if path.suffix == ".gz" or data[:2] == b"\x1f\x8b":
        data = gzip.decompress(data)
    return data


class _Cursor:
    """Byte cursor that supports line-wise ASCII reads and raw binary reads."""

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def readline(self) -> str:
        nl = self.data.find(b"\n", self.pos)
        if nl == -1:
            line, self.pos = self.data[self.pos:], len(self.data)
        else:
            line, self.pos = self.data[self.pos:nl], nl + 1
        return line.decode("ascii", errors="replace").strip()

    def read_binary(self, dtype: str, count: int) -> np.ndarray:
        dt = np.dtype(dtype)
        nbytes = dt.itemsize * count
        arr = np.frombuffer(self.data, dtype=dt, count=count, offset=self.pos)
        self.pos += nbytes
        # Binary sections are followed by a newline.
        if self.pos < len(self.data) and self.data[self.pos:self.pos + 1] == b"\n":
            self.pos += 1
        return arr

    def read_ascii_numbers(self, count: int, dtype) -> np.ndarray:
        """Read ``count`` whitespace-separated numbers spanning multiple lines.

        Raises ValueError on truncated input — at EOF ``readline`` returns ''
        forever, so without the position check this would loop indefinitely."""
        # each ASCII number occupies >= 1 byte: a declared count beyond the
        # remaining buffer is malformed — reject before allocating
        if count > len(self.data) - self.pos:
            raise ValueError(
                f"declared count {count} exceeds remaining input")
        out = np.empty(count, dtype=dtype)
        filled = 0
        while filled < count:
            if self.pos >= len(self.data):
                raise ValueError(
                    f"truncated ASCII section: got {filled}/{count} numbers")
            line = self.readline()
            if not line:
                continue
            vals = np.array(line.split(), dtype=dtype)
            take = min(len(vals), count - filled)
            out[filled:filled + take] = vals[:take]
            filled += take
        return out


def read_vtk_polydata(path: str | Path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse a legacy VTK POLYDATA file.

    Returns ``(points, offsets, connectivity)`` where ``points`` is (N, 3)
    float, and polyline ``i`` uses point indices
    ``connectivity[offsets[i]:offsets[i+1]]`` (CSR layout; the reference's
    flat ``mesh.lines`` walk at tract_geom_proc.py:17-25 is equivalent).
    """
    data = _read_bytes(path)
    # fast path: native C++ parser (falls back to the Python tokenizer)
    from . import vtk_native
    if vtk_native.available():
        parsed = vtk_native.parse_polydata(data)
        if parsed is not None:
            return parsed

    cur = _Cursor(data)
    header = cur.readline()
    if "vtk" not in header.lower():
        raise ValueError(f"{path}: not a legacy VTK file (header {header!r})")
    cur.readline()  # title
    fmt = cur.readline().upper()
    if fmt not in ("ASCII", "BINARY"):
        raise ValueError(f"{path}: unsupported encoding {fmt!r}")
    binary = fmt == "BINARY"
    dataset = cur.readline().upper()
    if "POLYDATA" not in dataset:
        raise ValueError(f"{path}: expected DATASET POLYDATA, got {dataset!r}")

    points: Optional[np.ndarray] = None
    offsets: Optional[np.ndarray] = None
    connectivity: Optional[np.ndarray] = None

    while cur.pos < len(cur.data):
        line = cur.readline()
        if not line:
            continue
        tokens = line.split()
        kw = tokens[0].upper()

        if kw == "POINTS":
            n = int(tokens[1])
            dtype = _DTYPES.get(tokens[2].lower(), ">f4")
            if binary:
                flat = cur.read_binary(dtype, 3 * n).astype(np.float64)
            else:
                flat = cur.read_ascii_numbers(3 * n, np.float64)
            points = flat.reshape(n, 3)

        elif kw == "LINES":
            n_a, n_b = int(tokens[1]), int(tokens[2])
            nxt_pos = cur.pos
            nxt = cur.readline()
            if nxt.split() and nxt.split()[0].upper() == "OFFSETS":
                # v5.1 layout: LINES <n_offsets> <conn_len>, OFFSETS + CONNECTIVITY.
                odt = _DTYPES.get(nxt.split()[1].lower(), ">i8")
                if binary:
                    offsets = cur.read_binary(odt, n_a).astype(np.int64)
                else:
                    offsets = cur.read_ascii_numbers(n_a, np.int64)
                cline = cur.readline()
                while cline == "":
                    cline = cur.readline()
                if cline.split()[0].upper() != "CONNECTIVITY":
                    raise ValueError(f"{path}: expected CONNECTIVITY, got {cline!r}")
                cdt = _DTYPES.get(cline.split()[1].lower(), ">i8")
                if binary:
                    connectivity = cur.read_binary(cdt, n_b).astype(np.int64)
                else:
                    connectivity = cur.read_ascii_numbers(n_b, np.int64)
            else:
                # classic v4 layout: n_a cells, n_b total ints, [npts ids...] packed.
                cur.pos = nxt_pos
                if binary:
                    flat = cur.read_binary(">i4", n_b).astype(np.int64)
                else:
                    flat = cur.read_ascii_numbers(n_b, np.int64)
                offs = [0]
                conn_parts = []
                i = 0
                while i < n_b and len(offs) <= n_a:
                    npts = int(flat[i])
                    if npts < 0:
                        raise ValueError(
                            f"{path}: negative cell size in LINES")
                    conn_parts.append(flat[i + 1:i + 1 + npts])
                    offs.append(offs[-1] + npts)
                    i += 1 + npts
                offsets = np.asarray(offs, dtype=np.int64)
                connectivity = (np.concatenate(conn_parts) if conn_parts
                                else np.empty(0, dtype=np.int64))

        elif kw in ("POINT_DATA", "CELL_DATA", "FIELD"):
            break  # attributes not needed for geometry metrics

    if points is None:
        raise ValueError(f"{path}: no POINTS section found")
    if offsets is None or connectivity is None:
        offsets = np.zeros(1, dtype=np.int64)
        connectivity = np.empty(0, dtype=np.int64)
    return points, offsets, connectivity


def read_streamlines(path: str | Path,
                     max_streamlines: Optional[int] = None) -> List[np.ndarray]:
    """Read a VTK bundle into a ragged list of (P, 3) float arrays.

    Filtering matches the reference exactly (tract_geom_proc.py:17-26): keep a
    polyline iff it has more than 2 points, 3 coordinates, and all values
    finite; stop once ``max_streamlines`` are collected.
    """
    points, offsets, connectivity = read_vtk_polydata(path)
    n = len(offsets) - 1
    if n <= 0:
        return []
    lens = np.diff(offsets)
    # One vectorized validity pass instead of a per-polyline Python loop
    # (the loop cost ~1 ms/bundle — a third of the warm read path).
    # Typical tractography bundles have contiguous connectivity, so the
    # gather is usually a no-op and the returned arrays are views.
    if (connectivity.size == len(points)
            and offsets[0] == 0 and offsets[-1] == connectivity.size
            and np.array_equal(connectivity,
                               np.arange(connectivity.size, dtype=np.int64))):
        P = points
    else:
        P = points[connectivity]
    if offsets.min() < 0 or offsets.max() > len(P):
        raise ValueError(f"{path}: offsets out of range")
    fin = np.isfinite(P).all(axis=1)
    cs = np.zeros(len(P) + 1, np.int64)
    np.cumsum(fin, out=cs[1:])
    valid = (lens > 2) & (cs[offsets[1:]] - cs[offsets[:-1]] == lens)
    idx_valid = np.flatnonzero(valid)
    if max_streamlines is not None:
        idx_valid = idx_valid[:max_streamlines]
    return [P[offsets[i]:offsets[i + 1]] for i in idx_valid]


def write_vtk_polylines(path: str | Path, streamlines: List[np.ndarray],
                        binary: bool = False, compress: Optional[bool] = None) -> None:
    """Write polylines as a legacy VTK POLYDATA file (v4 cell layout).

    Used by the synthetic-data factory and round-trip tests.  ``compress=None``
    gzips iff the path ends in ``.gz``.
    """
    path = Path(path)
    if compress is None:
        compress = path.suffix == ".gz"

    pts = (np.concatenate(streamlines, axis=0) if streamlines
           else np.empty((0, 3)))
    n_pts = len(pts)
    buf = _io.BytesIO()
    enc = "BINARY" if binary else "ASCII"
    buf.write(f"# vtk DataFile Version 4.0\nstreamlines\n{enc}\nDATASET POLYDATA\n".encode())
    buf.write(f"POINTS {n_pts} float\n".encode())
    if binary:
        buf.write(pts.astype(">f4").tobytes())
        buf.write(b"\n")
    else:
        for p in pts:
            buf.write(f"{p[0]:.8g} {p[1]:.8g} {p[2]:.8g}\n".encode())

    cells = []
    start = 0
    for sl in streamlines:
        n = len(sl)
        cells.append(np.concatenate([[n], np.arange(start, start + n)]))
        start += n
    total = sum(len(c) for c in cells)
    buf.write(f"LINES {len(cells)} {total}\n".encode())
    if binary:
        flat = (np.concatenate(cells).astype(">i4") if cells
                else np.empty(0, dtype=">i4"))
        buf.write(flat.tobytes())
        buf.write(b"\n")
    else:
        for c in cells:
            buf.write((" ".join(str(int(v)) for v in c) + "\n").encode())

    raw = buf.getvalue()
    path.parent.mkdir(parents=True, exist_ok=True)
    if compress:
        # mtime=0 keeps synthetic cohorts byte-reproducible across runs.
        with open(path, "wb") as f:
            f.write(gzip.compress(raw, mtime=0))
    else:
        path.write_bytes(raw)
