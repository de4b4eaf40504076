"""The port's VTK reader and writer (lesionvae_tpu_torch.io.vtk and
io.vtk_native) against the JAX package's, on the cases of tests/test_io.py
and tests/test_vtk_fuzz.py: the writer's bytes are the same, both readers
return the same arrays, and the port's native and Python parsers agree."""

import contextlib

import numpy as np
import pytest

from lesionvae_tpu.io import vtk as jvtk
from lesionvae_tpu_torch.io import vtk as tvtk
from lesionvae_tpu_torch.io import vtk_native as tnative

V51 = """# vtk DataFile Version 5.1
t
ASCII
DATASET POLYDATA
POINTS 6 float
0 0 0
1 0 0
2 0 0
0 1 0
1 1 0
2 1 0
LINES 3 6
OFFSETS vtktypeint64
0 3 6
CONNECTIVITY vtktypeint64
0 1 2 3 4 5
"""
POINTS_ONLY = ("# vtk DataFile Version 3.0\nt\nASCII\nDATASET POLYDATA\n"
               "POINTS 2 float\n0 0 0\n1 1 1\n")

MALFORMED = [
    b"",
    b"not a vtk file at all\n",
    b"# vtk DataFile Version 3.0\nt\nASCII\nDATASET STRUCTURED_GRID\n",
    b"# vtk DataFile Version 3.0\nt\nEBCDIC\nDATASET POLYDATA\n",
    b"# vtk DataFile Version 3.0\nt\nASCII\nDATASET POLYDATA\nPOINTS 5 float\n1 2 3\n",
    b"# vtk DataFile Version 3.0\nt\nASCII\nDATASET POLYDATA\n"
    b"POINTS 999999999999999 float\n1 2 3\n",
    b"# vtk DataFile Version 3.0\nt\nBINARY\nDATASET POLYDATA\n"
    b"POINTS 999999999999999 float\n\x00\x00\x00\x00",
    b"# vtk DataFile Version 3.0\nt\nBINARY\nDATASET POLYDATA\n"
    b"POINTS 2305843009213693952 double\n\x00",
    b"# vtk DataFile Version 3.0\nt\nASCII\nDATASET POLYDATA\n"
    b"POINTS 1 float\n0 0 0\nLINES 1 2\n-5 0\n",
]


@contextlib.contextmanager
def python_parser():
    """The port's reader with its native parser switched off."""
    saved, tried = tnative._lib, tnative._tried
    tnative._lib, tnative._tried = None, True
    try:
        yield
    finally:
        tnative._lib, tnative._tried = saved, tried


def _bundle(rng, n=7, lo=3, hi=40, scale=1.0):
    return [rng.normal(size=(int(rng.integers(lo, hi)), 3)) * scale for _ in range(n)]


def _assert_same_streamlines(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("binary", [False, True])
@pytest.mark.parametrize("compress", [False, True])
def test_writer_bytes_and_reader_match_jax(tmp_path, binary, compress):
    rng = np.random.default_rng(10 + 2 * binary + compress)
    bundle = _bundle(rng, scale=100.0)
    name = "b.vtk.gz" if compress else "b.vtk"
    tvtk.write_vtk_polylines(tmp_path / "t" / name, bundle, binary=binary)
    jvtk.write_vtk_polylines(tmp_path / "j" / name, bundle, binary=binary)
    assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    want = jvtk.read_streamlines(tmp_path / "j" / name)
    _assert_same_streamlines(tvtk.read_streamlines(tmp_path / "t" / name), want)
    with python_parser():
        _assert_same_streamlines(tvtk.read_streamlines(tmp_path / "t" / name), want)
    for a, b in zip(bundle, want):   # float32 storage either way
        np.testing.assert_allclose(b, a, rtol=0, atol=np.abs(a).max() * 1e-6 + 1e-6)


@pytest.mark.parametrize("max_streamlines", [None, 0, 1, 3, 100])
def test_filter_and_cap_match_jax(tmp_path, max_streamlines):
    """Only polylines of more than 2 points, all finite, in file order, up to
    ``max_streamlines`` (tract_geom_proc.py:17-26)."""
    rng = np.random.default_rng(4)
    bad = rng.normal(size=(8, 3))
    bad[3, 1] = np.nan
    inf = rng.normal(size=(5, 3))
    inf[0, 2] = np.inf
    sls = [rng.normal(size=(2, 3)), rng.normal(size=(10, 3)), bad,
           rng.normal(size=(3, 3)), inf, rng.normal(size=(6, 3))]
    path = tmp_path / "f.vtk"
    jvtk.write_vtk_polylines(path, sls)
    want = jvtk.read_streamlines(path, max_streamlines=max_streamlines)
    got = tvtk.read_streamlines(path, max_streamlines=max_streamlines)
    _assert_same_streamlines(got, want)
    assert len(got) == min(3, 3 if max_streamlines is None else max_streamlines)


@pytest.mark.parametrize("text,n_lines", [(V51, 2), (POINTS_ONLY, 0)])
def test_layouts_match_jax(tmp_path, text, n_lines):
    p = tmp_path / "x.vtk"
    p.write_text(text)
    for parsed in (tvtk.read_vtk_polydata(p), jvtk.read_vtk_polydata(p)):
        assert parsed[0].shape[1] == 3
    got = tvtk.read_vtk_polydata(p)
    with python_parser():
        got_py = tvtk.read_vtk_polydata(p)
    for a, b, c in zip(got, got_py, jvtk.read_vtk_polydata(p)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, c)
    assert len(tvtk.read_streamlines(p)) == n_lines


@pytest.mark.parametrize("binary", [False, True])
def test_native_matches_python(tmp_path, binary):
    assert tnative.available(), "the native parser builds with make here"
    rng = np.random.default_rng(20 + binary)
    for trial in range(4):
        bundle = _bundle(rng, n=int(rng.integers(1, 20)), scale=100.0)
        p = tmp_path / f"f{trial}.vtk"
        tvtk.write_vtk_polylines(p, bundle, binary=binary)
        native = tnative.parse_polydata(p.read_bytes())
        with python_parser():
            py = tvtk.read_vtk_polydata(p)
        np.testing.assert_allclose(native[0], py[0], rtol=1e-6)
        np.testing.assert_array_equal(native[1], py[1])
        np.testing.assert_array_equal(native[2], py[2])


@pytest.mark.parametrize("payload", MALFORMED)
def test_malformed_inputs_raise_in_both_parsers(tmp_path, payload):
    p = tmp_path / "bad.vtk"
    p.write_bytes(payload)
    with pytest.raises((ValueError, IndexError, OverflowError)):
        tvtk.read_vtk_polydata(p)
    with python_parser(), pytest.raises((ValueError, IndexError, OverflowError)):
        tvtk.read_vtk_polydata(p)


def test_out_of_range_indices_rejected(tmp_path):
    p = tmp_path / "oob.vtk"
    p.write_text("# vtk DataFile Version 3.0\nt\nASCII\nDATASET POLYDATA\n"
                 "POINTS 3 float\n0 0 0\n1 1 1\n2 2 2\nLINES 1 4\n3 0 1 99\n")
    with pytest.raises(IndexError):
        tvtk.read_streamlines(p)
