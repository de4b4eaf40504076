"""The port's NIfTI reader/writer (``io/nifti.py``) and volume ops
(``ops/volume.py``) beside the JAX package's, on the same inputs: the cases
of tests/test_nifti_extra.py (qform quaternions, dtypes, the FA fallback of
the brain volume) and tests/test_volume.py (largest connected component,
unit volume, marching vertices, the surface methods and their cap).  Each
case runs both packages and holds the port to the JAX package's result,
bit for bit, and to the case's expected values."""

import gzip
import struct

import numpy as np
import pytest
from scipy import ndimage

from lesionvae_tpu.io import nifti as jax_nifti
from lesionvae_tpu.ops import volume as jax_volume
from lesionvae_tpu_torch.io import nifti
from lesionvae_tpu_torch.ops import volume as vol


def _write_with_qform(path, data, quat, offsets, pixdim):
    """A NIfTI carrying only a qform (no sform), patched into the header."""
    nifti.save(path, data, np.eye(4))
    raw = bytearray(gzip.decompress(path.read_bytes())
                    if path.suffix == ".gz" else path.read_bytes())
    struct.pack_into("<8f", raw, 76, 1.0, *pixdim, *([1.0] * (7 - 3)))
    struct.pack_into("<h", raw, 252, 1)      # qform_code = 1
    struct.pack_into("<h", raw, 254, 0)      # sform_code = 0
    struct.pack_into("<6f", raw, 256, *quat, *offsets)
    path.write_bytes(gzip.compress(bytes(raw)) if path.suffix == ".gz" else bytes(raw))


def _load_both(path):
    """(affine, data) as the port reads the file, asserted equal to the
    JAX package's reading."""
    got, want = nifti.load(path), jax_nifti.load(path)
    np.testing.assert_array_equal(got.affine, want.affine)
    np.testing.assert_array_equal(got.get_fdata(), want.get_fdata())
    return got.affine, got.get_fdata()


def _ball(shape=(24, 24, 24), r=6.0, center=None):
    grid = np.stack(np.meshgrid(*[np.arange(s) for s in shape], indexing="ij"), -1)
    c = np.array(center if center is not None else np.array(shape) / 2)
    return (np.linalg.norm(grid - c, axis=-1) <= r).astype(float)


def test_qform_identity_quaternion(tmp_path):
    data = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    p = tmp_path / "q.nii"
    _write_with_qform(p, data, quat=(0.0, 0.0, 0.0), offsets=(1.0, 2.0, 3.0),
                      pixdim=(2.0, 3.0, 4.0))
    affine, got = _load_both(p)
    want = np.diag([2.0, 3.0, 4.0, 1.0])
    want[:3, 3] = [1, 2, 3]
    np.testing.assert_allclose(affine, want, atol=1e-6)
    np.testing.assert_allclose(got, data)


def test_qform_rotation_quaternion(tmp_path):
    """quaternion (b, c, d) = (1, 0, 0): 180 degrees about x."""
    p = tmp_path / "r.nii"
    _write_with_qform(p, np.zeros((2, 2, 2), np.float32), quat=(1.0, 0.0, 0.0),
                      offsets=(0.0, 0.0, 0.0), pixdim=(1.0, 1.0, 1.0))
    affine, _ = _load_both(p)
    np.testing.assert_allclose(affine[:3, :3], np.diag([1.0, -1.0, -1.0]), atol=1e-6)


@pytest.mark.parametrize("dtype", [np.uint8, np.int16, np.int32, np.float64])
def test_dtype_coverage(tmp_path, dtype):
    """Each on-disk dtype round-trips through the port's writer, and the
    file reads the same through either package."""
    data = (np.arange(8).reshape(2, 2, 2) % 3).astype(dtype)
    p = tmp_path / f"d_{dtype.__name__}.nii.gz"
    nifti.save(p, data, np.eye(4))
    _, got = _load_both(p)
    np.testing.assert_allclose(got, data.astype(np.float64))


def test_the_writers_write_the_same_bytes(tmp_path):
    """The port's writer and the JAX package's give the same file."""
    data = np.arange(60, dtype=np.float32).reshape(3, 4, 5) * 0.25
    affine = np.diag([0.5, 0.75, 1.25, 1.0])
    affine[:3, 3] = [-3.0, 1.5, 2.0]
    nifti.save(tmp_path / "torch.nii.gz", data, affine)
    jax_nifti.save(tmp_path / "jax.nii.gz", data, affine)
    assert (gzip.decompress((tmp_path / "torch.nii.gz").read_bytes())
            == gzip.decompress((tmp_path / "jax.nii.gz").read_bytes()))


def test_brain_volume_fa_fallback(tmp_path):
    """No tissue.nii.gz: FA > 0.1 with an erosion and a dilation
    (lesion_sh_heme_comprehensive.py:243-255)."""
    d = tmp_path / "s1" / "9d"
    fa = np.zeros((16, 16, 16), np.float32)
    fa[4:12, 4:12, 4:12] = 0.5
    nifti.save(d / "dti_FA.nii.gz", fa, np.diag([2.0, 1.0, 1.0, 1.0]))
    got = vol.compute_brain_volume("s1", "9d", tmp_path)
    assert got == jax_volume.compute_brain_volume("s1", "9d", tmp_path)
    mask = ndimage.binary_dilation(ndimage.binary_erosion(fa > 0.1, iterations=1),
                                   iterations=1)
    np.testing.assert_allclose(got, mask.sum() * 2.0)


def test_brain_volume_missing_everything(tmp_path):
    assert vol.compute_brain_volume("nope", "9d", tmp_path) is None
    assert jax_volume.compute_brain_volume("nope", "9d", tmp_path) is None


def test_lcc_picks_largest():
    m = _ball(r=5.0) + _ball(r=2.0, center=(3, 3, 3))
    cc = vol.extract_largest_connected_component(m)
    np.testing.assert_array_equal(cc, jax_volume.extract_largest_connected_component(m))
    assert cc.sum() < m.sum()
    centroid = vol.compute_centroid(cc)
    np.testing.assert_array_equal(centroid, jax_volume.compute_centroid(cc))
    np.testing.assert_allclose(centroid, [12, 12, 12], atol=0.5)


def test_unit_volume_scale():
    m = _ball(r=5.0)
    affine = np.diag([0.5, 0.5, 0.5, 1.0])
    scale, volume = vol.normalize_to_unit_volume(m, affine)
    assert (scale, volume) == jax_volume.normalize_to_unit_volume(m, affine)
    np.testing.assert_allclose(volume, m.sum() * 0.125, rtol=1e-12)
    np.testing.assert_allclose(scale, volume ** (-1 / 3))


def test_marching_vertices_are_edge_midpoints():
    m = np.zeros((5, 5, 5))
    m[2, 2, 2] = 1.0  # a single voxel: 6 face-crossing vertices
    v = vol.marching_cubes_vertices(m)
    np.testing.assert_array_equal(v, jax_volume.marching_cubes_vertices(m))
    assert v.shape == (6, 3)
    assert {tuple(row) for row in v} == {(1.5, 2, 2), (2.5, 2, 2), (2, 1.5, 2),
                                         (2, 2.5, 2), (2, 2, 1.5), (2, 2, 2.5)}


def test_marching_sphere_radius():
    m = _ball(r=7.0)
    v = vol.marching_cubes_vertices(m)
    np.testing.assert_array_equal(v, jax_volume.marching_cubes_vertices(m))
    r = np.linalg.norm(v - np.array([12, 12, 12]), axis=1)
    # every vertex within a voxel, the median within 0.6, of the true radius
    assert abs(np.median(r) - 7.0) < 0.6
    assert (np.abs(r - 7.0) < 1.0).all()


@pytest.mark.parametrize("method", ["marching", "erosion"])
def test_extract_surface_methods_and_cap(method):
    """Both methods sample the cap of 200 points from a seeded generator,
    the same points in both packages."""
    m = _ball(r=6.0)
    got = vol.extract_surface_points(m, np.eye(4), num_points=200,
                                     rng=np.random.default_rng(0), method=method)
    want = jax_volume.extract_surface_points(m, np.eye(4), num_points=200,
                                             rng=np.random.default_rng(0), method=method)
    np.testing.assert_array_equal(got, want)
    assert len(got) == 200


def test_extract_surface_auto_gate_takes_erosion_for_a_tiny_lesion():
    """The auto gate: a tiny lesion takes the erosion surface, whose
    points are the lesion's own voxels (reference :119)."""
    tiny = np.zeros((8, 8, 8))
    tiny[3:5, 3:5, 3:5] = 1
    got = vol.extract_surface_points(tiny, np.eye(4), num_points=200)
    np.testing.assert_array_equal(
        got, jax_volume.extract_surface_points(tiny, np.eye(4), num_points=200))
    voxels = {tuple(r) for r in np.argwhere(tiny > 0.5)}
    assert {tuple(r) for r in got.astype(int)} <= voxels
