"""Radius sampling: the port's plain version (and its wrapper on CPU tensors)
against the JAX package's XLA function in float64 and its Pallas kernel in
interpret mode in float32."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lesionvae_tpu.ops import sh as jsh
from lesionvae_tpu.ops.pallas_radius import sample_radii_padded
from lesionvae_tpu_torch.ops import radius

SHAPES = [(D, N, B) for D in (256, 512, 2000) for N in (1, 200, 333)
          for B in (1, 3, 13)]


def _inputs(D, N, B, dtype):
    """Seeded surfaces, centroids and directions; counts cover 0, partial
    and full (a single lesion is full)."""
    rng = np.random.default_rng(D * 1_000_003 + N * 101 + B)
    pts = rng.normal(size=(B, N, 3)).astype(dtype)
    cens = rng.normal(scale=0.3, size=(B, 3)).astype(dtype)
    counts = rng.integers(0, N + 1, size=B).astype(np.int32)
    counts[0] = N
    if B > 1:
        counts[1] = 0
    if B > 2:
        counts[2] = max(N // 2, 1)
    dirs = np.asarray(jsh.fibonacci_sphere(D, dtype=jnp.float64)[0]).astype(dtype)
    return pts, counts, cens, dirs


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("D,N,B", SHAPES)
def test_plain_matches_jax_f64(D, N, B):
    pts, counts, cens, dirs = _inputs(D, N, B, np.float64)
    want = np.asarray(jsh.sample_radii(jnp.asarray(pts), jnp.asarray(counts),
                                       jnp.asarray(cens), jnp.asarray(dirs)))
    got = radius.sample_radii_plain(*_torch(pts, counts, cens, dirs)).numpy()
    assert got.shape == (B, D)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("D,N,B", SHAPES[::4] + [SHAPES[-1]])
def test_wrapper_matches_pallas_interpret_f32(D, N, B):
    pts, counts, cens, dirs = _inputs(D, N, B, np.float32)
    want = np.asarray(sample_radii_padded(
        jnp.asarray(pts), jnp.asarray(counts), jnp.asarray(cens),
        jnp.asarray(dirs), interpret=True))
    radius.sample_radii.launches = 0
    got = radius.sample_radii(*_torch(pts, counts, cens, dirs))
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    # a CPU tensor takes the plain version and never counts a launch
    assert radius.sample_radii.launches == 0


CHUNK = radius.CHUNK
# N around the kernel's chunk of points: below, on and above one and two
# chunks, none a multiple of it but 256 and 512
CHUNK_NS = [CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK - 1, 2 * CHUNK, 2 * CHUNK + 3, 777]


@pytest.mark.parametrize("N", CHUNK_NS)
def test_wrapper_matches_jax_at_chunk_edges(N):
    """Counts exactly on a chunk edge, one either side of it, 0, 1 and N,
    with N itself on and off the chunk, through ``sample_radii`` on the CPU
    against the JAX ``sample_radii`` in float64."""
    D = 300
    edge = [0, 1, CHUNK - 1, CHUNK, CHUNK + 1, 2 * CHUNK, N - 1, N]
    counts = np.asarray(sorted({min(c, N) for c in edge}), np.int32)
    B = len(counts)
    rng = np.random.default_rng(N)
    pts = rng.normal(size=(B, N, 3))
    cens = rng.normal(scale=0.3, size=(B, 3))
    dirs = np.asarray(jsh.fibonacci_sphere(D, dtype=jnp.float64)[0])
    want = np.asarray(jsh.sample_radii(jnp.asarray(pts), jnp.asarray(counts),
                                       jnp.asarray(cens), jnp.asarray(dirs)))
    got = radius.sample_radii(*_torch(pts, counts, cens, dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    assert (got[counts == 0] == 0).all()
    # a point just past a count on the chunk edge never enters the maximum
    far = pts.copy()
    for b, c in enumerate(counts):
        if c < N:
            far[b, c] = 1e6
    again = radius.sample_radii(*_torch(far, counts, cens, dirs)).numpy()
    np.testing.assert_array_equal(again, got)


def test_kernel_limits_are_checked_before_launch():
    """More points a lesion than the grid can carry in chunks is refused."""
    assert radius._MAX_POINTS == 65535 * radius.CHUNK
    big = torch.empty((1, radius._MAX_POINTS + 1, 3), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="points"):
        radius._check(big, torch.empty(1, dtype=torch.int32, device="meta"),
                      torch.empty((1, 3), dtype=torch.float32, device="meta"),
                      torch.empty((4, 3), dtype=torch.float32, device="meta"))


def test_cuda_wrapper_rejects_wrong_inputs_before_launch():
    """The kernel route validates device, dtype, shape and contiguity
    itself; nothing here reaches a card."""
    pts, counts, cens, dirs = _torch(*_inputs(256, 8, 2, np.float32))
    with pytest.raises(TypeError, match="float32"):
        radius._check(pts.double(), counts, cens, dirs)
    with pytest.raises(TypeError, match="int32"):
        radius._check(pts, counts.long(), cens, dirs)
    with pytest.raises(ValueError, match="contiguous"):
        radius._check(pts.transpose(0, 1).contiguous().transpose(0, 1),
                      counts, cens, dirs)
    with pytest.raises(ValueError, match="centroids"):
        radius._check(pts, counts, cens[:1], dirs)
    with pytest.raises(ValueError, match="cuda or cpu"):
        radius.sample_radii(pts.to("meta"), counts.to("meta"),
                            cens.to("meta"), dirs.to("meta"))
