"""SH ops of the port against the JAX package: sphere directions, the real
SH basis, the cached Cholesky factor, and the packed batched fit fed with
the JAX package's own basis state (``state_from_numpy``)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lesionvae_tpu.ops import sh as jsh
from lesionvae_tpu_torch.ops import sh as tsh

TOL = 1e-10


def test_fibonacci_sphere_matches_jax():
    want = jsh.fibonacci_sphere(777, dtype=jnp.float64)
    got = tsh.fibonacci_sphere(777, dtype=torch.float64, device="cpu")
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("max_l", [2, 6])
def test_real_sh_basis_matches_jax(max_l):
    rng = np.random.default_rng(max_l)
    theta = rng.uniform(0.0, np.pi, 300)
    phi = rng.uniform(0.0, 2 * np.pi, 300)
    want = np.asarray(jsh.real_sh_basis(jnp.asarray(theta), jnp.asarray(phi),
                                        max_l))
    got = tsh.real_sh_basis(torch.from_numpy(theta), torch.from_numpy(phi),
                            max_l).numpy()
    assert got.shape == (300, (max_l + 1) ** 2)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    assert tsh.sh_index_list(max_l) == jsh.sh_index_list(max_l)


@pytest.mark.parametrize("max_l,D", [(2, 500), (6, 2000)])
def test_cached_basis_and_factor_match_jax(max_l, D):
    want = jsh.cached_basis(max_l, D, x64=True)
    got = tsh.cached_basis(max_l, D, dtype=torch.float64, device="cpu")
    for name, w, g in zip(("directions", "theta", "phi", "basis", "chol"),
                          want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL, err_msg=name)
    # the upper factor reproduces the Gram matrix
    A, U = got[3], got[4]
    np.testing.assert_allclose((U.T @ U).numpy(), (A.T @ A).numpy(),
                               rtol=TOL, atol=TOL)


def _radii(B, D, dtype, max_l):
    """Smooth positive radius functions plus one constant row (Pearson r is
    NaN there, in both packages)."""
    rng = np.random.default_rng(B * 7 + D)
    _, theta, phi = (np.asarray(a) for a in
                     jsh.fibonacci_sphere(D, dtype=jnp.float64))
    ct = np.cos(theta)
    r = (1.0 + rng.uniform(-0.3, 0.3, (B, 1)) * ct[None, :] ** 2
         + rng.uniform(-0.1, 0.1, (B, 1)) * np.sin(3 * phi)[None, :]
         + rng.normal(scale=0.01, size=(B, D)))
    r[-1] = 0.5  # exact in binary, so the row mean is exact and den == 0
    return r.astype(dtype)


@pytest.mark.parametrize("max_l,B,D", [(6, 5, 2000), (4, 3, 500)])
def test_packed_fit_matches_jax_f64(max_l, B, D):
    directions, _t, _p, A, chol = jsh.cached_basis(max_l, D, x64=True)
    radii = _radii(B, D, np.float64, max_l)
    want = np.asarray(jsh.sh_fit_batch_packed(jnp.asarray(radii), A, chol,
                                              max_l=max_l))
    _dirs, basis, chol_c = tsh.state_from_numpy(
        np.asarray(directions), np.asarray(A), np.asarray(chol),
        dtype=torch.float64, device="cpu")
    got = tsh.sh_fit_batch_packed(torch.from_numpy(radii), basis, chol_c,
                                  max_l=max_l).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, equal_nan=True)
    assert np.isnan(got[-1, -1])  # constant row: Pearson r stays NaN
    ug, uw = tsh.unpack_sh_fit(got, max_l), jsh.unpack_sh_fit(want, max_l)
    assert list(ug) == list(uw)
    for k in uw:
        np.testing.assert_allclose(ug[k], uw[k], rtol=TOL, atol=TOL,
                                   equal_nan=True, err_msg=k)
    recon = tsh.reconstruct_surface(torch.from_numpy(ug["coeffs"]), basis)
    np.testing.assert_allclose(
        recon.numpy(), np.asarray(jsh.reconstruct_surface(
            jnp.asarray(uw["coeffs"]), A)), rtol=TOL, atol=TOL)


def test_packed_fit_matches_jax_f32():
    max_l, B, D = 6, 4, 2000
    _dirs, _t, _p, A, chol = jsh.cached_basis(max_l, D, x64=False)
    radii = _radii(B, D, np.float32, max_l)[:-1]  # no constant row
    want = np.asarray(jsh.sh_fit_batch_packed(jnp.asarray(radii), A, chol,
                                              max_l=max_l))
    _d, _t, _p, basis, chol_c = tsh.cached_basis(
        max_l, D, dtype=torch.float32, device="cpu")
    got = tsh.sh_fit_batch_packed(torch.from_numpy(radii), basis, chol_c,
                                  max_l=max_l)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
