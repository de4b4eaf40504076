"""The port's uint16 upload codec against the JAX package's numpy route
(lesionvae_tpu/train/quantize.py:104-155): codes, lo and scale equal, the
reserved codes restored on decode."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lesionvae_tpu.train import quantize as jq
from lesionvae_tpu_torch.train import quantize as tq


@pytest.fixture(autouse=True)
def numpy_route(monkeypatch):
    """The JAX package's encoder without its native library."""
    monkeypatch.setattr(jq, "_lib_tried", True)
    monkeypatch.setattr(jq, "_lib", None)


def _block(case: str) -> np.ndarray:
    rng = np.random.default_rng(5)
    X = (rng.normal(size=(3, 20, 24, 5)) * [1.0, 10.0, 0.01, 100.0, 1.0]
         + [0.0, 50.0, -3.0, 0.0, 7.0]).astype(np.float32)
    if case == "finite":
        return X
    if case == "constant_feature":
        X[:, :, :, 2] = 4.25
        return X
    X[0, 3, 1, 0], X[1, 7, 4, 1], X[2, 0, 0, 3] = np.nan, np.inf, -np.inf
    X[0, 5:9, :, 4] = np.nan
    if case == "empty_feature":
        X[1, :, :, 2] = np.nan          # no finite value: scale 0, lo 0
    return X


@pytest.mark.parametrize("case", ["finite", "constant_feature", "non_finite",
                                  "empty_feature"])
def test_quantize_matches_jax_numpy_route(case):
    X = _block(case)
    codes, lo, scale = tq.quantize_u16(X)
    j_codes, j_lo, j_scale = jq.quantize_u16(X)
    assert codes.dtype == np.uint16 and lo.shape == scale.shape == (3, 1, 1, 5)
    np.testing.assert_array_equal(codes, j_codes)
    np.testing.assert_array_equal(lo, j_lo)
    np.testing.assert_array_equal(scale, j_scale)

    # decode: one member as the JAX program does it, all members in the port
    got = tq.dequantize_u16(tq.codes_to_tensor(codes, "cpu"),
                            torch.from_numpy(lo), torch.from_numpy(scale)).numpy()
    for i in range(3):
        want = np.asarray(jq.dequantize_u16(jnp.asarray(j_codes[i]),
                                            jnp.asarray(j_lo[i]), jnp.asarray(j_scale[i])))
        np.testing.assert_array_equal(got[i], want)
    fin = np.isfinite(X)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(X))
    np.testing.assert_array_equal(got[~fin & ~np.isnan(X)], X[~fin & ~np.isnan(X)])


def test_roundtrip_precision_and_sentinels():
    X = _block("non_finite")
    codes, lo, scale = tq.quantize_u16(X)
    assert codes[0, 3, 1, 0] == tq.SENT_NAN and codes[1, 7, 4, 1] == tq.SENT_PINF
    assert codes[2, 0, 0, 3] == tq.SENT_NINF
    fin = np.isfinite(X)
    assert codes[fin].max() <= tq.MAX_CODE
    back = tq.dequantize_u16(tq.codes_to_tensor(codes, "cpu"), torch.from_numpy(lo),
                             torch.from_numpy(scale)).numpy()
    step = np.broadcast_to(scale, X.shape)
    # half a code step, and the float32 rounding of (x - lo) / scale and of
    # lo + code * scale on top (read: 0.525 steps at worst)
    assert np.all(np.abs(back[fin] - X[fin]) <= 0.55 * step[fin])
    # the upload is two bytes a value
    assert tq.codes_to_tensor(codes, "cpu").element_size() == 2


# ---------------------------------------------------------------- the native encoder
def _native_block() -> np.ndarray:
    """tests/test_quantize_upload.py:92's block: scales 1e-3..1e3, NaN, ±inf
    and a constant feature."""
    rng = np.random.default_rng(9)
    X = (rng.normal(size=(4, 50, 10, 7)) * 10.0 ** rng.integers(
        -3, 4, (4, 1, 1, 7))).astype(np.float32)
    X[0, 1, 2, 3] = np.nan
    X[1, 0, 0, 0] = np.inf
    X[2, 5, 5, 5] = -np.inf
    X[:, :, :, 6] = -2.5      # constant feature
    return X


@pytest.mark.parametrize("case", ["native_block", "finite", "non_finite", "empty_feature"])
def test_native_encoder_matches_numpy_and_jax_native(monkeypatch, case):
    """The port's native encoder, its numpy encoder and the JAX package's
    native encoder give the same codes, lo and scale, bit for bit."""
    if tq._load() is None:
        pytest.skip("native quantizer cannot be built on this host")
    monkeypatch.setattr(jq, "_lib_tried", False)    # the JAX native route again
    X = _native_block() if case == "native_block" else _block(case)
    got = tq._quantize_native(X)
    want = jq._quantize_native(X)
    assert got is not None and want is not None
    for g, n, w in zip(got, tq.quantize_u16_numpy(X), want):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, n)
    assert tq.encoder() == "native"
    for g, q in zip(got, tq.quantize_u16(X)):
        np.testing.assert_array_equal(g, q)


def test_encoder_falls_back_to_numpy(monkeypatch):
    """Without the library, and for a block the native encoder refuses (more
    than 256 features), ``quantize_u16`` is the numpy encoder."""
    X = _block("non_finite")
    want = tq.quantize_u16_numpy(X)
    monkeypatch.setattr(tq, "_load", lambda: None)
    assert tq.encoder() == "numpy" and tq._quantize_native(X) is None
    for g, w in zip(tq.quantize_u16(X), want):
        np.testing.assert_array_equal(g, w)
    monkeypatch.undo()
    wide = np.random.default_rng(2).normal(size=(1, 2, 3, 257)).astype(np.float32)
    assert tq._quantize_native(wide) is None
    for g, w in zip(tq.quantize_u16(wide), jq.quantize_u16(wide)):
        np.testing.assert_array_equal(g, w)
