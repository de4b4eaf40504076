"""The port's geometry metrics (lesionvae_tpu_torch.ops.geometry: the plain
version of the geometry kernel, the eigen solvers, the host refinement and
summary) and its u16 codec (ops.geo_codec) against the JAX package, on the
CPU, with the same padded bundles made from a seed with numpy.

Bounds, relative to max(1, |x|) of the JAX value unless said otherwise:
- float64, every metric: 1e-10, inf for inf and NaN for NaN, on curves whose
  spectra are not degenerate.  On the adversarial bundle (spectra down to
  1e-18·λ1) the two eigen ratios are held to 1e-13 x their conditioning
  (λ1 / their denominator, from numpy's float64 eigenvalues): LAPACK's
  eigenvalues carry ~1e-16·λ1, so a ratio over λ3 ~ 1e-11 moves by far more
  than 1e-10 between any two LAPACK calls; their inf verdicts are equal.
- float32, every metric but torsion and the two ratios: 1e-5; the verdict
  columns (valid, eigen_ok, and isinf of both ratios where the certificate
  holds) equal in every row.
- float32, torsion: 1e-4 (b . db / |b|^2 is ill-conditioned; read up to
  3.5e-7 here).
- float32, bend_angle_mean of a curve with two consecutive tangents within
  0.01 rad of parallel: 5e-4 absolute.  arccos's slope 1/sin(theta) turns a
  cosine's last-bit difference into up to sqrt(2 eps) ~ 5e-4 rad at theta
  -> 0; the JAX package's own float32 test allows 1e-3 there.
- float32, elongation and planarity where certified: 2e-6 x their
  conditioning (λ1/λ2, λ1/λ3).  A float32 eigenvalue carries up to ~7e-7·λ1
  (the JAX package's measurement), so two float32 programs that sum in other
  orders differ by that much in the denominator: both packages read ~1e-4
  on a planarity of 31 against float64.  Not a difference of the port: the
  pipeline refines uncertified rows in float64 on the host.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lesionvae_tpu.ops import geo_codec as jcodec
from lesionvae_tpu.ops import geometry as jg
from lesionvae_tpu.ops.padding import pad_streamlines as jpad
from lesionvae_tpu_torch.ops import geo_codec as tcodec
from lesionvae_tpu_torch.ops import geometry as tg
from lesionvae_tpu_torch.ops.padding import pad_streamlines
from tests.test_geo_codec import _bundle as codec_bundle
from tests.test_geometry import _random_bundle
from tests.test_geometry_inf_stability import _adversarial_bundle

RATIOS = ("elongation_ratio", "planarity_ratio")
VERDICTS = ("valid", "eigen_ok")


def _edges():
    """n = 3, 4, 5, a curve that fills P exactly, duplicate consecutive
    points, a zero-length curve, a straight line and a planar circle."""
    rng = np.random.default_rng(3)
    sls = [rng.normal(size=(n, 3)) * 4 for n in (3, 4, 5, 16)]
    dup = np.cumsum(rng.normal(size=(12, 3)), axis=0)
    dup[5] = dup[4]
    dup[6] = dup[4]
    t = np.linspace(0, 1, 9)
    sls += [dup, np.zeros((6, 3)), np.stack([5 * t, 2 * t, -t], 1),
            np.stack([np.cos(6 * t), np.sin(6 * t), 0 * t], 1)]
    return sls


def _helix():
    t = np.linspace(0, 4 * np.pi, 400)
    return [np.stack([2 * np.cos(t), 2 * np.sin(t), 0.5 * t], 1)]


CASES = {
    "random0": lambda: _random_bundle(np.random.default_rng(0)),
    "random1": lambda: _random_bundle(np.random.default_rng(1)),
    "edges": _edges,
    "helix": _helix,
}


def _both(sls, dtype, max_points=None):
    """Stacked (19, S) metrics of both packages on the same padded input."""
    np_dtype = np.float64 if dtype == "f64" else np.float32
    pts, lens = pad_streamlines(sls, max_points=max_points, dtype=np_dtype)
    jpts, jlens = jpad(sls, max_points=max_points, dtype=np_dtype)
    np.testing.assert_array_equal(pts, jpts)
    np.testing.assert_array_equal(lens, jlens)
    want = np.asarray(jg.streamline_metrics_stacked(
        jnp.asarray(pts), jnp.asarray(lens),
        dtype=jnp.float64 if dtype == "f64" else jnp.float32))
    got = tg.streamline_metrics_stacked(
        torch.from_numpy(pts), torch.from_numpy(lens),
        dtype=torch.float64 if dtype == "f64" else torch.float32).numpy()
    return dict(zip(tg.STACKED_NAMES, got)), dict(zip(jg.STACKED_NAMES, want))


def _rel(got, want):
    fin = np.isfinite(got) & np.isfinite(want)
    return np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))


def _same_specials(name, got, want, rows=slice(None)):
    g, w = got[rows], want[rows]
    np.testing.assert_array_equal(np.isinf(g), np.isinf(w), err_msg=f"{name}: inf")
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w), err_msg=f"{name}: NaN")
    np.testing.assert_array_equal(np.sign(g[np.isinf(g)]), np.sign(w[np.isinf(w)]))


def _near_parallel(sls):
    """True for a curve with two consecutive tangents within 0.01 rad."""
    out = []
    for sl in sls:
        d = np.diff(np.asarray(sl, np.float64), axis=0)
        n = np.linalg.norm(d, axis=1)
        keep = n > 0
        t = d[keep] / n[keep, None]
        cos = np.einsum("ij,ij->i", t[:-1], t[1:]) if len(t) > 1 else np.zeros(0)
        out.append(bool((cos > np.cos(0.01)).any()))
    return np.array(out)


def _conditioning(sls):
    """(λ1/λ2, λ1/λ3) a streamline from numpy's float64 eigenvalues."""
    out = []
    for sl in sls:
        lam = np.maximum(np.linalg.eigvalsh(np.cov(np.asarray(sl, np.float64).T))[::-1],
                         1e-300)
        out.append((lam[0] / lam[1], lam[0] / lam[2]))
    return np.array(out).T


def test_names_and_constants_match_jax():
    assert tg.METRIC_NAMES == jg.METRIC_NAMES
    assert tg.STACKED_NAMES == jg.STACKED_NAMES
    assert tg.BUNDLE_SUMMARY == jg.BUNDLE_SUMMARY
    assert (tg.EIGEN_SAFE_REL, tg.EIGEN_SAFE_ABS) == (jg.EIGEN_SAFE_REL, jg.EIGEN_SAFE_ABS)


@pytest.mark.parametrize("case", sorted(CASES))
def test_metrics_f64_match_jax(case):
    got, want = _both(CASES[case](), "f64")
    for name in tg.STACKED_NAMES:
        _same_specials(name, got[name], want[name])
        rel = _rel(got[name], want[name])
        assert rel.size == 0 or rel.max() <= 1e-10, (name, rel.max())


def test_metrics_f64_adversarial_match_jax():
    sls = _adversarial_bundle()
    got, want = _both(sls, "f64")
    cond = dict(zip(RATIOS, _conditioning(sls)))
    for name in tg.STACKED_NAMES:
        _same_specials(name, got[name], want[name])
        fin = np.isfinite(got[name]) & np.isfinite(want[name])
        err = _rel(got[name], want[name])
        bound = 1e-13 * cond[name][fin] if name in RATIOS else 1e-10
        assert (err <= bound).all(), (name, err.max())
    assert np.isinf(got["planarity_ratio"]).any() and np.isinf(got["elongation_ratio"]).any()


@pytest.mark.parametrize("case", sorted(CASES) + ["adversarial"])
def test_metrics_f32_match_jax(case):
    sls = _adversarial_bundle() if case == "adversarial" else CASES[case]()
    got, want = _both(sls, "f32")
    for name in VERDICTS:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    ok = want["eigen_ok"] > 0.5
    cond = dict(zip(RATIOS, _conditioning(sls)))
    for name in tg.METRIC_NAMES:
        if name in RATIOS:
            _same_specials(name, got[name], want[name], rows=ok)
            g, w = got[name][ok], want[name][ok]
            err = np.abs(g - w) / np.abs(w)
            assert (err <= 2e-6 * cond[name][ok]).all(), (name, err.max())
            continue
        _same_specials(name, got[name], want[name])
        rel = np.abs(got[name] - want[name]) / np.maximum(1, np.abs(want[name]))
        bound = np.full(len(sls), 1e-4 if name == "torsion_mean" else 1e-5)
        if name == "bend_angle_mean":
            bound[_near_parallel(sls)] = 5e-4
        fin = np.isfinite(want[name])
        assert (rel[fin] <= bound[fin]).all(), (name, rel[fin].max())
    if case != "adversarial":
        assert ok.sum() >= len(sls) - 4   # the degenerate edge rows fail it


def test_certificate_flags_only_near_degenerate():
    """Well-conditioned curves pass the float32 certificate, so the host
    refinement stays near-empty on real cohorts (as the JAX package's test
    of the same name)."""
    rng = np.random.default_rng(5)
    sls = []
    for _ in range(60):
        P = int(rng.integers(10, 100))
        t = np.linspace(0, 1, P)
        sls.append(np.stack([20 * t + rng.normal(0, 0.1, P),
                             3 * np.sin(5 * t) + rng.normal(0, 0.1, P),
                             2 * np.cos(4 * t) + rng.normal(0, 0.1, P)], 1))
    got, _ = _both(sls, "f32", max_points=112)
    assert (got["eigen_ok"] == 1).all()


def _spectra(dtype):
    """Covariances as the six entries (S,) each: random SPD matrices, and the
    degenerate ones: exact zero and repeated eigenvalues, rank 1 and 2,
    the zero and the isotropic matrix, and spectra at 1e-4·λ1."""
    rng = np.random.default_rng(11)
    mats = []
    for lam in ([3.0, 2.0, 1.0], [5.0, 1e-4, 1e-4], [1.0, 1.0, 0.0], [2.0, 0.0, 0.0],
                [0.0, 0.0, 0.0], [1.0, 1.0, 1.0], [4.0, 4.0 * 1.02e-4, 4.0 * 0.98e-4],
                [1e3, 1.0, 1e-3]):
        q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
        mats.append(q @ np.diag(lam) @ q.T)
    for _ in range(40):
        a = rng.normal(size=(3, 3)) * rng.uniform(0.1, 10)
        mats.append(a @ a.T)
    C = np.array(mats).astype(dtype)
    C = (C + C.transpose(0, 2, 1)) / 2
    return C


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("solver", ["trig", "deflated"])
def test_eigen_solvers_match_jax(dtype, solver):
    C = _spectra(dtype)
    entries = {f"{j}{k}": torch.from_numpy(np.ascontiguousarray(C[:, j, k]))
               for j, k in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))}
    got = getattr(tg, f"_eigh3_{solver}")(entries).numpy()
    want = np.asarray(getattr(jg, f"_eigh3_{solver}")(jnp.asarray(C)))
    scale = np.maximum(1.0, np.abs(np.linalg.eigvalsh(C.astype(np.float64))).max(-1))
    tol = 1e-12 if dtype == np.float64 else 2e-6
    if solver == "trig":   # sqrt(eps)-accurate near degeneracy: arccos near ±1
        tol = 1e-7 if dtype == np.float64 else 2e-3
    assert np.all(np.abs(got - want) <= tol * scale[:, None]), np.abs(got - want).max()
    if solver == "deflated":   # and against LAPACK, to the JAX package's measured 7e-7·λ1
        ref = np.linalg.eigvalsh(C.astype(np.float64))[:, ::-1]
        err = np.abs(got - ref) / scale[:, None]
        assert err.max() <= (1e-12 if dtype == np.float64 else 1e-6), err.max()


def test_eigen_metrics_f64_matches_jax():
    sls = _adversarial_bundle(12)
    idx = np.arange(0, len(sls), 2)
    outs = []
    for mod in (tg, jg):
        e, p, a = np.full(len(sls), -1.0), np.full(len(sls), -1.0), np.full(len(sls), -1.0)
        mod.eigen_metrics_f64(sls, e, p, a, idx)
        outs.append((e, p, a))
    for g, w in zip(*outs):
        np.testing.assert_array_equal(g, w)
    assert np.isinf(outs[0][1]).any() and (outs[0][0][1::2] == -1).all()


def test_bundle_summary_matches_jax():
    """nanmean over valid rows: NaN skipped, inf propagates, no valid rows
    give NaN."""
    rng = np.random.default_rng(2)
    m = {k: rng.normal(size=9) for k in tg.METRIC_NAMES}
    m["valid"] = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], bool)
    m["elongation_ratio"][3] = np.inf
    m["planarity_ratio"][4] = np.nan
    m["curv_mean"][2] = np.inf          # an invalid row: ignored
    got, want = tg.bundle_summary(m), jg.bundle_summary(m)
    assert got == pytest.approx(want, nan_ok=True, rel=0, abs=0)
    assert np.isinf(got["elongation_ratio_mean"]) and np.isfinite(got["planarity_ratio_mean"])
    assert np.isfinite(got["curv_mean_avg"]) and got["n_streamlines"] == 7
    none = {**m, "valid": np.zeros(9, bool)}
    assert tg.bundle_summary(none) == pytest.approx(jg.bundle_summary(none), nan_ok=True)


@contextlib.contextmanager
def numpy_codec():
    """The port's codec with its native library switched off."""
    saved, tried = tcodec._lib, tcodec._lib_tried
    tcodec._lib, tcodec._lib_tried = None, True
    try:
        yield
    finally:
        tcodec._lib, tcodec._lib_tried = saved, tried


def _codec_inputs(seed, n_sl=40, P=64):
    pts, lens = pad_streamlines(codec_bundle(np.random.default_rng(seed), n_sl=n_sl),
                                max_points=P)
    return pts, lens


def test_encode_matches_jax_and_numpy_route():
    pts, lens = _codec_inputs(0)
    want = jcodec.encode_u16_delta(pts, lens)
    assert tcodec._load() is not None, "the native codec builds with make here"
    for g, w in zip(tcodec.encode_u16_delta(pts, lens), want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with numpy_codec():
        for g, w in zip(tcodec.encode_u16_delta(pts, lens), want):
            np.testing.assert_array_equal(g, w)


def test_torsion_f64_matches_jax_and_numpy_route():
    pts, lens = _codec_inputs(2, n_sl=12)
    lens[0] = 3                                   # fewer than 4 points: 0
    want = jcodec.torsion_f64(pts, lens)
    np.testing.assert_array_equal(tcodec.torsion_f64(pts, lens), want)
    with numpy_codec():
        np.testing.assert_allclose(tcodec.torsion_f64(pts, lens), want,
                                   rtol=1e-12, atol=1e-15)
    assert want[0] == 0.0


def _decode_both(pts, lens):
    codes, p0, lo, sc = tcodec.encode_u16_delta(pts, lens)
    t_in = [torch.from_numpy(codes.view(np.int16))] + [
        torch.from_numpy(a) for a in (p0, lo, sc, lens)]
    got = tcodec.decode_points(*t_in).numpy()
    want = np.asarray(jcodec.decode_points(*(jnp.asarray(a) for a in
                                             (codes, p0, lo, sc, lens))))
    return got, want, t_in


def test_decode_points_matches_jax():
    """Same decode; the running sum is taken in order where XLA's cumsum
    associates otherwise, so float32 rounding differs at 1e-6 of the
    coordinates' size (bound 1e-5 x max(1, |x|))."""
    pts, lens = _codec_inputs(1)
    got, want, _ = _decode_both(pts, lens)
    assert got.dtype == np.float32 and got.shape == pts.shape
    mask = np.arange(pts.shape[1])[None, :] < lens[:, None]
    rel = np.abs(got - want)[mask] / np.maximum(1, np.abs(want[mask]))
    assert rel.max() <= 1e-5, rel.max()
    # pad points repeat the last real point
    s = int(np.argmin(lens))
    np.testing.assert_array_equal(got[s, lens[s]:], np.broadcast_to(
        got[s, lens[s] - 1], got[s, lens[s]:].shape))
    # and the decode is within a few quantization steps of the originals
    codes, p0, lo, sc = tcodec.encode_u16_delta(pts, lens)
    err = np.abs(np.where(mask[..., None], got - pts, 0))
    assert (err <= sc.max(axis=1)[:, None, None] * (0.5 * np.sqrt(pts.shape[1]) + 1)
            + 1e-6).all()


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_stacked_u16_is_decode_then_metrics(dtype):
    """The u16 mode's plain version is the decode followed by the metrics:
    held against the JAX metrics of the port's decoded points (the decode
    itself is held against the JAX decode above)."""
    pts, lens = _codec_inputs(3)
    decoded, _, t_in = _decode_both(pts, lens)
    tdt = torch.float64 if dtype == "f64" else torch.float32
    got = tg.streamline_metrics_stacked_u16(*t_in, dtype=tdt).numpy()
    want = np.asarray(jg.streamline_metrics_stacked(
        jnp.asarray(decoded), jnp.asarray(lens),
        dtype=jnp.float64 if dtype == "f64" else jnp.float32))
    assert got.shape == (19, len(lens))
    for r, name in enumerate(tg.STACKED_NAMES):
        _same_specials(name, got[r], want[r])
        bound = (1e-10 if dtype == "f64" else
                 {"torsion_mean": 1e-4, **{k: 1e-3 for k in RATIOS}}.get(name, 1e-5))
        rel = _rel(got[r], want[r])
        assert rel.size == 0 or rel.max() <= bound, (name, rel.max())


def test_cpu_tensors_take_the_plain_version():
    pts, lens = pad_streamlines(_random_bundle(np.random.default_rng(9), n=5))
    x, n = torch.from_numpy(pts), torch.from_numpy(lens)
    before = tg.streamline_metrics_stacked.launches
    got = tg.streamline_metrics_stacked(x, n)
    assert tg.streamline_metrics_stacked.launches == before
    assert torch.equal(got, tg.streamline_metrics_stacked_plain(x, n))
    assert got.dtype == torch.float32 and got.shape == (19, 5)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tg.streamline_metrics_stacked(x.to("meta"), n.to("meta"))


@pytest.mark.parametrize("bad", ["float64", "shape", "lengths", "codes", "P"])
def test_kernel_rejects_inputs_it_does_not_take(bad):
    x = torch.zeros(4, 32, 3)
    n = torch.full((4,), 5, dtype=torch.int32)
    codes, aux = torch.zeros(4, 31, 3, dtype=torch.int16), torch.zeros(4, 3)
    args = {"float64": (x, None, None, None, None, n, torch.float64),
            "shape": (x[:, :, :2].contiguous(), None, None, None, None, n, torch.float32),
            "lengths": (x, None, None, None, None, n.long(), torch.float32),
            "codes": (None, codes.int(), aux, aux, aux, n, torch.float32),
            "P": (torch.zeros(1, 20000, 3), None, None, None, None,
                  torch.ones(1, dtype=torch.int32), torch.float32)}[bad]
    with pytest.raises(ValueError):
        tg._check(*args)
    assert tg._check(x, None, None, None, None, n, torch.float32) == (4, 32)
    assert tg._check(None, codes, aux, aux, aux, n, torch.float32) == (4, 32)


@pytest.mark.parametrize("P,lanes,want", [(32, 16, 8), (64, 16, 8), (128, 16, 8),
                                           (129, 32, 4), (256, 32, 4), (4096, 32, 1),
                                           (9000, 32, 1)])
def test_block_streamlines(P, lanes, want):
    """16 lanes a streamline up to P = 128, 32 beyond; 4 and 8 warps a
    block, halved while the block needs more than 48 KB."""
    got_lanes, spb, shared = tg.block_streamlines(P)
    assert (got_lanes, spb) == (lanes, want)
    assert spb * lanes <= 256 and (spb * lanes) % 32 == 0
    assert shared == spb * 4 * tg.stream_floats(P, lanes)
    assert spb == 32 // lanes or shared <= 48 * 1024


@pytest.mark.parametrize("P", [2, 3, 32, 48, 64, 100, 128, 256, 4096])
@pytest.mark.parametrize("lanes", [16, 32])
def test_stream_floats(P, lanes):
    """The layout of csrc/geometry.cu::Lay: 34 x lanes + 40 floats that do
    not depend on P, 5 a point; the stride keeps 16-byte slots aligned and
    puts the streamlines of a warp on distinct banks (lanes modulo 32)."""
    w = tg.stream_floats(P, lanes)
    assert 5 * P + 34 * lanes + 40 <= w < 5 * P + 34 * lanes + 40 + 32
    assert w % 32 == lanes % 32 and w % 4 == 0
    assert (34 * lanes + 40) % 4 == 0          # the points' slots start aligned


def test_max_points_is_the_shared_memory_limit():
    P = tg.max_points()
    assert 4 * tg.stream_floats(P, 32) <= tg._MAX_SHARED < 4 * tg.stream_floats(P + 1, 32)
    n = torch.ones(1, dtype=torch.int32)
    assert tg._check(torch.zeros(1, P, 3), None, None, None, None, n, torch.float32) == (1, P)
    with pytest.raises(ValueError, match=f"at most {P} points"):
        tg._check(torch.zeros(1, P + 1, 3), None, None, None, None, n, torch.float32)


# the card's issue rate that the issue bound divides by: 132 SMs x 4
# schedulers x 32 lanes x 1.98 GHz = 33.45 T lane-instructions/s
LANE_RATE = 132 * 4 * 32 * 1.98e9


def _issue_ms(lens, P, u16=False):
    return tg.bound_ms(lens, P, u16=u16)["issue_bound_ms"]


@pytest.mark.parametrize("u16,per_point", [(False, 181), (True, 196)])
def test_issue_bound_hand_worked(u16, per_point):
    """Two streamlines of 10 and 20 real points: 30 x 181 (196 with the
    decode) + 2 x 550 lane-instructions."""
    from lesionvae_tpu_torch.utils import cost_model

    want = 1e3 * (30 * per_point + 2 * 550) / LANE_RATE
    assert _issue_ms([10, 20], 32, u16=u16) == pytest.approx(want, rel=1e-12)
    assert (cost_model.H100_SMS * cost_model.H100_ISSUE_LANES * cost_model.H100_CLOCK_GHZ
            * 1e9 == pytest.approx(LANE_RATE))


@pytest.mark.parametrize("u16", [False, True])
def test_issue_bound_counts_real_points_only(u16):
    """Padding P counts nothing; lengths clip to [1, P] as the kernel
    clips them."""
    lens = np.array([20, 31, 3, 32])
    at32 = _issue_ms(lens, 32, u16=u16)
    assert _issue_ms(lens, 64, u16=u16) == at32
    assert _issue_ms(lens, 128, u16=u16) == at32
    assert _issue_ms([40, 0], 32, u16=u16) == _issue_ms([32, 1], 32, u16=u16)


@pytest.mark.parametrize("P", [32, 64, 256])
def test_issue_bound_u16_above_f32(P):
    """The decode adds instructions a point: the u16 bound is the larger,
    and both exceed the byte bound at the path's chunk shape."""
    lens = np.random.default_rng(P).integers(3, P + 1, size=4096)
    f32, u16 = _issue_ms(lens, P), _issue_ms(lens, P, u16=True)
    assert u16 > f32
    assert f32 > tg.bound_ms(lens, P)["bound_ms"]


def _ring_schedule(n, G):
    """The kernel's pass-1 schedule (csrc/geometry.cu: prologue, then rounds
    of step A at row j0+2+l, step B at j0+1+l, step C and the sums at j0+l)
    on rings of 2G slots that record which row each slot holds.  Returns the
    rows every read found, against the rows it wanted."""
    RM = 2 * G - 1
    V, B, H, T = {}, {}, {}, {}
    got, want = [], []

    def edge(p):
        return (0 if p == 0 else p - 1), (p if p == n - 1 else p + 1)

    def read(ring, row):
        got.append(ring.get(row & RM))
        want.append(row)

    def step_b(p):
        if n >= 3:
            for q in (p, *edge(p)):
                read(V, q)
        B[p & RM] = H[p & RM] = T[p & RM] = p

    curv = n >= 3
    if curv:
        for p in (0, 1):
            V[p & RM] = p
    step_b(0)
    rounds = -(-n // G)
    for r in range(rounds):
        j0 = r * G
        for p in range(j0 + 2, j0 + G + 2):          # step A, lanes l = 0..G-1
            if curv and p < n:
                V[p & RM] = p
        for p in range(j0 + 1, j0 + G + 1):          # step B
            if p < n:
                step_b(p)
        for j in range(j0, j0 + G):                  # step C
            if j < n:
                if n >= 4:
                    for q in (j, *edge(j)):
                        read(B, q)
                if n >= 3 and j < n - 2:
                    read(H, j)
                    read(H, j + 1)
                T[j & RM] = j                        # torsion and bend terms
        for j in range(j0, min(j0 + G, n)):          # the sums
            read(T, j)
    return got, want


@pytest.mark.parametrize("G", [16, 32])
@pytest.mark.parametrize("n", [1, 2, 3, 4, 5, 15, 16, 17, 31, 32, 33, 63, 64, 65, 200])
def test_ring_schedule_reads_the_rows_it_needs(n, G):
    """No ring slot is overwritten before every step that needs its row has
    read it, at lengths on and beside a round's edges."""
    got, want = _ring_schedule(n, G)
    assert got == want


def test_geometry_lanes_benchmark_needs_the_card():
    """The launch-geometry benchmark times the kernel on the card only."""
    from lesionvae_tpu_torch.benchmarks import geometry_lanes

    if torch.cuda.is_available():
        pytest.skip("a card is present: the benchmark would run")
    with pytest.raises(SystemExit, match="no CUDA device"):
        geometry_lanes.main(["--S", "8"])
