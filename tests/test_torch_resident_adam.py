"""Resident bf16 Adam: the port's plain version (and its wrapper on CPU
tensors) against the JAX probe's Pallas kernel in interpret mode and its
``run_xla`` scan (benchmarks/pallas_opt_probe.py).

The probe reads its sizes from PROBE_T/PROBE_P/PROBE_BLK when it is
imported and sets up a compile cache for a TPU; both are arranged here
before the import.

The plain version rounds once per float32 operation, in the order the
probe writes them, so it equals the probe's own step (``_adam``) evaluated
op by op in JAX, bit for bit, at every K.  Compiled, XLA fuses the step and
may round some elements' float32 intermediates differently (which ones
depends on how the program was compiled: K = 1 is usually bit-equal but was
seen once not to be); after the bf16 rounding of each step that shows as
single-ulp flips which later steps carry.  So against the Pallas kernel
(interpret mode) and ``run_xla``, on the probe's inputs: at most 0.1% of
elements differ, none by more than 2 bf16 ulps, counted at a magnitude of at
least 2^-10 (about five times LR, the size of one Adam step: an element
passing through zero has ulps far finer than the step that moves it).

The fast-math form (``form="fastmath"``; the probe's ``PROBE_FASTMATH``,
set here on the test's own copy of the probe module) goes through the same
three comparisons from both starting states.  Its one rsqrt is computed
differently by XLA's CPU backend and by PyTorch's CPU kernels (2 of 262,144
elements differed, by 2 ulps, at K = 10 from the warm state), so even the
op-by-op comparison holds the budget above and not bit-equality.  From the
warm state, where v is as small as 1e-8 and one step is therefore up to ten
times LR, a rounding that XLA's fused program flips moves p further: there
the fused routes are held to at most 0.1% of elements, 8 bf16 ulps (4 were
seen at K = 10, in the IEEE form as well) and the probe's own rtol/atol."""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lesionvae_tpu_torch.benchmarks import opt_probe
from lesionvae_tpu_torch.ops import resident_adam as ra

REPO = Path(__file__).resolve().parents[1]
T, P, BLK = 4, 65536, 65536
KS = [1, 10, 30]
MAX_SHARE, MAX_ULPS, ULP_FLOOR = 1e-3, 2, 2.0 ** -10
WARM_FUSED_ULPS = 8


@pytest.fixture(scope="module")
def probe():
    """benchmarks/pallas_opt_probe.py imported at a small size, without its
    TPU compile-cache set-up."""
    import lesionvae_tpu.utils.cache as cache

    mp = pytest.MonkeyPatch()
    mp.setenv("PROBE_T", str(T))
    mp.setenv("PROBE_P", str(P))
    mp.setenv("PROBE_BLK", str(BLK))
    mp.setattr(cache, "configure_cache", lambda *a, **k: None)
    try:
        spec = importlib.util.spec_from_file_location(
            "_pallas_opt_probe_small", REPO / "benchmarks" / "pallas_opt_probe.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        mp.undo()
    assert (mod.T, mod.P, mod.BLK) == (T, P, BLK)
    return mod


def _pallas_interpret(probe, p0, m0, v0, k, c):
    """The pallas_call of run_resident (pallas_opt_probe.py:137-153) with
    interpret=True; returns the whole (p, m, v)."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    rows_total, rows_blk = (T * P) // probe.LANES, BLK // probe.LANES
    spec = pl.BlockSpec((rows_blk, probe.LANES), lambda i: (i, 0),
                        memory_space=pltpu.VMEM)
    # a new function object every call: a trace is never reused across a
    # change of the probe's FASTMATH
    outs = pl.pallas_call(
        lambda *refs: probe._resident_kernel(*refs), grid=(rows_total // rows_blk,),
        in_specs=[pl.BlockSpec(memory_space=pltpu.SMEM)] * 2 + [spec] * 3,
        out_specs=(spec, spec, spec),
        out_shape=tuple(jax.ShapeDtypeStruct((rows_total, probe.LANES), jnp.bfloat16)
                        for _ in range(3)),
        interpret=True,
    )(jnp.asarray([k], jnp.int32), jnp.asarray([c], jnp.float32),
      *(x.reshape(rows_total, probe.LANES) for x in (p0, m0, v0)))
    return [np.asarray(o.astype(jnp.float32)).reshape(T, P) for o in outs]


def _jax_xla(probe, p0, m0, v0, k, c):
    """run_xla's scan body (pallas_opt_probe.py:102-115), returning the
    whole (p, m, v)."""
    def body(carry, _):
        p, m, v = carry
        g = probe.GA * p.astype(jnp.float32) + c
        p2, m2, v2 = probe._adam(p.astype(jnp.float32), m.astype(jnp.float32),
                                 v.astype(jnp.float32), g)
        return (p2.astype(jnp.bfloat16), m2.astype(jnp.bfloat16),
                v2.astype(jnp.bfloat16)), 0.0

    (p, m, v), _ = jax.jit(lambda a, b, d: jax.lax.scan(
        body, (a, b, d), None, length=k))(p0, m0, v0)
    return [np.asarray(x.astype(jnp.float32)) for x in (p, m, v)]


def _inputs(init):
    """bf16 (p, m, v): the probe's (p ~ 0.02 N(0,1), m = v = 0) or a warm
    state with nonzero moments; as torch tensors and as JAX arrays holding
    the same bf16 values."""
    if init == "probe":
        tp, tm, tv = opt_probe.make_inputs(T, P, device="cpu")
    else:
        g = np.random.default_rng(7)
        tp = torch.from_numpy(g.normal(size=(T, P)) * 0.02).to(torch.bfloat16)
        tm = torch.from_numpy(g.normal(size=(T, P)) * 1e-3).to(torch.bfloat16)
        tv = torch.from_numpy(np.abs(g.normal(size=(T, P))) * 1e-6).to(torch.bfloat16)
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tp, tm, tv)]
    return (tp, tm, tv), jx


def _jax_eager(probe, p, m, v, k, c):
    """The probe's step (pallas_opt_probe.py:92-99,108-112) evaluated op by
    op, without jit: one float32 rounding per operation."""
    for _ in range(k):
        g = probe.GA * p.astype(jnp.float32) + c
        p2, m2, v2 = probe._adam(p.astype(jnp.float32), m.astype(jnp.float32),
                                 v.astype(jnp.float32), g)
        p, m, v = (x.astype(jnp.bfloat16) for x in (p2, m2, v2))
    return [np.asarray(x.astype(jnp.float32)) for x in (p, m, v)]


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """|a - b| in bf16 ulps at max(|a|, |b|, ULP_FLOOR)."""
    mag = np.maximum(np.maximum(np.abs(a), np.abs(b)), ULP_FLOOR)
    return np.abs(a - b) / 2.0 ** (np.floor(np.log2(mag)) - 7)


def _assert_budget(got, want, k, max_ulps=MAX_ULPS):
    for name, a, b in zip("pmv", got, want):
        share = float(np.mean(a != b))
        assert share <= MAX_SHARE, (name, k, share)
        assert _ulps(a, b).max() <= max_ulps, (name, k, int(_ulps(a, b).max()))


def _assert_fused_budget(got, want, k, init):
    """The budget of a fused JAX route: see the note at the top."""
    _assert_budget(got, want, k, MAX_ULPS if init == "probe" else WARM_FUSED_ULPS)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=opt_probe.RTOL, atol=opt_probe.ATOL)


@pytest.mark.parametrize("init", ["probe", "warm"])
@pytest.mark.parametrize("k", KS)
def test_plain_equals_the_probe_step_bitwise(probe, init, k):
    (tp, tm, tv), jx = _inputs(init)
    want = _jax_eager(probe, *jx, k, probe.GC)
    got = [t.float().numpy() for t in ra.resident_adam_plain(tp, tm, tv, k, probe.GC)]
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("k", KS)
def test_plain_matches_pallas_kernel_interpret(probe, k):
    (tp, tm, tv), jx = _inputs("probe")
    want = _pallas_interpret(probe, *jx, k, probe.GC)
    got = [t.float().numpy() for t in ra.resident_adam_plain(tp, tm, tv, k, probe.GC)]
    _assert_budget(got, want, k)


@pytest.mark.parametrize("k", KS)
def test_plain_matches_run_xla(probe, k):
    (tp, tm, tv), jx = _inputs("probe")
    want = _jax_xla(probe, *jx, k, probe.GC)
    got = [t.float().numpy() for t in ra.resident_adam_plain(tp, tm, tv, k, probe.GC)]
    _assert_budget(got, want, k)


@pytest.mark.parametrize("k", [1, 10])
def test_probe_arms_match_jax_probe(probe, k):
    """The port's arms return the checksum and first row the JAX probe's
    arms return, within the probe's own tolerance; on CPU tensors both arms
    are the plain loop and launch nothing."""
    (tp, tm, tv), jx = _inputs("probe")
    j_sum, j_row = probe.run_xla(*jx, k, probe.GC)
    ra.resident_adam.launches = 0
    for arm in (opt_probe.run_plain, opt_probe.run_resident):
        s, row = arm(tp, tm, tv, k, probe.GC)
        assert row.shape == (1, opt_probe.LANES)
        np.testing.assert_allclose(row.float().numpy(), np.asarray(j_row, np.float32),
                                   rtol=opt_probe.RTOL, atol=opt_probe.ATOL)
        np.testing.assert_allclose(float(s), float(j_sum), rtol=1e-5)
    assert ra.resident_adam.launches == 0


@pytest.mark.parametrize("n", [1, 7, 8, 9, 4097])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_wrapper_on_cpu_is_the_plain_version(n, k):
    g = np.random.default_rng(n)
    p, m, v = (torch.from_numpy(np.abs(g.normal(size=n)) * s).to(torch.bfloat16)
               for s in (0.02, 1e-3, 1e-6))
    got = ra.resident_adam(p, m, v, k, 1e-3)
    want = ra.resident_adam_plain(p, m, v, k, 1e-3)
    for a, b, x in zip(got, want, (p, m, v)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        if k == 0:
            assert torch.equal(a, x)


FAST_KS = [1, 3, 10]


@pytest.fixture
def fast_probe(probe, monkeypatch):
    """The probe module with its fast-math step switched on for one test."""
    monkeypatch.setattr(probe, "FASTMATH", True)
    return probe


@pytest.mark.parametrize("init", ["probe", "warm"])
@pytest.mark.parametrize("k", FAST_KS)
def test_fastmath_plain_matches_the_probe_step(fast_probe, init, k):
    """Op by op.  Not bit-equal: rsqrt on the CPU is XLA's in one and
    PyTorch's in the other; hence the budget."""
    (tp, tm, tv), jx = _inputs(init)
    want = _jax_eager(fast_probe, *jx, k, fast_probe.GC)
    got = [t.float().numpy()
           for t in ra.resident_adam_plain(tp, tm, tv, k, fast_probe.GC, "fastmath")]
    _assert_budget(got, want, k)
    # m and v do not pass through the rsqrt until p has moved
    if k == 1:
        np.testing.assert_array_equal(got[1], want[1])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("init", ["probe", "warm"])
@pytest.mark.parametrize("k", FAST_KS)
def test_fastmath_plain_matches_run_xla(fast_probe, init, k):
    (tp, tm, tv), jx = _inputs(init)
    want = _jax_xla(fast_probe, *jx, k, fast_probe.GC)
    got = [t.float().numpy()
           for t in ra.resident_adam_plain(tp, tm, tv, k, fast_probe.GC, "fastmath")]
    _assert_fused_budget(got, want, k, init)


@pytest.mark.parametrize("init", ["probe", "warm"])
@pytest.mark.parametrize("k", FAST_KS)
def test_fastmath_plain_matches_pallas_kernel_interpret(fast_probe, init, k):
    (tp, tm, tv), jx = _inputs(init)
    want = _pallas_interpret(fast_probe, *jx, k, fast_probe.GC)
    got = [t.float().numpy()
           for t in ra.resident_adam_plain(tp, tm, tv, k, fast_probe.GC, "fastmath")]
    _assert_fused_budget(got, want, k, init)


def test_fastmath_switch_changes_the_jax_step(probe, monkeypatch):
    """The comparisons above really ran the other formula: with the switch on,
    the JAX step gives another p than with it off, through each route (in
    few elements: EPS is small beside the root of most v)."""
    _, jx = _inputs("warm")
    for route in (_jax_eager, _jax_xla, _pallas_interpret):
        ieee = route(probe, *jx, 3, probe.GC)[0]
        with monkeypatch.context() as mp:
            mp.setattr(probe, "FASTMATH", True)
            fast = route(probe, *jx, 3, probe.GC)[0]
        assert np.mean(ieee != fast) > 1e-4, route.__name__


def test_forms_differ_and_agree_to_the_step_size():
    """The two forms are different functions (eps outside the root or
    inside it) that stay within the probe's tolerance of each other."""
    (tp, tm, tv), _ = _inputs("warm")
    ieee = ra.resident_adam_plain(tp, tm, tv, 10, 1e-3)
    fast = ra.resident_adam_plain(tp, tm, tv, 10, 1e-3, "fastmath")
    assert not torch.equal(ieee[0], fast[0])
    np.testing.assert_allclose(fast[0].float().numpy(), ieee[0].float().numpy(),
                               rtol=opt_probe.RTOL, atol=opt_probe.ATOL)


@pytest.mark.parametrize("word", ["", "IEEE", "fast", "fast-math", None])
def test_form_is_one_of_two_words(word):
    p = torch.zeros(8, dtype=torch.bfloat16)
    for fn in (ra.resident_adam, ra.resident_adam_plain):
        with pytest.raises(ValueError, match="'ieee' or 'fastmath'"):
            fn(p, p, p, 1, 1e-3, form=word)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 4097])
@pytest.mark.parametrize("k", [0, 1, 3])
def test_fastmath_wrapper_on_cpu_is_the_plain_version(n, k):
    g = np.random.default_rng(n)
    p, m, v = (torch.from_numpy(np.abs(g.normal(size=n)) * s).to(torch.bfloat16)
               for s in (0.02, 1e-3, 1e-6))
    ra.resident_adam.launches = 0
    got = ra.resident_adam(p, m, v, k, 1e-3, form="fastmath")
    want = ra.resident_adam_plain(p, m, v, k, 1e-3, "fastmath")
    for a, b, x in zip(got, want, (p, m, v)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)
        if k == 0:
            assert torch.equal(a, x)
    assert ra.resident_adam.launches == 0


def _special_inputs():
    """Values the kernel's in-range quotient and root do not take: v = 0 with
    m = 0, a subnormal v, a huge v, inf and NaN in p, an infinite m."""
    g = np.random.default_rng(3)
    n = 64
    p = g.normal(size=n) * 0.02
    m = g.normal(size=n) * 1e-3
    v = np.abs(g.normal(size=n)) * 1e-6
    v[0::8], m[0::8] = 0.0, 0.0
    v[1::8] = 1e-39
    v[2::8] = 3e38
    p[3::8] = np.inf
    p[4::8] = np.nan
    m[5::8] = -np.inf
    tp, tm, tv = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
                  for x in (p, m, v))
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (tp, tm, tv)]
    return (tp, tm, tv), jx


@pytest.mark.parametrize("k", [1, 3])
def test_special_values_match_the_probe_step(probe, k):
    """Zero, subnormal, huge, infinite and NaN state through the IEEE plain
    loop and the probe's own step, op by op: equal bit for bit, NaN where
    the other has NaN."""
    (tp, tm, tv), jx = _special_inputs()
    assert float(tv.float()[1]) != 0.0   # the subnormal survives bf16
    want = _jax_eager(probe, *jx, k, probe.GC)
    got = [t.float().numpy() for t in ra.resident_adam_plain(tp, tm, tv, k, probe.GC)]
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_array_equal(a, b, err_msg=name)   # NaN == NaN here
    assert np.isnan(got[0][4]) and np.isnan(got[0][3])


@pytest.mark.parametrize("k", [1, 3])
def test_fastmath_special_values_match_the_probe_step(fast_probe, k):
    """The same through the fast-math step: NaN and inf at the same places,
    finite values within the budget."""
    (tp, tm, tv), jx = _special_inputs()
    want = _jax_eager(fast_probe, *jx, k, fast_probe.GC)
    got = [t.float().numpy()
           for t in ra.resident_adam_plain(tp, tm, tv, k, fast_probe.GC, "fastmath")]
    for name, a, b in zip("pmv", got, want):
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b), err_msg=name)
        np.testing.assert_array_equal(np.isinf(a), np.isinf(b), err_msg=name)
        ok = np.isfinite(a) & np.isfinite(b)
        assert _ulps(a[ok], b[ok]).max() <= MAX_ULPS, name


def test_kernel_checks_its_inputs():
    """What the kernel does not take raises before any launch."""
    p = torch.zeros(16, dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="bfloat16"):
        ra._check(p, p.float(), p)
    with pytest.raises(ValueError, match="shape"):
        ra._check(p, p[:8], p[:8])
    with pytest.raises(ValueError, match="contiguous"):
        wide = torch.zeros(16, 2, dtype=torch.bfloat16)
        ra._check(wide[:, 0], wide[:, 0], wide[:, 0])
    with pytest.raises(ValueError, match="aligned"):
        ra._check(p[1:9], p[1:9], p[1:9])


def test_probe_check_on_cpu_reports_every_k():
    inputs = opt_probe.make_inputs(2, 512, device="cpu")
    res = [opt_probe.check_k(*inputs, k) for k in (0, 2)]
    assert [r["k"] for r in res] == [0, 2]
    assert all(r["within_tol"] and r["share_differing"] == 0.0 for r in res)
    assert all(r["checksum_plain"] == r["checksum_resident"] for r in res)
    k30, k1 = opt_probe.bound_ms(64 * 2867200, 30), opt_probe.bound_ms(64 * 2867200, 1)
    assert k30["bound_by"] == "operations" and k1["bound_by"] == "bytes"
    np.testing.assert_allclose(k1["bound_ms"], 12 * 64 * 2867200 / 3.35e12 * 1e3)
    # the issue bound: the instructions of 30 steps over 132 SMs x 128 lanes
    # x 1.98 GHz, above the nominal bound; bytes at K = 1 for both forms
    np.testing.assert_allclose(k30["issue_bound_ms"],
                               27.5 * 64 * 2867200 * 30 / (132 * 128 * 1.98e9) * 1e3)
    assert k30["issue_bound_ms"] > k30["bound_ms"]
    for form in opt_probe.FORMS:
        bound = opt_probe.bound_ms(64 * 2867200, 1, form)
        assert bound["issue_bound_ms"] == bound["bound_ms"] == k1["bound_ms"]
    assert (opt_probe.bound_ms(64 * 2867200, 30, "fastmath")["issue_bound_ms"]
            < k30["issue_bound_ms"])


def test_probe_check_on_cpu_takes_the_fastmath_form():
    inputs = opt_probe.make_inputs(2, 512, device="cpu")
    res = opt_probe.check_k(*inputs, 3, form="fastmath")
    assert res["form"] == "fastmath" and res["share_differing"] == 0.0
    assert res["checksum_plain"] == res["checksum_resident"]
    assert res["checksum_plain"] != opt_probe.check_k(*inputs, 3)["checksum_plain"]


def test_compare_counts_nan_as_equal_and_reports_ulps():
    a = torch.tensor([1.0, float("nan"), float("inf"), 2.0]).to(torch.bfloat16)
    b = torch.tensor([1.0, float("nan"), float("inf"), 2.0 + 2 ** -6]).to(torch.bfloat16)
    same = opt_probe.compare((a,), (a.clone(),))
    assert same["share_differing"] == 0.0 and same["max_ulps"] == 0.0
    one = opt_probe.compare((a,), (b,))
    assert one["share_differing"] == 0.25 and one["max_ulps"] == 1.0
    nan_vs_number = opt_probe.compare((a,), (torch.ones(4).to(torch.bfloat16),))
    assert nan_vs_number["share_differing"] == 0.75 and not nan_vs_number["within_tol"]
