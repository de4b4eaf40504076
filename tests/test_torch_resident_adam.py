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
passing through zero has ulps far finer than the step that moves it)."""

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
    outs = pl.pallas_call(
        probe._resident_kernel, grid=(rows_total // rows_blk,),
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


def _assert_budget(got, want, k):
    for name, a, b in zip("pmv", got, want):
        share = float(np.mean(a != b))
        assert share <= MAX_SHARE, (name, k, share)
        assert _ulps(a, b).max() <= MAX_ULPS, (name, k, int(_ulps(a, b).max()))


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
    ms, by = opt_probe.bound_ms(64 * 2867200, 30)
    assert by == "operations" and opt_probe.bound_ms(64 * 2867200, 1)[1] == "bytes"
    np.testing.assert_allclose(opt_probe.bound_ms(64 * 2867200, 1)[0],
                               12 * 64 * 2867200 / 3.35e12 * 1e3)
