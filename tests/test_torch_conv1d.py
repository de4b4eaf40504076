"""The fleet's convolutions (``ops/conv1d.py``) against the JAX package's
``Conv1d`` / ``ConvTranspose1d`` (lesionvae_tpu/models/layers.py:165-213)
under ``jax.vmap`` over the members, with ``jax.grad`` for the gradients of
the input, the kernel and the bias; the hand-written backward against
autograd through the plain forward; a bf16 case; the kernels' row geometry
(padded rows, staged tiles, split ranges), read from the kernels' source,
written out in numpy and held to the plain version; and the step's FLOP
and byte counts against a hand count.  The CUDA kernels themselves run only on the card (chip_smoke.py)."""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lesionvae_tpu.models import layers as jlayers
from lesionvae_tpu_torch.models.convert import conv_weight
from lesionvae_tpu_torch.models.layers import KERNEL, PADDING
from lesionvae_tpu_torch.ops import conv1d, cuda_build
from lesionvae_tpu_torch.utils import cost_model as tcm

torch.set_num_threads(1)

T = 3          # members, each with its own weights
# the eight layer kinds of the step at narrow widths: (L, C_in, C_out,
# transposed), named after the layer whose kind and length they take
LAYERS = {"micro_c1": (100, 13, 5, False), "micro_c2": (50, 5, 13, False),
          "micro_c3": (25, 13, 13, False), "lesion_c1": (100, 3, 5, False),
          "lesion_c2": (50, 5, 3, False), "dec_t1": (12, 13, 5, True),
          "dec_t2": (24, 5, 5, True), "dec_t3": (48, 5, 13, True)}


def _inputs(L, cin, cout, n=2, seed=0):
    """h (T, n, L, C_in), flax kernels (T, 5, C_in, C_out), biases (T, C_out)
    and an upstream gradient (T, n, L, C_out), float64, a member each its own."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(T, n, L, cin)), rng.normal(size=(T, KERNEL, cin, cout)) * 0.3,
            rng.normal(size=(T, cout)), rng.normal(size=(T, n, L, cout)))


def _jax(h, kernel, bias, dy, transposed):
    """(y, dh, dkernel, dbias) of the flax layer vmapped over the members;
    the gradients of sum(y * dy) by jax.grad."""
    cout = kernel.shape[-1]
    layer = (jlayers.ConvTranspose1d if transposed else jlayers.Conv1d)(cout)

    def one(x, k, b):
        return layer.apply({"params": {"conv": {"kernel": k, "bias": b}}}, x)

    def loss(x, k, b, g):
        return jnp.sum(one(x, k, b) * g)

    y = jax.vmap(one)(h, kernel, bias)
    grads = jax.vmap(jax.grad(loss, argnums=(0, 1, 2)))(h, kernel, bias, dy)
    return [np.asarray(a) for a in (y, *grads)]


def _port_weight(kernel, transposed):
    return torch.from_numpy(np.stack([conv_weight(k, transposed) for k in kernel]).copy())


def test_constants_are_the_models():
    assert (conv1d.TAPS, conv1d.PAD) == (KERNEL, PADDING) == (5, 2)


@pytest.mark.parametrize("name", list(LAYERS))
def test_plain_matches_vmapped_jax_layer_f64(name):
    """Forward and the three gradients to 1e-10 in float64, through
    ``fleet_conv1d`` (the plain versions on the CPU) and autograd."""
    L, cin, cout, transposed = LAYERS[name]
    h, kernel, bias, dy = _inputs(L, cin, cout, seed=len(name))
    want = _jax(h, kernel, bias, dy, transposed)
    ht = torch.from_numpy(h).requires_grad_()
    w = _port_weight(kernel, transposed).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = conv1d.fleet_conv1d(ht, w, b, transposed)
    dh, dw, db = torch.autograd.grad(y, (ht, w, b), torch.from_numpy(dy))
    # the flax kernel's gradient carried into the port's layout, as the weights are
    want[2] = np.stack([conv_weight(k, transposed) for k in want[2]])
    got = [y.detach().numpy(), dh.numpy(), dw.numpy(), db.numpy()]
    for what, g, wnt in zip(("y", "dh", "dw", "db"), got, want):
        np.testing.assert_allclose(g, wnt, rtol=0, atol=1e-10, err_msg=f"{name} {what}")
    # the members differ: each used its own weights
    assert np.abs(want[0][0] - want[0][1]).max() > 1e-3


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("need_dh", [True, False])
def test_backward_equals_autograd_through_the_plain_forward(transposed, need_dh):
    """``conv1d_backward_plain`` (and the ``Function``'s backward, which runs
    it on the CPU) against ``torch.autograd.grad`` through ``conv1d_plain``,
    in float64: the same products summed in another order by the CPU's
    BLAS, so to 1e-12; dw in the leaf's own layout, contiguous; no dh where
    the input needs no gradient."""
    L, cin, cout = 25, 13, 5
    h, kernel, bias, dy = _inputs(L, cin, cout, n=3, seed=7)
    h, b, dy = torch.from_numpy(h), torch.from_numpy(bias), torch.from_numpy(dy)
    w = _port_weight(kernel, transposed)
    leaves = [t.clone().requires_grad_() for t in (h, w, b)]
    y = conv1d.conv1d_plain(*leaves, transposed)
    want = torch.autograd.grad(y, leaves, dy)
    dh, dw, db = conv1d.conv1d_backward_plain(h, w, dy, transposed, need_dh)
    assert dw.shape == w.shape and dw.is_contiguous() and db.shape == b.shape
    for g, wnt in zip((dh, dw, db), want):
        if g is not None:
            torch.testing.assert_close(g, wnt, rtol=0, atol=1e-12)
    assert (dh is None) != need_dh
    hf = h.clone().requires_grad_(need_dh)
    wf, bf = w.clone().requires_grad_(), b.clone().requires_grad_()
    y = conv1d.fleet_conv1d(hf, wf, bf, transposed)
    got = torch.autograd.grad(y, [t for t in (hf, wf, bf) if t.requires_grad], dy)
    assert all(torch.equal(g, x) for g, x in zip(got, [t for t in (dh, dw, db)
                                                       if t is not None]))


def test_dh_is_skipped_where_the_input_takes_no_gradient(monkeypatch):
    """micro_c1 and lesion_c1 take the input data: their backward runs no
    convolution for dh."""
    calls = []
    plain = conv1d.conv1d_plain
    monkeypatch.setattr(conv1d, "conv1d_plain",
                        lambda *a: calls.append(a[3]) or plain(*a))
    h, kernel, bias, dy = _inputs(100, 3, 5)
    w = _port_weight(kernel, False).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    y = conv1d.fleet_conv1d(torch.from_numpy(h), w, b, False)
    y.backward(torch.from_numpy(dy))
    assert calls == [False] and w.grad.shape == w.shape


def test_bf16_plain_holds_to_its_rounding():
    """bf16 inputs through ``fleet_conv1d`` on the CPU against the float64
    product of the same (bf16) inputs: each output within 2^-7 x max(1,
    |exact|), twice the 2^-8 that rounding the exact value once to bf16 can
    give (read 3.9e-3: the CPU's bf16 products and sums carry float32 and
    round once)."""
    L, cin, cout = 24, 13, 13
    h, kernel, bias, dy = _inputs(L, cin, cout, seed=3)
    for transposed in (False, True):
        x64 = [torch.from_numpy(a).to(torch.bfloat16).double()
               for a in (h, bias, dy)]
        w64 = _port_weight(kernel, transposed).to(torch.bfloat16).double()
        leaves16 = [t.to(torch.bfloat16).requires_grad_() for t in (x64[0], w64, x64[1])]
        leaves64 = [t.clone().requires_grad_() for t in (x64[0], w64, x64[1])]
        y16 = conv1d.fleet_conv1d(*leaves16, transposed)
        y64 = conv1d.fleet_conv1d(*leaves64, transposed)
        g16 = torch.autograd.grad(y16, leaves16, x64[2].to(torch.bfloat16))
        g64 = torch.autograd.grad(y64, leaves64, x64[2])
        assert y16.dtype == torch.bfloat16 and all(g.dtype == torch.bfloat16 for g in g16)
        for what, got, want in zip(("y", "dh", "dw", "db"), (y16, *g16), (y64, *g64)):
            err = ((got.double() - want).abs() / want.abs().clamp(min=1.0)).max().detach()
            assert float(err) <= 2.0 ** -7, (transposed, what, float(err))


# ------------------------------------------------------------ the kernels' geometry
# csrc/conv1d.cu, read from the source: its tile constants, and its row
# geometry (padded, staged_rows) as written there
_CU = (cuda_build.CSRC / "conv1d.cu").read_text()
_PADDED = "return n * (L + 4) + (r - n * L) + 2;"
_STAGED = "return rows + 4 + 4 * ((rows - 1 + L - 1) / L);"


def _cu_constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", _CU).group(1))


def _padded_row(r, L):
    """Row r = (n, l) of a member in its padded rows, where each sample has
    two zero rows before and after it (csrc/conv1d.cu: padded, _PADDED).  A
    tile of rows r0..r1 reads padded rows _padded_row(r0) - 2 ..
    _padded_row(r1) + 2, one contiguous range the kernels stage."""
    n = r // L
    return n * (L + 4) + (r - n * L) + 2


def _staged_rows(rows, L):
    """The most padded rows a tile of ``rows`` rows stages: its rows, two
    before and after, and four a sample boundary inside it
    (csrc/conv1d.cu: staged_rows, _STAGED)."""
    return rows + 4 + 4 * ((rows - 1 + L - 1) // L)


def _cu_f32_tiles():
    """csrc/conv1d.cu's F32_FNS table: (output channels, rows a thread,
    threads) of each float32 conv_fwd kernel function, in its order."""
    table = re.search(r"const F32Fn F32_FNS\[\] = \{(.*?)\};", _CU, re.S).group(1)
    value = {"F32_TM": _cu_constant("F32_TM"), "F32_THREADS": _cu_constant("F32_THREADS")}
    return tuple(tuple(int(value.get(a, a)) for a in t)
                 for t in re.findall(r"F32_FN\((\w+), (\w+), (\w+)\)", table))


def test_kernel_source_holds_the_same_constants_and_geometry():
    """csrc/conv1d.cu's taps and weight-gradient channel tiles are the
    host's, its output tiles by C_out are ``fwd_tile``'s, its float32
    forward tiles, their rule and the kernel function of each are
    ``fwd_f32_tile``'s, and its row geometry and row split are the ones the
    mirrors below write out."""
    for name, value in (("TAPS", conv1d.TAPS), ("WG_BI", conv1d.WGRAD_F32_IN),
                        ("WH_BO", conv1d.WGRAD_BF16_OUT), ("WH_BI", conv1d.WGRAD_BF16_IN),
                        ("SMS", conv1d.SMS), ("F32_THREADS", conv1d.F32_FULL_THREADS),
                        ("F32_TM", conv1d.F32_FULL_ROWS), ("F32_TN", conv1d.F32_CHANNELS)):
        assert _cu_constant(name) == value, name
    assert conv1d.SMS == tcm.H100_SMS
    assert "int fwd_bn(int cout) { return cout <= 16 ? 16 : (cout <= 32 ? 32 : 64); }" in _CU
    assert [conv1d.fwd_tile(c) for c in (1, 16, 17, 32, 33, 640)] == [16, 16, 32, 32, 64, 64]
    full = tuple((c, conv1d.F32_FULL_ROWS, conv1d.F32_FULL_THREADS) for c in (16, 32, 64))
    assert _cu_f32_tiles() == full + conv1d.F32_SMALL_TILES
    assert "constexpr int N_FULL = 3, N_F32 = sizeof(F32_FNS) / sizeof(F32_FNS[0]);" in _CU
    assert ("#define F32_FN(BN, TM, THREADS) {{BN, TM, THREADS}, "
            "conv_fwd_f32<BN, TM, THREADS>}") in _CU
    assert "return threads / (bn / F32_TN) * tm;" in _CU
    assert "while (F32_FNS[full].tile.bn != fwd_bn(cout)) ++full;" in _CU
    assert "if (f32_blocks(F32_FNS[full].tile, T, R, cout) >= SMS) return F32_FNS[full];" in _CU
    assert "if (f32_blocks(F32_FNS[i].tile, T, R, cout) >= SMS) return F32_FNS[i];" in _CU
    assert "return F32_FNS[N_F32 - 1];" in _CU
    # the attribute query's order (KERNELS), as KERNEL_FUNCTIONS names it
    assert "    F32_KERNEL(0), F32_KERNEL(1), F32_KERNEL(2),\n" in _CU
    assert "    F32_KERNEL(3), F32_KERNEL(4), F32_KERNEL(5), F32_KERNEL(6), F32_KERNEL(7)};" in _CU
    assert conv1d.KERNEL_FUNCTIONS[-5:] == tuple(f"conv_fwd_f32<{bn},{tm},{th}>"
                                                 for bn, tm, th in conv1d.F32_SMALL_TILES)
    assert ("return static_cast<long long>((R + rows - 1) / rows) * ((cout + t.bn - 1) / t.bn) "
            "* T;") in _CU
    assert _PADDED in _CU and _STAGED in _CU
    assert "*ra = static_cast<int>(static_cast<long long>(g.R) * sp / splits);" in _CU
    assert "*rb = static_cast<int>(static_cast<long long>(g.R) * (sp + 1) / splits);" in _CU
    assert "staged_rows(f32_rows(t.bn, t.tm, t.threads), L)" in _CU
    assert "staged_rows(BF16_ROWS, L)" in _CU
    assert "staged_rows(WG_BR, g.L)" in _CU and "staged_rows(WH_BR, g.L)" in _CU


def _staged(h, p0, rows):
    """The staged tile of one member's rows h (N, L, C): padded rows p0 ..
    p0 + rows - 1, a zero row outside the samples (csrc/conv1d.cu:
    source_offset)."""
    N, L, C = h.shape
    out = np.zeros((rows, C))
    for s in range(rows):
        n, rest = divmod(p0 + s, L + 4)
        if n < N and 2 <= rest < L + 2:
            out[s] = h[n, rest - 2]
    return out


def _mirror_fwd(h, W, b, bm):
    """One member's conv_fwd written out: tiles of ``bm`` rows, each staging
    its padded range, output row r at tap k reading staged row
    _padded_row(r) - p0 - 2 + k.  h (N, L, C_in), W (5, C_in, C_out)."""
    N, L, C = h.shape
    R = N * L
    y = np.zeros((R, W.shape[2]))
    for r0 in range(0, R, bm):
        r_end = min(r0 + bm, R)
        p0 = _padded_row(r0, L) - 2
        rows = _padded_row(r_end - 1, L) - p0 + 3
        assert rows <= _staged_rows(bm, L)
        xs = _staged(h, p0, rows)
        base = np.array([_padded_row(r, L) - p0 - 2 for r in range(r0, r_end)])
        y[r0:r_end] = b + sum(xs[base + k] @ W[k] for k in range(conv1d.TAPS))
    return y.reshape(N, L, -1)


def _mirror_wgrad(h, dy, splits, stage):
    """One member's conv_wgrad partials written out: ``splits`` ranges of
    rows R * s // splits .. R * (s + 1) // splits, each in stages of
    ``stage`` rows; G[o, i, k] and db summed split by split.  h (N, L,
    C_in), dy (N, L, C_out)."""
    N, L, C = h.shape
    R = N * L
    dyr = dy.reshape(R, -1)
    G, db = np.zeros((dyr.shape[1], C, conv1d.TAPS)), np.zeros(dyr.shape[1])
    for sp in range(splits):
        ra, rb = R * sp // splits, R * (sp + 1) // splits
        for rs in range(ra, rb, stage):
            n = min(stage, rb - rs)
            p0 = _padded_row(rs, L) - 2
            rows = _padded_row(rs + n - 1, L) - p0 + 3
            assert rows <= _staged_rows(stage, L)
            xs = _staged(h, p0, rows)
            base = np.array([_padded_row(r, L) - p0 - 2 for r in range(rs, rs + n)])
            for k in range(conv1d.TAPS):
                G[:, :, k] += dyr[rs:rs + n].T @ xs[base + k]
            db += dyr[rs:rs + n].sum(axis=0)
    return G, db


@pytest.mark.parametrize("N,L,cin,cout", [(3, 100, 13, 5), (5, 25, 3, 13), (7, 12, 5, 40),
                                          (40, 1, 3, 3), (2, 48, 20, 70)])
def test_kernel_tiles_read_the_rows_the_plain_version_reads(N, L, cin, cout):
    """The kernels' row geometry, in float64 numpy: the forward's tiles
    (the float32 ones at every row count a tile of ``fwd_f32_tile`` takes,
    the full tiles by C_out and the smaller ones, and the bf16 ones) and
    the weight gradient's split ranges and stages (float32 and bf16) give
    the plain version's y, dw and db, at ragged tiles, short samples (L = 1,
    12, 25) and narrow and odd channel counts."""
    rng = np.random.default_rng(N * L)
    h = rng.normal(size=(1, N, L, cin))
    w = rng.normal(size=(1, cout, cin, conv1d.TAPS))
    b = rng.normal(size=(1, cout))
    dy = rng.normal(size=(1, N, L, cout))
    ht, wt, bt, dyt = map(torch.from_numpy, (h, w, b, dy))
    want = conv1d.conv1d_plain(ht, wt, bt, False)[0].numpy()
    W = w[0].transpose(2, 1, 0)                   # (5, C_in, C_out) at tap k
    f32 = {bm for c in (16, 32, 64) for bm, _bn, _threads in conv1d.fwd_f32_tiles(c)}
    assert sorted(f32) == [16, 32, 64, 128, 256, 512]
    for bm in sorted({*f32, _cu_constant("BF16_ROWS")}):
        np.testing.assert_allclose(_mirror_fwd(h[0], W, b[0], bm), want, atol=1e-12)
    dw, db = conv1d.conv_wgrad_plain(ht, dyt, False)
    for dtype, stage in ((torch.float32, _cu_constant("WG_BR")),
                         (torch.bfloat16, _cu_constant("WH_BR"))):
        for splits in sorted({1, 3, conv1d.wgrad_splits(64, N * L, cin, cout, dtype)}):
            if splits <= N * L:
                G, gdb = _mirror_wgrad(h[0], dy[0], splits, stage)
                np.testing.assert_allclose(G, dw[0].numpy(), atol=1e-11)
                np.testing.assert_allclose(gdb, db[0].numpy(), atol=1e-11)


def test_input_gradient_is_the_flipped_swapped_convolution():
    """dh of a Conv1d is the ConvTranspose1d of dy with the same leaf, and
    the other way round: what lets conv_fwd serve the input gradient."""
    h, kernel, bias, dy = _inputs(25, 13, 5, seed=11)
    for transposed in (False, True):
        w = _port_weight(kernel, transposed)
        ht = torch.from_numpy(h).requires_grad_()
        y = conv1d.conv1d_plain(ht, w, torch.from_numpy(bias), transposed)
        (want,) = torch.autograd.grad(y, ht, torch.from_numpy(dy))
        got = conv1d.conv1d_plain(torch.from_numpy(dy), w, None, not transposed)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


# the full-width path's layers at 64 members x batch 64: (name, splits a
# member's rows take in float32 and in bf16)
PATH_SPLITS = {"micro_c1": (17, 8), "micro_c2": (3, 3), "micro_c3": (2, 2),
               "lesion_c1": (17, 8), "lesion_c2": (9, 8), "dec_t1": (3, 3),
               "dec_t2": (5, 5), "dec_t3": (5, 5)}


def test_wgrad_splits_at_the_paths_shapes():
    """The row split is a function of the shapes: at the path's layers it
    keeps every range at least MIN_SPLIT_ROWS rows and gives 64 members
    enough blocks to fill the card."""
    for name, (L, cin, cout, _t) in tcm.conv_layers().items():
        got = tuple(conv1d.wgrad_splits(64, 64 * L, cin, cout, dt)
                    for dt in (torch.float32, torch.bfloat16))
        assert got == PATH_SPLITS[name], name
        assert all(64 * L // s >= conv1d.MIN_SPLIT_ROWS for s in got)
        assert got[1] <= conv1d.WGRAD_BF16_MAX_SPLITS
    assert conv1d.wgrad_splits(1, 7, 3, 3, torch.float32) == 1


# ------------------------------------------------------------ the bf16 kernels' ring and cluster
def test_bf16_constants_are_the_sources():
    """The bf16 weight gradient's cluster bound (WH_MAX_SPLITS) and its
    channel tiles by C_out and C_in are the host's, and the entry point
    refuses more splits than a cluster holds."""
    assert _cu_constant("WH_MAX_SPLITS") == conv1d.WGRAD_BF16_MAX_SPLITS == 8
    assert "int wh_bo(int cout) { return cout <= 32 ? 32 : WH_BO; }" in _CU
    assert "int wh_bi(int cin) { return cin <= 16 ? 16 : WH_BI; }" in _CU
    assert "constexpr int WO = BO / 32, WI = BI / 16, KS = 4 / (WO * WI);" in _CU
    assert "for (int ks = kslice; ks < (n + 15) / 16; ks += KS) {" in _CU
    for bo, bi in ((64, 32), (64, 16), (32, 32), (32, 16)):
        assert f"conv_wgrad_bf16<{bo}, {bi}>" in _CU
        assert f"conv_wgrad_bf16<{bo},{bi}>" in conv1d.KERNEL_FUNCTIONS
    assert "(bf && splits > WH_MAX_SPLITS)" in _CU
    assert "attr[0].val.clusterDim.z = splits;" in _CU
    assert "constexpr uint32_t BF16_ONES = 0x3F803F80u;" in _CU
    # 0x3F80 is bfloat16's 1.0: the top half of float32's 1.0
    assert np.float32(1.0).view(np.uint32) >> 16 == 0x3F80


def _ring(items, stages):
    """The bf16 kernels' ring of ``stages`` slots over ``items`` stages
    (conv_wgrad_bf16: stages of rows; conv_fwd_bf16: chunks of input
    channels), as csrc/conv1d.cu writes it: items 0 .. stages - 2 issued
    (one cp.async group each, empty past the last item) before the loop;
    at iteration j the thread waits until at most stages - 2 of its groups
    are in flight, passes the block's barrier, issues item j + stages - 1
    into slot (j + stages - 1) % stages, commits a group and computes item
    j from slot j % stages.  Returns the events in order: ("issue", item,
    slot, j), ("land", item, j) where the wait lets the item's group go, and
    ("compute", item, slot, j); j is -1 before the loop."""
    events, groups, landed = [], [], 0
    for j in range(stages - 1):
        if j < items:
            events.append(("issue", j, j % stages, -1))
        groups.append(j if j < items else None)
    for j in range(items):
        while len(groups) - landed > stages - 2:
            if groups[landed] is not None:
                events.append(("land", groups[landed], j))
            landed += 1
        jn = j + stages - 1
        if jn < items:
            events.append(("issue", jn, jn % stages, j))
        groups.append(jn if jn < items else None)
        events.append(("compute", j, j % stages, j))
    return events


@pytest.mark.parametrize("stages", [2, 3, 4, "WH_STAGES", "FWD_STAGES"])
@pytest.mark.parametrize("items", [1, 2, 3, 4, 5, 9, 13, 40])
def test_bf16_ring_computes_each_stage_once_after_it_lands(items, stages):
    """The ring's schedule: every item is issued and computed once, each
    after its copies landed (the wait before the barrier of its iteration),
    and a slot is written again only in an iteration after the one that
    computed from it, across the barrier that every warp passes first."""
    if isinstance(stages, str):
        name = stages
        stages = _cu_constant(name)
        assert f"cp_async_wait<{name} - 2>();" in _CU and f"const int jn = j + {name} - 1;" in _CU
    events = _ring(items, stages)
    issued = [e for e in events if e[0] == "issue"]
    computed = [e for e in events if e[0] == "compute"]
    assert [e[1] for e in issued] == list(range(items)) == [e[1] for e in computed]
    for item in range(items):
        at = {e[0]: events.index(e) for e in events if e[1] == item}
        assert at["issue"] < at["land"] < at["compute"]
    for _, item, slot, j in computed:
        later = [e for e in issued if e[2] == slot and e[1] > item]
        assert all(e[3] > j for e in later)


def _mirror_wgrad_bf16(h, dy, transposed, splits):
    """One member's bf16 conv_wgrad written out in float64 numpy: channel
    tiles of ``wgrad_bf16_tile``; ``splits`` ranges of rows, one a block of
    the tile's cluster, each in stages of WH_BR rows staged as the
    plain-loads mirror above stages them; a block's KS k-slices (the warps
    a smaller tile leaves over) each sum every KS-th 16-row step, and their
    sums are added in k-slice order into G[o, i, k], db from the tensor
    cores' product of each step's dy^T by a B fragment of ones; then block
    sp writes outputs [E sp / splits, E (sp + 1) / splits) of the tile, E
    its real outputs in the leaf's order, each the blocks' sums in split
    order.  Returns dw in the leaf's layout, db, and how often each element
    of dw was written."""
    N, L, C = h.shape
    R, cout = N * L, dy.shape[-1]
    dyr = dy.reshape(R, cout)
    BO, BI = conv1d.wgrad_bf16_tile(C, cout)
    BR = _cu_constant("WH_BR")
    KS = 4 // ((BO // 32) * (BI // 16))
    K = conv1d.TAPS
    shape = (C, cout, K) if transposed else (cout, C, K)
    dw, writes, db = np.zeros(shape), np.zeros(shape, dtype=int), np.zeros(cout)
    ones = np.ones((16, 8))
    for o0 in range(0, cout, BO):
        for i0 in range(0, C, BI):
            no, ni = min(BO, cout - o0), min(BI, C - i0)
            G = np.zeros((splits, KS, no, ni, K))
            dbs = np.zeros((splits, KS, no))
            for sp in range(splits):
                ra, rb = R * sp // splits, R * (sp + 1) // splits
                for rs in range(ra, rb, BR):
                    n = min(BR, rb - rs)
                    p0 = _padded_row(rs, L) - 2
                    rows = _padded_row(rs + n - 1, L) - p0 + 3
                    assert rows <= _staged_rows(BR, L)
                    xs = _staged(h, p0, rows)[:, i0:i0 + ni]
                    base = np.array([_padded_row(r, L) - p0 - 2 for r in range(rs, rs + n)])
                    d = dyr[rs:rs + n, o0:o0 + no]
                    for ks in range(0, n, 16):
                        step, at = slice(ks, ks + 16), base[ks:ks + 16]
                        for k in range(K):
                            G[sp, ks // 16 % KS, :, :, k] += d[step].T @ xs[at + k]
                        dbs[sp, ks // 16 % KS] += (d[step].T @ ones[:len(at)])[:, 0]
            G, dbs = G.sum(axis=1), dbs.sum(axis=1)
            E = no * ni * K
            for sp in range(splits):
                for e in range(E * sp // splits, E * (sp + 1) // splits):
                    if transposed:
                        i, rest = divmod(e, no * K)
                        o, kk = divmod(rest, K)
                        at, k = (i0 + i, o0 + o, kk), K - 1 - kk
                    else:
                        o, rest = divmod(e, ni * K)
                        i, k = divmod(rest, K)
                        at = (o0 + o, i0 + i, k)
                    dw[at] = sum(G[r, o, i, k] for r in range(splits))
                    writes[at] += 1
            if i0 == 0:
                db[o0:o0 + no] = dbs.sum(axis=0)
    return dw, db, writes


@pytest.mark.parametrize("N,L,cin,cout,transposed", [
    (3, 100, 13, 64, False), (5, 100, 3, 32, False), (2, 25, 70, 130, False),
    (2, 12, 128, 64, True), (4, 48, 64, 13, True), (40, 1, 3, 3, True), (7, 24, 33, 65, True)])
def test_bf16_wgrad_cluster_writes_each_output_once_in_the_leafs_layout(N, L, cin, cout,
                                                                        transposed):
    """The bf16 weight gradient's row geometry and cluster sum, in float64
    numpy: at the splits the kernel takes (``wgrad_splits``) and at 1, 3
    and a cluster's most, the blocks' shares of each tile cover every
    output of dw once, in the leaf's own layout (reversed along k for a
    ConvTranspose1d), and give the plain version's dw; db from the product
    of dy^T by ones gives its db."""
    rng = np.random.default_rng(N * L + cin)
    h = rng.normal(size=(1, N, L, cin))
    dy = rng.normal(size=(1, N, L, cout))
    want_dw, want_db = conv1d.conv_wgrad_plain(torch.from_numpy(h), torch.from_numpy(dy),
                                               transposed)
    path = conv1d.wgrad_splits(64, N * L, cin, cout, torch.bfloat16)
    for splits in sorted({1, 3, conv1d.WGRAD_BF16_MAX_SPLITS, path}):
        if splits > N * L:
            continue
        dw, db, writes = _mirror_wgrad_bf16(h[0], dy[0], transposed, splits)
        assert (writes == 1).all(), splits
        np.testing.assert_allclose(dw, want_dw[0].numpy(), atol=1e-10)
        np.testing.assert_allclose(db, want_db[0].numpy(), atol=1e-10)


@pytest.mark.parametrize("T", [1, 2, 8, 64])
def test_bf16_wgrad_splits_fit_a_cluster_and_read_the_shapes_alone(T):
    """wgrad_splits' bf16 branch: about WGRAD_BF16_TARGET blocks over the
    member's channel tiles, each range at least MIN_SPLIT_ROWS rows, at
    most a cluster's WGRAD_BF16_MAX_SPLITS, at least 1; the same value at
    every call from the same shapes."""
    rng = np.random.default_rng(T)
    for _ in range(500):
        rows, cin, cout = int(rng.integers(1, 9000)), int(rng.integers(1, 300)), \
            int(rng.integers(1, 300))
        got = conv1d.wgrad_splits(T, rows, cin, cout, torch.bfloat16)
        tiles = -(-cout // conv1d.WGRAD_BF16_OUT) * -(-cin // conv1d.WGRAD_BF16_IN)
        want = min(-(-conv1d.WGRAD_BF16_TARGET // (T * tiles)), rows // conv1d.MIN_SPLIT_ROWS,
                   conv1d.WGRAD_BF16_MAX_SPLITS)
        assert got == max(1, want) == conv1d.wgrad_splits(T, rows, cin, cout, torch.bfloat16)
        assert 1 <= got <= conv1d.WGRAD_BF16_MAX_SPLITS


@pytest.mark.parametrize("c_in,c_out,want", [
    (3, 32, (32, 16)), (13, 64, (64, 16)), (16, 16, (32, 16)), (17, 33, (64, 32)),
    (64, 13, (32, 32)), (128, 128, (64, 32)), (32, 64, (64, 32)), (130, 70, (64, 32))])
def test_bf16_wgrad_tile_reads_the_channels_alone(c_in, c_out, want):
    """The bf16 weight gradient's channel tile from C_in and C_out alone
    (csrc/conv1d.cu: wh_bo, wh_bi): 32 output or 16 input channels where the
    layer's fit in them, else 64 x 32, so a layer takes as many tiles as the
    full tile gives it and the rows' split stays the same."""
    tile = conv1d.wgrad_bf16_tile(c_in, c_out)
    assert tile == want
    bo, bi = tile
    full = -(-c_out // conv1d.WGRAD_BF16_OUT) * -(-c_in // conv1d.WGRAD_BF16_IN)
    assert -(-c_out // bo) * -(-c_in // bi) == full


# csrc/conv1d.cu's bf16 shared memory a block, as written there
_WH_SLOT = ("return WH_BR * (bo + 8) * 2 + (staged_rows(WH_BR, L) + TAPS) * (bi + 8) * 2 + "
            "WH_BR * 4;")
_FWD_SLOT = "return (TAPS * bn + staged_rows(BF16_ROWS, L)) * BF16_ROW * 2;"


@pytest.mark.parametrize("L", sorted({L for L, *_ in tcm.conv_layers().values()}))
def test_bf16_rings_fit_the_blocks_an_sm_at_the_paths_lengths(L):
    """At each layer length of the step, the bf16 weight gradient's ring of
    WH_STAGES slots leaves room for three blocks an SM at every channel tile
    and holds the block's sums for the cluster (BO output channels of BI *
    5 + 1 floats, and db); the forward's ring of FWD_STAGES chunks and its
    row table leave room for two blocks an SM at every output tile."""
    c = {k: _cu_constant(k) for k in ("WH_BR", "WH_STAGES", "TAPS", "BF16_ROWS", "BF16_ROW",
                                      "FWD_STAGES", "MAX_SHARED")}
    assert _WH_SLOT in _CU and _FWD_SLOT in _CU
    assert "constexpr int DROW = BO + 8, XROW = BI + 8, RROW = BI * TAPS + 1;" in _CU
    for bo, bi in ((64, 32), (64, 16), (32, 32), (32, 16)):
        slot = (c["WH_BR"] * (bo + 8) * 2
                + (_staged_rows(c["WH_BR"], L) + c["TAPS"]) * (bi + 8) * 2 + c["WH_BR"] * 4)
        sums = (bo * (bi * c["TAPS"] + 1) + bo) * 4
        assert sums <= c["WH_STAGES"] * slot <= c["MAX_SHARED"] // 3, (bo, bi)
    staged = _staged_rows(c["BF16_ROWS"], L)
    for bn in (16, 32, 64):
        fwd = c["FWD_STAGES"] * (c["TAPS"] * bn + staged) * c["BF16_ROW"] * 2 + staged * 4
        assert fwd <= c["MAX_SHARED"] // 2, bn


def _path_launches(T, batch):
    """(rows, C_out) of the float32 conv_fwd launches of a training step at
    the full widths (eight forwards and the six dx; micro_c1 and lesion_c1
    take the input data) and of an eval forward (the eight forwards)."""
    train, evals = [], []
    for name, (L, cin, cout, _t) in tcm.conv_layers().items():
        train.append((batch * L, cout))
        evals.append((batch * L, cout))
        if name not in tcm.CONV_INPUT_LAYERS:
            train.append((batch * L, cin))
    return train, evals


def _blocks(T, rows, c_out, tile):
    bm, bn, _threads = tile
    return -(-rows // bm) * -(-c_out // bn) * T


# the float32 forward's one tile before the rule, (rows, output channels,
# threads) by C_out: 8192 outputs a block, 256 threads
FULL_TILES = {16: (512, 16, 256), 32: (256, 32, 256), 64: (128, 64, 256)}


@pytest.mark.parametrize("batch", [64, 960])
def test_fwd_f32_tile_keeps_the_full_tile_on_the_fleets_path(batch):
    """64 members (the cohort fleet), a training batch of 64 or a member's
    960 padded rows (the summary's eval forwards): all 22 launches (14 a
    training step, 8 an eval forward) take the tile every launch took
    before the rule, so the fleet's kernels, grids and bits stay."""
    train, evals = _path_launches(64, batch)
    assert len(train) == 14 and len(evals) == 8
    for rows, c_out in train + evals:
        tile = conv1d.fwd_f32_tile(64, rows, c_out)
        assert tile == conv1d.fwd_f32_tiles(c_out)[0] == FULL_TILES[conv1d.fwd_tile(c_out)]
        assert _blocks(64, rows, c_out, tile) >= 384


def test_fwd_f32_tile_fills_the_sms_at_one_member():
    """The single VAE (one member, batch 64): each of its 14 launches a
    step takes a smaller tile, and each grid has a block for every SM,
    where the full tile gave 6-50 blocks."""
    train, _evals = _path_launches(1, 64)
    before, after = [], []
    for rows, c_out in train:
        tile = conv1d.fwd_f32_tile(1, rows, c_out)
        assert tile != conv1d.fwd_f32_tiles(c_out)[0]
        before.append(_blocks(1, rows, c_out, conv1d.fwd_f32_tiles(c_out)[0]))
        after.append(_blocks(1, rows, c_out, tile))
    assert sorted(before) == [6, 6, 12, 12, 12, 13, 24, 25, 25, 25, 26, 26, 50, 50]
    assert min(after) >= conv1d.SMS == 132


def test_fwd_f32_tile_is_a_function_of_the_shapes():
    """The tile reads T, the rows and C_out alone: at every shape it is
    the first of the full tile and F32_SMALL_TILES whose grid has SMS
    blocks (the smallest where none has), and each tile it returns is one
    the kernel source instantiates."""
    import inspect

    assert list(inspect.signature(conv1d.fwd_f32_tile).parameters) == ["T", "rows", "c_out"]
    rng = np.random.default_rng(21)
    known = {t for c in (16, 32, 64) for t in conv1d.fwd_f32_tiles(c)}
    assert len(known) == 3 + len(conv1d.F32_SMALL_TILES)
    for _ in range(2000):
        T, rows = int(rng.integers(1, 65)), int(rng.integers(1, 8000))
        c_out = int(rng.integers(1, 300))
        tile = conv1d.fwd_f32_tile(T, rows, c_out)
        ladder = conv1d.fwd_f32_tiles(c_out)
        fits = [t for t in ladder if _blocks(T, rows, c_out, t) >= conv1d.SMS]
        assert tile == (fits[0] if fits else ladder[-1]) and tile in known
        assert conv1d.fwd_f32_tile(T, rows, c_out) == tile


def test_small_tile_launches_show_in_the_programs_counts():
    """The count of float32 conv_fwd launches on a smaller tile is a kernel
    count of ``train.program.COUNTS``: an epoch graph counts it as a
    wrapper's launches (``launches``, and ``captured`` at every replay),
    and it is reset with the program's counts."""
    from lesionvae_tpu_torch.train import program

    program.reset_counts()
    assert conv1d.SMALL_TILE_LAUNCHES in program.counted_wrappers()
    assert conv1d.SMALL_TILE_LAUNCHES.captured == 0
    conv1d.SMALL_TILE_LAUNCHES.launches += 14          # as a replay of a one-member step adds
    assert dict(program.COUNTS)["conv_fwd_small_tiles"] == conv1d.SMALL_TILE_LAUNCHES.launches == 14
    program.COUNTS["captures"] += 1
    program.reset_counts()
    assert set(dict(program.COUNTS).values()) == {0}


def test_wrappers_take_only_cuda_tensors():
    h, w, b = torch.zeros(2, 3, 4, 5), torch.zeros(2, 6, 5, 5), torch.zeros(2, 6)
    with pytest.raises(ValueError, match="run on cuda"):
        conv1d.conv_fwd(h, w, b, False)
    with pytest.raises(ValueError, match="run on cuda"):
        conv1d.conv_wgrad(h, torch.zeros(2, 3, 4, 6), False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        conv1d.fleet_conv1d(h.to("meta"), w.to("meta"), b.to("meta"), False)


# ------------------------------------------------------------ the cost model
# the path's layers by hand (lesionvae_tpu/models/lesion_vae.py:44-69 at
# seq 100, 13 + 3 channels): L, C_in, C_out
HAND = {"micro_c1": (100, 13, 64), "micro_c2": (50, 64, 128), "micro_c3": (25, 128, 128),
        "lesion_c1": (100, 3, 32), "lesion_c2": (50, 32, 64), "dec_t1": (12, 128, 64),
        "dec_t2": (24, 64, 64), "dec_t3": (48, 64, 13)}


@pytest.mark.parametrize("compute,item", [("f32", 4), ("bf16", 2)])
def test_conv_counts_match_a_hand_count(compute, item):
    """64 members x batch 64: the forward's 51.24 GFLOP (micro_c1 3.41,
    micro_c2 and micro_c3 16.78 each, lesion_c1 0.39, lesion_c2 4.19, dec_t1
    and dec_t2 4.03 each, dec_t3 1.64), dw the same, dx all but the two
    input layers'; the bytes each tensor once; the bound the FLOPs over 67
    TFLOP/s in float32 and the bytes over 3.35 TB/s in bf16."""
    dtype = torch.bfloat16 if compute == "bf16" else None
    flops = tcm.conv_flops(64)
    nbytes = tcm.conv_bytes(64, compute_dtype=dtype)
    gflop = {"micro_c1": 3.41, "micro_c2": 16.78, "micro_c3": 16.78, "lesion_c1": 0.39,
             "lesion_c2": 4.19, "dec_t1": 4.03, "dec_t2": 4.03, "dec_t3": 1.64}
    assert {k: v[:3] for k, v in tcm.conv_layers().items()} == HAND
    for name, (L, cin, cout) in HAND.items():
        macs = 64 * 64 * L * cin * cout * 5
        f = flops["layers"][name]
        assert f["forward"] == f["dw"] == 2 * macs
        assert f["dx"] == (0 if name in ("micro_c1", "lesion_c1") else 2 * macs)
        assert round(f["forward"] / 1e9, 2) == gflop[name]
        x, y, w = 64 * 64 * L * cin, 64 * 64 * L * cout, 64 * cin * cout * 5
        assert nbytes["layers"][name]["forward"] == item * (x + y + w + 64 * cout)
        assert nbytes["layers"][name]["dw"] == item * (x + y + w + 64 * cout)
    assert flops["forward"] == 51_238_666_240
    assert flops["total"] == 2 * 51_238_666_240 + 47_437_578_240
    # h in and y out: 168.2 M elements a forward
    assert sum(64 * 64 * L * (cin + cout) for L, cin, cout in HAND.values()) == 168_230_912
    bound = tcm.conv_bound_ms(64, compute_dtype=dtype)
    if compute == "f32":
        assert bound["bound_by"] == "operations"
        assert bound["forward"] == pytest.approx(0.776, abs=1e-3)
        assert bound["bound_ms"] == pytest.approx(2.260, abs=1e-3)
    else:
        assert bound["bound_by"] == "bytes"
        assert bound["bound_ms"] == pytest.approx(nbytes["total"] / 3.35e9, rel=1e-9)
