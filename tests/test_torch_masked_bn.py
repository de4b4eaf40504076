"""The fleet's masked BatchNorm + ReLU (``ops/masked_bn.py``) against the JAX
package's ``MaskedBatchNorm`` under ``jax.vmap`` followed by ``nn.relu``, as
``_fleet_program`` runs it: the output, the new running statistics and,
through ``jax.grad``, the gradients of x, scale and bias against the
``Function``'s closed-form backward; with pad rows, without a mask, with an
all-pad member, with a NaN member and in eval mode.  The plain version's
sums are held to the kernel's order written out element by element, and
the ``Function`` to ``torch.autograd.gradcheck``."""

import re
from pathlib import Path

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lesionvae_tpu.models import layers as jlayers
from lesionvae_tpu_torch.ops import masked_bn

torch.set_num_threads(1)

# 296 rows a member: two chunks of the kernel's order, the second ragged
T, N, L, C = 3, 8, 37, 5
DTYPES = {"f64": (torch.float64, jnp.float64), "f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
CASES = ["pad_rows", "unmasked", "all_pad_member", "nan_member", "eval"]


def _inputs(case: str, seed: int = 0):
    """x (T, N, L, C), mask (T, N) or None, scale, bias, running mean and
    variance (T, C), and an upstream gradient, in float64."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(T, N, L, C)) * [1.0, 3.0, 0.5, 2.0, 1.0] + [0.0, 1.0, -2.0, 0.5, 4.0]
    mask = (rng.uniform(size=(T, N)) > 0.3).astype(np.float64)
    mask[:, 0] = 1.0
    if case == "all_pad_member":
        mask[1] = 0.0
    if case == "nan_member":
        x[2, 3, 5, 1] = np.nan
    gamma = rng.uniform(0.5, 1.5, (T, C))
    beta = rng.normal(size=(T, C)) * 0.5
    rm = rng.normal(size=(T, C)) * 0.3
    rv = rng.uniform(0.5, 2.0, (T, C))
    dy = rng.normal(size=(T, N, L, C))
    return x, (None if case == "unmasked" else mask), gamma, beta, rm, rv, dy


def _jax(x, mask, gamma, beta, rm, rv, dy, train: bool, dt):
    """(y, new running mean, new running var, dx, dscale, dbias) of the flax
    layer vmapped over the members and followed by nn.relu."""
    bn = jlayers.MaskedBatchNorm(C)

    def one(x, m, g, b, mean, var):
        variables = {"params": {"scale": g, "bias": b},
                     "batch_stats": {"mean": mean, "var": var}}
        if train:
            y, new = bn.apply(variables, x, m, True, mutable=["batch_stats"])
            return nn.relu(y), new["batch_stats"]["mean"], new["batch_stats"]["var"]
        return nn.relu(bn.apply(variables, x, m, False)), mean, var

    stat = jnp.float64 if dt == jnp.float64 else jnp.float32
    args = [jnp.asarray(x).astype(dt), None if mask is None else jnp.asarray(mask, stat),
            jnp.asarray(gamma, stat), jnp.asarray(beta, stat), jnp.asarray(rm, stat),
            jnp.asarray(rv, stat)]
    axes = (0, None if mask is None else 0, 0, 0, 0, 0)
    run = jax.vmap(one, in_axes=axes)
    y, new_rm, new_rv = run(*args)
    g_up = jnp.asarray(dy).astype(dt)

    def loss(x_, g_, b_):
        out = run(x_, args[1], g_, b_, args[4], args[5])[0]
        return jnp.sum((out * g_up).astype(stat))

    dx, dg, db = jax.grad(loss, argnums=(0, 1, 2))(args[0], args[2], args[3])
    return [np.asarray(a.astype(jnp.float64)) for a in (y, new_rm, new_rv, dx, dg, db)]


def _torch(x, mask, gamma, beta, rm, rv, dy, train: bool, dt):
    stat = torch.float64 if dt == torch.float64 else torch.float32
    xt = torch.from_numpy(x).to(dt).requires_grad_()
    mt = None if mask is None else torch.from_numpy(mask).to(stat)
    g = torch.from_numpy(gamma).to(stat).requires_grad_()
    b = torch.from_numpy(beta).to(stat).requires_grad_()
    y, new_rm, new_rv = masked_bn.masked_bn_relu(
        xt, mt, g, b, torch.from_numpy(rm).to(stat), torch.from_numpy(rv).to(stat), train)
    dx, dg, db = torch.autograd.grad(y, (xt, g, b), torch.from_numpy(dy).to(dt))
    return [t.detach().double().numpy() for t in (y, new_rm, new_rv, dx, dg, db)]


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, equal_nan=True,
                               err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_matches_the_vmapped_flax_layer_and_its_gradient(case, dtype):
    """float64 to 1e-12; float32 to a few ulps of the values' scale (the
    two sum the rows in other orders); bfloat16 to one bf16 ulp in y (both
    fold scale and shift in float32 and apply them in bf16) and the float32
    statistics to 1e-5.  The bf16 gradients differ by more than rounding
    order: the JAX program differentiates its bf16 chain, rounding each
    product to bf16, where the closed form works in float32 and rounds dx
    once (read: dx 0.6%, scale 2.6%, bias 1.5% of the largest apart; each
    lies ~25% (dx) and ~5% from a float64 run at the same bf16 inputs,
    whose ReLU keeps other elements): dx is held to 1%, scale and bias to
    5% of the largest.  One rule differs on purpose: a NaN output passes
    its gradient (PyTorch's ReLU rule, ``threshold_backward``), where
    ``jax.nn.relu`` passes 0, so the bias gradient of the NaN's channel is
    the sum of its upstream gradient."""
    train = case != "eval"
    inputs = _inputs(case)
    got = _torch(*inputs, train, DTYPES[dtype][0])
    want = _jax(*inputs, train, DTYPES[dtype][1])
    names = ["y", "running_mean", "running_var", "dx", "dscale", "dbias"]
    if case == "nan_member":
        # the NaN's channel of its member is NaN throughout (output through
        # the ReLU, statistics, gradient); its other channels and the other
        # members are untouched
        assert np.isnan(got[0][2, ..., 1]).all() and np.isnan(want[0][2, ..., 1]).all()
        assert np.isnan(got[1][2, 1]) and np.isnan(got[3][2, ..., 1]).all()
        rest = np.arange(C) != 1
        assert np.isfinite(got[0][2][..., rest]).all() and np.isfinite(got[0][:2]).all()
        assert np.isfinite(got[3][2][..., rest]).all() and np.isfinite(got[3][:2]).all()
        dy = torch.from_numpy(inputs[6]).to(DTYPES[dtype][0]).double().numpy()
        _close(got[5][2, 1], dy[2, ..., 1].sum(), 1e-5, 1e-5, "dbias of the NaN channel")
        got[5][2, 1] = want[5][2, 1]
    for g, w, name in zip(got, want, names):
        scale = max(1.0, float(np.nanmax(np.abs(w))))
        if dtype == "f64":
            _close(g, w, 1e-12, 1e-12 * scale, name)
        elif dtype == "f32":
            _close(g, w, 1e-5, 1e-5 * scale, name)
        elif name == "y":
            ulp = np.maximum(np.abs(w), 2.0 ** -6) * 2.0 ** -7
            assert np.all((np.abs(g - w) <= ulp) | (np.isnan(g) & np.isnan(w))), name
        elif name.startswith("running"):
            _close(g, w, 1e-5, 1e-6, name)
        else:
            _close(g, w, 0.0, (1e-2 if name == "dx" else 5e-2) * scale, name)
    if case == "all_pad_member":
        # the count clamps to 1: mean 0, variance 0, so the statistics move
        # only by momentum
        np.testing.assert_allclose(got[1][1], 0.9 * inputs[4][1], rtol=1e-6)


def _kernel_order_sum(v: np.ndarray) -> np.ndarray:
    """The kernel's order of a sum over rows, thread by thread in float32:
    (T, R, C) -> (T, C)."""
    Tn, R, Cn = v.shape
    K = -(-R // masked_bn.CHUNK)
    out = np.zeros((Tn, Cn), np.float32)
    for t in range(Tn):
        for c in range(Cn):
            partials = []
            for k in range(K):
                lanes = []
                for s in range(masked_bn.LANES):
                    acc = np.float32(0)
                    for j in range(masked_bn.ROWS_A_LANE):
                        r = k * masked_bn.CHUNK + j * masked_bn.LANES + s
                        if r < R:
                            acc = np.float32(acc + v[t, r, c])
                    lanes.append(acc)
                w = masked_bn.LANES // 2
                while w:
                    lanes = [np.float32(lanes[s] + lanes[s + w]) for s in range(w)]
                    w //= 2
                partials.append(lanes[0])
            total = partials[0]
            for p in partials[1:]:
                total = np.float32(total + p)
            out[t, c] = total
    return out


@pytest.mark.parametrize("R", [1, 255, 256, 257, 600])
def test_plain_sums_follow_the_kernel_order(R):
    """chunk_partials + chunk_total give, bit for bit, the sum the kernel's
    threads take (lanes in turn, lanes in a tree, chunks in order), on and
    beside the chunk's edge, with values whose sum depends on the order."""
    rng = np.random.default_rng(R)
    v = (rng.normal(size=(2, R, 3)) * 10.0 ** rng.integers(-4, 5, size=(2, R, 3)))
    v = v.astype(np.float32)
    got = masked_bn.chunk_total(masked_bn.chunk_partials(torch.from_numpy(v))).numpy()
    assert got.tobytes() == _kernel_order_sum(v).tobytes()


@pytest.mark.parametrize("train", [True, False])
def test_closed_form_backward_passes_gradcheck(train):
    """float64, pad rows and an all-pad member: the closed-form backward
    against finite differences of the forward, in x, scale and bias."""
    rng = np.random.default_rng(3)
    Tn, Nn, Ln, Cn = 2, 5, 7, 3
    x = torch.from_numpy(rng.normal(size=(Tn, Nn, Ln, Cn))).requires_grad_()
    mask = torch.from_numpy((rng.uniform(size=(Tn, Nn)) > 0.4).astype(np.float64))
    mask[0, 0], mask[1] = 1.0, 0.0
    g = torch.from_numpy(rng.uniform(0.5, 1.5, (Tn, Cn))).requires_grad_()
    b = torch.from_numpy(rng.normal(size=(Tn, Cn)) * 0.3).requires_grad_()
    rm = torch.from_numpy(rng.normal(size=(Tn, Cn)) * 0.3)
    rv = torch.from_numpy(rng.uniform(0.5, 2.0, (Tn, Cn)))
    assert torch.autograd.gradcheck(
        lambda x_, g_, b_: masked_bn.masked_bn_relu(x_, mask, g_, b_, rm, rv, train)[0],
        (x, g, b))


def test_the_kernel_route_takes_only_cuda_tensors():
    """The kernel wrappers raise on what they do not take; nothing falls
    back to the plain version."""
    x = torch.zeros(1, 2, 3, 4)
    w = torch.ones(1, 4)
    with pytest.raises(ValueError, match="run on cuda"):
        masked_bn.masked_bn_relu_kernel(x, None, w, w, w, w, True)
    with pytest.raises(ValueError, match="cuda or cpu"):
        masked_bn.masked_bn_relu(x.to("meta"), None, w, w, w, w, True)


def test_the_plain_order_is_the_kernels():
    """The constants that fix the order of the sums, the tile and the
    vector width are the source's own."""
    src = (Path(masked_bn.__file__).parent / "csrc" / "masked_bn.cu").read_text()
    const = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert const["LANES"] == masked_bn.LANES and const["J"] == masked_bn.ROWS_A_LANE
    assert const["LANES"] * const["J"] == masked_bn.CHUNK
    assert const["VECTORS"] == masked_bn.VECTORS_A_ROW
    assert const["SLOTS"] == masked_bn.CHUNKS_A_BLOCK
    assert const["VECTOR_BYTES"] == masked_bn.VECTOR_BYTES
    assert const["MAX_CLUSTER"] == masked_bn.MAX_CLUSTER
    assert const["SLOTS"] * const["LANES"] * const["VECTORS"] == masked_bn.THREADS
    for dtype, n in masked_bn.ELEMENTS_A_THREAD.items():
        item = torch.empty((), dtype=dtype).element_size()
        assert n == const["J"] * const["VECTOR_BYTES"] // item


def _thread_map_sum(v: np.ndarray, V: int) -> np.ndarray:
    """The sum over rows of (R, CT) float32 terms as the kernel's threads
    take it, thread by thread: a block's 256 threads hold (vector, lane,
    chunk slot) by the bits of csrc/masked_bn.cu's ``Pos``; each adds its
    J rows of V channels in turn, skipping rows past R; three shuffle
    levels (xor 16, 8, 4 of the thread index), the four nodes of lane bits
    2-4 = 0 as (n0 + n2) + (n1 + n3), then the chunks in order."""
    R, CT = v.shape
    K = -(-R // masked_bn.CHUNK)
    partials = {}
    for block in range(-(-K // masked_bn.CHUNKS_A_BLOCK)):
        acc = np.zeros((masked_bn.THREADS, V), np.float32)
        lane = np.zeros(masked_bn.THREADS, int)
        for tid in range(masked_bn.THREADS):
            vec, lo, slot = tid & 3, (tid >> 5) & 3, tid >> 7
            lane[tid] = ((tid >> 2) & 7) * 4 + lo
            chunk = block * masked_bn.CHUNKS_A_BLOCK + slot
            for j in range(masked_bn.ROWS_A_LANE):
                r = chunk * masked_bn.CHUNK + j * masked_bn.LANES + lane[tid]
                if r < R:
                    acc[tid] = acc[tid] + v[r, vec * V:(vec + 1) * V]
        for o in (16, 8, 4):
            acc = acc + acc[np.arange(masked_bn.THREADS) ^ o]
        for slot in range(masked_bn.CHUNKS_A_BLOCK):
            nodes = {}
            for tid in range(slot * 128, slot * 128 + 128):
                if (tid >> 2) & 7 == 0:
                    nodes.setdefault(lane[tid], np.zeros(CT, np.float32))[
                        (tid & 3) * V:((tid & 3) + 1) * V] = acc[tid]
            assert sorted(nodes) == [0, 1, 2, 3]
            partials[block * masked_bn.CHUNKS_A_BLOCK + slot] = (
                (nodes[0] + nodes[2]) + (nodes[1] + nodes[3]))
    total = partials[0]
    for k in range(1, K):
        total = total + partials[k]
    return total


@pytest.mark.parametrize("V", [4, 8, 1])
@pytest.mark.parametrize("R", [1, 255, 256, 257, 296, 600, 1536, 8192])
def test_the_kernels_thread_map_sums_in_the_plain_order(R, V):
    """The threads of one (member, channel tile) and their shuffles, at the
    kernel's vector widths (float32, bf16, one channel), give the plain
    version's sums bit for bit, on and beside the chunk's edge, over a
    ragged block pair, and at the rows of the cluster route's edges (one
    block: 8 x 37 rows; MAX_CLUSTER blocks: 128 x 64)."""
    rng = np.random.default_rng(R + V)
    CT = masked_bn.VECTORS_A_ROW * V
    v = rng.normal(size=(R, CT)) * 10.0 ** rng.integers(-4, 5, size=(R, CT))
    v = v.astype(np.float32)
    want = masked_bn.chunk_total(masked_bn.chunk_partials(torch.from_numpy(v[None]))).numpy()
    assert _thread_map_sum(v, V).tobytes() == want[0].tobytes()


def test_the_route_is_chosen_by_shape():
    """The seven layers of a 64-member step at batch 64 take the cluster
    route in both dtypes; a batch-512 (100, 64) float32 layer is too long
    for one cluster, a row of 5 float32 or 12 bf16 channels no whole number
    of 16-byte vectors, both the general route; eval is one apply.  The
    cluster sizes the card check holds at the route's edges: 16 blocks at
    batch 128 x (64, 64), one block at batch 8 x (37, 8)."""
    from lesionvae_tpu_torch.utils.cost_model import bn_layers

    for L, C in bn_layers().values():
        for dtype in (torch.float32, torch.bfloat16):
            assert masked_bn.route(64, L, C, dtype, True) == "cluster"
            assert masked_bn.route(64, L, C, dtype, False) == "apply"
            assert masked_bn.cluster_size(64, L) <= masked_bn.MAX_CLUSTER
    assert masked_bn.route(512, 100, 64, torch.float32, True) == "general"
    assert masked_bn.route(512, 100, 64, torch.float32, False) == "apply"
    assert masked_bn.route(8, 37, 5, torch.float32, True) == "general"
    assert masked_bn.route(8, 37, 12, torch.bfloat16, True) == "general"
    for dtype in (torch.float32, torch.bfloat16):
        assert masked_bn.route(128, 64, 64, dtype, True) == "cluster"
        assert masked_bn.route(8, 37, 8, dtype, True) == "cluster"
    assert masked_bn.cluster_size(128, 64) == masked_bn.MAX_CLUSTER == 16
    assert masked_bn.cluster_size(8, 37) == 1
    # the longest member a cluster holds, and one row more
    rows = masked_bn.MAX_CLUSTER * masked_bn.CHUNKS_A_BLOCK * masked_bn.CHUNK
    assert masked_bn.route(1, rows, 16, torch.float32, True) == "cluster"
    assert masked_bn.route(1, rows + 1, 16, torch.float32, True) == "general"


def test_masked_bn_timing_needs_the_card():
    """The kernels' timing script runs on the card only."""
    from lesionvae_tpu_torch.benchmarks import masked_bn_timing

    if torch.cuda.is_available():
        pytest.skip("a card is present: the benchmark would run")
    with pytest.raises(SystemExit, match="NVIDIA card"):
        masked_bn_timing.main()
