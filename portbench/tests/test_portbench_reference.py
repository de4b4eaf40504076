"""The plain reference (``portbench/reference``) against the port's CPU
path at a tiny size, in float64 where both take it; and the imports of
everything the benchmark runs, compared by whole top-level module name."""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lesionvae_tpu_torch.models.lesion_vae import LesionConditionedVAE
from lesionvae_tpu_torch.train import batched, data
from lesionvae_tpu_torch.train.trainer import train_lesion_vae
from portbench import inputs
from portbench.reference import draws, model, normalize, normative
from portbench.reference import train as rtrain

PORTBENCH = Path(__file__).resolve().parents[1]
HYPER = {"seq_len": 16, "micro_ch": 13, "lesion_ch": 3, "latent": 4}
TRAFFIC = {"tracts": 1, "timepoints": ["2d", "9d", "1mo"],
           "groups": {"Sham": 2, "TBI": 1, "PTE": 1}, "streamlines": 5}
E, B, SEED = 2, 8, 2 ** 40 + 7
F64 = torch.float64


def cohort():
    return inputs.make_cohort(TRAFFIC, 16, 13, 3, B, 11, "cpu")


def close(a, b, tol=1e-10):
    a = a.detach().double().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, float)
    b = b.detach().double().numpy() if isinstance(b, torch.Tensor) else np.asarray(b, float)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol)


def stacked(members, dtype=F64):
    return {k: v.to(dtype) for k, v in model.stack(members, "cpu").items()}


def test_fleet_draws_are_the_programs():
    T, n_pad = 3, 24
    want = batched.member_draws(T, n_pad, HYPER, E, B, SEED)
    params, stats, perms, noise = draws.fleet(T, n_pad, E, B, HYPER, SEED, [0, 2])
    for got_p, got_s, sd in zip(params, stats, [want["state_dicts"][i] for i in (0, 2)]):
        for k, v in {**got_p, **got_s}.items():
            assert torch.equal(v, sd[k]), k
    assert torch.equal(perms, want["perms"][[0, 2]])
    assert torch.equal(noise, want["noise"][[0, 2]])


def test_summary_noise_is_the_programs():
    from lesionvae_tpu_torch.train.normative import reparam_noise

    a, b = draws.summary_noise(10, 4, SEED)
    assert torch.equal(a, reparam_noise(10, 4, SEED))
    assert torch.equal(b, reparam_noise(10, 4, SEED + 1))


@pytest.mark.parametrize("training", [True, False])
def test_forward_is_the_modules(training):
    torch.manual_seed(3)
    mod = LesionConditionedVAE(**HYPER).double()
    sd = {k: v.detach().clone() for k, v in mod.state_dict().items()}
    xm, xl = torch.randn(2, 6, 16, 13, dtype=F64), torch.rand(2, 6, 16, 3, dtype=F64)
    eps = torch.randn(6, 4, dtype=F64)
    mask = torch.tensor([[1, 1, 1, 1, 0, 1], [1, 0, 1, 1, 1, 1]], dtype=F64)
    p = {k: torch.stack([v, v]) for k, v in sd.items() if "running" not in k}
    s = {k: torch.stack([v, v]) for k, v in sd.items() if "running" in k}
    xh, mu, logv, new = model.forward(p, s, xm, xl, mask if training else None, eps, training)
    mod.train(training)
    for i in range(2):
        mod.load_state_dict(sd)
        want = mod(xm[i], xl[i], mask=mask[i] if training else None, eps=eps)
        close(xh[i], want[0])
        close(mu[i], want[1])
        close(logv[i], want[2])
        if training:
            for k in s:
                close(new[k][i], mod.state_dict()[k])


def test_normalization_is_the_programs():
    c = cohort()
    Xm = c.Xm.copy()
    Xm[0, 3, 2, 1] = np.nan
    stats = normalize.fit(Xm, c.n_real)
    Xz, Xl = normalize.apply(Xm, c.Xl, stats)
    got_z, got_l, got = data.normalize_on_device(torch.from_numpy(Xm), torch.from_numpy(c.Xl),
                                                 torch.from_numpy(c.n_real).long())
    for k in stats:
        close(got[k], stats[k], 1e-6)
    close(got_z, Xz, 1e-5)
    close(got_l, Xl)
    n = int(c.n_real[1])
    host = data.fit_normalization_stats(c.Xm[1, :n], c.Xl[1, :n], list(range(13)))
    for k in stats:
        close(host[k], stats[k][1], 1e-6)


def test_fleet_training_and_summary_are_the_programs():
    c = cohort()
    T, n_pad = c.Xm.shape[:2]
    stats = normalize.fit(c.Xm, c.n_real)
    Xz, Xl = (torch.from_numpy(x).to(F64) for x in normalize.apply(c.Xm, c.Xl, stats))
    members = list(range(T))
    p0, s0, perms, noise = draws.fleet(T, n_pad, E, B, HYPER, SEED, members)
    sds = [{k: v.to(F64) for k, v in {**p, **s}.items()} for p, s in zip(p0, s0)]
    n_seg = c.n_subjects + 1
    handle = batched.launch_many_vaes(
        Xz.numpy(), Xl.numpy(), c.n_real, latent_dim=4, epochs=E, batch_size=B, seed=SEED,
        summary_spec=(c.sham, c.subject, n_seg, SEED), device="cpu", dtype=F64,
        state_dicts=sds, perms=perms, noise=noise)
    models, hist = handle.fetch()
    params, bn = stacked(p0), stacked(s0)
    ref_hist, _first = rtrain.train(params, bn, Xz, Xl, torch.from_numpy(c.n_real), perms,
                                    noise, E, B, 2e-4, 1e-3, 2.0)
    close(hist, ref_hist)
    for i, m in enumerate(models):
        for k, v in m.module.state_dict().items():
            close(v, {**params, **bn}[k][i])
    a, b = (e.to(F64) for e in draws.summary_noise(n_pad, 4, SEED))
    mean, std, z, mag = normative.zscores(params, bn, Xz, Xl, torch.from_numpy(c.sham).to(F64),
                                          a, b)
    prof = normative.subject_profiles(z, torch.from_numpy(c.subject), c.n_subjects)
    got = handle.summary
    close(got[0], mean)
    close(got[1], std)
    close(got[2], mag)
    close(got[3][:, :c.n_subjects], prof)


def test_single_training_and_zscores_are_the_programs():
    from lesionvae_tpu_torch.train.normative import normative_zscores_fused

    c = cohort()
    n = int(c.n_real[0])
    n_pad = -(-n // B) * B
    stats = normalize.fit(c.Xm[:1], c.n_real[:1])
    Xz, Xl = normalize.apply(c.Xm[:1], c.Xl[:1], stats)
    Xz, Xl = Xz[0, :n].astype(np.float64), Xl[0, :n].astype(np.float64)
    trained, hist = train_lesion_vae(Xz, Xl, latent_dim=4, epochs=E, batch_size=B, seed=SEED,
                                     device="cpu", dtype=F64)
    p0, s0, perms, noise = draws.single(n, n_pad, E, B, HYPER, SEED)
    params, bn = stacked(p0), stacked(s0)
    def pad(x):
        return torch.cat([torch.from_numpy(x),
                          torch.zeros((n_pad - n,) + x.shape[1:], dtype=F64)])[None]

    ref_hist, _ = rtrain.train(params, bn, pad(Xz), pad(Xl), torch.tensor([n]), perms, noise,
                               E, B, 2e-4, 1e-3, 2.0)
    close(hist.to_numpy(), ref_hist[0])
    for k, v in trained.module.state_dict().items():
        close(v, {**params, **bn}[k][0])
    sham = c.sham[0, :n] > 0
    got = normative_zscores_fused(trained, Xz, Xl, sham, seed=SEED)
    a, b = (e.to(F64) for e in draws.summary_noise(n, 4, SEED))
    want = normative.zscores(params, bn, torch.from_numpy(Xz)[None], torch.from_numpy(Xl)[None],
                             torch.from_numpy(sham[None].astype(np.float64)), a, b)
    for g, w in zip(got, want):
        close(g, w[0])
    want_mu = normative.latents(params, bn, torch.from_numpy(Xz)[None], torch.from_numpy(Xl)[None])
    close(trained.encode(Xz, Xl)[0], want_mu[0])


def test_fault_planted_in_the_reference_moves_its_output():
    c = cohort()
    T, n_pad = c.Xm.shape[:2]
    stats = normalize.fit(c.Xm, c.n_real)
    Xz, Xl = (torch.from_numpy(x) for x in normalize.apply(c.Xm, c.Xl, stats))
    runs = {}
    for fault in (None, "frozen", "half_batch"):
        p0, s0, perms, noise = draws.fleet(T, n_pad, E, B, HYPER, SEED, [0])
        params, bn = model.stack(p0, "cpu"), model.stack(s0, "cpu")
        init = {k: v.clone() for k, v in params.items()}
        hist, _ = rtrain.train(params, bn, Xz[:1], Xl[:1], torch.from_numpy(c.n_real[:1]),
                               perms, noise, E, B, 2e-4, 1e-3, 2.0, fault=fault)
        runs[fault] = (hist, params, init)
    assert all(torch.equal(v, runs["frozen"][2][k]) for k, v in runs["frozen"][1].items())
    assert not np.allclose(runs[None][0], runs["half_batch"][0])


def imports(path: Path):
    """Top-level names of every module ``path`` imports (relative imports
    are the benchmark's own)."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_the_benchmark_runs_imports_jax_or_the_jax_package():
    files = [p for p in PORTBENCH.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 20
    for path in files:
        found = set(imports(path)) & {"jax", "jaxlib", "flax", "lesionvae_tpu"}
        assert not found, (path, found)


def test_the_reference_and_the_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "cost"):
        for path in (PORTBENCH / sub).rglob("*.py"):
            assert "lesionvae_tpu_torch" not in set(imports(path)), path
    code = ("import sys; import portbench.reference.train, portbench.reference.normative, "
            "portbench.reference.normalize, portbench.reference.draws, portbench.cost.counts, "
            "portbench.check; tops = {m.split('.')[0] for m in sys.modules}; "
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'lesionvae_tpu', "
            "'lesionvae_tpu_torch'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=PORTBENCH.parent,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
