"""One tract's VAE at one timepoint, as the ``vae`` stage runs it
(``pipeline/vae_run.py::run_vae_analysis``): the normalization fitted and
applied on the host, ``train_lesion_vae`` (one graph replay an epoch),
``normative_zscores_fused`` and the latents from ``encode``, every output on
the host."""

from __future__ import annotations

import torch
from lesionvae_tpu_torch.train import data, normative as program_normative, trainer

from ..reference import draws, normative
from ..reference import model as rmodel
from ..reference import normalize
from ..reference import train as rtrain
from .common import Job as Base

#: the harness's ranges around the job's calls
RANGES = ("normalize", "train", "normative", "readback")


class Job(Base):
    NORMALIZATION = "host"

    def __init__(self, config, traffic, seed, device="cuda"):
        super().__init__(config, traffic, seed, device)
        c = self.cohort
        if c.Xm.shape[0] != 1:
            raise ValueError("a single job trains one member: one tract at one timepoint")
        self.Xm, self.Xl = c.Xm[0, :self.n], c.Xl[0, :self.n]
        self.sham = c.sham[0, :self.n] > 0
        self.feats = [f"f{j}" for j in range(self.hyper["micro_ch"])]

    def run(self, job_seed: int) -> dict:
        h = self.hyper
        with self.span("normalize"):
            stats = data.fit_normalization_stats(self.Xm, self.Xl, self.feats)
            Xz, Xl = data.apply_normalization(self.Xm, self.Xl, stats)
        with self.span("train"):
            model, hist = trainer.train_lesion_vae(
                Xz, Xl, latent_dim=h["latent"], epochs=self.epochs, batch_size=self.batch,
                seed=job_seed, device=self.device, **self.train_hyper)
        with self.span("normative"):
            mean, std, Z, mag = program_normative.normative_zscores_fused(
                model, Xz, Xl, self.sham, seed=job_seed)
            mu = model.encode(Xz, Xl)[0].cpu().numpy()
        with self.span("readback"):
            weights = self._weights([model])
        return {"hist": hist.to_numpy()[None],
                "norm": {k: v[None] for k, v in stats.items()}, "weights": weights,
                "summary": [mean[None], std[None], mag[None], Z[None], mu[None]]}

    def work(self) -> dict:
        return {"members": 1, "batch": self.batch,
                "train_steps": self.epochs * (self.n_pad // self.batch),
                "eval_rows": [self.n, self.n], "encode_rows": [self.n],
                "flat_params": True}

    def release(self) -> None:
        trainer.PROGRAMS.clear()

    def _replay(self, job_seed, stats, mode, fault):
        Xz, Xl = normalize.apply(self.cohort.Xm, self.cohort.Xl, stats)
        Xz, Xl = (torch.from_numpy(x).to(self.device) for x in (Xz, Xl))
        p0, s0, perms, noise = draws.single(self.n, self.n_pad, self.epochs, self.batch,
                                            self.hyper, job_seed)
        params, bn = self.stacked(p0, s0)
        init = {k: v.clone() for k, v in {**params, **bn}.items()}
        pad = torch.zeros_like(Xz)
        pad[:, :self.n] = Xz[:, :self.n]
        with rmodel.precision(mode):
            hist, first = rtrain.train(params, bn, pad, Xl, torch.tensor([self.n]), perms,
                                       noise, self.epochs, self.batch, fault=fault,
                                       **self.train_hyper)
        return params, bn, init, hist, first, Xz[:, :self.n], Xl[:, :self.n]

    def _summary(self, params, stats, Xz, Xl, job_seed):
        eps_a, eps_b = (e.to(self.device) for e in draws.summary_noise(
            self.n, self.hyper["latent"], job_seed))
        sham = torch.from_numpy(self.sham[None].astype("float32")).to(self.device)
        mean, std, z, mag = normative.zscores(params, stats, Xz, Xl, sham, eps_a, eps_b)
        return [mean, std, mag, z, normative.latents(params, stats, Xz, Xl)]
