"""The cohort fleet's job, as ``vae-cohort`` (and ``all --with-vae``) runs
it: every (tract, timepoint) member trained as one program by
``train.batched.launch_many_vaes`` with the raw blocks normalized on the
device and the normative summary after training, then ``fetch()`` (the
trained members as modules, the history) and the summary and the
normalization statistics brought to the host."""

from __future__ import annotations

import torch
from lesionvae_tpu_torch.train import batched

from ..reference import draws, normative
from ..reference import train as rtrain
from ..reference import model as rmodel
from ..reference import normalize
from .common import Job as Base

#: the harness's ranges around the job's calls, and the program's own
RANGES = ("draws+launch", "fetch", "readback", "fleet_train", "member_summary")


class Job(Base):
    NORMALIZATION = "device"

    def __init__(self, config, traffic, seed, device="cuda"):
        super().__init__(config, traffic, seed, device)
        c = self.cohort
        self.n_seg = c.n_subjects + 1             # the last segment takes the pad rows

    def run(self, job_seed: int) -> dict:
        c, h = self.cohort, self.hyper
        with self.span("draws+launch"):
            handle = batched.launch_many_vaes(
                c.Xm, c.Xl, c.n_real, latent_dim=h["latent"], epochs=self.epochs,
                batch_size=self.batch, seed=job_seed,
                summary_spec=(c.sham, c.subject, self.n_seg, job_seed),
                normalize_on_device=True, device=self.device, **self.train_hyper)
        with self.span("fetch"):
            models, hist = handle.fetch()
        with self.span("readback"):
            mean, std, mag, prof, _counts = [t.cpu().numpy() for t in handle.summary]
            norm = {k: v.cpu().numpy() for k, v in handle.norm_stats.items()}
            weights = self._weights(models)
        return {"hist": hist, "norm": norm, "weights": weights,
                "summary": [mean, std, mag[:, :self.n], prof[:, :c.n_subjects]]}

    def work(self) -> dict:
        return {"members": self.cohort.Xm.shape[0], "batch": self.batch,
                "train_steps": self.epochs * (self.n_pad // self.batch),
                "eval_rows": [self.n_pad, self.n_pad], "encode_rows": [], "flat_params": False}

    def release(self) -> None:
        batched.PROGRAMS.clear()

    def _replay(self, job_seed, stats, mode, fault):
        c, idx = self.cohort, self.checked
        sub = {k: v[idx] for k, v in stats.items()}
        Xz, Xl = normalize.apply(c.Xm[idx], c.Xl[idx], sub)
        Xz, Xl = (torch.from_numpy(x).to(self.device) for x in (Xz, Xl))
        p0, s0, perms, noise = draws.fleet(c.Xm.shape[0], self.n_pad, self.epochs,
                                           self.batch, self.hyper, job_seed, idx)
        params, bn = self.stacked(p0, s0)
        init = {k: v.clone() for k, v in {**params, **bn}.items()}
        with rmodel.precision(mode):
            hist, first = rtrain.train(params, bn, Xz, Xl, torch.from_numpy(c.n_real[idx]),
                                       perms, noise, self.epochs, self.batch,
                                       fault=fault, **self.train_hyper)
        return params, bn, init, hist, first, Xz, Xl

    def _summary(self, params, stats, Xz, Xl, job_seed):
        c, idx, dev = self.cohort, self.checked, self.device
        eps_a, eps_b = (e.to(dev) for e in draws.summary_noise(self.n_pad, self.hyper["latent"],
                                                                  job_seed))
        sham = torch.from_numpy(c.sham[idx]).to(dev)
        mean, std, z, mag = normative.zscores(params, stats, Xz, Xl, sham, eps_a, eps_b)
        prof = normative.subject_profiles(z, torch.from_numpy(c.subject[idx]).to(dev),
                                          c.n_subjects)
        return [mean, std, mag[:, :self.n], prof]
