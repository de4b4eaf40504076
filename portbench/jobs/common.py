"""What every job kind shares: the cohort made from the run's seed, the
members whose outputs the check replays, and the comparison with the plain
reference (``portbench.check``).

A job kind subclasses ``Job`` and gives ``run`` (the timed call into the
program, returning what a user gets on the host plus the checked members'
trained weights), ``work`` (the counts the per-layer metrics read),
``_replay`` (the reference's training of the checked members from the job's
seed) and ``_summary`` (the reference's normative pass, in ``run``'s
order)."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional

import numpy as np
import torch
from lesionvae_tpu_torch.train import program
from lesionvae_tpu_torch.utils import precision
from torch.profiler import record_function

from .. import check, inputs
from ..reference import model as rmodel
from ..reference import normalize

NORM_FIELDS = ("median", "mean", "std")


class Job:
    #: where the job kind normalizes the raw blocks: its configurations'
    #: ``normalization``
    NORMALIZATION = ""

    def __init__(self, config: dict, traffic: dict, seed: int, device="cuda"):
        if config["normalization"] != self.NORMALIZATION:
            raise ValueError(f"this job kind normalizes on the {self.NORMALIZATION}, "
                             f"the configuration says {config['normalization']!r}")
        if (config["storage"], config["compute"]) != ("float32", "float32"):
            raise ValueError("the job kinds run float32 storage and compute only")
        if traffic["loop"] != "closed":
            raise ValueError("the harness runs jobs back to back only (loop 'closed')")
        self.config, self.traffic, self.device = config, traffic, torch.device(device)
        self.spans: Dict[str, float] = {}
        self.hyper = {k: int(config[k]) for k in ("seq_len", "micro_ch", "lesion_ch", "latent")}
        self.epochs, self.batch = int(config["epochs"]), int(config["batch_size"])
        self.train_hyper = {k: float(config[k]) for k in ("lr", "weight_decay", "grad_clip")}
        self.cohort = inputs.make_cohort(traffic, self.hyper["seq_len"],
                                         self.hyper["micro_ch"], self.hyper["lesion_ch"],
                                         self.batch, seed, self.device)
        T = self.cohort.Xm.shape[0]
        self.checked = inputs.sample(seed, T, int(traffic["check_members"]), salt=2)
        self.n_pad = self.cohort.Xm.shape[1]
        self.n = int(self.cohort.n_real[0])

    # ------------------------------------------------------------ program
    def run(self, job_seed: int) -> dict:
        raise NotImplementedError

    @contextlib.contextmanager
    def span(self, name: str):
        """A range of the job's calls, in the trace and in host seconds."""
        t = time.perf_counter()
        with record_function(name):
            yield
        self.spans[name] = self.spans.get(name, 0.0) + time.perf_counter() - t

    def take_spans(self) -> Dict[str, float]:
        spans, self.spans = self.spans, {}
        return spans

    def check_precision(self) -> None:
        """After a job on a card: TF32 is in force as the configuration's
        ``tf32`` says (the program sets its own math modes)."""
        if self.device.type != "cuda":
            return
        cublas, cudnn, matmul = precision.math_mode()
        tf32 = cublas or cudnn or matmul != "highest"
        if tf32 != bool(self.config["tf32"]):
            raise ValueError(f"the program ran with TF32 {'on' if tf32 else 'off'}, the "
                             f"configuration says tf32={self.config['tf32']}")

    def rows(self) -> int:
        """Real rows trained by one job: members x real rows x epochs."""
        return int(self.cohort.n_real.sum()) * self.epochs

    def work(self) -> dict:
        raise NotImplementedError

    def release(self) -> None:
        """Free what the program keeps between jobs (its cached programs)."""

    def _weights(self, models) -> Dict[str, torch.Tensor]:
        """The checked members' trained parameters and statistics (of the
        program's ``TrainedVAE``s), stacked, on the host."""
        sds = [models[i].module.state_dict() for i in self.checked]
        return {k: torch.stack([sd[k].detach() for sd in sds]).cpu() for k in sds[0]}

    # ---------------------------------------------------------- reference
    def _replay(self, job_seed: int, stats: dict, mode: str, fault: Optional[str]):
        """-> (params, stats, initial params and stats, history, first
        gradient norms, Xz, Xl) of the checked members, on the device."""
        raise NotImplementedError

    def _summary(self, params, stats, Xz, Xl, job_seed: int) -> List[torch.Tensor]:
        raise NotImplementedError

    def fit_stats(self) -> Dict[str, np.ndarray]:
        return normalize.fit(self.cohort.Xm, self.cohort.n_real)

    def reference(self, job_seed: int, mode: str = "float32",
                  fault: Optional[str] = None) -> dict:
        """The reference put in the program's place, computed in ``mode``,
        with ``fault`` planted: outputs of the checked members as ``run``
        gives them."""
        stats = self.fit_stats()
        params, bn, _init, hist, _first, Xz, Xl = self._replay(job_seed, stats, mode, fault)
        with rmodel.precision(mode):
            summary = [t.cpu().numpy() for t in self._summary(params, bn, Xz, Xl, job_seed)]
        if fault == "altered":              # an answer of each kind altered where produced
            stats = {k: v.copy() for k, v in stats.items()}
            for x in (summary[-1], stats["median"]):
                x.reshape(-1)[0] += 0.05 * max(abs(x).max(), 1.0)
        weights = {k: v.cpu() for k, v in {**params, **bn}.items()}
        return {"norm": stats, "hist": hist, "weights": weights, "summary": summary}

    def readings(self, out: dict, job_seed: int) -> Dict[str, float]:
        """The gaps of ``out`` (``run``'s or ``reference``'s) from the float32
        reference: the normalization of every member; the training of the
        checked members replayed from the job's seed; their normative pass
        worked out again from ``out``'s trained weights."""
        idx = self.checked
        pick = lambda a: a if len(a) == len(idx) else a[idx]  # noqa: E731
        stats = self.fit_stats()
        r = {"norm": max(check.rel_gap(out["norm"][k], stats[k]) for k in NORM_FIELDS)}
        params, bn, init, hist, first, Xz, Xl = self._replay(job_seed, stats, "float32", None)
        w = out["weights"]
        r["hist1"] = check.hist_gap(pick(out["hist"])[:, :1], hist[:, :1])
        r["hist"] = check.hist_gap(pick(out["hist"]), hist, columns=2)
        first_epoch = check.member_hist_gaps(pick(out["hist"])[:, :1], hist[:, :1], columns=2)
        r["hist1_loss_recon"] = float(first_epoch.max())
        r["hist1_median"] = float(np.median(first_epoch))
        r["stats"] = check.stats_gap({k: w[k] for k in bn}, bn)
        r["stats_change"] = check.stats_change_gap({k: w[k] for k in bn}, bn, init)
        r["change"] = check.change_gap({k: w[k] for k in params}, params, init, first)
        dev = Xz.device
        with rmodel.precision("float32"):
            ref = self._summary({k: w[k].to(dev) for k in params},
                                {k: w[k].to(dev) for k in bn}, Xz, Xl, job_seed)
        r["summary"] = max(check.rel_gap(pick(got), want)
                           for got, want in zip(out["summary"], ref))
        return r

    def stacked(self, params, stats):
        return rmodel.stack(params, self.device), rmodel.stack(stats, self.device)


def program_counts() -> dict:
    """The program's graph captures and replays so far: a capture inside the
    window would be a compile there."""
    return dict(program.COUNTS)


def finite(out: dict) -> bool:
    """Whether every number a user gets from the job is finite."""
    parts = [out["hist"], *out["summary"], *out["norm"].values()]
    return all(np.isfinite(np.asarray(p)).all() for p in parts)
