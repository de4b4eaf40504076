"""What a run draws from its seed, in the order the published trainer and
the fleet's launch draw it (torch's CPU generators).

- A fleet of T members (``fleet``): the members' initial weights one after
  the other from the global generator seeded with ``seed``; then, from a
  generator seeded with ``seed``, every member's permutations of all its
  padded rows (``rand(T, epochs, n_pad).argsort``) and reparameterisation
  noise (T, epochs, n_batches, batch, latent).
- One VAE (``single``): its initial weights from the global generator
  seeded with ``seed``, then, continuing it, each epoch's permutation of
  the real rows with the pad rows kept at the tail, and the noise.
- The normative pass (``summary_noise``): draws A and B, (n, latent) each,
  from generators seeded with ``seed`` and ``seed + 1``.
"""

from __future__ import annotations

from typing import Sequence

import torch

from .model import init_member


def fleet(T: int, n_pad: int, epochs: int, batch_size: int, hyper: dict, seed: int,
          members: Sequence[int]):
    """(initial params, stats, perms, noise) of the ``members`` of a T-member
    fleet, each stacked over those members (on the CPU)."""
    keep = set(members)
    params, stats = [], []
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        for i in range(max(members) + 1):
            p, s = init_member(**hyper)
            if i in keep:
                params.append(p)
                stats.append(s)
    gen = torch.Generator().manual_seed(seed)
    perms = torch.rand((T, epochs, n_pad), generator=gen).argsort(dim=-1)
    noise = torch.randn((T, epochs, n_pad // batch_size, batch_size, hyper["latent"]),
                        generator=gen)
    idx = torch.tensor(list(members))
    return params, stats, perms[idx], noise[idx]


def single(n: int, n_pad: int, epochs: int, batch_size: int, hyper: dict, seed: int):
    """(initial params, stats, perms (1, epochs, n_pad), noise (1, epochs,
    n_batches, batch, latent)) of one VAE."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        p, s = init_member(**hyper)
        tail = torch.arange(n, n_pad)
        perms = torch.stack([torch.cat([torch.randperm(n), tail]) for _ in range(epochs)])
        noise = torch.randn((epochs, n_pad // batch_size, batch_size, hyper["latent"]))
    return [p], [s], perms[None], noise[None]


def summary_noise(n: int, latent: int, seed: int):
    """Draws A and B of the normative pass."""
    return tuple(torch.randn((n, latent), generator=torch.Generator().manual_seed(s))
                 for s in (seed, seed + 1))
