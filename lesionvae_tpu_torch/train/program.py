"""A training run as one device program: the port's counterpart of the JAX
package's jitted ``lax.scan`` programs (``_train_program``,
lesionvae_tpu/train/trainer.py:127-207, and ``_fleet_program``,
lesionvae_tpu/train/batched.py:48-258).

A program holds every tensor an epoch touches at a fixed address: the
state (parameters, Adam moments, step counts, BatchNorm statistics), the
data, the run's draws, the history and a device epoch counter.  Its epoch
body reads the epoch's permutation, noise and KLD weight through that
counter and advances it itself, so an epoch takes no host input.  On
``cuda`` the body is captured once into a CUDA graph and every epoch is one
replay of it; on the CPU the same body runs eagerly.  There is no eager
fallback on the card: a capture or replay that fails raises.

Programs are cached by their static configuration (``ProgramCache``), as
the JAX package caches its jitted programs with ``lru_cache``, so a second
launch of the same configuration (a chunk of a chunked fleet, a real launch
after a ``warm_compile`` one) copies its inputs in and replays the graph
with no new capture.  Evicting a program frees its graph and buffers.

``COUNTS`` counts captures and replays in this process.  A kernel wrapper
counted with ``ops.cuda_build.count_launch`` adds its launches recorded in
a graph to its count once a replay.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Dict, Hashable, Sequence

import torch

from ..ops import masked_bn, sr_adam

#: captures and replays of epoch graphs in this process
COUNTS: Dict[str, int] = {"captures": 0, "replays": 0}


def counted_wrappers():
    """The kernel wrappers an epoch graph may record (``count_launch``)."""
    return (sr_adam.sr_adam_step, *masked_bn.WRAPPERS)


def reset_counts() -> None:
    COUNTS.update(captures=0, replays=0)


class EpochGraph:
    """``body()`` run ``times`` times: captured once into a CUDA graph and
    replayed on ``cuda``, called on the CPU.

    ``state``: every tensor the body carries from one epoch to the next
    (written in place, read by the next epoch).  PyTorch runs a body once
    on a side stream before capturing it (library handles, kernel modules
    and the allocator are set up outside the capture); that run advances
    the state, so ``warm_up`` snapshots ``state`` first and copies it back
    after."""

    def __init__(self, body: Callable[[], None], state: Sequence[torch.Tensor],
                 device):
        self.body, self.state = body, list(state)
        self.device = torch.device(device)
        self.graph = None
        self.per_replay: Dict[object, int] = {}

    def warm_up(self) -> None:
        """One run of the body that leaves ``state`` bit for bit as it was."""
        saved = [t.clone() for t in self.state]
        if self.device.type == "cuda":
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self.body()
            torch.cuda.current_stream(self.device).wait_stream(side)
        else:
            self.body()
        with torch.no_grad():
            for t, s in zip(self.state, saved):
                t.copy_(s)

    def capture(self) -> None:
        self.warm_up()
        before = {fn: fn.captured for fn in counted_wrappers()}
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(graph):
            self.body()
        self.per_replay = {fn: fn.captured - n for fn, n in before.items()}
        self.graph = graph
        COUNTS["captures"] += 1

    def run(self, times: int) -> None:
        if self.device.type != "cuda":
            for _ in range(times):
                self.body()
            return
        if self.graph is None:
            self.capture()
        for _ in range(times):
            self.graph.replay()
            COUNTS["replays"] += 1
            for fn, n in self.per_replay.items():
                fn.launches += n

    def free(self) -> None:
        """Drop the graph (its memory pool goes with it) and the body, which
        holds the program's buffers."""
        self.graph, self.body, self.state = None, None, []


class ProgramCache:
    """At most ``maxsize`` programs by key, the least recently used evicted
    and freed (``program.free()``)."""

    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.programs: "OrderedDict[Hashable, object]" = OrderedDict()

    def get(self, key: Hashable, build: Callable[[], object]):
        program = self.programs.pop(key, None)
        if program is None:
            program = build()
        self.programs[key] = program
        while len(self.programs) > self.maxsize:
            self.programs.popitem(last=False)[1].free()
        return program

    def clear(self) -> None:
        for program in self.programs.values():
            program.free()
        self.programs.clear()

    def __len__(self) -> int:
        return len(self.programs)
