"""A stand-in for the engine's CUDA-graph cache on the CPU, which cannot
capture (:mod:`rald_torch.train.cuda_graphs`): :class:`StandCache` applies
to every tensor, and each entry it "captures" replays by calling its
functions, so the cache's keys, guards, counts and the engine's host logic
around a replay run as on the card."""
from __future__ import annotations

from rald_torch.train.cuda_graphs import GraphCache


class _Stand:
    """A stand-in for a captured entry: replay ``i`` calls ``fns[i]``."""

    def __init__(self, fns, guard):
        self.fns, self.guard, self.replays = fns, guard, 0

    def replay(self, i, *inputs):
        self.replays += 1
        return self.fns[i](*inputs)


class StandCache(GraphCache):
    """The cache as on the card, with :class:`_Stand` for the capture."""

    def applies(self, tensor):
        return True

    def capture(self, fns, guard):
        return _Stand(fns, guard)
