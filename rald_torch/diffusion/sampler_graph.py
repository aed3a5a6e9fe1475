"""The no-churn Heun sampler replayed as captured CUDA graphs.

Eagerly, each of the sampler's 35 NFEs launches about a thousand small
kernels from Python, and at the product's shapes the host, not the card,
paces the chain. JAX runs the same chain as one ``lax.scan`` inside one
jitted program (``rald_tpu/diffusion/edm.py``); on the card its counterpart
is one ``torch.cuda.CUDAGraph`` of the whole call. :class:`SamplerGraphs`
keeps one such graph per input key (:data:`MAX_KEYS` keys, least recently
used dropped first):

- the first call with a new key runs eagerly (cuBLAS handles, kernel
  attributes and the kernels' TMA descriptor cache are set up outside any
  capture);
- the next call with that key captures, the later ones replay, each
  after copying its prior and condition tokens into the graph's static
  inputs, and each returning a fresh copy of the static output;
- a call whose guard (the storage addresses of the tensors the graph reads
  in place) differs from the captured one captures anew.

The same kernels run in the same order on the same shapes, so a replay
gives the eager call's bits. The kernel wrappers count their launches when
Python calls them (``rald_torch.ops.launch_counts``); a replay calls none,
so the graph adds the launches it recorded at capture on every replay, and
the counters keep counting the kernels that ran on the card.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional

import torch

from rald_torch.ops import KERNELS, launch_counts
from rald_torch.train.profiler import span

MAX_KEYS = 4  # the dataset loop's batch and its short last batch, with room to spare


class CapturedSampler:
    """One captured call ``fn(latents, cond)``: its static inputs and output,
    the kernel launches in it, and the guard it was captured under."""

    def __init__(self, fn: Callable, latents: torch.Tensor, cond: Optional[torch.Tensor],
                 guard: tuple):
        self.guard = guard
        self.latents = latents.clone()
        self.cond = None if cond is None else cond.clone()
        self.graph = torch.cuda.CUDAGraph()
        before = launch_counts()
        # thread-local: a data loader's pinning thread may call the runtime meanwhile
        with torch.cuda.graph(self.graph, capture_error_mode="thread_local"):
            self.out = fn(self.latents, self.cond)
        after = launch_counts()
        self.launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
        for k, n in self.launches.items():  # captured, not run: each replay counts them
            KERNELS[k].launches -= n

    def replay(self, latents: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
        """The captured call on new inputs of the captured shapes; a fresh tensor."""
        with span("sample_graph"):
            self.latents.copy_(latents)
            if cond is not None:
                self.cond.copy_(cond)
            self.graph.replay()
            for k, n in self.launches.items():
                KERNELS[k].launches += n
            return self.out.clone()


class SamplerGraphs:
    """The captured sampler calls of one engine, by input key, and how
    calls were served (:attr:`counts`: ``captures``, ``replays``, ``eager``)."""

    def __init__(self):
        self.entries: OrderedDict = OrderedDict()  # key -> CapturedSampler, None once warmed
        self.counts = {"captures": 0, "replays": 0, "eager": 0}
        self.revision = None  # the model revision the graphs were captured under

    def clear(self) -> None:
        """Drop every graph (its memory pool with it); the keys stay warmed."""
        for key in self.entries:
            self.entries[key] = None

    def applies(self, latents: torch.Tensor) -> bool:
        """Whether a call on ``latents`` can run as a graph: on a CUDA device."""
        return latents.is_cuda

    def eager(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` as it runs without graphs, counted."""
        self.counts["eager"] += 1
        return fn(*args, **kwargs)

    def capture(self, fn, latents, cond, guard) -> CapturedSampler:
        return CapturedSampler(fn, latents, cond, guard)

    def __call__(self, fn: Callable, key, guard: tuple, latents: torch.Tensor,
                 cond: Optional[torch.Tensor]) -> torch.Tensor:
        """``fn(latents, cond)`` for ``key``: eager on the key's first call,
        else the key's graph, captured first where there is none or its
        guard differs from ``guard``."""
        if key not in self.entries:
            self.entries[key] = None
            while len(self.entries) > MAX_KEYS:
                self.entries.popitem(last=False)
            return self.eager(fn, latents, cond)
        self.entries.move_to_end(key)
        g = self.entries[key]
        if g is not None and g.guard == guard:
            self.counts["replays"] += 1
        else:
            self.entries[key] = None  # free the stale graph's pool before capturing
            g = self.entries[key] = self.capture(fn, latents, cond, guard)
            self.counts["captures"] += 1
        return g.replay(latents, cond)
