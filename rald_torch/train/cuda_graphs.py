"""The engine's calls replayed as captured CUDA graphs.

Eagerly, the sampler's NFEs and the training step launch thousands of small
kernels from Python, and at the product's shapes the host, not the card,
paces them. JAX runs each as one jitted program; on the card its
counterpart is a :class:`CapturedGraphs`: ``torch.cuda.CUDAGraph``s
captured in order into one memory pool, as
``torch.cuda.make_graphed_callables`` shares one. The no-churn sampler is
one graph; the training step two, forward + backward, then the optimizer.

A :class:`GraphCache` keeps one entry per input key (at most ``max_keys``,
least recently used dropped first) and serves every call by one rule:

- the first call with a new key runs eagerly (cuBLAS handles, kernel
  attributes and the kernels' TMA descriptor cache are set up outside any
  capture);
- the next call with that key captures, the later ones replay, each after
  copying its inputs into the graphs' static inputs, and each returning a
  fresh copy of the static output;
- a call whose guard (the storage addresses of the tensors the graphs read
  in place, and any constant they hold) differs from the captured one
  captures anew.

The key holds what a graph is specific to (shapes, strides, dtypes, modes,
settings), the guard what it reads in place: a graph is stale when, and only
when, one of them changes. The same kernels run in the same order on the
same shapes, so a replay gives the eager call's bits. The kernel wrappers
count their launches when Python calls them (``rald_torch.ops.launch_counts``);
a replay calls none, so each graph adds the launches it recorded at capture
on every replay, and the counters keep counting the kernels that ran on the
card.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Callable, Optional, Sequence

import torch

from rald_torch.ops import KERNELS, launch_counts
from rald_torch.train.profiler import span


class CapturedGraphs:
    """One key's captured calls: ``fns[0](*inputs)``, then each later
    ``fns[i]()``, as graphs in one pool; their static inputs (None stays
    None) and outputs, the kernel launches of each, and the guard they were
    captured under. The graphs are captured on the first :meth:`replay`,
    from its inputs; the functions are dropped then, so a captured entry
    keeps nothing they close over alive (the guard holds addresses, not
    tensors)."""

    def __init__(self, name: str, fns: Sequence[Callable], guard: tuple):
        self.name, self.fns, self.guard = name, fns, guard
        self.graphs = None

    def _capture(self, inputs) -> None:
        dev = inputs[0].device
        self.inputs = [None if t is None else torch.empty_like(t, device=dev).copy_(t)
                       for t in inputs]
        self.graphs, self.outs, self.launches = [], [], []
        for i, fn in enumerate(self.fns):
            graph = torch.cuda.CUDAGraph()
            pool = self.graphs[0].pool() if self.graphs else None
            before = launch_counts()
            # thread-local: a data loader's pinning thread may call the runtime meanwhile
            with torch.cuda.graph(graph, pool=pool, capture_error_mode="thread_local"):
                self.outs.append(fn(*self.inputs) if i == 0 else fn())
            after = launch_counts()
            launches = {k: after[k] - before[k] for k in after if after[k] != before[k]}
            for k, n in launches.items():  # captured, not run: each replay counts them
                KERNELS[k].launches -= n
            self.graphs.append(graph)
            self.launches.append(launches)
        self.fns = None

    def replay(self, i: int, *inputs) -> torch.Tensor:
        """Graph ``i``, after copying ``inputs`` (of the captured shapes) into
        the static inputs where given: its output, a fresh tensor."""
        if self.graphs is None:
            self._capture(inputs)
        with span(self.name):
            for s, t in zip(self.inputs, inputs):
                if s is not None:
                    s.copy_(t)
            self.graphs[i].replay()
            for k, n in self.launches[i].items():
                KERNELS[k].launches += n
            return self.outs[i].clone()


class GraphCache:
    """The captured calls of one engine path, by input key, and how calls
    were served (:attr:`counts`: ``captures``, ``replays``, ``eager``).
    ``name`` is the span each replay opens; a cache of ``max_keys = 0``
    runs every call eagerly."""

    def __init__(self, name: str, max_keys: int):
        self.name, self.max_keys = name, max_keys
        self.entries: OrderedDict = OrderedDict()  # key -> CapturedGraphs, None once warmed
        self.counts = {"captures": 0, "replays": 0, "eager": 0}

    def clear(self) -> None:
        """Drop every graph (its memory pool with it); the keys stay warmed."""
        for key in self.entries:
            self.entries[key] = None

    def applies(self, tensor: torch.Tensor) -> bool:
        """Whether a call on ``tensor`` can run as graphs: on a CUDA device."""
        return tensor.is_cuda

    def eager(self, fn: Callable, *args, **kwargs):
        """``fn(*args, **kwargs)`` as it runs without graphs, counted."""
        self.counts["eager"] += 1
        return fn(*args, **kwargs)

    def capture(self, fns: Sequence[Callable], guard: tuple) -> CapturedGraphs:
        return CapturedGraphs(self.name, fns, guard)

    def lookup(self, key, guard: tuple, fns: Sequence[Callable]) -> Optional[CapturedGraphs]:
        """The entry to replay for ``key``, a new one of ``fns`` where there
        is none or its guard differs from ``guard``; None on the key's first
        call, which the caller runs through :meth:`eager`."""
        if key not in self.entries:
            self.entries[key] = None
            while len(self.entries) > self.max_keys:
                self.entries.popitem(last=False)  # its graphs and their pool with it
            return None
        self.entries.move_to_end(key)
        g = self.entries[key]
        if g is not None and g.guard == guard:
            self.counts["replays"] += 1
        else:
            self.entries[key] = None  # free the stale graphs' pool before capturing
            g = self.entries[key] = self.capture(fns, guard)
            self.counts["captures"] += 1
        return g
