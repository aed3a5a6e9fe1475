"""The stage-2 training step replayed as two captured CUDA graphs.

Eagerly, a step launches the training DiT's forward and backward kernels
and then the optimizer's from Python, one by one, and at the product's
shapes the host, not the card, paces the step. JAX runs the step as one
jitted program (``rald_tpu/train/gen_engine.py`` ``_train_step_impl``); on
the card its counterpart is two ``torch.cuda.CUDAGraph``s that share one
memory pool, as ``torch.cuda.make_graphed_callables`` shares one:

- the first holds the forward, the backward and the float32 gradients,
  and is replayed inside the step's ``forward_backward`` stage;
- the second holds the gradients' global norm, the clip, AdamW, the
  working-copy refresh and the EMA (:meth:`TrainState.device_update`), and
  is replayed inside the step's ``optimizer`` stage.

A step runs as graphs where the code can observe that it holds no host
decision: its tensors are on a CUDA device, there is no process group (no
all-reduce), and the state is :attr:`TrainState.device_only` (no
finiteness test, no accumulation). Every other step runs eagerly and is
counted as ``eager``. As :class:`rald_torch.diffusion.sampler_graph.SamplerGraphs`
does:

- the first step with a new key (the shapes, strides and dtypes of the
  latents, the condition input and injected draws) runs eagerly;
- the next step with that key captures both graphs and replays them, and
  later steps replay, each after copying the latents, the condition input
  and the EDM draws into the graphs' static inputs. The draws are made
  eagerly first, from the step's generator in ``edm_loss``'s order, so the
  graphs hold no RNG;
- a step whose guard (the storage addresses of the tensors the graphs read
  in place, and the state's constants) differs from the captured one
  captures anew.

The lr goes into AdamW's device tensor before the second replay, and the
state's counters advance after it, on the host
(:meth:`TrainState.replay_update`). The same kernels run in the same order
on the same shapes, so a replayed step gives the eager step's bits. The
training model reaches no hand-written kernel, so the graphs have no
launches to count.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from rald_torch.parallel.dist import backend
from rald_torch.train.profiler import span


class CapturedStep:
    """One captured training step: ``forward_backward(latents, cond, rnd,
    noise) -> (loss, grads)`` and ``update(state, grads) -> grad_norm`` as
    two graphs in one pool, their static inputs and outputs, and the guard
    they were captured under. The graphs are captured on the first
    :meth:`forward_backward`, from its inputs and state; the functions are
    dropped then, so a captured step keeps no train state alive (the guard
    holds its addresses, not its tensors)."""

    def __init__(self, forward_backward: Callable, update: Callable, guard: tuple):
        self.fns = (forward_backward, update)
        self.guard = guard
        self.graphs = None

    def _capture(self, inputs, state) -> None:
        forward_backward, update = self.fns
        dev = inputs[0].device
        self.inputs = [None if t is None else torch.empty_like(t, device=dev).copy_(t)
                       for t in inputs]
        fb, up = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        # thread-local: a data loader's pinning thread may call the runtime meanwhile
        with torch.cuda.graph(fb, capture_error_mode="thread_local"):
            self.loss, self.grads = forward_backward(*self.inputs)
        with torch.cuda.graph(up, pool=fb.pool(), capture_error_mode="thread_local"):
            self.grad_norm = update(state, self.grads)
        self.graphs, self.fns = (fb, up), None

    def forward_backward(self, inputs, state) -> torch.Tensor:
        """The first graph on ``inputs`` (latents, condition input or None,
        rnd, noise, of the captured shapes): the loss, a fresh tensor. The
        gradients stay in the graph for :meth:`update`. ``state`` is the
        train state the graphs are captured on, the first time."""
        if self.graphs is None:
            self._capture(inputs, state)
        with span("train_graph"):
            for s, t in zip(self.inputs, inputs):
                if s is not None:
                    s.copy_(t)
            self.graphs[0].replay()
            return self.loss.clone()

    def update(self) -> torch.Tensor:
        """The second graph, on the first one's gradients and the captured
        state's tensors: the gradients' global norm, a fresh tensor."""
        with span("train_graph"):
            self.graphs[1].replay()
            return self.grad_norm.clone()


class TrainGraphs:
    """The captured training step of one engine (one key: the training
    loader drops its short last batch) and how steps were served
    (:attr:`counts`: ``captures``, ``replays``, ``eager``)."""

    def __init__(self):
        self.key = None  # the warmed key
        self.step: Optional[CapturedStep] = None
        self.counts = {"captures": 0, "replays": 0, "eager": 0}

    def on_device(self, latents: torch.Tensor) -> bool:
        """Whether the step's tensors are on a CUDA device."""
        return latents.is_cuda

    def applies(self, state, latents: torch.Tensor) -> bool:
        """Whether a step can run as graphs: on a CUDA device, without a
        process group, with a :attr:`TrainState.device_only` state."""
        return self.on_device(latents) and backend() is None and state.device_only

    def capture(self, forward_backward: Callable, update: Callable, guard: tuple) -> CapturedStep:
        return CapturedStep(forward_backward, update, guard)

    def lookup(self, state, latents: torch.Tensor, key, guard: Callable,
               forward_backward: Callable, update: Callable) -> Optional[CapturedStep]:
        """The captured step to replay for ``key``, captured first where there
        is none or its guard differs from ``guard()``; None where the step
        runs eagerly: it cannot run as graphs, or it is the key's first."""
        if not self.applies(state, latents):
            self.counts["eager"] += 1
            return None
        if key != self.key:
            self.key, self.step = key, None  # drop the old key's graphs and their pool
            self.counts["eager"] += 1
            return None
        g = guard()
        if self.step is not None and self.step.guard == g:
            self.counts["replays"] += 1
        else:
            self.step = None  # free the stale graphs' pool before capturing
            self.step = self.capture(forward_backward, update, g)
            self.counts["captures"] += 1
        return self.step
