"""The mixture-of-experts feed-forward of Hunyuan3D-2.1's DiT (public code
``hy3dshape/models/denoisers/moe_layers.py``: ``MoEBlock``, ``MoEGate``),
in the public code's ``state_dict`` layout, routed on the device.

For the (T, D) normed rows ``h`` of a block, with ``E`` experts of the
published ``FeedForward`` (``D -> inner``, exact GELU, ``inner -> D``):

    g = softmax(W_gate h)                    (E logits, no bias)
    (g_j, e_j) = top-k of g                  (not renormalised)
    out = sum_j g_j FFN_{e_j}(h) + FFN_shared(h)

The public code routes on the host (``bincount().cpu()``, then a loop over
the experts), which a captured CUDA graph cannot hold. Here every step
stays on the device, with shapes that depend on T alone:

1. the gate GEMM, softmax (float32) and top-k;
2. a stable sort of the k T (token, slot) pairs by expert;
3. each expert's count by ``scatter_add_`` into an (E,) buffer, and the
   offsets ``[0, cumsum]`` of the experts' rows in sorted order;
4. the rows gathered into that order;
5. :func:`rald_torch.ops.moe_grouped_ffn`: each expert's FFN on its rows,
   the bias and exact GELU fused into the first GEMM, the bias and the
   gate weight into the second (a hand kernel on the card, whose tiles find
   their expert from the offsets in device memory; the per-expert loop on
   the CPU);
6. the combine: each token's k weighted rows summed in slot order, by
   gathers (no atomics), so a replay gives the same bits;
7. the shared expert (cuBLAS), added to that sum.

Each call adds its per-expert counts to :attr:`MoEFFN.tokens` and one to
:attr:`MoEFFN.calls`, int64 device buffers that a captured graph updates on
every replay; the engine reads them after the timed work
(``GenerationEngine.moe_counts``). The call runs under a ``moe`` span and
its routing (steps 1-4) under ``moe_route``; like every span of the
sampler, they open in eager and capturing calls only.

The experts' weights are the public per-expert ``nn.Linear`` modules, whose
parameters are views into one stacked tensor of each kind (``(E, inner,
D)``, ``(E, inner)``, ``(E, D, inner)``, ``(E, D)``) from every move or cast
of the module on: the kernel reads the stack in place, a loaded
``state_dict`` writes into it, and nothing is copied per call.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rald_torch.ops import moe_grouped_ffn
from rald_torch.train.profiler import span


class GELUProj(nn.Module):
    """The published ``FeedForward``'s first layer: ``proj``, then exact GELU."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.proj(x))


class FeedForward(nn.Module):
    """``net.0.proj`` (D -> inner), exact GELU, ``net.2`` (inner -> D)."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, inner), nn.Identity(), nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.net[2](self.net[0](x))


class MoEFFN(nn.Module):
    """``MoEBlock``: ``num_experts`` routed experts at top ``top_k`` and one
    shared expert, each ``dim -> inner -> dim``."""

    def __init__(self, dim: int, inner: int, num_experts: int = 8, top_k: int = 2):
        super().__init__()
        if not 1 <= top_k <= num_experts:
            raise ValueError(f"top_k {top_k} must lie in [1, {num_experts}]")
        self.top_k = top_k
        self.experts = nn.ModuleList([FeedForward(dim, inner) for _ in range(num_experts)])
        self.gate = nn.Linear(dim, num_experts, bias=False)  # the published MoEGate's weight
        self.shared_experts = FeedForward(dim, inner)
        self.register_buffer("tokens", torch.zeros(num_experts, dtype=torch.int64), persistent=False)
        self.register_buffer("calls", torch.zeros((), dtype=torch.int64), persistent=False)
        self._stack()

    def _apply(self, fn, *args, **kwargs):
        # a move or cast gives each expert parameter storage of its own: stack again
        super()._apply(fn, *args, **kwargs)
        self._stack()
        return self

    @torch.no_grad()
    def _stack(self) -> None:
        """Point the experts' parameters at slices of one stacked tensor of
        each kind (:attr:`w1`, :attr:`b1`, :attr:`w2`, :attr:`b2`)."""
        first = [e.net[0].proj for e in self.experts]
        second = [e.net[2] for e in self.experts]
        stacks = []
        for mods, attr in ((first, "weight"), (first, "bias"), (second, "weight"), (second, "bias")):
            params = [getattr(m, attr) for m in mods]
            stack = torch.stack([p.data for p in params])
            for i, p in enumerate(params):
                p.data = stack[i]
            stacks.append(stack)
        self.w1, self.b1, self.w2, self.b2 = stacks

    def route(self, h: torch.Tensor) -> tuple:
        """(T, D) rows -> their (k T, D) copies in expert order, the gate
        weight of each copy (float32), the (E + 1,) int32 offsets of each
        expert's copies, the place of each (token, slot) pair in that order,
        and the (E,) counts."""
        num_experts = self.w1.shape[0]
        scores = F.linear(h, self.gate.weight).float().softmax(-1)
        weight, expert = scores.topk(self.top_k, dim=-1)
        pairs = expert.flatten()  # pair p = token * top_k + slot
        order = torch.sort(pairs, stable=True).indices
        counts = torch.zeros(num_experts, dtype=torch.int64, device=h.device)
        counts.scatter_add_(0, pairs, torch.ones_like(pairs))
        offsets = torch.zeros(num_experts + 1, dtype=torch.int32, device=h.device)
        offsets[1:] = counts.cumsum(0)
        place = torch.empty_like(order).scatter_(
            0, order, torch.arange(order.numel(), device=h.device))
        rows = h.index_select(0, order // self.top_k)
        return rows, weight.flatten().index_select(0, order), offsets, place, counts

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        """(..., D) normed rows -> the mixture's output, same shape."""
        shape = h.shape
        h = h.reshape(-1, shape[-1])
        with span("moe"):
            with span("moe_route"):
                rows, weight, offsets, place, counts = self.route(h)
            self.tokens += counts
            self.calls += 1
            out = moe_grouped_ffn(rows, offsets, self.w1, self.b1, self.w2, self.b2, weight)
            out = out.index_select(0, place).view(h.shape[0], self.top_k, -1)
            routed = out[:, 0]
            for j in range(1, self.top_k):
                routed = routed + out[:, j]
            return (routed + self.shared_experts(h)).view(shape)
