"""Hunyuan3D-DiT-v2-1: the flow-matching denoiser of Hunyuan3D-2.1's shape
generator (arXiv:2506.15442; public code ``hy3dshape/models/denoisers/
hunyuandit.py`` ``HunYuanDiTPlain``, config ``hunyuan3d-dit-v2-1/
config.yaml``), in the public code's ``state_dict`` layout.

A U-Net-shaped transformer over the latent set ``z`` (4096 x 64), with
the flow time as one more token and an image encoder's tokens ``c`` (1370
x 1024, DINOv2-large) read by cross-attention. No modulation:

- ``x = [t_embedder(emb(1000 t)) ; x_embedder(z)]``: the time token first,
  ``emb`` ``hidden`` sinusoidal channels (cos, then sin), ``t_embedder`` a
  ``hidden -> 4 hidden -> hidden`` exact-GELU MLP;
- ``depth`` blocks (:class:`DiTBlock`), pre-norm, affine LayerNorms at eps
  1e-6: self-attention (RMS QK-norm with a learned scale, no QKV bias),
  cross-attention from the tokens to ``c``, and a feed-forward, each a
  residual. The blocks past the middle (``l > depth // 2``) first join the
  output of block ``depth - 1 - l`` to their input through ``skip_linear``
  over ``[skip ; x]`` and ``skip_norm``; the last ``num_moe_layers`` blocks'
  feed-forward is the mixture of experts of :mod:`rald_torch.models.moe`;
- the final layer normalises, drops the time token and projects back to
  ``in_channels``.

The GEMMs run in cuBLAS (q, k and v as three, as published), both
attentions in ``F.scaled_dot_product_attention``, the 128-wide QK-norm in
``F.rms_norm``; the routed experts in the hand kernel
:func:`rald_torch.ops.moe_grouped_ffn`. The time token depends on ``t``
alone, so the sampler computes it for all its steps at once
(:meth:`Hunyuan3DDiTPlain.sample`).
The model has no fused, int8 or training path; the engine refuses those
flags for it. It brings the engine its sampler (:meth:`sample`, the guided
Euler steps of :mod:`rald_torch.diffusion.flow`, as Hunyuan3D-2.0's DiT)
and what a captured sampler depends on, under the names the other DiTs
give them; :meth:`moe_layers` lists the mixtures, whose counters the
engine reads.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rald_torch.diffusion.flow import flow_euler_cfg, flow_times
from rald_torch.models.mmdit import timestep_embedding
from rald_torch.models.moe import MoEFFN

EPS = 1e-6  # of every LayerNorm and RMSNorm of the DiT
TIME_FACTOR = 1000.0  # the time token's sinusoid takes 1000 t (assumed, as the 2.0 DiT's)


def _ln(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=EPS)


class RMSNorm(nn.Module):
    """RMS norm over the last axis with a learned ``weight``, at :data:`EPS`
    (``F.rms_norm``: statistics in float32)."""

    def __init__(self, dim: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x, (x.shape[-1],), self.weight, EPS)


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H * Dh) -> (B, H, L, Dh)."""
    b, n, _ = t.shape
    return t.view(b, n, heads, -1).transpose(1, 2)


class Attention(nn.Module):
    """Attention of ``dim``-wide queries over ``kv_dim``-wide keys and
    values: ``to_q``, ``to_k``, ``to_v`` (no bias), per-head RMS ``q_norm`` /
    ``k_norm``, softmax at scale Dh^-0.5, ``out_proj``. Self-attention when
    called with one argument."""

    def __init__(self, dim: int, num_heads: int, kv_dim: Optional[int] = None):
        super().__init__()
        kv_dim = kv_dim or dim
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(kv_dim, dim, bias=False)
        self.to_v = nn.Linear(kv_dim, dim, bias=False)
        self.q_norm = RMSNorm(dim // num_heads)
        self.k_norm = RMSNorm(dim // num_heads)
        self.out_proj = nn.Linear(dim, dim)

    def forward(self, x: torch.Tensor, c: Optional[torch.Tensor] = None) -> torch.Tensor:
        c = x if c is None else c
        h = self.num_heads
        q = self.q_norm(_heads(self.to_q(x), h))
        k = self.k_norm(_heads(self.to_k(c), h))
        out = F.scaled_dot_product_attention(q, k, _heads(self.to_v(c), h))
        return self.out_proj(out.transpose(1, 2).flatten(2))


class MLP(nn.Module):
    """``fc1``, exact GELU, ``fc2``."""

    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, inner)
        self.fc2 = nn.Linear(inner, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class DiTBlock(nn.Module):
    """``HunYuanDiTBlock``: the long skip (``skip_linear``, ``skip_norm``)
    where ``skip``, self-attention (``norm1``, ``attn1``), cross-attention
    (``norm2``, ``attn2``) and the feed-forward (``norm3``, ``mlp`` or
    ``moe``), each a residual."""

    def __init__(self, dim: int, num_heads: int, context_dim: int, skip: bool = False,
                 moe: bool = False, num_experts: int = 8, moe_top_k: int = 2):
        super().__init__()
        inner = 4 * dim
        self.norm1 = _ln(dim)
        self.attn1 = Attention(dim, num_heads)
        self.norm2 = _ln(dim)
        self.attn2 = Attention(dim, num_heads, context_dim)
        self.norm3 = _ln(dim)
        if skip:
            self.skip_norm = _ln(dim)
            self.skip_linear = nn.Linear(2 * dim, dim)
        else:
            self.skip_linear = None
        if moe:
            self.moe = MoEFFN(dim, inner, num_experts, moe_top_k)
        else:
            self.mlp = MLP(dim, inner)

    def forward(self, x: torch.Tensor, c: torch.Tensor,
                skip: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.skip_linear is not None:
            x = self.skip_norm(self.skip_linear(torch.cat([skip, x], -1)))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), c)
        ffn = self.moe if hasattr(self, "moe") else self.mlp
        return x + ffn(self.norm3(x))


class TimestepEmbedder(nn.Module):
    """``mlp``: ``hidden -> 4 hidden``, exact GELU, ``-> hidden``, of the
    time's ``hidden`` sinusoidal channels."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim
        self.mlp = nn.Sequential(nn.Linear(dim, 4 * dim), nn.GELU(), nn.Linear(4 * dim, dim))

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        """(R,) flow times -> (R, 1, hidden) time tokens."""
        emb = timestep_embedding(t, self.dim, time_factor=TIME_FACTOR)
        return self.mlp(emb.to(self.mlp[0].weight.dtype))[:, None]


class FinalLayer(nn.Module):
    def __init__(self, dim: int, out_channels: int):
        super().__init__()
        self.norm_final = _ln(dim)
        self.linear = nn.Linear(dim, out_channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.linear(self.norm_final(x)[:, 1:])


class Hunyuan3DDiTPlain(nn.Module):
    """The denoiser: ``velocity(x, t, cond)`` of (B, n_latents, in_channels)
    latents, (B,) flow times and (B, T, context_dim) condition tokens. The
    published v2-1 widths are the defaults. ``n_latents`` is the latent
    set's size (the ShapeVAE's ``num_latents``); ``dtype`` as the other
    models'."""

    use_int8_ff = use_int8_attn = False
    EVAL_ONLY = True
    SAMPLER = dict(num_steps=50, guidance_scale=5.0)

    def __init__(
        self,
        in_channels: int = 64,
        hidden_size: int = 2048,
        context_dim: int = 1024,
        depth: int = 21,
        num_heads: int = 16,
        num_moe_layers: int = 6,
        num_experts: int = 8,
        moe_top_k: int = 2,
        n_latents: int = 4096,
        dtype=None,
    ):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads {num_heads}")
        self.compute_dtype = dtype
        self.n_latents, self.channels = n_latents, in_channels
        self.context_in_dim, self.hidden_size = context_dim, hidden_size
        self.x_embedder = nn.Linear(in_channels, hidden_size)
        self.t_embedder = TimestepEmbedder(hidden_size)
        self.blocks = nn.ModuleList([
            DiTBlock(hidden_size, num_heads, context_dim, skip=layer > depth // 2,
                     moe=depth - layer <= num_moe_layers,
                     num_experts=num_experts, moe_top_k=moe_top_k)
            for layer in range(depth)])
        self.final_layer = FinalLayer(hidden_size, in_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.x_embedder.weight.dtype

    def moe_layers(self) -> list:
        """The blocks' mixtures of experts, in order."""
        return [b.moe for b in self.blocks if hasattr(b, "moe")]

    def process_cond(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, context_dim) encoder tokens, read as they are by every
        block's cross-attention: only cast to the model's dtype."""
        return tokens.to(self.dtype)

    def velocity_with_time(self, x: torch.Tensor, c: torch.Tensor,
                           temb: torch.Tensor) -> torch.Tensor:
        """The velocity of (B, N, in_channels) latents ``x`` given ``c``
        (B, T, context_dim) and the time tokens (B or 1, 1, hidden)."""
        h = self.x_embedder(x.to(self.dtype))
        h = torch.cat([temb.expand(h.shape[0], -1, -1), h], 1)
        skips, mid = [], len(self.blocks) // 2
        for layer, blk in enumerate(self.blocks):
            h = blk(h, c, skips.pop() if layer > mid else None)
            if layer < mid:
                skips.append(h)
        return self.final_layer(h)

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: torch.Tensor) -> torch.Tensor:
        """The velocity at (B,) flow times ``t`` from raw condition tokens."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(x.shape[0])
        return self.velocity_with_time(x, self.process_cond(cond), self.t_embedder(t))

    def set_fast(self) -> None:
        """No fused path: the model as built."""

    def sample(self, latents: torch.Tensor, cond: torch.Tensor, num_steps: int = 50,
               guidance_scale: float = 5.0, act_scales=None, capture_states: bool = False):
        """The guided Euler sampler (:func:`flow_euler_cfg`) from the prior
        ``latents`` and ``cond`` (B, T, context_dim): the time tokens of
        every step at once, the unconditional rows' condition zero tokens."""
        if act_scales is not None or capture_states:
            raise ValueError("act_scales and capture_states belong to the EDM sampler's int8 "
                             "calibration; the flow sampler has none")
        temb = self.t_embedder(flow_times(num_steps, latents.device))
        c2 = torch.cat([cond, torch.zeros_like(cond)])

        def velocity(x2, i):
            return self.velocity_with_time(x2, c2, temb[i:i + 1])

        return flow_euler_cfg(velocity, latents, num_steps, guidance_scale)

    def sampler_calls(self, batch: int, num_steps: int, **_) -> tuple:
        """(DiT calls, their batch rows) of one sampling of ``batch``
        samples: one call a step, on the 2 ``batch`` rows of guidance."""
        return num_steps, num_steps * 2 * batch

    def graph_modes(self) -> tuple:
        """No modes: a captured sampler depends on the shapes and settings."""
        return ()

    def graph_tensors(self) -> list:
        """The tensors a captured sampler reads or updates in place: the
        parameters, and the buffers (the mixtures' counters among them)."""
        return [*self.parameters(), *self.buffers()]
