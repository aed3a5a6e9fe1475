"""Hunyuan3D-DiT-v2-0: the flow-matching denoiser of Hunyuan3D-2.0's shape
generator (arXiv:2501.12202; public code ``hy3dgen/shapegen/models/
denoisers/hunyuan3ddit.py``, config ``hunyuan3d-dit-v2-0/config.yaml``),
in the public code's ``state_dict`` layout.

A FLUX-style DiT over an unordered set of latent tokens ``x`` (3072 x 64),
conditioned on an image encoder's tokens ``c`` (1370 x 1536) and on the
flow time ``t``:

- ``vec = time_in(emb(1000 t))``, ``emb`` 256 sinusoidal channels (cos,
  then sin, max period 10000), ``time_in`` Linear -> SiLU -> Linear;
- ``x = latent_in(z)``, ``c = cond_in(cond)``, no positional embedding;
- 16 dual-stream blocks (:class:`DoubleStreamBlock`): per-stream weights,
  gated AdaLN on both sublayers, RMS QK-norm, one joint softmax attention
  over ``[c ; x]``, a tanh-GELU MLP;
- 32 single-stream blocks (:class:`SingleStreamBlock`) over ``h = [c ;
  x]``: one ``linear1`` gives qkv and the MLP's input, attention and MLP
  run side by side and ``linear2`` takes both, behind one gate;
- the final layer drops the condition tokens, modulates and projects
  back to 64 channels.

Every LayerNorm of the DiT is without affine at eps 1e-6; every
modulation row ``Linear(SiLU(vec))`` depends on ``t`` alone. So the
sampler computes them for all its steps at once (:meth:`Hunyuan3DDiT.mod_rows`)
and hoists ``cond_in`` out of its loop (:meth:`Hunyuan3DDiT.process_cond`):
the same numbers as evaluating them in every call. The scale rows are
stored as ``1 + scale``, the sum the public code forms at each use.

One kernel of this package runs here: on the card each block's q / k / v
split and RMS QK-norm, with the dual-stream blocks' joint ``[c ; x]``
layout, is :func:`rald_torch.ops.split_qk_norm` (``csrc/qk_norm.cu``; its
plain version on the CPU). The GEMMs stay in cuBLAS and the attention in
``F.scaled_dot_product_attention``. The model has no fused, int8 or
training path; the engine refuses those flags for it. It brings the
engine its sampler (:meth:`Hunyuan3DDiT.sample`, the guided Euler steps of
:mod:`rald_torch.diffusion.flow`) and what a captured sampler depends on,
under the names the RaLD DiT gives them.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rald_torch.diffusion.flow import flow_euler_cfg, flow_times
from rald_torch.ops import split_qk_norm
from rald_torch.train.profiler import span


def timestep_embedding(t: torch.Tensor, dim: int = 256, max_period: float = 10000.0,
                       time_factor: float = 1000.0) -> torch.Tensor:
    """(R,) flow times -> (R, dim) float32 embedding of ``time_factor * t``:
    cos, then sin, of ``dim / 2`` frequencies ``max_period ** (-k / (dim / 2))``."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = (time_factor * t.float())[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


EPS = 1e-6  # of every LayerNorm and RMSNorm of the DiT


def layer_norm(x: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """LayerNorm without affine over the last axis."""
    return F.layer_norm(x, (x.shape[-1],), eps=eps)


class RMSNorm(nn.Module):
    """The learned ``scale`` of an RMSNorm at :data:`EPS`, applied by
    :func:`split_qk_norm`: statistics and the scale in float32, rounded to
    the input's dtype once (the public code rounds the normed value, then
    multiplies by the scale in that dtype)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)

    def part(self, qkv: torch.Tensor) -> tuple:
        """One stream's ``(qkv, q scale, k scale)`` for :func:`split_qk_norm`."""
        return qkv, self.query_norm.scale, self.key_norm.scale


class SelfAttention(nn.Module):
    """``qkv`` (the output's channels are [q | k | v], each heads x 64),
    the RMS QK-norm and ``proj``."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.norm = QKNorm(dim // num_heads)
        self.proj = nn.Linear(dim, dim)

    def part(self, m: torch.Tensor) -> tuple:
        """(B, L, D) modulated input -> its ``(qkv, q scale, k scale)``."""
        return self.norm.part(self.qkv(m))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Softmax attention at scale Dh^-0.5: (B, H, L, Dh) -> (B, L, H * Dh)."""
    out = F.scaled_dot_product_attention(q, k, v)
    return out.transpose(1, 2).flatten(2)


def modulate(x: torch.Tensor, shift: torch.Tensor, scale1: torch.Tensor) -> torch.Tensor:
    """``(1 + scale) * LN(x) + shift``, given ``scale1 = 1 + scale``."""
    return torch.addcmul(shift, layer_norm(x), scale1)


class Modulation(nn.Module):
    def __init__(self, dim: int, rows: int):
        super().__init__()
        self.lin = nn.Linear(dim, rows * dim)


def _mlp(dim: int, hidden: int) -> nn.Sequential:
    return nn.Sequential(nn.Linear(dim, hidden), nn.GELU(approximate="tanh"), nn.Linear(hidden, dim))


class DoubleStreamBlock(nn.Module):
    """A dual-stream block: the latent stream (``img_*``) and the condition
    stream (``txt_*``) each with their own modulation, QKV, projection and
    MLP, joined in one attention over ``[c ; x]``. Its 12 modulation rows:
    the latents' shift, 1 + scale, gate of the attention and of the MLP,
    then the condition's."""

    ROWS = 12
    SCALE_ROWS = (1, 4, 7, 10)

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, qkv_bias: bool = True):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.img_mod = Modulation(dim, 6)
        self.img_attn = SelfAttention(dim, num_heads, qkv_bias)
        self.img_mlp = _mlp(dim, hidden)
        self.txt_mod = Modulation(dim, 6)
        self.txt_attn = SelfAttention(dim, num_heads, qkv_bias)
        self.txt_mlp = _mlp(dim, hidden)

    def mod_rows(self, s: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.img_mod.lin(s), self.txt_mod.lin(s)], dim=-1)

    def forward(self, x: torch.Tensor, c: torch.Tensor, m: torch.Tensor):
        a = attention(*split_qk_norm([self.txt_attn.part(modulate(c, m[6], m[7])),
                                      self.img_attn.part(modulate(x, m[0], m[1]))],
                                     self.img_attn.num_heads, EPS))
        n_c = c.shape[1]
        x = torch.addcmul(x, m[2], self.img_attn.proj(a[:, n_c:]))
        x = torch.addcmul(x, m[5], self.img_mlp(modulate(x, m[3], m[4])))
        c = torch.addcmul(c, m[8], self.txt_attn.proj(a[:, :n_c]))
        c = torch.addcmul(c, m[11], self.txt_mlp(modulate(c, m[9], m[10])))
        return x, c


class SingleStreamBlock(nn.Module):
    """A single-stream block over ``h = [c ; x]``: ``linear1`` gives [qkv |
    MLP input], ``linear2`` maps [attention | tanh-GELU(MLP input)] back,
    behind one gate. Rows: shift, 1 + scale, gate."""

    ROWS = 3
    SCALE_ROWS = (1,)

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0):
        super().__init__()
        self.num_heads, self.dim = num_heads, dim
        self.mlp_hidden = int(dim * mlp_ratio)
        self.linear1 = nn.Linear(dim, 3 * dim + self.mlp_hidden)
        self.linear2 = nn.Linear(dim + self.mlp_hidden, dim)
        self.norm = QKNorm(dim // num_heads)
        self.modulation = Modulation(dim, 3)

    def mod_rows(self, s: torch.Tensor) -> torch.Tensor:
        return self.modulation.lin(s)

    def forward(self, h: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        qkv, u = self.linear1(modulate(h, m[0], m[1])).split([3 * self.dim, self.mlp_hidden], -1)
        a = attention(*split_qk_norm([self.norm.part(qkv)], self.num_heads, EPS))
        out = self.linear2(torch.cat([a, F.gelu(u, approximate="tanh")], -1))
        return torch.addcmul(h, m[2], out)


class LastLayer(nn.Module):
    """Rows: shift, 1 + scale (``adaLN_modulation.1``), then ``linear``."""

    ROWS = 2
    SCALE_ROWS = (1,)

    def __init__(self, dim: int, out_channels: int):
        super().__init__()
        self.linear = nn.Linear(dim, out_channels)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 2 * dim))

    def mod_rows(self, s: torch.Tensor) -> torch.Tensor:
        return self.adaLN_modulation[1](s)

    def forward(self, x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
        return self.linear(modulate(x, m[0], m[1]))


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden_dim)
        self.out_layer = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.out_layer(F.silu(self.in_layer(x)))


class Hunyuan3DDiT(nn.Module):
    """The denoiser: ``velocity(x, t, cond)`` of (B, n_latents, in_channels)
    latents, (B,) flow times and (B, T, context_in_dim) condition tokens.

    ``n_latents`` is the latent set's size (the ShapeVAE's ``num_latents``),
    which the engine draws the prior at; ``dtype`` as the other models'."""

    # no int8 path (the engine reads the modes), no fused-kernel or training
    # path (the engine refuses them), and the sampler's settings
    # (eval.inference) with their defaults, the public pipeline's
    use_int8_ff = use_int8_attn = False
    EVAL_ONLY = True
    SAMPLER = dict(num_steps=50, guidance_scale=5.0)

    def __init__(
        self,
        in_channels: int = 64,
        context_in_dim: int = 1536,
        hidden_size: int = 1024,
        mlp_ratio: float = 4.0,
        num_heads: int = 16,
        depth: int = 16,
        depth_single_blocks: int = 32,
        qkv_bias: bool = True,
        time_factor: float = 1000.0,
        n_latents: int = 3072,
        dtype=None,
    ):
        super().__init__()
        if hidden_size % num_heads:
            raise ValueError(f"hidden_size {hidden_size} is not a multiple of num_heads {num_heads}")
        self.compute_dtype = dtype
        self.n_latents, self.channels = n_latents, in_channels
        self.context_in_dim, self.hidden_size, self.time_factor = context_in_dim, hidden_size, time_factor
        self.latent_in = nn.Linear(in_channels, hidden_size)
        self.time_in = MLPEmbedder(256, hidden_size)
        self.cond_in = nn.Linear(context_in_dim, hidden_size)
        self.double_blocks = nn.ModuleList(
            [DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias) for _ in range(depth)])
        self.single_blocks = nn.ModuleList(
            [SingleStreamBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth_single_blocks)])
        self.final_layer = LastLayer(hidden_size, in_channels)

    @property
    def dtype(self) -> torch.dtype:
        return self.latent_in.weight.dtype

    def _blocks(self):
        return [*self.double_blocks, *self.single_blocks, self.final_layer]

    def process_cond(self, tokens: torch.Tensor) -> torch.Tensor:
        """(B, T, context_in_dim) encoder tokens -> (B, T, hidden) ``c``."""
        return self.cond_in(tokens.to(self.dtype))

    def mod_rows(self, t: torch.Tensor) -> list:
        """(R,) flow times -> each block's modulation rows, a (rows, R, 1,
        hidden) tensor in the model's dtype with its scale rows as ``1 +
        scale``: row ``r`` of step or sample ``i`` is ``[r, i]``."""
        s = F.silu(self.time_in(timestep_embedding(t, 256, time_factor=self.time_factor).to(self.dtype)))
        out = []
        for blk in self._blocks():
            rows = blk.mod_rows(s).view(len(t), blk.ROWS, 1, -1).transpose(0, 1).contiguous()
            for r in blk.SCALE_ROWS:
                rows[r] += 1
            out.append(rows)
        return out

    def velocity_with_mods(self, x: torch.Tensor, c: torch.Tensor, mods: list) -> torch.Tensor:
        """The velocity of (B, N, in_channels) latents ``x`` given ``c =
        process_cond(cond)`` (B, T, hidden) and the rows of
        :meth:`mod_rows` for these samples, each (rows, B or 1, 1, hidden)."""
        nd = len(self.double_blocks)
        h = self.latent_in(x.to(self.dtype))
        with span("dual_stream"):
            for blk, m in zip(self.double_blocks, mods[:nd]):
                h, c = blk(h, c, m)
        n_c = c.shape[1]
        h = torch.cat([c, h], 1)
        with span("single_stream"):
            for blk, m in zip(self.single_blocks, mods[nd:-1]):
                h = blk(h, m)
        return self.final_layer(h[:, n_c:], mods[-1])

    def forward(self, x: torch.Tensor, t: torch.Tensor, cond: Optional[torch.Tensor]) -> torch.Tensor:
        """The velocity at (B,) flow times ``t`` from raw condition tokens."""
        t = torch.as_tensor(t, dtype=torch.float32, device=x.device).reshape(-1).expand(x.shape[0])
        return self.velocity_with_mods(x, self.process_cond(cond), self.mod_rows(t))

    def set_fast(self) -> None:
        """No fused path: the model as built."""

    def sample(self, latents: torch.Tensor, cond: torch.Tensor, num_steps: int = 50,
               guidance_scale: float = 5.0, act_scales=None, capture_states: bool = False):
        """The guided Euler sampler (:func:`flow_euler_cfg`) from the prior
        ``latents`` and ``cond`` (B, T, hidden), the projected condition:
        the modulation rows of every step at once, the unconditional rows'
        condition ``process_cond`` of zero tokens. No static int8 scales
        and no calibration states: the model has no int8 path."""
        if act_scales is not None or capture_states:
            raise ValueError("act_scales and capture_states belong to the EDM sampler's int8 "
                             "calibration; the flow sampler has none")
        table = self.mod_rows(flow_times(num_steps, latents.device))
        zero = cond.new_zeros((1, cond.shape[1], self.context_in_dim))
        c2 = torch.cat([cond, self.process_cond(zero).expand_as(cond)])

        def velocity(x2, i):
            return self.velocity_with_mods(x2, c2, [rows[:, i:i + 1] for rows in table])

        return flow_euler_cfg(velocity, latents, num_steps, guidance_scale)

    def sampler_calls(self, batch: int, num_steps: int, **_) -> tuple:
        """(DiT calls, their batch rows) of one sampling of ``batch``
        samples: one call a step, on the 2 ``batch`` rows of guidance."""
        return num_steps, num_steps * 2 * batch

    def graph_modes(self) -> tuple:
        """No modes: a captured sampler depends on the shapes and settings."""
        return ()

    def graph_tensors(self) -> list:
        """The tensors a captured sampler reads in place."""
        return [*self.parameters(), *self.buffers()]
