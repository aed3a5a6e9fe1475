"""Latent DiT + EDM preconditioner (``rald_tpu/models/latent_dit.py``).

:class:`LatentDiTBlock` (:43), :class:`LatentArrayTransformer` (:200) and
:class:`EDMPrecond` (:277) with ``process_radar_cond`` (:336), ``denoise``
(:361), ``compute_mod_table`` (:390) and ``denoise_with_mods`` (:401), in
the reference's torch key layout (``model.transformer_blocks.{i}...``).

The block's FF sublayer (AdaLN mod + LN + GEGLU FF + residual) always goes
through :func:`rald_torch.ops.geglu_kernel.fused_ln_geglu_residual`: the
CUDA kernel on the card, its plain version on the CPU.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from rald_torch.models.radar_encoder3d import RadarEncoder3D
from rald_torch.nn.layers import (
    AdaLayerNorm,
    Attention,
    FourierTimeEmbedding,
    GEGLUFeedForward,
    LayerNorm,
)
from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual


class LatentDiTBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64, context_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = AdaLayerNorm(dim)
        self.attn1 = Attention(dim, heads=n_heads, dim_head=d_head, fused_kv=False)
        self.norm2 = AdaLayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads=n_heads, dim_head=d_head, fused_kv=False)
        self.norm3 = AdaLayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dit_style=True)

    def mods(self, t_emb):
        """All three sigma-dependent (scale, shift) pairs for this block."""
        return (self.norm1.mod(t_emb), self.norm2.mod(t_emb), self.norm3.mod(t_emb))

    def apply_with_mods(self, x, mods, cond=None):
        (s1, b1), (s2, b2), (s3, b3) = mods
        x = x + self.attn1(self.norm1.apply_mod(x, s1, b1))
        x = x + self.attn2(self.norm2.apply_mod(x, s2, b2), context=cond)
        pi, po = self.ff.proj_in, self.ff.proj_out
        return fused_ln_geglu_residual(
            x.contiguous(), s3.contiguous(), b3.contiguous(),
            pi.weight, pi.bias, po.weight, po.bias,
            scale_shift_mod=True,
        )

    def forward(self, x, t_emb, cond=None):
        return self.apply_with_mods(x, self.mods(t_emb), cond)


class LatentArrayTransformer(nn.Module):
    def __init__(
        self,
        in_channels: int,
        t_channels: int = 256,
        n_heads: int = 8,
        d_head: int = 64,
        depth: int = 12,
        out_channels: Optional[int] = None,
        context_dim: Optional[int] = None,
    ):
        super().__init__()
        inner = n_heads * d_head
        self.map_noise = FourierTimeEmbedding(t_channels)
        self.map_layer0 = nn.Linear(t_channels, inner)
        self.map_layer1 = nn.Linear(inner, inner)
        self.proj_in = nn.Linear(in_channels, inner, bias=False)
        self.transformer_blocks = nn.ModuleList(
            [LatentDiTBlock(inner, n_heads, d_head, context_dim) for _ in range(depth)]
        )
        self.norm = LayerNorm(inner)
        self.proj_out = nn.Linear(inner, out_channels or in_channels, bias=False)
        nn.init.zeros_(self.proj_out.weight)  # reference zero_module

    def compute_mods(self, t: torch.Tensor):
        """Noise embedding -> every block's AdaLN (scale, shift) pairs."""
        dt = self.map_layer0.weight.dtype
        t_emb = self.map_noise(t)[:, None, :]
        t_emb = F.silu(self.map_layer0(t_emb.to(dt)))
        t_emb = F.silu(self.map_layer1(t_emb))
        return tuple(block.mods(t_emb) for block in self.transformer_blocks)

    def forward_with_mods(self, x, mods, cond=None):
        x = self.proj_in(x)
        for block, block_mods in zip(self.transformer_blocks, mods):
            x = block.apply_with_mods(x, block_mods, cond)
        return self.proj_out(self.norm(x))

    def forward(self, x, t, cond=None):
        return self.forward_with_mods(x, self.compute_mods(t), cond)


class EDMPrecond(nn.Module):
    """EDM-preconditioned conditional denoiser over the latent token set."""

    def __init__(
        self,
        n_latents: int = 512,
        channels: int = 8,
        sigma_data: float = 1.0,
        n_heads: int = 8,
        d_head: int = 64,
        depth: int = 12,
        cond_type: str = "radar",
        use_radar_enc: bool = True,
        unfreeze_radar_enc: bool = True,
        radar_token_channel: int = 512,
        input_radar_dims: tuple = (128, 8, 2),
        enc_radar_dims: tuple = (8, 4, 2),
        enc_radar_ch: int = 16,
        enc_hidden_ch: int = 64,
    ):
        super().__init__()
        self.n_latents, self.channels, self.depth = n_latents, channels, depth
        self.sigma_data = sigma_data
        self.cond_type = cond_type
        self.use_radar_enc, self.unfreeze_radar_enc = use_radar_enc, unfreeze_radar_enc
        self.radar_token_channel = radar_token_channel
        self.model = LatentArrayTransformer(
            channels, 256, n_heads, d_head, depth,
            context_dim=radar_token_channel if cond_type == "radar" else None,
        )
        if cond_type == "radar":
            if unfreeze_radar_enc:
                self.radar_enc = RadarEncoder3D(in_channels=1, ch=enc_hidden_ch, z_channels=enc_radar_ch)
            if use_radar_enc:
                (r_dim, a_dim, e_dim), token_in = enc_radar_dims, enc_radar_ch
            else:
                (r_dim, a_dim, e_dim), token_in = input_radar_dims, 1
            self.radar_r_emb = nn.Embedding(r_dim, radar_token_channel)
            self.radar_a_emb = nn.Embedding(a_dim, radar_token_channel)
            self.radar_e_emb = nn.Embedding(e_dim, radar_token_channel)
            self.radar_token_project = nn.Linear(token_in, radar_token_channel)

    def process_radar_cond(self, radar_cube: torch.Tensor) -> torch.Tensor:
        """Raw (B, R, A, E, ch) cube (or pre-encoded tokens) -> (B, R*A*E, C)."""
        if self.unfreeze_radar_enc:
            x = self.radar_enc(radar_cube[..., :1])
        elif not self.use_radar_enc:
            x = radar_cube[..., :1]
        else:
            x = radar_cube
        tokens = self.radar_token_project(x.to(self.radar_token_project.weight.dtype))
        tokens = (
            tokens
            + self.radar_r_emb.weight[None, :, None, None, :]
            + self.radar_a_emb.weight[None, None, :, None, :]
            + self.radar_e_emb.weight[None, None, None, :, :]
        )
        return tokens.reshape(tokens.shape[0], -1, self.radar_token_channel)

    def _precond(self, x, sigma):
        x = x.float()
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device)
        sigma = sigma.reshape(-1, 1, 1).expand(x.shape[0], 1, 1)
        sd2 = self.sigma_data ** 2
        c_skip = sd2 / (sigma ** 2 + sd2)
        c_out = sigma * self.sigma_data * torch.rsqrt(sigma ** 2 + sd2)
        c_in = torch.rsqrt(sd2 + sigma ** 2)
        return x, sigma, c_skip, c_out, c_in

    def denoise(self, x, sigma, cond_tokens=None):
        """EDM-preconditioned D(x; sigma); ``cond_tokens`` already processed."""
        x, sigma, c_skip, c_out, c_in = self._precond(x, sigma)
        dt = self.model.proj_in.weight.dtype
        f_x = self.model((c_in * x).to(dt), (torch.log(sigma) / 4).reshape(-1), cond=cond_tokens)
        return c_skip * x + c_out * f_x.float()

    def compute_mod_table(self, sigmas: torch.Tensor):
        """AdaLN (scale, shift) pairs for a fixed schedule; leaves (S, 1, C)."""
        return self.model.compute_mods(torch.log(sigmas.float()) / 4)

    def denoise_with_mods(self, x, sigma, mods, cond_tokens=None):
        """``denoise`` with precomputed AdaLN modulations for this sigma."""
        x, sigma, c_skip, c_out, c_in = self._precond(x, sigma)
        dt = self.model.proj_in.weight.dtype
        f_x = self.model.forward_with_mods((c_in * x).to(dt), mods, cond_tokens)
        return c_skip * x + c_out * f_x.float()

    def forward(self, x, sigma, radar_cube=None):
        cond = (
            self.process_radar_cond(radar_cube)
            if (self.cond_type == "radar" and radar_cube is not None) else None
        )
        return self.denoise(x, sigma, cond)
