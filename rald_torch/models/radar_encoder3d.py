"""Radar-cube 3D-CNN autoencoder (``rald_tpu/models/radar_encoder3d.py``):
the encoder (:39-146), the mirror decoder (:92-103, :149-182), the
autoencoder (:185-222) and its factory (:225-239).

The public layout is NDHWC (B, R, A, E, C), as in JAX; the encoder and the
decoder permute to PyTorch's NCDHW once on entry and back once on exit.
Convolutions may run through cuDNN: JAX leaves the 3D-CNN to XLA, so it
holds no TPU kernel. Key layout follows the reference (``down.{i}.block.{j}``,
``down.{i}.attn.{j}``, ``down.{i}.downsample.conv``, ``mid.block_1``,
``up.{i}.block.{j}``, ``up.{i}.upsample.conv`` ...).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


def _group_norm(ch: int) -> nn.GroupNorm:
    """GroupNorm(gcd(32, ch), eps 1e-6): 32 groups on every real config."""
    return nn.GroupNorm(math.gcd(32, ch), ch, eps=1e-6)


def _gn(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm with f32 statistics, returned in ``x``'s dtype."""
    return F.group_norm(
        x.float(), norm.num_groups, norm.weight.float(), norm.bias.float(), norm.eps
    ).to(x.dtype)


def _swish(x):
    return x * torch.sigmoid(x)


class ResnetBlock3D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = _group_norm(in_ch)
        self.conv1 = nn.Conv3d(in_ch, out_ch, 3, padding=1)
        self.norm2 = _group_norm(out_ch)
        self.conv2 = nn.Conv3d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.nin_shortcut = nn.Conv3d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(_swish(_gn(self.norm1, x)))
        h = self.conv2(_swish(_gn(self.norm2, h)))
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class AttnBlock3D(nn.Module):
    """Full self-attention over the flattened (R, A, E) cells."""

    def __init__(self, ch: int):
        super().__init__()
        self.norm = _group_norm(ch)
        self.q = nn.Conv3d(ch, ch, 1)
        self.k = nn.Conv3d(ch, ch, 1)
        self.v = nn.Conv3d(ch, ch, 1)
        self.proj_out = nn.Conv3d(ch, ch, 1)

    def forward(self, x):
        b, c = x.shape[:2]
        h = _gn(self.norm, x)
        q = self.q(h).reshape(b, c, -1).transpose(1, 2)  # (b, cells, c)
        k = self.k(h).reshape(b, c, -1)
        v = self.v(h).reshape(b, c, -1).transpose(1, 2)
        sim = torch.matmul(q, k) * (c ** -0.5)
        attn = torch.softmax(sim.float(), dim=-1).to(x.dtype)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(x.shape)
        return x + self.proj_out(out)


class Downsample3D(nn.Module):
    """Pad (0, 1) on each spatial dim, then a stride-2 VALID conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv3d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1, 0, 1)))


class Upsample3D(nn.Module):
    """Nearest x2 (cell ``i`` of the output reads input cell ``i // 2``, as
    ``jax.image.resize(method="nearest")`` does at scale 2), then a 3x3x3
    conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv3d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class _Level(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()
        self.attn = nn.ModuleList()


class _Mid(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.block_1 = ResnetBlock3D(ch, ch)
        self.attn_1 = AttnBlock3D(ch)
        self.block_2 = ResnetBlock3D(ch, ch)


class RadarEncoder3D(nn.Module):
    """(B, R, A, E, C_in) -> (B, R/16, A/16, E/16, z_channels)."""

    def __init__(
        self,
        in_channels: int = 1,
        ch: int = 128,
        ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
        num_res_blocks: int = 2,
        attn_resolutions: Tuple[Tuple[int, int, int], ...] = ((8, 4, 2),),
        resolution: Tuple[int, int, int] = (128, 64, 32),
        z_channels: int = 16,
    ):
        super().__init__()
        self.conv_in = nn.Conv3d(in_channels, ch, 3, padding=1)
        self.down = nn.ModuleList()
        # attention follows the CONFIGURED resolution's halving schedule,
        # not the tensor shape, so the structure is input-size independent
        curr_res = tuple(resolution)
        block_in = ch
        for i_level, mult in enumerate(ch_mult):
            level = _Level()
            block_out = ch * mult
            for _ in range(num_res_blocks):
                level.block.append(ResnetBlock3D(block_in, block_out))
                block_in = block_out
                if curr_res in attn_resolutions:
                    level.attn.append(AttnBlock3D(block_in))
            if i_level != len(ch_mult) - 1:
                level.downsample = Downsample3D(block_in)
                curr_res = tuple(int(r / 2) for r in curr_res)
            self.down.append(level)
        self.mid = _Mid(block_in)
        self.norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv3d(block_in, z_channels, 3, padding=1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(x.permute(0, 4, 1, 2, 3).to(self.conv_in.weight.dtype))
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        h = self.conv_out(_swish(_gn(self.norm_out, h)))
        return h.permute(0, 2, 3, 4, 1)


class _UpLevel(nn.Module):
    def __init__(self):
        super().__init__()
        self.block = nn.ModuleList()


class RadarDecoder3D(nn.Module):
    """(B, R, A, E, z_channels) -> (B, 16R, 16A, 16E, out_ch): conv_in, mid
    (ResNet, attention, ResNet), then the levels from the deepest up, each
    ``num_res_blocks + 1`` ResNet blocks and, above level 0, an
    :class:`Upsample3D`; GroupNorm, swish, conv_out."""

    def __init__(
        self,
        ch: int = 128,
        out_ch: int = 2,
        ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
        num_res_blocks: int = 2,
        z_channels: int = 16,
    ):
        super().__init__()
        block_in = ch * ch_mult[-1]
        self.conv_in = nn.Conv3d(z_channels, block_in, 3, padding=1)
        self.mid = _Mid(block_in)
        self.up = nn.ModuleList([_UpLevel() for _ in ch_mult])
        for i_level in reversed(range(len(ch_mult))):
            level = self.up[i_level]
            for _ in range(num_res_blocks + 1):
                level.block.append(ResnetBlock3D(block_in, ch * ch_mult[i_level]))
                block_in = ch * ch_mult[i_level]
            if i_level != 0:
                level.upsample = Upsample3D(block_in)
        self.norm_out = _group_norm(block_in)
        self.conv_out = nn.Conv3d(block_in, out_ch, 3, padding=1)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.conv_in(z.permute(0, 4, 1, 2, 3).to(self.conv_in.weight.dtype))
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        for level in reversed(self.up):
            for block in level.block:
                h = block(h)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        h = self.conv_out(_swish(_gn(self.norm_out, h)))
        return h.permute(0, 2, 3, 4, 1)


class RadarAutoencoder(nn.Module):
    """The reference's radar autoencoder (``rald_tpu/models/radar_encoder3d.py:185-222``):
    :meth:`encode`, :meth:`decode` and :meth:`forward`, channel-last in and
    out; its state_dict is a reference checkpoint's (``encoder.*`` and
    ``decoder.*``). ``in_channels`` is the channel count the encoder takes
    and the decoder gives back (the generation engine passes 1, the
    intensity channel). ``decoder=False`` builds the encoder alone: the
    frozen conditioning encoder never decodes, so the engine keeps no
    decoder weights. ``dtype`` (a torch dtype or its name), when given, is
    the compute dtype the engine casts it to."""

    def __init__(
        self,
        basic_channel: int = 128,
        ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
        num_res_blocks: int = 2,
        embed_dim: int = 16,
        in_channels: int = 2,
        dtype=None,
        decoder: bool = True,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.encoder = RadarEncoder3D(
            in_channels=in_channels, ch=basic_channel, ch_mult=ch_mult,
            num_res_blocks=num_res_blocks, z_channels=embed_dim,
        )
        if decoder:
            self.decoder = RadarDecoder3D(
                ch=basic_channel, out_ch=in_channels, ch_mult=ch_mult,
                num_res_blocks=num_res_blocks, z_channels=embed_dim,
            )

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        """(B, R, A, E, in_channels) -> (B, R/16, A/16, E/16, embed_dim)."""
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """(B, R', A', E', embed_dim) -> (B, 16R', 16A', 16E', in_channels)."""
        return self.decoder(z)

    def forward(self, x: torch.Tensor) -> dict:
        z = self.encode(x)
        return {"pred": self.decode(z), "latent": z}


def create_radar_autoencoder(
    basic_channel: int = 128,
    ch_mult: Sequence[int] = (1, 1, 2, 2, 4),
    num_res_blocks: int = 2,
    embed_dim: int = 16,
    in_channels: int = 2,
    dtype=None,
) -> RadarAutoencoder:
    """The reference's ``create_autoencoder`` (JAX ``create_radar_autoencoder``)."""
    return RadarAutoencoder(basic_channel=basic_channel, ch_mult=ch_mult,
                            num_res_blocks=num_res_blocks, embed_dim=embed_dim,
                            in_channels=in_channels, dtype=dtype)
