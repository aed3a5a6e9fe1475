"""Plain PyTorch reference of Hunyuan3D-2.0's shape generator, in float32.

Written from the published description (arXiv:2501.12202; the public
code's ``hy3dgen/shapegen/models/denoisers/hunyuan3ddit.py`` and
``.../autoencoders/``, configs ``hunyuan3d-dit-v2-0`` and
``hunyuan3d-vae-v2-0``) in the public ``state_dict`` layout, so that one
seeded weight set loads strictly into it and into the port. It imports
nothing of the port: no cache, no graph, no batched guidance (the
conditional and unconditional velocities are two calls), no precomputed
modulation, softmax attention written out. :func:`float32_matmuls` turns
TF32 off in cuBLAS and cuDNN.

Departures from the public code that are known:

- the sampler's times are ``t_i = i / steps`` with ``x += v / steps``;
  the public ``FlowMatchEulerDiscreteScheduler`` with ``sigmas =
  linspace(0, 1, steps)`` takes ``t_i = i / (steps - 1)``, and its last
  step has length 0 (``sigma_next`` is appended as 1). Same work, a
  different last point;
- the prior, the condition tokens and the guidance (5.0, the pipeline's
  default) are inputs; the DINOv2 encoder that makes the tokens is not
  here;
- everything runs in float32, where the public pipeline runs float16.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn


@contextlib.contextmanager
def float32_matmuls():
    """True float32 products (no TF32 in cuBLAS or cuDNN) inside the
    block; the settings in force before are restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def softmax_attention(q, k, v):
    """(B, H, Lq, Dh) x (B, H, Lk, Dh) -> (B, Lq, H * Dh) at scale Dh^-0.5."""
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1) @ v
    return a.transpose(1, 2).flatten(2)


# --------------------------------------------------------------------- DiT
def timestep_embedding(t, dim=256, max_period=10000.0, time_factor=1000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
    args = (time_factor * t)[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + 1e-6) * self.scale


class QKNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.query_norm, self.key_norm = RMSNorm(dim), RMSNorm(dim)


def ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, qkv_bias=True):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.norm = QKNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)


def qkv_heads(qkv, heads, norm):
    """(B, L, 3 * H * Dh), channels [q | k | v] -> q, k, v (B, H, L, Dh)."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    return norm.query_norm(q), norm.key_norm(k), v


class Modulation(nn.Module):
    def __init__(self, dim, n):
        super().__init__()
        self.n, self.lin = n, nn.Linear(dim, n * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, -1)


def mlp(dim, hidden):
    return nn.Sequential(nn.Linear(dim, hidden), nn.GELU(approximate="tanh"), nn.Linear(hidden, dim))


class DoubleStreamBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4.0, qkv_bias=True):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.img_mod, self.txt_mod = Modulation(dim, 6), Modulation(dim, 6)
        self.img_attn = SelfAttention(dim, heads, qkv_bias)
        self.txt_attn = SelfAttention(dim, heads, qkv_bias)
        self.img_mlp, self.txt_mlp = mlp(dim, hidden), mlp(dim, hidden)

    def forward(self, img, txt, vec):
        i_sh1, i_sc1, i_g1, i_sh2, i_sc2, i_g2 = self.img_mod(vec)
        t_sh1, t_sc1, t_g1, t_sh2, t_sc2, t_g2 = self.txt_mod(vec)
        iq, ik, iv = qkv_heads(self.img_attn.qkv((1 + i_sc1) * ln(img) + i_sh1), self.img_attn.heads,
                               self.img_attn.norm)
        tq, tk, tv = qkv_heads(self.txt_attn.qkv((1 + t_sc1) * ln(txt) + t_sh1), self.txt_attn.heads,
                               self.txt_attn.norm)
        a = softmax_attention(torch.cat([tq, iq], 2), torch.cat([tk, ik], 2), torch.cat([tv, iv], 2))
        t_a, i_a = a[:, :txt.shape[1]], a[:, txt.shape[1]:]
        img = img + i_g1 * self.img_attn.proj(i_a)
        img = img + i_g2 * self.img_mlp((1 + i_sc2) * ln(img) + i_sh2)
        txt = txt + t_g1 * self.txt_attn.proj(t_a)
        txt = txt + t_g2 * self.txt_mlp((1 + t_sc2) * ln(txt) + t_sh2)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, dim, heads, mlp_ratio=4.0):
        super().__init__()
        self.dim, self.heads, self.hidden = dim, heads, int(dim * mlp_ratio)
        self.linear1 = nn.Linear(dim, 3 * dim + self.hidden)
        self.linear2 = nn.Linear(dim + self.hidden, dim)
        self.norm = QKNorm(dim // heads)
        self.modulation = Modulation(dim, 3)

    def forward(self, x, vec):
        shift, scale, gate = self.modulation(vec)
        qkv, u = torch.split(self.linear1((1 + scale) * ln(x) + shift), [3 * self.dim, self.hidden], -1)
        a = softmax_attention(*qkv_heads(qkv, self.heads, self.norm))
        return x + gate * self.linear2(torch.cat([a, F.gelu(u, approximate="tanh")], 2))


class LastLayer(nn.Module):
    def __init__(self, dim, out):
        super().__init__()
        self.linear = nn.Linear(dim, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), nn.Linear(dim, 2 * dim))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, 1)
        return self.linear((1 + scale[:, None]) * ln(x) + shift[:, None])


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim, hidden):
        super().__init__()
        self.in_layer, self.out_layer = nn.Linear(in_dim, hidden), nn.Linear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class Hunyuan3DDiT(nn.Module):
    def __init__(self, in_channels=64, context_in_dim=1536, hidden_size=1024, mlp_ratio=4.0,
                 num_heads=16, depth=16, depth_single_blocks=32, qkv_bias=True, time_factor=1000.0):
        super().__init__()
        self.time_factor = time_factor
        self.latent_in = nn.Linear(in_channels, hidden_size)
        self.time_in = MLPEmbedder(256, hidden_size)
        self.cond_in = nn.Linear(context_in_dim, hidden_size)
        self.double_blocks = nn.ModuleList(
            [DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias) for _ in range(depth)])
        self.single_blocks = nn.ModuleList(
            [SingleStreamBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth_single_blocks)])
        self.final_layer = LastLayer(hidden_size, in_channels)

    def forward(self, x, t, cond):
        """The velocity of (B, N, C) latents at (B,) times ``t`` given
        (B, T, context_in_dim) condition tokens."""
        latent = self.latent_in(x)
        vec = self.time_in(timestep_embedding(t, 256, time_factor=self.time_factor))
        c = self.cond_in(cond)
        for block in self.double_blocks:
            latent, c = block(latent, c, vec)
        h = torch.cat([c, latent], 1)
        for block in self.single_blocks:
            h = block(h, vec)
        return self.final_layer(h[:, c.shape[1]:], vec)


def flow_sample(dit, cond, prior, num_steps=50, guidance_scale=5.0, scale_factor=0.9990943042622529):
    """Euler steps at ``t_i = i / num_steps`` from ``prior``, the
    conditional and the unconditional (zero tokens) velocity each its own
    call, ``v = v_u + g (v_c - v_u)``; the latents over ``scale_factor``."""
    x = prior.float()
    uncond = torch.zeros_like(cond)
    t = torch.arange(num_steps, dtype=torch.float32, device=x.device) / num_steps
    for i in range(num_steps):
        ti = t[i].expand(x.shape[0])
        v_c, v_u = dit(x, ti, cond), dit(x, ti, uncond)
        x = x + (v_u + guidance_scale * (v_c - v_u)) / num_steps
    return x / scale_factor


# -------------------------------------------------------------- ShapeVAE
def fourier(p, num_freqs=8, include_pi=False):
    f = 2.0 ** torch.arange(num_freqs, dtype=torch.float32, device=p.device)
    if include_pi:
        f = f * math.pi
    e = (p[..., None] * f).reshape(*p.shape[:-1], -1)
    return torch.cat([p, torch.sin(e), torch.cos(e)], -1)


class QKLayerNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.q_norm = nn.LayerNorm(dim, eps=1e-6)
        self.k_norm = nn.LayerNorm(dim, eps=1e-6)


class VAEAttention(nn.Module):
    """Self-attention: ``c_qkv`` per head [q | k | v]."""

    def __init__(self, width, heads, qkv_bias=False):
        super().__init__()
        self.heads = heads
        self.c_qkv = nn.Linear(width, 3 * width, bias=qkv_bias)
        self.c_proj = nn.Linear(width, width)
        self.attention = QKLayerNorm(width // heads)

    def forward(self, x):
        b, n, w = x.shape
        q, k, v = self.c_qkv(x).reshape(b, n, self.heads, -1).split(w // self.heads, -1)
        q, k = self.attention.q_norm(q), self.attention.k_norm(k)
        return self.c_proj(softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))


class VAEMLP(nn.Module):
    def __init__(self, width, ratio=4):
        super().__init__()
        self.c_fc, self.c_proj = nn.Linear(width, width * ratio), nn.Linear(width * ratio, width)

    def forward(self, x):
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width, heads, qkv_bias=False):
        super().__init__()
        self.attn, self.ln_1 = VAEAttention(width, heads, qkv_bias), nn.LayerNorm(width, eps=1e-6)
        self.mlp, self.ln_2 = VAEMLP(width), nn.LayerNorm(width, eps=1e-6)

    def forward(self, x):
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width, layers, heads, qkv_bias=False):
        super().__init__()
        self.resblocks = nn.ModuleList([ResidualAttentionBlock(width, heads, qkv_bias) for _ in range(layers)])


class CrossAttention(nn.Module):
    """``c_q``, ``c_kv`` per head [k | v], per-head LayerNorm of q and k."""

    def __init__(self, width, heads, qkv_bias=False):
        super().__init__()
        self.heads = heads
        self.c_q = nn.Linear(width, width, bias=qkv_bias)
        self.c_kv = nn.Linear(width, 2 * width, bias=qkv_bias)
        self.c_proj = nn.Linear(width, width)
        self.attention = QKLayerNorm(width // heads)

    def forward(self, x, data):
        b, n, w = x.shape
        q = self.attention.q_norm(self.c_q(x).reshape(b, n, self.heads, -1))
        k, v = self.c_kv(data).reshape(b, data.shape[1], self.heads, -1).split(w // self.heads, -1)
        k = self.attention.k_norm(k)
        return self.c_proj(softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))


class ResidualCrossAttentionBlock(nn.Module):
    def __init__(self, width, heads, ratio=4, qkv_bias=False):
        super().__init__()
        self.attn = CrossAttention(width, heads, qkv_bias)
        self.ln_1, self.ln_2, self.ln_3 = (nn.LayerNorm(width, eps=1e-6) for _ in range(3))
        self.mlp = VAEMLP(width, ratio)

    def forward(self, x, data):
        x = x + self.attn(self.ln_1(x), self.ln_2(data))
        return x + self.mlp(self.ln_3(x))


class CrossAttentionDecoder(nn.Module):
    def __init__(self, in_dim, width, heads, ratio=4, qkv_bias=False):
        super().__init__()
        self.query_proj = nn.Linear(in_dim, width)
        self.cross_attn_decoder = ResidualCrossAttentionBlock(width, heads, ratio, qkv_bias)
        self.ln_post = nn.LayerNorm(width)
        self.output_proj = nn.Linear(width, 1)


class ShapeVAE(nn.Module):
    def __init__(self, num_latents=3072, embed_dim=64, width=1024, heads=16, num_decoder_layers=16,
                 num_freqs=8, include_pi=False, qkv_bias=False, mlp_expand_ratio=4):
        super().__init__()
        self.num_freqs, self.include_pi = num_freqs, include_pi
        self.post_kl = nn.Linear(embed_dim, width)
        self.transformer = Transformer(width, num_decoder_layers, heads, qkv_bias)
        self.geo_decoder = CrossAttentionDecoder(3 * (2 * num_freqs + 1), width, heads,
                                                 mlp_expand_ratio, qkv_bias)

    def decode_latents(self, z):
        h = self.post_kl(z)
        for block in self.transformer.resblocks:
            h = block(h)
        return h

    def decode_queries(self, h, queries, chunk=65536):
        """(B, Q) occupancy logits of (B, Q, 3) points, ``chunk`` at a time."""
        dec = self.geo_decoder
        out = []
        for s in range(0, queries.shape[1], chunk):
            y = dec.query_proj(fourier(queries[:, s:s + chunk], self.num_freqs, self.include_pi))
            y = dec.cross_attn_decoder(y, h)
            out.append(dec.output_proj(dec.ln_post(y))[..., 0])
        return torch.cat(out, 1)
