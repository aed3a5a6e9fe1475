"""Plain PyTorch reference of Hunyuan3D-2.0's shape generator, in float32,
and its eval chain on the benchmark's inputs.

Written from the published description (arXiv:2501.12202; the public
code's ``hy3dgen/shapegen/models/denoisers/hunyuan3ddit.py`` and
``.../autoencoders/``, configs ``hunyuan3d-dit-v2-0`` and
``hunyuan3d-vae-v2-0``) in the public ``state_dict`` layout, so that one
seeded weight set loads into it and into the system under test alike. It
imports nothing of the system under test: no cache, no graph, no batched
guidance (the conditional and unconditional velocities are two calls), no
precomputed modulation, softmax attention written out. Every matmul runs
in float32 with TF32 off (:func:`rald_bench.reference.nets.float32_matmuls`
around the calls). ``fp8`` on its :class:`~rald_bench.reference.nets.QLinear`
layers is the precision control, as in ``nets.py``.

Departures from the public code that are known: the sampler's times are
``t_i = i / steps`` with ``x += v / steps`` (the public scheduler's
``linspace(0, 1, steps)`` ends on a step of length 0: same work, another
last point); the condition tokens are an input (no DINOv2 encoder); all in
float32 where the public pipeline runs float16.

:func:`run_flow_chain` is :func:`rald_bench.reference.chain.run_chain`
with the flow sampler, and geometry in the configuration's frame: the
condition projection, the sample, the decodes of the eval, grid + helper
and refine queries, the point count and Chamfer / F, each stage from the
program's output of the stage before when judging.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rald_bench.reference.chain import (
    BatchMismatch,
    _low,
    chamfer_f,
    densify,
    inverse_norm_points,
    occupancy,
    polar2cartesian,
)
from rald_bench.reference.nets import QLinear, float32_matmuls


def softmax_attention(q, k, v):
    """(B, H, Lq, Dh) x (B, H, Lk, Dh) -> (B, Lq, H * Dh) at scale Dh^-0.5."""
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1) @ v
    return a.transpose(1, 2).flatten(2)


def ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


# --------------------------------------------------------------------- DiT
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


class SelfAttention(nn.Module):
    def __init__(self, dim, heads, qkv_bias=True):
        super().__init__()
        self.heads = heads
        self.qkv = QLinear(dim, 3 * dim, bias=qkv_bias)
        self.norm = QKNorm(dim // heads)
        self.proj = QLinear(dim, dim)


def qkv_heads(qkv, heads, norm):
    """(B, L, 3 * H * Dh), channels [q | k | v] -> q, k, v (B, H, L, Dh)."""
    b, n, _ = qkv.shape
    q, k, v = qkv.reshape(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4)
    return norm.query_norm(q), norm.key_norm(k), v


class Modulation(nn.Module):
    def __init__(self, dim, n):
        super().__init__()
        self.n, self.lin = n, QLinear(dim, n * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.n, -1)


def mlp(dim, hidden):
    return nn.Sequential(QLinear(dim, hidden), nn.GELU(approximate="tanh"), QLinear(hidden, dim))


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
        self.linear1 = QLinear(dim, 3 * dim + self.hidden)
        self.linear2 = QLinear(dim + self.hidden, dim)
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
        self.linear = QLinear(dim, out)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(), QLinear(dim, 2 * dim))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, 1)
        return self.linear((1 + scale[:, None]) * ln(x) + shift[:, None])


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim, hidden):
        super().__init__()
        self.in_layer, self.out_layer = QLinear(in_dim, hidden), QLinear(hidden, hidden)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


def timestep_embedding(t, dim=256, max_period=10000.0, time_factor=1000.0):
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32) / half)
    args = (time_factor * t)[:, None] * freqs.to(t.device)[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class Hunyuan3DDiT(nn.Module):
    def __init__(self, in_channels=64, context_in_dim=1536, hidden_size=1024, mlp_ratio=4.0,
                 num_heads=16, depth=16, depth_single_blocks=32, qkv_bias=True, time_factor=1000.0):
        super().__init__()
        self.time_factor = time_factor
        self.latent_in = QLinear(in_channels, hidden_size)
        self.time_in = MLPEmbedder(256, hidden_size)
        self.cond_in = QLinear(context_in_dim, hidden_size)
        self.double_blocks = nn.ModuleList(
            [DoubleStreamBlock(hidden_size, num_heads, mlp_ratio, qkv_bias) for _ in range(depth)])
        self.single_blocks = nn.ModuleList(
            [SingleStreamBlock(hidden_size, num_heads, mlp_ratio) for _ in range(depth_single_blocks)])
        self.final_layer = LastLayer(hidden_size, in_channels)

    def condition(self, tokens):
        """(B, T, context_in_dim) encoder tokens -> ``c = cond_in(tokens)``."""
        return self.cond_in(tokens)

    def velocity(self, x, t, c):
        """The velocity of (B, N, C) latents at (B,) times given ``c``."""
        latent = self.latent_in(x)
        vec = self.time_in(timestep_embedding(t, 256, time_factor=self.time_factor))
        for block in self.double_blocks:
            latent, c = block(latent, c, vec)
        h = torch.cat([c, latent], 1)
        for block in self.single_blocks:
            h = block(h, vec)
        return self.final_layer(h[:, c.shape[1]:], vec)


def flow_sample(dit, c, prior, num_steps=50, guidance_scale=5.0, scale_factor=1.0):
    """Euler steps at ``t_i = i / num_steps`` from ``prior`` given ``c``
    (the projected condition); the unconditional velocity is a second call
    on ``cond_in`` of zero tokens; the latents over ``scale_factor``."""
    x = prior.float()
    c_u = dit.condition(torch.zeros((1, c.shape[1], dit.cond_in.in_features), device=c.device))
    c_u = c_u.expand_as(c)
    t = torch.arange(num_steps, dtype=torch.float32, device=x.device) / num_steps
    for i in range(num_steps):
        ti = t[i].expand(x.shape[0])
        v_c, v_u = dit.velocity(x, ti, c), dit.velocity(x, ti, c_u)
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
        self.c_qkv = QLinear(width, 3 * width, bias=qkv_bias)
        self.c_proj = QLinear(width, width)
        self.attention = QKLayerNorm(width // heads)

    def forward(self, x):
        b, n, w = x.shape
        q, k, v = self.c_qkv(x).reshape(b, n, self.heads, -1).split(w // self.heads, -1)
        q, k = self.attention.q_norm(q), self.attention.k_norm(k)
        return self.c_proj(softmax_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)))


class VAEMLP(nn.Module):
    def __init__(self, width, ratio=4):
        super().__init__()
        self.c_fc, self.c_proj = QLinear(width, width * ratio), QLinear(width * ratio, width)

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
        self.c_q = QLinear(width, width, bias=qkv_bias)
        self.c_kv = QLinear(width, 2 * width, bias=qkv_bias)
        self.c_proj = QLinear(width, width)
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
        self.query_proj = QLinear(in_dim, width)
        self.cross_attn_decoder = ResidualCrossAttentionBlock(width, heads, ratio, qkv_bias)
        self.ln_post = nn.LayerNorm(width)
        self.output_proj = QLinear(width, 1)


class ShapeVAE(nn.Module):
    """The decoder half; ``query_chunk`` bounds the (chunk x latents x
    heads) float32 score tensor of each decode block."""

    def __init__(self, num_latents=3072, embed_dim=64, width=1024, heads=16, num_decoder_layers=16,
                 num_freqs=8, include_pi=False, qkv_bias=False, mlp_expand_ratio=4, query_chunk=8192):
        super().__init__()
        self.num_freqs, self.include_pi, self.query_chunk = num_freqs, include_pi, query_chunk
        self.post_kl = QLinear(embed_dim, width)
        self.transformer = Transformer(width, num_decoder_layers, heads, qkv_bias)
        self.geo_decoder = CrossAttentionDecoder(3 * (2 * num_freqs + 1), width, heads,
                                                 mlp_expand_ratio, qkv_bias)

    def decode_latents(self, z):
        h = self.post_kl(z)
        for block in self.transformer.resblocks:
            h = block(h)
        return h

    def decode_queries(self, h, queries):
        """(B, Q) occupancy logits of (B, Q, 3) points, in ``query_chunk`` blocks."""
        dec = self.geo_decoder
        out = []
        for s in range(0, queries.shape[1], self.query_chunk):
            y = dec.query_proj(fourier(queries[:, s:s + self.query_chunk], self.num_freqs,
                                       self.include_pi))
            y = dec.cross_attn_decoder(y, h)
            out.append(dec.output_proj(dec.ln_post(y))[..., 0])
        return torch.cat(out, 1)


# ------------------------------------------------------------------ chain
def _frame(p, ev):
    """Normalised points -> the configuration's metric frame."""
    p = inverse_norm_points(p, ev["pc_range"])
    return polar2cartesian(p) if ev["view_cone"] else p


@torch.no_grad()
def run_flow_chain(dit: Hunyuan3DDiT, vae: ShapeVAE, inputs: dict, ev: dict, gen, forced=None,
                   low: bool = False) -> dict:
    """The eval chain on one batch of the benchmark's ``inputs`` (the
    condition tokens (B, T, context_in_dim) under the generator's key
    ``radar_cube``, ``prior``, the query and GT sets); ``gen`` is a
    fresh generator seeded as the program's step generator was; ``forced``
    and ``low`` as in :func:`rald_bench.reference.chain.run_chain`.
    ``ev["sampler"]``: ``num_steps``, ``guidance_scale``, ``scale_factor``."""
    dev = ev["device"]
    f = forced or {}
    bsz = len(inputs["radar_cube"])
    if any(torch.is_tensor(v) and v.dim() and v.shape[0] != bsz for v in f.values()):
        raise BatchMismatch(f"the judged record does not hold the batch's {bsz} frames")

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), device=dev).to(dt)

    out = {"cond": dit.condition(t(inputs["radar_cube"]))}
    cond = f["cond"].to(dev).float() if f else out["cond"]
    out["latents"] = flow_sample(dit, cond, t(inputs["prior"]), **ev["sampler"])
    h = vae.decode_latents(f["latents"].to(dev).float() if f else out["latents"])
    out["logits"] = vae.decode_queries(h, t(inputs["q_eval"]))
    out["loss"], out["iou"], out["acc"] = occupancy(out["logits"], t(inputs["labels"]))
    grid = torch.rand((ev["num_query"], 3), generator=gen, device=dev) * 2.0 - 1.0
    helper, _ = densify(t(inputs["helper"]), t(inputs["helper_mask"], torch.bool),
                        ev["helper_num"], gen, ev["pc_range"], ev["voxel_size"], ev["helper_scale"],
                        low)
    out["q_grid"] = torch.cat([grid[None].expand(bsz, -1, -1), helper], 1)
    del helper
    q_grid = f["q_grid"].to(dev).float() if f else _low(out["q_grid"], low)
    out["l_grid"] = vae.decode_queries(h, q_grid)
    hits = (f["l_grid"].to(dev) if f else out["l_grid"]) > 0
    out["q_ref"], valid = densify(q_grid, hits, ev["refine_num"], gen, ev["pc_range"],
                                  ev["voxel_size"], ev["refine_scale"], low)
    del hits
    q_ref = f["q_ref"].to(dev).float() if f else out["q_ref"]
    out["l_ref"] = vae.decode_queries(h, q_ref)
    mask = ((f["l_ref"].to(dev) if f else out["l_ref"]) > 0) & valid
    out["n_pred"] = mask.sum(1).tolist()
    out["cd"], out["f"] = [], []
    surf = t(inputs["surface"])
    for i in range(bsz):
        cd, fs = chamfer_f(_frame(q_ref[i][mask[i]], ev), _frame(surf[i], ev), ev["fscore_tau"], low)
        out["cd"].append(cd)
        out["f"].append(fs)
    return out


@torch.no_grad()
def centred_bias(dit, vae, tokens, prior, ev: dict, probe_seed: int, quantile: float = 0.8,
                 n_probe: int = 65536) -> float:
    """The occupancy bias at which ``1 - quantile`` of a seeded uniform
    probe's queries score positive on the reference's sample of one probe
    frame (``tokens`` (1, T, C), ``prior`` (1, N, C)). ``vae`` holds bias 0."""
    dev = ev["device"]
    gen = torch.Generator(dev).manual_seed(probe_seed)
    probe = torch.rand((1, n_probe, 3), generator=gen, device=dev) * 2 - 1
    with float32_matmuls():
        c = dit.condition(torch.as_tensor(tokens, device=dev).float())
        lat = flow_sample(dit, c, torch.as_tensor(prior, device=dev), **ev["sampler"])
        logits = vae.decode_queries(vae.decode_latents(lat), probe)
    return -float(torch.quantile(logits[0], quantile))
