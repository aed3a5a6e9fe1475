"""Plain PyTorch reference of Hunyuan3D-2.1's shape-generator DiT, in
float32.

Written from the published description (arXiv:2506.15442; the public
code's ``hy3dshape/models/denoisers/hunyuandit.py`` ``HunYuanDiTPlain`` and
``.../denoisers/moe_layers.py``, config ``hunyuan3d-dit-v2-1``) in the
public ``state_dict`` layout, so that one seeded weight set loads into it
and into the system under test alike. It imports nothing of the system
under test: no graph, no batched guidance, no hoisted time token,
softmax attention written out, and the mixture of experts in the public
code's form (``MoEBlock.moe_infer``): the pairs sorted by expert, each
expert's count read on the host, a loop over the experts and a
``scatter_reduce`` sum. Every matmul runs in float32 with TF32 off
(:func:`rald_bench.reference.nets.float32_matmuls` around the calls);
``fp8`` on its :class:`~rald_bench.reference.nets.QLinear` layers is the
precision control; the gate stays in float32 in the control too.

The ShapeVAE decoder, the flow sampler and the eval chain are
:mod:`rald_bench.reference.hunyuan3d`'s: this DiT has the interface they
call (``condition``, ``cond_in.in_features``, ``velocity``). Departures
from the public code that are known: those of that module (the sampler's
times, the condition tokens as an input, float32), and the assumptions the
configuration file lists under ``assumed`` (the time scale and the order
of the sinusoid's halves, the long skip's order, the heads of q, k and v
split per projection).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rald_bench.reference.hunyuan3d import softmax_attention, timestep_embedding
from rald_bench.reference.nets import QLinear

EPS = 1e-6
TIME_FACTOR = 1000.0  # the time token's sinusoid takes 1000 t (assumed)


class RMSNorm(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + EPS) * self.weight


def heads(t, n):
    """(B, L, H * Dh) -> (B, H, L, Dh)."""
    b, length, _ = t.shape
    return t.reshape(b, length, n, -1).transpose(1, 2)


class Attention(nn.Module):
    """``to_q``, ``to_k``, ``to_v`` (no bias), per-head RMS ``q_norm`` /
    ``k_norm``, ``out_proj``; cross-attention when ``kv_dim`` is given."""

    def __init__(self, dim, n_heads, kv_dim=None):
        super().__init__()
        kv_dim = kv_dim or dim
        self.n_heads = n_heads
        self.to_q = QLinear(dim, dim, bias=False)
        self.to_k = QLinear(kv_dim, dim, bias=False)
        self.to_v = QLinear(kv_dim, dim, bias=False)
        self.q_norm, self.k_norm = RMSNorm(dim // n_heads), RMSNorm(dim // n_heads)
        self.out_proj = QLinear(dim, dim)

    def forward(self, x, c=None):
        c = x if c is None else c
        q = self.q_norm(heads(self.to_q(x), self.n_heads))
        k = self.k_norm(heads(self.to_k(c), self.n_heads))
        return self.out_proj(softmax_attention(q, k, heads(self.to_v(c), self.n_heads)))


class MLP(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.fc1, self.fc2 = QLinear(dim, inner), QLinear(inner, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class GELUProj(nn.Module):
    def __init__(self, dim, inner):
        super().__init__()
        self.proj = QLinear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x))


class FeedForward(nn.Module):
    """The published ``FeedForward``: ``net.0.proj``, exact GELU, ``net.2``."""

    def __init__(self, dim, inner):
        super().__init__()
        self.net = nn.ModuleList([GELUProj(dim, inner), nn.Identity(), QLinear(inner, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class MoEBlock(nn.Module):
    def __init__(self, dim, inner, n_experts=8, top_k=2):
        super().__init__()
        self.top_k = top_k
        self.experts = nn.ModuleList([FeedForward(dim, inner) for _ in range(n_experts)])
        self.gate = nn.Linear(dim, n_experts, bias=False)  # float32 in the control too
        self.shared_experts = FeedForward(dim, inner)

    def forward(self, h):
        shape = h.shape
        x = h.reshape(-1, shape[-1])
        scores = F.linear(x, self.gate.weight).softmax(-1)
        weight, expert = torch.topk(scores, self.top_k, dim=-1, sorted=False)
        flat, flat_w = expert.reshape(-1), weight.reshape(-1, 1)
        cache = torch.zeros_like(x)
        idxs = flat.argsort()
        ends = flat.bincount(minlength=len(self.experts)).cpu().numpy().cumsum(0)
        token_idxs = idxs // self.top_k
        for i, end in enumerate(ends):
            start = 0 if i == 0 else ends[i - 1]
            if start == end:
                continue
            t = token_idxs[start:end]
            out = self.experts[i](x[t]) * flat_w[idxs[start:end]]
            cache.scatter_reduce_(0, t[:, None].expand(-1, x.shape[1]), out, reduce="sum")
        return (cache + self.shared_experts(x)).reshape(shape)


class DiTBlock(nn.Module):
    def __init__(self, dim, n_heads, context_dim, skip=False, moe=False, n_experts=8, top_k=2):
        super().__init__()
        inner = 4 * dim
        self.norm1 = nn.LayerNorm(dim, eps=EPS)
        self.attn1 = Attention(dim, n_heads)
        self.norm2 = nn.LayerNorm(dim, eps=EPS)
        self.attn2 = Attention(dim, n_heads, context_dim)
        self.norm3 = nn.LayerNorm(dim, eps=EPS)
        self.skip = skip
        if skip:
            self.skip_norm = nn.LayerNorm(dim, eps=EPS)
            self.skip_linear = QLinear(2 * dim, dim)
        self.ffn_is_moe = moe
        if moe:
            self.moe = MoEBlock(dim, inner, n_experts, top_k)
        else:
            self.mlp = MLP(dim, inner)

    def forward(self, x, c, skip_value=None):
        if self.skip:
            x = self.skip_norm(self.skip_linear(torch.cat([skip_value, x], dim=-1)))
        x = x + self.attn1(self.norm1(x))
        x = x + self.attn2(self.norm2(x), c)
        return x + (self.moe if self.ffn_is_moe else self.mlp)(self.norm3(x))


class TokenInput(nn.Identity):
    """The condition tokens enter the blocks as they are; ``in_features``
    is their width (the flow sampler's zero tokens are made at it)."""

    def __init__(self, in_features):
        super().__init__()
        self.in_features = in_features


class Hunyuan3DDiTPlain(nn.Module):
    def __init__(self, in_channels=64, hidden_size=2048, context_dim=1024, depth=21,
                 num_heads=16, num_moe_layers=6, num_experts=8, moe_top_k=2):
        super().__init__()
        self.hidden_size = hidden_size
        self.cond_in = TokenInput(context_dim)
        self.x_embedder = QLinear(in_channels, hidden_size)
        self.t_embedder = nn.Module()
        self.t_embedder.mlp = nn.Sequential(QLinear(hidden_size, 4 * hidden_size), nn.GELU(),
                                            QLinear(4 * hidden_size, hidden_size))
        self.blocks = nn.ModuleList([
            DiTBlock(hidden_size, num_heads, context_dim, skip=layer > depth // 2,
                     moe=depth - layer <= num_moe_layers,
                     n_experts=num_experts, top_k=moe_top_k)
            for layer in range(depth)])
        self.final_layer = nn.Module()
        self.final_layer.norm_final = nn.LayerNorm(hidden_size, eps=EPS)
        self.final_layer.linear = QLinear(hidden_size, in_channels)

    def condition(self, tokens):
        """(B, T, context_dim) encoder tokens, as the blocks read them."""
        return self.cond_in(tokens)

    def velocity(self, x, t, c):
        """The velocity of (B, N, C) latents at (B,) times given the tokens ``c``."""
        emb = timestep_embedding(t, self.hidden_size, time_factor=TIME_FACTOR)
        h = torch.cat([self.t_embedder.mlp(emb)[:, None], self.x_embedder(x)], dim=1)
        skips, mid = [], len(self.blocks) // 2
        for layer, block in enumerate(self.blocks):
            h = block(h, c, skips.pop() if layer > mid else None)
            if layer < mid:
                skips.append(h)
        f = self.final_layer
        return f.linear(f.norm_final(h)[:, 1:])

    def forward(self, x, t, cond):
        return self.velocity(x, t, self.condition(cond))
