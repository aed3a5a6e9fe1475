"""The decoder half of Hunyuan3D-2.0's ShapeVAE (arXiv:2501.12202; public
code ``hy3dgen/shapegen/models/autoencoders/``, config
``hunyuan3d-vae-v2-0/config.yaml``), in the public code's ``state_dict``
layout, with the interface the generation engine decodes through
(:meth:`ShapeVAE.decode_latents`, :meth:`ShapeVAE.decode_queries`,
``dtype``, ``_chunk``).

- Latent stack: ``h = post_kl(z)`` (64 -> 1024), then 16 pre-norm blocks
  ``h += Attn(LN_1 h)``, ``h += MLP(LN_2 h)``: 16 heads of 64, no QKV
  bias, LayerNorm on q and k per head, exact-GELU MLP x 4.
- Geometry decoder, per query point ``p``: ``y = query_proj(Fourier(p))``
  (8 frequencies 2^k, no pi, the input kept: 51 channels), ``y +=
  CrossAttn(LN_1 y, LN_2 h)`` (16 heads, q and k LayerNormed per head),
  ``y += MLP(LN_3 y)``, ``logit = output_proj(ln_post(y))``.

The latent stack's blocks (:meth:`ShapeVAE.decode_latents`) and the
cross-attention's keys and values (at the start of each
:meth:`ShapeVAE.decode_queries`) run under ``vae_stack`` spans, once per
decode; the query axis streams through
:func:`~rald_torch.ops.query_attention.map_query_chunks` in
``_chunk(B)`` blocks under ``decode_block`` spans, each block's attention
one ``F.scaled_dot_product_attention`` call (no (block x 3072 x 16) score
tensor on the card). Unlike the RaLD VAE's single-head tail, this one has
16 QK-normed heads and an MLP after the attention, so nothing folds.

The QKV layouts differ from the DiT's: the self-attention's ``c_qkv``
output is per head [q | k | v] (``view(B, N, H, 3 * Dh)``), the
cross-attention's ``c_kv`` per head [k | v].
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from rald_torch.ops.query_attention import map_query_chunks
from rald_torch.train.profiler import span


class FourierEmbedder(nn.Module):
    """(..., 3) -> (..., 3 * (2 * num_freqs + 1)): ``[p, sin(p f), cos(p
    f)]``, ``f = 2^k`` (times pi with ``include_pi``), channels axis-major
    (x's frequencies, then y's, then z's), in float32."""

    def __init__(self, num_freqs: int = 8, include_pi: bool = False):
        super().__init__()
        freqs = 2.0 ** torch.arange(num_freqs, dtype=torch.float32)
        # kept out of the buffers, so that a cast to bf16 leaves them in f32,
        # and copied to each device once
        self._freqs = {torch.device("cpu"): freqs * torch.pi if include_pi else freqs}
        self.out_dim = 3 * (2 * num_freqs + 1)

    def forward(self, p: torch.Tensor) -> torch.Tensor:
        p = p.float()
        freqs = self._freqs.get(p.device)
        if freqs is None:
            freqs = self._freqs[p.device] = self._freqs[torch.device("cpu")].to(p.device)
        e = (p[..., None] * freqs).flatten(-2)
        return torch.cat([p, torch.sin(e), torch.cos(e)], dim=-1)


def _ln(dim: int, eps: float = 1e-6) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=eps)


class QKNorm(nn.Module):
    """Per-head LayerNorms of q and k (``q_norm``, ``k_norm``)."""

    def __init__(self, head_dim: int):
        super().__init__()
        self.q_norm = _ln(head_dim)
        self.k_norm = _ln(head_dim)


def _heads(t: torch.Tensor) -> torch.Tensor:
    """(B, L, H, Dh) -> (B, H, L, Dh)."""
    return t.transpose(1, 2)


class MultiheadAttention(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool = False):
        super().__init__()
        self.heads = heads
        self.c_qkv = nn.Linear(width, 3 * width, bias=qkv_bias)
        self.c_proj = nn.Linear(width, width)
        self.attention = QKNorm(width // heads)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        q, k, v = self.c_qkv(x).view(b, n, self.heads, -1).chunk(3, dim=-1)
        q, k = self.attention.q_norm(q), self.attention.k_norm(k)
        out = F.scaled_dot_product_attention(_heads(q), _heads(k), _heads(v))
        return self.c_proj(out.transpose(1, 2).reshape(b, n, w))


class MLP(nn.Module):
    def __init__(self, width: int, expand_ratio: int = 4):
        super().__init__()
        self.c_fc = nn.Linear(width, width * expand_ratio)
        self.c_proj = nn.Linear(width * expand_ratio, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.c_proj(F.gelu(self.c_fc(x)))


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool = False):
        super().__init__()
        self.attn = MultiheadAttention(width, heads, qkv_bias)
        self.ln_1 = _ln(width)
        self.mlp = MLP(width)
        self.ln_2 = _ln(width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x))
        return x + self.mlp(self.ln_2(x))


class Transformer(nn.Module):
    def __init__(self, width: int, layers: int, heads: int, qkv_bias: bool = False):
        super().__init__()
        self.resblocks = nn.ModuleList(
            [ResidualAttentionBlock(width, heads, qkv_bias) for _ in range(layers)])


class MultiheadCrossAttention(nn.Module):
    def __init__(self, width: int, heads: int, qkv_bias: bool = False):
        super().__init__()
        self.heads = heads
        self.c_q = nn.Linear(width, width, bias=qkv_bias)
        self.c_kv = nn.Linear(width, 2 * width, bias=qkv_bias)
        self.c_proj = nn.Linear(width, width)
        self.attention = QKNorm(width // heads)

    def keys_values(self, data: torch.Tensor):
        """(B, M, width) normed latents -> k (normed) and v, each (B, H, M, Dh)."""
        b, m, _ = data.shape
        k, v = self.c_kv(data).view(b, m, self.heads, -1).chunk(2, dim=-1)
        return _heads(self.attention.k_norm(k)), _heads(v)

    def forward(self, x: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        b, n, w = x.shape
        q = self.attention.q_norm(self.c_q(x).view(b, n, self.heads, -1))
        out = F.scaled_dot_product_attention(_heads(q), k, v)
        return self.c_proj(out.transpose(1, 2).reshape(b, n, w))


class ResidualCrossAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, mlp_expand_ratio: int = 4, qkv_bias: bool = False):
        super().__init__()
        self.attn = MultiheadCrossAttention(width, heads, qkv_bias)
        self.ln_1 = _ln(width)
        self.ln_2 = _ln(width)
        self.ln_3 = _ln(width)
        self.mlp = MLP(width, mlp_expand_ratio)


class CrossAttentionDecoder(nn.Module):
    def __init__(self, in_dim: int, width: int, heads: int, mlp_expand_ratio: int = 4,
                 qkv_bias: bool = False):
        super().__init__()
        self.query_proj = nn.Linear(in_dim, width)
        self.cross_attn_decoder = ResidualCrossAttentionBlock(width, heads, mlp_expand_ratio, qkv_bias)
        self.ln_post = nn.LayerNorm(width)
        self.output_proj = nn.Linear(width, 1)


class ShapeVAE(nn.Module):
    """The ShapeVAE's decoder: (B, num_latents, embed_dim) latents -> the
    occupancy logit of any query point. The published v2-0 widths are the
    defaults. ``scale_factor`` divides the sampler's latents before the
    decode (:meth:`from_sampler`); ``query_chunk`` caps a decode block;
    ``dtype`` as the other models'. :attr:`queries_decoded` counts the
    query points scored (a host counter: shapes only, no synchronise)."""

    def __init__(
        self,
        num_latents: int = 3072,
        embed_dim: int = 64,
        width: int = 1024,
        heads: int = 16,
        num_decoder_layers: int = 16,
        num_freqs: int = 8,
        include_pi: bool = False,
        qkv_bias: bool = False,
        mlp_expand_ratio: int = 4,
        scale_factor: float = 0.9990943042622529,
        query_chunk: int = 65536,
        dtype=None,
    ):
        super().__init__()
        self.compute_dtype = dtype
        self.num_latents, self.latent_dim = num_latents, embed_dim
        self.scale_factor, self.query_chunk = scale_factor, query_chunk
        self.queries_decoded = 0
        self.fourier_embedder = FourierEmbedder(num_freqs, include_pi)
        self.post_kl = nn.Linear(embed_dim, width)
        self.transformer = Transformer(width, num_decoder_layers, heads, qkv_bias)
        self.geo_decoder = CrossAttentionDecoder(self.fourier_embedder.out_dim, width, heads,
                                                 mlp_expand_ratio, qkv_bias)

    @property
    def dtype(self) -> torch.dtype:
        return self.post_kl.weight.dtype

    def set_fast(self) -> None:
        """No fused or folded path: the model as built."""

    def from_sampler(self, z: torch.Tensor) -> torch.Tensor:
        """The sampler's latents in the decoder's scale: over ``scale_factor``."""
        return z / self.scale_factor

    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """(B, num_latents, embed_dim) latents -> (B, num_latents, width)
        decoder state: ``post_kl`` and the self-attention stack."""
        with span("vae_stack"):
            h = self.post_kl(z.to(self.dtype))
            for block in self.transformer.resblocks:
                h = block(h)
        return h

    def decode_queries(self, h: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """(B, Q, 1) occupancy logits of (B, Q, 3) query points from the
        decoder state ``h``, streamed in ``_chunk(B)`` query blocks."""
        dec = self.geo_decoder
        block = dec.cross_attn_decoder
        with span("vae_stack"):  # the latents' keys and values, once a decode
            k, v = block.attn.keys_values(block.ln_2(h))
        self.queries_decoded += queries.shape[0] * queries.shape[1]

        def tail(q_blk):
            with span("decode_block"):
                y = dec.query_proj(self.fourier_embedder(q_blk).to(self.dtype))
                y = y + block.attn(block.ln_1(y), k, v)
                y = y + block.mlp(block.ln_3(y))
                return dec.output_proj(dec.ln_post(y))

        return map_query_chunks(tail, queries, self._chunk(queries.shape[0]))

    def _chunk(self, batch: int) -> int:
        """Per-block query count, scaled so batch * block stays <= 2^19."""
        return max(4096, min(self.query_chunk, (1 << 19) // max(1, batch)))
