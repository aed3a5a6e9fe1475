"""Point-cloud VAE, decode side (``rald_tpu/models/vecset_vae.py``).

:class:`VecSetVAE` declares every parameter of the reference
``KLAutoEncoder`` (encoder included, in its torch key layout), so its
``state_dict`` is complete and round-trips through
``rald_tpu.convert.torch_ckpt.convert_vae_state_dict``. It computes the
decode: ``decode_latents`` (:204), ``decode_queries`` (:213) and the folded
decode ``_decode_queries_folded`` (:251-301). ``encode`` comes in a later
slice.

Each self-attention block's FF sublayer (LayerNorm + GEGLU FF + residual)
goes through :func:`rald_torch.ops.geglu_kernel.fused_ln_geglu_residual`
in affine mode, with the ``ff`` LayerNorm's weight and bias as the rows.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from rald_torch.nn.layers import Attention, GEGLUFeedForward, LayerNorm, PointEmbed
from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual
from rald_torch.ops.query_attention import map_query_chunks


class PreNorm(nn.Module):
    """``fn`` behind a LayerNorm (and one on the context when given)."""

    def __init__(self, dim: int, fn: nn.Module, context_dim: Optional[int] = None):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim)
        if context_dim is not None:
            self.norm_context = LayerNorm(context_dim)


class SelfAttnBlock(nn.ModuleList):
    """``layers.{i}``: pre-norm self-attention, then the pre-norm GEGLU FF,
    both residual."""

    def __init__(self, dim: int, heads: int, dim_head: int):
        super().__init__([
            PreNorm(dim, Attention(dim, heads=heads, dim_head=dim_head)),
            PreNorm(dim, GEGLUFeedForward(dim)),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        attn, ff = self[0], self[1]
        x = x + attn.fn(attn.norm(x))
        f = ff.fn
        return fused_ln_geglu_residual(
            x.contiguous(), ff.norm.weight, ff.norm.bias,
            f.proj_in.weight, f.proj_in.bias, f.proj_out.weight, f.proj_out.bias,
            scale_shift_mod=False,
        )


class VecSetVAE(nn.Module):
    def __init__(
        self,
        depth: int = 24,
        dim: int = 512,
        queries_dim: int = 512,
        output_dim: int = 1,
        num_inputs: int = 2048,
        num_latents: int = 512,
        latent_dim: int = 32,
        heads: int = 8,
        dim_head: int = 64,
        query_type: str = "mix",
        deterministic_latent: bool = False,
        query_chunk: int = 65536,
    ):
        super().__init__()
        self.dim, self.queries_dim, self.output_dim = dim, queries_dim, output_dim
        self.num_inputs, self.num_latents, self.latent_dim = num_inputs, num_latents, latent_dim
        self.query_type, self.deterministic_latent = query_type, deterministic_latent
        self.query_chunk = query_chunk

        self.point_embed = PointEmbed(dim=dim)
        self.cross_attend_blocks = nn.ModuleList([
            PreNorm(dim, Attention(dim, dim, heads=1, dim_head=dim), context_dim=dim),
            PreNorm(dim, GEGLUFeedForward(dim)),
        ])
        if query_type == "learnable":
            self.latents = nn.Embedding(num_latents, dim)
        elif query_type == "mix":
            self.s_latents = nn.Embedding(num_latents, dim)
            self.d_latents = nn.Embedding(num_latents, dim)
            self.mix_attn_layer = PreNorm(dim, Attention(dim, dim, heads=heads, dim_head=dim_head))
            self.query_proj = nn.Linear(dim, dim)
        elif query_type != "point":
            raise NotImplementedError(f"Query type {query_type} is not implemented")
        self.layers = nn.ModuleList([SelfAttnBlock(dim, heads, dim_head) for _ in range(depth)])
        self.decoder_cross_attn = PreNorm(
            dim,
            Attention(dim, dim, heads=1, dim_head=queries_dim, out_dim=queries_dim),
            context_dim=dim,
        )
        self.to_outputs = nn.Linear(queries_dim, output_dim)
        if not deterministic_latent:
            self.proj = nn.Linear(latent_dim, dim)
            self.mean_fc = nn.Linear(dim, latent_dim)
            self.logvar_fc = nn.Linear(dim, latent_dim)

    @property
    def dtype(self) -> torch.dtype:
        return self.to_outputs.weight.dtype

    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Latent tokens -> decoder token state (proj + self-attn stack)."""
        x = z.to(self.dtype)
        if not self.deterministic_latent:
            x = self.proj(x)
        for block in self.layers:
            x = block(x)
        return x

    def decode_queries(self, tokens: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """(B, Q, 1) occupancy logits at query points, streamed in
        ``_chunk(B)`` query blocks through the folded decode."""
        if self.output_dim != 1:
            raise NotImplementedError(
                f"rald_torch: the folded decode needs output_dim 1, got {self.output_dim}")
        return self._decode_queries_folded(self.decoder_cross_attn.norm_context(tokens), queries)

    def _chunk(self, batch: int) -> int:
        """Per-chunk query count, scaled so batch * chunk stays <= 2^19."""
        return max(4096, min(self.query_chunk, (1 << 19) // max(1, batch)))

    def _decode_queries_folded(self, ctx: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        dca = self.decoder_cross_attn
        attn, dt = dca.fn, self.dtype
        inner = attn.heads * attn.dim_head
        wq = attn.to_q.weight.float().t()  # (dim, inner)
        wk, wv = attn.to_kv.weight[:inner], attn.to_kv.weight[inner:]  # (inner, dim)
        wo, bo = attn.to_out.weight.float(), attn.to_out.bias.float()  # (qd, inner)
        wh, bh = self.to_outputs.weight.float(), self.to_outputs.bias.float()  # (1, qd)
        # the occupancy head is linear: fold values -> out-proj -> head into
        # one (M, 1) value vector per frame
        w_tail = wo.t() @ wh.t()  # (inner, 1)
        bias = bo @ wh.t() + bh  # (1,)
        k = ctx @ wk.t()  # (B, M, inner)
        v = ctx @ wv.t()
        v_fold = v.float() @ w_tail  # (B, M, 1)
        scale = float(self.queries_dim) ** -0.5
        # query-side fold: to_q is bias-free and the attention 1-head, so
        # softmax((q Wq) K^T s) == softmax(q (Wq K^T s)), one (dim, M) weight
        w_score = torch.einsum("di,bmi->bdm", wq * scale, k.float()).to(dt)
        # ones column: one (M, 2) matvec gives numerator and denominator
        v2 = torch.cat([v_fold, torch.ones_like(v_fold)], dim=-1)  # (B, M, 2)

        def tail(q_blk):
            q_emb = dca.norm(self.point_embed(q_blk))
            sim = torch.matmul(q_emb, w_score).float()
            # constant-shift exp: the ratio is invariant to the shift, and
            # the clip keeps exp inside the normal f32 range
            e = torch.exp(torch.clamp(sim, -45.0, 80.0) - 40.0)
            nd = torch.matmul(e, v2)
            return nd[..., :1] / nd[..., 1:] + bias

        return map_query_chunks(tail, queries, self._chunk(queries.shape[0]))

    def decode(self, z: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        return self.decode_queries(self.decode_latents(z), queries)
