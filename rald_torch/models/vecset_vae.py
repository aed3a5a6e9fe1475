"""Point-cloud VAE (``rald_tpu/models/vecset_vae.py``).

:class:`VecSetVAE` declares every parameter of the reference
``KLAutoEncoder`` in its torch key layout, so its ``state_dict`` is
complete and round-trips through
``rald_tpu.convert.torch_ckpt.convert_vae_state_dict``. It computes the
encode (``_latent_queries`` and ``encode``, :156-202: ``mix``,
``learnable`` or FPS ``point`` queries, the KL posterior), the decode:
``decode_latents`` (:204), ``decode_queries`` (:213-239) and the folded
decode ``_decode_queries_folded`` (:251-301), and the whole forward
(:meth:`VecSetVAE.forward`, JAX's ``__call__`` :307-319);
:func:`create_autoencoder` is JAX's factory (:322-349).

Training mode (``module.train()``) is JAX's ``deterministic=False``: each
self-attention block's two sublayers and the mix attention end in a
drop-path of rate 0.1 (:50, :128-130), drawn per sample from the
generator given to :meth:`VecSetVAE.forward`, or injected by module name
(``drop_masks``). The encoder cross-attention, its FF and the decoder
cross-attention have none.

JAX's inference flags, with its names and defaults: ``use_fused_ff`` runs
each self-attention block's FF sublayer (LayerNorm + GEGLU FF + residual)
through :func:`rald_torch.ops.geglu_kernel.fused_ln_geglu_residual` in
affine mode, with the ``ff`` LayerNorm's weight and bias as the rows (else
the plain modules), and raises in training mode: a kernel has no backward,
and JAX's training forward, which then calls the ``geglu_ff``
``pallas_call``, cannot be differentiated either; ``fold_decode_tail``
(with ``output_dim`` 1) decodes through the folded tail, else the unfolded
point-embed -> LayerNorm -> cross-attention -> head.
:meth:`VecSetVAE.set_flags` is JAX's ``vae.copy(**flags)`` for them.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch
from torch import nn

from rald_torch.nn.layers import Attention, DropPath, GEGLUFeedForward, LayerNorm, PointEmbed
from rald_torch.ops.fps import fps_points
from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual
from rald_torch.ops.query_attention import map_query_chunks
from rald_torch.parallel.dist import draw_rows
from rald_torch.train.profiler import span


class PreNorm(nn.Module):
    """``fn`` behind a LayerNorm (and one on the context when given)."""

    def __init__(self, dim: int, fn: nn.Module, context_dim: Optional[int] = None):
        super().__init__()
        self.fn = fn
        self.norm = LayerNorm(dim)
        if context_dim is not None:
            self.norm_context = LayerNorm(context_dim)


DROP_PATH_RATE = 0.1  # the self-attention blocks' and the mix attention's


class SelfAttnBlock(nn.ModuleList):
    """``layers.{i}``: pre-norm self-attention, then the pre-norm GEGLU FF,
    both residual, each ending in a drop-path of ``DROP_PATH_RATE``."""

    def __init__(self, dim: int, heads: int, dim_head: int, use_fused_ff: bool = False):
        super().__init__([
            PreNorm(dim, Attention(dim, heads=heads, dim_head=dim_head,
                                   drop_path_rate=DROP_PATH_RATE)),
            PreNorm(dim, GEGLUFeedForward(dim, use_fused=use_fused_ff,
                                          drop_path_rate=DROP_PATH_RATE)),
        ])
        self.use_fused_ff = use_fused_ff

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.use_fused_ff and self.training:
            raise ValueError(
                "VecSetVAE: use_fused_ff in training mode — the fused FF kernel is "
                "inference-only (no backward), and the JAX package cannot differentiate its "
                "fused FF either (a pallas_call has no reverse-mode rule); train the plain "
                "model and set use_fused_ff for evaluation only")
        attn, ff = self[0], self[1]
        x = x + attn.fn(attn.norm(x))
        if not self.use_fused_ff:
            return x + ff.fn(ff.norm(x))
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
        use_fused_ff: bool = False,
        fold_decode_tail: bool = False,
        dtype=None,
    ):
        """Arguments are JAX's ``VecSetVAE`` fields; ``dtype`` (a torch dtype
        or its name), when given, is the compute dtype the engine casts this
        model to instead of ``system.compute_dtype``."""
        super().__init__()
        self.use_fused_ff, self.fold_decode_tail = use_fused_ff, fold_decode_tail
        self.compute_dtype = dtype
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
            self.mix_attn_layer = PreNorm(dim, Attention(dim, dim, heads=heads, dim_head=dim_head,
                                                         drop_path_rate=DROP_PATH_RATE))
            self.query_proj = nn.Linear(dim, dim)
        elif query_type != "point":
            raise NotImplementedError(f"Query type {query_type} is not implemented")
        self.layers = nn.ModuleList(
            [SelfAttnBlock(dim, heads, dim_head, use_fused_ff) for _ in range(depth)])
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

    def set_fast(self) -> None:
        """JAX's ``vae_eval``: the folded decode tail and the fused FF."""
        self.set_flags(fold_decode_tail=True, use_fused_ff=True)

    def from_sampler(self, z):
        """The sampler's output as it is: RaLD samples in the decoder's scale."""
        return z

    def set_flags(self, **flags) -> None:
        """Set ``use_fused_ff`` / ``fold_decode_tail``, in the blocks and
        their FF modules too, as JAX's ``vae.copy(**flags)`` does."""
        for k, v in flags.items():
            if k not in ("use_fused_ff", "fold_decode_tail"):
                raise TypeError(f"VecSetVAE.set_flags: unknown flag {k!r}")
            setattr(self, k, v)
            if k == "use_fused_ff":
                for block in self.layers:
                    block.use_fused_ff = v
                    block[1].fn.use_fused = v

    def _latent_queries(self, pc: torch.Tensor, pc_embeddings: torch.Tensor) -> torch.Tensor:
        """(B, M, dim) encoder queries: the point embeddings of M FPS points
        (``point``), the learned table (``learnable``), or the static table
        plus the dynamic table attending to the cloud, jointly projected
        (``mix``; the context is not normed)."""
        b, m, dim = pc.shape[0], self.num_latents, self.dim
        if self.query_type == "point":
            return self.point_embed(fps_points(pc, m))
        if self.query_type == "learnable":
            return self.latents.weight.to(self.dtype).expand(b, m, dim)
        static_q = self.s_latents.weight.to(self.dtype).expand(b, m, dim)
        dynamic_q = self.d_latents.weight.to(self.dtype).expand(b, m, dim)
        mix = self.mix_attn_layer
        dynamic_q = mix.fn(mix.norm(dynamic_q), context=pc_embeddings)
        return self.query_proj(static_q + dynamic_q)

    def encode(self, pc: torch.Tensor, generator: Optional[torch.Generator] = None,
               eps: Optional[torch.Tensor] = None, sample_posterior: bool = True):
        """(B, N, 3) -> ``(kl (B,), z (B, M, latent_dim))``, z in the model's
        dtype: ``mean + exp(logvar / 2) * eps`` with ``logvar`` clipped to
        [-30, 20] and ``eps ~ N(0, 1)`` from ``generator`` (on ``pc``'s
        device; under a process group this rank's rows of the draw at the
        global batch) unless given, or ``mean`` without
        ``sample_posterior``. With
        ``deterministic_latent`` the encoder output itself, and a zero KL."""
        if pc.shape[1] != self.num_inputs:
            raise ValueError(f"VecSetVAE.encode: {pc.shape[1]} points, the model takes "
                             f"{self.num_inputs}")
        pc_embeddings = self.point_embed(pc)
        x = self._latent_queries(pc, pc_embeddings)
        cross, ff = self.cross_attend_blocks
        x = x + cross.fn(cross.norm(x), context=cross.norm_context(pc_embeddings))
        x = x + ff.fn(ff.norm(x))
        if self.deterministic_latent:
            return torch.zeros((pc.shape[0],), device=pc.device), x
        mean = self.mean_fc(x).float()
        logvar = torch.clamp(self.logvar_fc(x).float(), -30.0, 20.0)
        kl = 0.5 * torch.mean(mean ** 2 + torch.exp(logvar) - 1.0 - logvar, dim=(1, 2))
        if not sample_posterior:
            return kl, mean.to(self.dtype)
        if eps is None:
            eps = draw_rows(torch.randn, mean.shape, generator=generator, device=mean.device)
        z = mean + torch.exp(0.5 * logvar) * eps.to(mean.device, torch.float32)
        return kl, z.to(self.dtype)

    def decode_latents(self, z: torch.Tensor) -> torch.Tensor:
        """Latent tokens -> decoder token state (proj + self-attn stack)."""
        x = z.to(self.dtype)
        if not self.deterministic_latent:
            x = self.proj(x)
        for block in self.layers:
            x = block(x)
        return x

    def decode_queries(self, tokens: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
        """(B, Q, output_dim) occupancy logits at query points, streamed in
        ``_chunk(B)`` query blocks: the folded decode with
        ``fold_decode_tail`` and ``output_dim`` 1, else point-embed ->
        LayerNorm -> 1-head cross-attention -> head."""
        dca = self.decoder_cross_attn
        ctx = dca.norm_context(tokens)
        if self.fold_decode_tail and self.output_dim == 1:
            return self._decode_queries_folded(ctx, queries)

        def tail(q_blk):
            with span("decode_block"):
                return self.to_outputs(dca.fn(dca.norm(self.point_embed(q_blk)), context=ctx))

        return map_query_chunks(tail, queries, self._chunk(queries.shape[0]))

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
            with span("decode_block"):
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

    def drop_paths(self) -> dict:
        """Name -> :class:`DropPath` for every drop-path that draws in
        training mode (rate > 0): ``layers.{i}.{0,1}.fn.drop_path`` and
        ``mix_attn_layer.fn.drop_path``, in forward order."""
        return {k: m for k, m in self.named_modules()
                if isinstance(m, DropPath) and m.rate > 0}

    @contextmanager
    def _drop_path_draws(self, generator, drop_masks):
        sites = self.drop_paths()
        unknown = set(drop_masks or ()) - set(sites)
        if unknown:
            raise KeyError(f"VecSetVAE.forward: no drop-path named {sorted(unknown)}")
        for name, m in sites.items():
            m.generator, m.mask = generator, (drop_masks or {}).get(name)
        try:
            yield
        finally:
            for m in sites.values():
                m.generator = m.mask = None

    def forward(self, pc: torch.Tensor, queries: torch.Tensor,
                generator: Optional[torch.Generator] = None, eps: Optional[torch.Tensor] = None,
                sample_posterior: bool = True, drop_masks: Optional[dict] = None) -> dict:
        """``{"logits": (B, Q) f32, "kl": (B,)}`` of (B, N, 3) clouds at (B, Q,
        3) queries (JAX ``__call__``). ``generator`` draws the posterior
        noise (unless ``eps`` is given) and, in training mode, the
        drop-path masks, in forward order; ``drop_masks`` (name as in
        :meth:`drop_paths` -> (B,) bool) replaces a site's draw."""
        with self._drop_path_draws(generator, drop_masks):
            kl, z = self.encode(pc, generator=generator, eps=eps,
                                sample_posterior=sample_posterior)
            logits = self.decode(z, queries)
        return {"logits": logits.squeeze(-1).float(), "kl": kl}


def create_autoencoder(
    dim: int = 512,
    M: int = 512,
    latent_dim: int = 64,
    N: int = 2048,
    deterministic: bool = False,
    query_type: str = "point",
    use_fused_ff: bool = False,
    fold_decode_tail: bool = False,
    dtype=None,
) -> VecSetVAE:
    """The reference's ``create_autoencoder`` (``models_ae.py:434-459``):
    24 blocks, 8 heads of 64, one output logit, JAX's defaults."""
    return VecSetVAE(
        depth=24, dim=dim, queries_dim=dim, output_dim=1, num_inputs=N, num_latents=M,
        latent_dim=latent_dim, heads=8, dim_head=64, query_type=query_type,
        deterministic_latent=deterministic, use_fused_ff=use_fused_ff,
        fold_decode_tail=fold_decode_tail, dtype=dtype,
    )
