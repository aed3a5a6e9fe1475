"""Latent DiT + EDM preconditioner (``rald_tpu/models/latent_dit.py``).

:class:`LatentDiTBlock` (:43), :class:`LatentArrayTransformer` (:200) and
:class:`EDMPrecond` (:277) with ``process_radar_cond`` (:336), ``denoise``
(:361), ``compute_mod_table`` (:390) and ``denoise_with_mods`` (:401), in
the reference's torch key layout (``model.transformer_blocks.{i}...``).

The modules take JAX's inference flags with JAX's names and defaults
(:43-64, routing :91-188), each a kernel wrapper (the CUDA kernel on the
card, its plain version on the CPU): ``use_fused_ff`` runs the block's FF
sublayer (AdaLN mod + LN + GEGLU FF + residual) through
:func:`~rald_torch.ops.geglu_kernel.fused_ln_geglu_residual`, or with
``use_int8_ff`` through the dynamic or static int8 FF kernel;
``use_fused_attn`` runs the self-attention sublayer through
:func:`~rald_torch.ops.attn_kernel.fused_self_attention_block`, and
``use_int8_attn`` (checked first) through the full or vout int8 attention
kernel, with the int8 side-tree that :meth:`EDMPrecond.set_int8` hands to
the blocks. Without flags every sublayer is the plain module.
:meth:`EDMPrecond.set_flags` is JAX's ``model.copy(**flags)`` for them.
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
from rald_torch.ops.attn_kernel import (
    fused_self_attention_block,
    fused_self_attention_block_int8,
    fused_self_attention_block_int8_vout,
)
from rald_torch.ops.geglu_kernel import (
    div127,
    fused_ln_geglu_residual,
    fused_ln_geglu_residual_int8,
    fused_ln_geglu_residual_int8_static,
    inv127,
)


FLAGS = ("use_fused_ff", "use_fused_attn")


class LatentDiTBlock(nn.Module):
    def __init__(self, dim: int, n_heads: int = 8, d_head: int = 64,
                 context_dim: Optional[int] = None, use_fused_ff: bool = False,
                 use_fused_attn: bool = False):
        super().__init__()
        self.use_fused_ff, self.use_fused_attn = use_fused_ff, use_fused_attn
        self.norm1 = AdaLayerNorm(dim)
        self.attn1 = Attention(dim, heads=n_heads, dim_head=d_head, fused_kv=False)
        self.norm2 = AdaLayerNorm(dim)
        self.attn2 = Attention(dim, context_dim, heads=n_heads, dim_head=d_head, fused_kv=False)
        self.norm3 = AdaLayerNorm(dim)
        self.ff = GEGLUFeedForward(dim, dit_style=True)
        # quantized inference, set by EDMPrecond.set_int8: use_int8_ff False |
        # True (dynamic per-token activation scales) | "static" (calibrated
        # per-(step, block) scales through ``act_scales``; dynamic without
        # them); use_int8_attn False | True / "full" | "vout" (v / out int8,
        # q / k bf16); int8: this block's side-tree nodes {"ff", "attn1"}
        self.use_int8_ff = False
        self.use_int8_attn = False
        self.int8 = {}

    def mods(self, t_emb):
        """All three sigma-dependent (scale, shift) pairs for this block."""
        return (self.norm1.mod(t_emb), self.norm2.mod(t_emb), self.norm3.mod(t_emb))

    def _int8_attn(self, x, s1, b1, q8):
        attn = self.attn1
        if self.use_int8_attn == "vout":
            return fused_self_attention_block_int8_vout(
                x, s1, b1, attn.to_q.weight, attn.to_k.weight, q8["to_v_q"], q8["to_v_s"],
                q8["to_out_q"], q8["to_out_s"], q8["to_out_b"], heads=attn.heads,
            )
        return fused_self_attention_block_int8(
            x, s1, b1, q8["to_q_q"], q8["to_q_s"], q8["to_k_q"], q8["to_k_s"], q8["to_v_q"],
            q8["to_v_s"], q8["to_out_q"], q8["to_out_s"], q8["to_out_b"], heads=attn.heads,
        )

    def _int8_ff(self, x, s3, b3, q8, act_scales):
        if self.use_int8_ff == "static" and act_scales is not None:
            # calibrated amax folded into the dequant rows outside the kernel
            ah, ag = (a.float().clamp_min(1e-6) for a in act_scales)
            return fused_ln_geglu_residual_int8_static(
                x, s3, b3, q8["w1q"], q8["s1"] * div127(ah), q8["b1"], q8["w2q"],
                q8["s2"] * div127(ag), q8["b2"], inv127(ah).reshape(1), inv127(ag).reshape(1),
            )
        return fused_ln_geglu_residual_int8(
            x, s3, b3, q8["w1q"], q8["s1"], q8["b1"], q8["w2q"], q8["s2"], q8["b2"]
        )

    def apply_with_mods(self, x, mods, cond=None, act_scales=None, quant_stats=None):
        """``act_scales``: this block's ``(ah, ag)`` FF activation amax for
        the static int8 FF. ``quant_stats``: a list that receives the FF's
        ``(max|h|, max|g|)``; the block then runs unfused and without int8,
        as the JAX calibration model does."""
        (s1, b1), (s2, b2), (s3, b3) = mods
        calib = quant_stats is not None
        q8 = {} if calib else self.int8
        if self.use_int8_attn and "attn1" in q8:
            x = self._int8_attn(x.contiguous(), s1, b1, q8["attn1"])
        elif self.use_fused_attn and not calib:
            a = self.attn1
            x = fused_self_attention_block(
                x.contiguous(), s1, b1, a.to_q.weight, a.to_k.weight, a.to_v.weight,
                a.to_out[0].weight, a.to_out[0].bias, heads=a.heads,
            )
        else:
            x = x + self.attn1(self.norm1.apply_mod(x, s1, b1))
        x = x + self.attn2(self.norm2.apply_mod(x, s2, b2), context=cond)
        if not self.use_fused_ff or calib:
            return x + self.ff(self.norm3.apply_mod(x, s3, b3), amax=quant_stats)
        x = x.contiguous()
        if self.use_int8_ff and "ff" in q8:
            return self._int8_ff(x, s3, b3, q8["ff"], act_scales)
        pi, po = self.ff.proj_in, self.ff.proj_out
        return fused_ln_geglu_residual(
            x, s3.contiguous(), b3.contiguous(), pi.weight, pi.bias, po.weight, po.bias,
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
        use_fused_ff: bool = False,
        use_fused_attn: bool = False,
    ):
        super().__init__()
        self.use_fused_ff, self.use_fused_attn = use_fused_ff, use_fused_attn
        inner = n_heads * d_head
        self.map_noise = FourierTimeEmbedding(t_channels)
        self.map_layer0 = nn.Linear(t_channels, inner)
        self.map_layer1 = nn.Linear(inner, inner)
        self.proj_in = nn.Linear(in_channels, inner, bias=False)
        self.transformer_blocks = nn.ModuleList(
            [LatentDiTBlock(inner, n_heads, d_head, context_dim, use_fused_ff, use_fused_attn)
             for _ in range(depth)]
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

    def forward_with_mods(self, x, mods, cond=None, act_scales=None, quant_stats=None):
        """``act_scales``: per-block ``(ah, ag)`` for the static int8 FF
        (None: dynamic). ``quant_stats``: a list that receives each block's
        FF ``(max|h|, max|g|)`` in block order (unfused, no int8)."""
        x = self.proj_in(x)
        if act_scales is None:
            act_scales = (None,) * len(self.transformer_blocks)
        for block, block_mods, sc in zip(self.transformer_blocks, mods, act_scales):
            x = block.apply_with_mods(x, block_mods, cond, act_scales=sc, quant_stats=quant_stats)
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
        use_fused_ff: bool = False,
        use_fused_attn: bool = False,
        use_int8_ff=False,
        use_int8_attn=False,
        sow_quant_stats: bool = False,
        sigma_min: float = 0.0,
        sigma_max: float = float("inf"),
        dtype=None,
    ):
        """Arguments are JAX's ``EDMPrecond`` fields. ``use_int8_ff`` /
        ``use_int8_attn`` take effect through :meth:`set_int8` (the engine
        builds the side-tree); ``sow_quant_stats`` is kept for the YAML (the
        port's calibration passes ``quant_stats`` instead); ``sigma_min`` /
        ``sigma_max`` are unused there too; ``dtype`` (a torch dtype or its
        name), when given, is the compute dtype the engine casts this model
        to instead of ``system.compute_dtype``."""
        super().__init__()
        self.use_fused_ff, self.use_fused_attn = use_fused_ff, use_fused_attn
        self.use_int8_ff, self.use_int8_attn = use_int8_ff, use_int8_attn
        self.sow_quant_stats, self.sigma_min, self.sigma_max = sow_quant_stats, sigma_min, sigma_max
        self.compute_dtype = dtype
        self.n_latents, self.channels, self.depth = n_latents, channels, depth
        self.sigma_data = sigma_data
        self.cond_type = cond_type
        self.use_radar_enc, self.unfreeze_radar_enc = use_radar_enc, unfreeze_radar_enc
        self.radar_token_channel = radar_token_channel
        self.model = LatentArrayTransformer(
            channels, 256, n_heads, d_head, depth,
            context_dim=radar_token_channel if cond_type == "radar" else None,
            use_fused_ff=use_fused_ff, use_fused_attn=use_fused_attn,
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

    def denoise_with_mods(self, x, sigma, mods, cond_tokens=None, act_scales=None,
                          quant_stats=None):
        """``denoise`` with precomputed AdaLN modulations for this sigma;
        ``act_scales`` / ``quant_stats`` as in ``forward_with_mods``."""
        x, sigma, c_skip, c_out, c_in = self._precond(x, sigma)
        dt = self.model.proj_in.weight.dtype
        f_x = self.model.forward_with_mods((c_in * x).to(dt), mods, cond_tokens,
                                           act_scales=act_scales, quant_stats=quant_stats)
        return c_skip * x + c_out * f_x.float()

    def set_flags(self, **flags) -> None:
        """Set ``use_fused_ff`` / ``use_fused_attn`` here and in every
        transformer and block, as JAX's ``model.copy(**flags)`` rebuilds the
        module tree with them (the weights stay shared)."""
        for k in flags:
            if k not in FLAGS:
                raise TypeError(f"EDMPrecond.set_flags: unknown flag {k!r}")
        for mod in self.modules():
            if isinstance(mod, (EDMPrecond, LatentArrayTransformer, LatentDiTBlock)):
                for k, v in flags.items():
                    setattr(mod, k, v)

    def set_int8(self, tree: dict, use_int8_ff=False, use_int8_attn=False) -> None:
        """Quantized inference: ``tree`` is the int8 side-tree of this
        model's f32 weights (``quantize_ff_tree`` / ``quantize_attn_tree``,
        merged; keys are module paths), on the model's device. Each DiT block
        takes its nodes and routes its FF / self-attention by the flags
        (values as ``eval.inference.int8_ff`` / ``int8_attn``)."""
        self.use_int8_ff, self.use_int8_attn = use_int8_ff, use_int8_attn
        for name, mod in self.named_modules():
            if isinstance(mod, LatentDiTBlock):
                mod.use_int8_ff, mod.use_int8_attn = use_int8_ff, use_int8_attn
                mod.int8 = {k: tree[f"{name}.{k}"] for k in ("ff", "attn1") if f"{name}.{k}" in tree}

    def forward(self, x, sigma, radar_cube=None):
        """D(x; sigma) from a raw cube (or pre-encoded tokens): JAX's
        ``EDMPrecond.__call__``, the function training differentiates. JAX
        trains it with ``deterministic=False``, which changes nothing: the
        DiT's attention and FF drop-path rates and the radar encoder's
        dropout are 0 (``rald_tpu/nn/layers.py:99,155``,
        ``radar_encoder3d.py:41``), so this model has no dropout."""
        cond = (
            self.process_radar_cond(radar_cube)
            if (self.cond_type == "radar" and radar_cube is not None) else None
        )
        return self.denoise(x, sigma, cond)
