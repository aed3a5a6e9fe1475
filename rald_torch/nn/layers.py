"""Shared layers in the reference's torch ``state_dict`` layout.

Counterparts of ``rald_tpu/nn/layers.py``: :class:`PointEmbed` (:50),
:class:`DropPath` (:66), :class:`Attention` (:82),
:class:`GEGLUFeedForward` (:137), :class:`AdaLayerNorm` (:187) and
:class:`FourierTimeEmbedding` (:214). ``Attention`` and
``GEGLUFeedForward`` end in a ``drop_path`` of ``drop_path_rate`` (default
0, the identity: the DiT's modules and the VAE's cross-attentions); the
VAE's self-attention blocks and mix attention train with 0.1.

Compute dtype is the parameters' dtype (the engine casts a whole model to
``system.compute_dtype`` once, which rounds each weight exactly as the JAX
modules' per-use cast does); LayerNorm and softmax statistics and the
point-embedding frequencies stay in f32.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rald_torch.ops.geglu_kernel import geglu_ff


def point_fourier_basis(hidden_dim: int) -> np.ndarray:
    """Block-diagonal (3, hidden_dim//2) basis of 2^k * pi frequencies."""
    assert hidden_dim % 6 == 0
    k = hidden_dim // 6
    e = (2.0 ** np.arange(k, dtype=np.float64)) * np.pi
    basis = np.zeros((3, 3 * k), dtype=np.float32)
    for axis in range(3):
        basis[axis, axis * k:(axis + 1) * k] = e
    return basis


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm with f32 statistics, returned in ``x``'s dtype."""
    w = None if weight is None else weight.float()
    b = None if bias is None else bias.float()
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, eps).to(x.dtype)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` (weight/bias keys) computed with f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__(dim, eps=eps)

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class PointEmbed(nn.Module):
    """Fourier positional embedding of 3D points -> ``dim`` channels."""

    def __init__(self, hidden_dim: int = 48, dim: int = 512):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.mlp = nn.Linear(hidden_dim + 3, dim)
        # kept out of the module's buffers so a cast to bf16 leaves the
        # 2^k*pi frequencies in f32 (they need the precision before sin)
        self._basis = {}

    def _basis_on(self, device) -> torch.Tensor:
        basis = self._basis.get(device)
        if basis is None:
            basis = torch.from_numpy(point_fourier_basis(self.hidden_dim)).to(device)
            self._basis[device] = basis
        return basis

    def forward(self, pts: torch.Tensor) -> torch.Tensor:
        p = pts.float()
        proj = torch.matmul(p, self._basis_on(p.device))
        feats = torch.cat([torch.sin(proj), torch.cos(proj), p], dim=-1)
        return self.mlp(feats.to(self.mlp.weight.dtype))


class DropPath(nn.Module):
    """Per-sample stochastic depth, timm's semantics as in JAX: in training
    mode with ``rate > 0``, each sample of the batch is kept with
    probability ``keep = 1 - rate`` (a ``(B, 1, ..., 1)`` mask) and
    ``where(mask, x / keep, 0)`` is returned, with ``keep`` cast to x's dtype
    as JAX casts the weakly typed scalar (bf16 divides by 0.8984375), and a
    true division, not a product with ``1 / keep``; otherwise ``x`` itself.

    The mask is :attr:`mask` where set (a (B,) bool; tests inject JAX's
    masks so), else drawn as ``uniform < keep`` from :attr:`generator`
    (torch's default generator when None). A caller sets the two
    attributes for one forward
    (:meth:`rald_torch.models.vecset_vae.VecSetVAE.forward` does) and
    clears them after."""

    def __init__(self, rate: float = 0.0):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None
        self.mask: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.rate == 0.0 or not self.training:
            return x
        keep = 1.0 - self.rate
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = self.mask
        if mask is None:
            mask = torch.rand(shape, generator=self.generator, device=x.device) < keep
        mask = mask.to(x.device, torch.bool).reshape(shape)
        # a device tensor, not a Python scalar: torch turns division by a
        # host scalar into a product with its reciprocal
        divisor = torch.tensor(keep, dtype=x.dtype, device=x.device)
        return torch.where(mask, x / divisor, torch.zeros_like(x))


class Attention(nn.Module):
    """Multi-head softmax attention with optional cross-attention context.

    ``fused_kv=True`` is the VAE layout (``to_kv``, ``to_out``);
    ``fused_kv=False`` the DiT layout (``to_k``/``to_v``, ``to_out.0``).
    Plain matmul -> f32 softmax -> matmul, as the JAX module leaves it to XLA,
    then :class:`DropPath` of ``drop_path_rate`` after ``to_out``.
    """

    def __init__(
        self,
        query_dim: int,
        context_dim: Optional[int] = None,
        heads: int = 8,
        dim_head: int = 64,
        out_dim: Optional[int] = None,
        fused_kv: bool = True,
        drop_path_rate: float = 0.0,
    ):
        super().__init__()
        inner = heads * dim_head
        context_dim = context_dim or query_dim
        self.heads, self.dim_head, self.fused_kv = heads, dim_head, fused_kv
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        if fused_kv:
            self.to_kv = nn.Linear(context_dim, 2 * inner, bias=False)
        else:
            self.to_k = nn.Linear(context_dim, inner, bias=False)
            self.to_v = nn.Linear(context_dim, inner, bias=False)
        out = nn.Linear(inner, out_dim or query_dim)
        self.to_out = out if fused_kv else nn.Sequential(out, nn.Dropout(0.0))
        self.drop_path = DropPath(drop_path_rate)

    def forward(self, x: torch.Tensor, context: Optional[torch.Tensor] = None) -> torch.Tensor:
        dt = self.to_q.weight.dtype
        x = x.to(dt)
        ctx = x if context is None else context.to(dt)
        q = self.to_q(x)
        if self.fused_kv:
            k, v = self.to_kv(ctx).chunk(2, dim=-1)
        else:
            k, v = self.to_k(ctx), self.to_v(ctx)

        def heads(t):
            return t.reshape(*t.shape[:-1], self.heads, self.dim_head).transpose(-3, -2)

        q, k, v = heads(q), heads(k), heads(v)
        sim = torch.matmul(q, k.transpose(-1, -2)) * (self.dim_head ** -0.5)
        attn = torch.softmax(sim.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v).transpose(-3, -2)
        out = out.reshape(*out.shape[:-2], self.heads * self.dim_head)
        return self.drop_path(self.to_out(out))


class _GEGLUProj(nn.Module):
    """The DiT FF's ``net.0`` (a GEGLU holding its projection as ``proj``)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, 2 * dim_out)


class GEGLUFeedForward(nn.Module):
    """Linear -> GEGLU (exact-erf GELU) -> Linear.

    ``dit_style`` picks the key layout: ``net.0.proj`` / ``net.2`` (DiT) or
    ``net.0`` / ``net.2`` (VAE). ``proj_in`` weight rows ``[:inner]`` are
    the values, ``[inner:]`` the gates.

    ``use_fused`` (JAX ``use_fused``, :165-173) runs the whole FF through
    :func:`rald_torch.ops.geglu_kernel.geglu_ff`: the CUDA kernel on the
    card, its plain version on the CPU.

    ``forward(x, amax=list)`` appends ``(max|x|, max|gated product|)`` in f32,
    the two activations the int8 FF kernels quantize (JAX ``sow_amax``,
    ``rald_tpu/nn/layers.py:146-182``): the calibration of static int8
    activation scales reads them. It runs unfused, as ``sow_amax`` does.

    Either path ends in :class:`DropPath` of ``drop_path_rate``.
    """

    def __init__(self, dim: int, mult: int = 4, out_dim: Optional[int] = None,
                 dit_style: bool = False, use_fused: bool = False, drop_path_rate: float = 0.0):
        super().__init__()
        inner = dim * mult
        first = _GEGLUProj(dim, inner) if dit_style else nn.Linear(dim, 2 * inner)
        self.net = nn.Sequential(first, nn.Identity(), nn.Linear(inner, out_dim or dim))
        self.dit_style = dit_style
        self.use_fused = use_fused
        self.drop_path = DropPath(drop_path_rate)

    @property
    def proj_in(self) -> nn.Linear:
        return self.net[0].proj if self.dit_style else self.net[0]

    @property
    def proj_out(self) -> nn.Linear:
        return self.net[2]

    def forward(self, x: torch.Tensor, amax: Optional[list] = None) -> torch.Tensor:
        if self.use_fused and amax is None:
            pi, po = self.proj_in, self.proj_out
            return self.drop_path(geglu_ff(x.to(pi.weight.dtype), pi.weight, pi.bias,
                                           po.weight, po.bias))
        h, gates = self.proj_in(x).chunk(2, dim=-1)
        g = h * F.gelu(gates)
        if amax is not None:
            amax.append((x.float().abs().amax(), g.float().abs().amax()))
        return self.drop_path(self.proj_out(g))


class AdaLayerNorm(nn.Module):
    """LayerNorm (no affine) modulated by the noise embedding; ``mod`` and
    ``apply_mod`` are separate so the sampler can hoist the modulation."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def mod(self, t_emb: torch.Tensor):
        scale, shift = self.linear(t_emb).chunk(2, dim=-1)
        return scale, shift

    def apply_mod(self, x, scale, shift):
        return layer_norm(x, eps=1e-5) * (1 + scale) + shift

    def forward(self, x, t_emb):
        return self.apply_mod(x, *self.mod(t_emb))


class FourierTimeEmbedding(nn.Module):
    """EDM noise-level embedding ``concat([cos(t f), sin(t f)])``, cos first."""

    def __init__(self, num_channels: int = 256, max_positions: int = 10000, endpoint: bool = False):
        super().__init__()
        self.num_channels, self.max_positions, self.endpoint = num_channels, max_positions, endpoint

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        half = self.num_channels // 2
        freqs = torch.arange(half, dtype=torch.float32, device=t.device)
        freqs = freqs / (half - (1 if self.endpoint else 0))
        freqs = torch.pow(torch.tensor(1.0 / self.max_positions, dtype=torch.float32), freqs)
        ang = t.float()[..., None] * freqs
        return torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1)
