"""Plain PyTorch reference of the RaLD models, in float32.

Written from the published architecture (arXiv:2511.07067: a 3D-CNN radar
encoder, a latent DiT under EDM preconditioning, a VecSet point-cloud VAE)
in the reference repository's ``state_dict`` layout, so that one seeded
weight set loads into it and into the system under test alike. It imports
nothing of the system under test: no kernel, no fused or folded path, no
int8, no cache. Every matmul runs in float32 with TF32 off (see
:func:`float32_matmuls`).

``fp8`` on :class:`QLinear` / :class:`QConv3d` rounds the input and the
weight of each product to float8 e4m3 with a per-tensor scale before the
float32 product (straight-through in the backward pass): the precision
control of the training cell, the nearest precision below the bfloat16 the
configuration states.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F
from torch import nn

E4M3_MAX = 448.0


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under a per-tensor scale, in float32;
    the gradient passes straight through."""
    scale = t.detach().abs().amax().clamp_min(1e-12) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


class QLinear(nn.Linear):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return F.linear(x, self.weight, self.bias)
        return F.linear(fake_fp8(x), fake_fp8(self.weight), self.bias)


class QConv3d(nn.Conv3d):
    fp8 = False

    def forward(self, x):
        if not self.fp8:
            return super().forward(x)
        return self._conv_forward(fake_fp8(x), fake_fp8(self.weight), self.bias)


def set_fp8(module: nn.Module, on: bool) -> None:
    for m in module.modules():
        if isinstance(m, (QLinear, QConv3d)):
            m.fp8 = on


@contextlib.contextmanager
def float32_matmuls():
    """True float32 products (no TF32 in cuBLAS or cuDNN) inside the block;
    the settings in force before are restored after it."""
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


def layer_norm(x, weight=None, bias=None, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), weight, bias, eps)


# ------------------------------------------------------------------ layers
class Attention(nn.Module):
    """Softmax attention; ``fused_kv`` is the VAE layout (``to_kv``,
    ``to_out``), otherwise the DiT layout (``to_k``, ``to_v``, ``to_out.0``)."""

    def __init__(self, dim, context_dim=None, heads=8, dim_head=64, out_dim=None, fused_kv=True):
        super().__init__()
        inner, context_dim = heads * dim_head, context_dim or dim
        self.heads, self.dim_head, self.fused_kv = heads, dim_head, fused_kv
        self.to_q = QLinear(dim, inner, bias=False)
        if fused_kv:
            self.to_kv = QLinear(context_dim, 2 * inner, bias=False)
            self.to_out = QLinear(inner, out_dim or dim)
        else:
            self.to_k = QLinear(context_dim, inner, bias=False)
            self.to_v = QLinear(context_dim, inner, bias=False)
            self.to_out = nn.Sequential(QLinear(inner, out_dim or dim))

    def forward(self, x, context=None):
        ctx = x if context is None else context
        q = self.to_q(x)
        k, v = self.to_kv(ctx).chunk(2, -1) if self.fused_kv else (self.to_k(ctx), self.to_v(ctx))

        def split(t):
            return t.reshape(*t.shape[:-1], self.heads, self.dim_head).transpose(-3, -2)

        q, k, v = split(q), split(k), split(v)
        attn = torch.softmax(q @ k.transpose(-1, -2) * self.dim_head ** -0.5, dim=-1)
        out = (attn @ v).transpose(-3, -2)
        return self.to_out(out.reshape(*out.shape[:-2], self.heads * self.dim_head))


class GEGLU(nn.Module):
    """Linear -> value * GELU(gate) (exact erf) -> Linear; ``dit_style``:
    keys ``net.0.proj`` / ``net.2``, else ``net.0`` / ``net.2``."""

    def __init__(self, dim, mult=4, dit_style=False):
        super().__init__()
        inner = dim * mult

        class _Proj(nn.Module):
            def __init__(self):
                super().__init__()
                self.proj = QLinear(dim, 2 * inner)

            def forward(self, x):
                return self.proj(x)

        self.net = nn.Sequential(_Proj() if dit_style else QLinear(dim, 2 * inner), nn.Identity(),
                                 QLinear(inner, dim))

    def forward(self, x):
        h, gate = self.net[0](x).chunk(2, -1)
        return self.net[2](h * F.gelu(gate))


class AdaLN(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.linear = QLinear(dim, 2 * dim)

    def forward(self, x, t_emb):
        scale, shift = self.linear(t_emb).chunk(2, -1)
        return layer_norm(x) * (1 + scale) + shift


class PreNorm(nn.Module):
    def __init__(self, dim, fn, context_dim=None):
        super().__init__()
        self.fn, self.norm = fn, nn.LayerNorm(dim)
        if context_dim is not None:
            self.norm_context = nn.LayerNorm(context_dim)


# ------------------------------------------------------------ radar encoder
def _gn(ch):
    return nn.GroupNorm(math.gcd(32, ch), ch, eps=1e-6)


class ResBlock(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.norm1, self.conv1 = _gn(cin), QConv3d(cin, cout, 3, padding=1)
        self.norm2, self.conv2 = _gn(cout), QConv3d(cout, cout, 3, padding=1)
        if cin != cout:
            self.nin_shortcut = QConv3d(cin, cout, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        return (self.nin_shortcut(x) if hasattr(self, "nin_shortcut") else x) + h


class AttnBlock(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.norm = _gn(ch)
        self.q, self.k, self.v, self.proj_out = (QConv3d(ch, ch, 1) for _ in range(4))

    def forward(self, x):
        b, c = x.shape[:2]
        h = self.norm(x)
        q = self.q(h).reshape(b, c, -1).transpose(1, 2)
        k = self.k(h).reshape(b, c, -1)
        v = self.v(h).reshape(b, c, -1).transpose(1, 2)
        attn = torch.softmax(q @ k * c ** -0.5, dim=-1)
        return x + self.proj_out((attn @ v).transpose(1, 2).reshape(x.shape))


class Downsample(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.conv = QConv3d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1, 0, 1)))


class RadarEncoder(nn.Module):
    """(B, R, A, E, 1) -> (B, R/16, A/16, E/16, z): VQGAN-style 3D-CNN, five
    levels (channel multipliers 1, 1, 2, 2, 4), two ResNet blocks a level,
    attention where the configured resolution halves to (8, 4, 2)."""

    def __init__(self, ch=64, z_channels=16, ch_mult=(1, 1, 2, 2, 4), num_res_blocks=2,
                 resolution=(128, 64, 32), attn_resolutions=((8, 4, 2),)):
        super().__init__()
        self.conv_in = QConv3d(1, ch, 3, padding=1)
        self.down = nn.ModuleList()
        res, cin = tuple(resolution), ch
        for i, mult in enumerate(ch_mult):
            level = nn.Module()
            level.block, level.attn = nn.ModuleList(), nn.ModuleList()
            for _ in range(num_res_blocks):
                level.block.append(ResBlock(cin, ch * mult))
                cin = ch * mult
                if res in attn_resolutions:
                    level.attn.append(AttnBlock(cin))
            if i != len(ch_mult) - 1:
                level.downsample = Downsample(cin)
                res = tuple(int(r / 2) for r in res)
            self.down.append(level)
        self.mid = nn.Module()
        self.mid.block_1, self.mid.attn_1, self.mid.block_2 = ResBlock(cin, cin), AttnBlock(cin), ResBlock(cin, cin)
        self.norm_out, self.conv_out = _gn(cin), QConv3d(cin, z_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x.permute(0, 4, 1, 2, 3))
        for level in self.down:
            for i, block in enumerate(level.block):
                h = block(h)
                if len(level.attn):
                    h = level.attn[i](h)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.attn_1(self.mid.block_1(h)))
        return self.conv_out(F.silu(self.norm_out(h))).permute(0, 2, 3, 4, 1)


def resize_align_corners(x, out_sizes, axes):
    """Linear resize with align_corners semantics, one axis at a time."""
    for axis, n_out in zip(axes, out_sizes):
        n_in = x.shape[axis]
        if n_in == n_out:
            continue
        pos = (torch.zeros(n_out, device=x.device) if n_out == 1 or n_in == 1
               else torch.linspace(0.0, n_in - 1.0, n_out, device=x.device))
        lo = pos.floor().long().clamp(0, n_in - 1)
        hi = (lo + 1).clamp(0, n_in - 1)
        shape = [1] * x.dim()
        shape[axis] = -1
        x_lo, x_hi = x.index_select(axis, lo), x.index_select(axis, hi)
        x = x_lo + (pos - lo.float()).reshape(shape) * (x_hi - x_lo)
    return x


# --------------------------------------------------------------------- DiT
class DiTBlock(nn.Module):
    def __init__(self, dim, heads, dim_head, context_dim):
        super().__init__()
        self.norm1, self.attn1 = AdaLN(dim), Attention(dim, None, heads, dim_head, fused_kv=False)
        self.norm2 = AdaLN(dim)
        self.attn2 = Attention(dim, context_dim, heads, dim_head, fused_kv=False)
        self.norm3, self.ff = AdaLN(dim), GEGLU(dim, dit_style=True)

    def forward(self, x, t_emb, cond):
        x = x + self.attn1(self.norm1(x, t_emb))
        x = x + self.attn2(self.norm2(x, t_emb), cond)
        return x + self.ff(self.norm3(x, t_emb))


class LatentTransformer(nn.Module):
    def __init__(self, channels, depth, heads=8, dim_head=64, context_dim=512, t_channels=256):
        super().__init__()
        inner = heads * dim_head
        self.t_channels = t_channels
        self.map_layer0, self.map_layer1 = QLinear(t_channels, inner), QLinear(inner, inner)
        self.proj_in = QLinear(channels, inner, bias=False)
        self.transformer_blocks = nn.ModuleList(
            [DiTBlock(inner, heads, dim_head, context_dim) for _ in range(depth)])
        self.norm = nn.LayerNorm(inner)
        self.proj_out = QLinear(inner, channels, bias=False)

    def forward(self, x, t, cond):
        half = self.t_channels // 2
        freqs = (1.0 / 10000) ** (torch.arange(half, device=x.device, dtype=torch.float32) / half)
        ang = t[..., None] * freqs
        t_emb = torch.cat([torch.cos(ang), torch.sin(ang)], -1)[:, None, :]
        t_emb = F.silu(self.map_layer1(F.silu(self.map_layer0(t_emb))))
        x = self.proj_in(x)
        for block in self.transformer_blocks:
            x = block(x, t_emb, cond)
        return self.proj_out(self.norm(x))


class EDMDenoiser(nn.Module):
    """EDM-preconditioned D(x; sigma) of the latent DiT, conditioned on the
    tokens of a jointly trained radar encoder (sigma_data 1)."""

    def __init__(self, channels=32, depth=24, n_latents=512, enc_hidden_ch=64, enc_radar_ch=16,
                 enc_dims=(8, 4, 2), token_channel=512, upsample_to=(64, 32)):
        super().__init__()
        self.n_latents, self.channels, self.upsample_to = n_latents, channels, tuple(upsample_to)
        self.model = LatentTransformer(channels, depth, context_dim=token_channel)
        self.radar_enc = RadarEncoder(enc_hidden_ch, enc_radar_ch)
        self.radar_r_emb = nn.Embedding(enc_dims[0], token_channel)
        self.radar_a_emb = nn.Embedding(enc_dims[1], token_channel)
        self.radar_e_emb = nn.Embedding(enc_dims[2], token_channel)
        self.radar_token_project = QLinear(enc_radar_ch, token_channel)

    def condition(self, cube):
        """Raw (B, R, A, E, C) cube -> (B, R'A'E', C') condition tokens: the
        intensity channel, upsampled on A and E, through the encoder."""
        x = resize_align_corners(cube.float(), self.upsample_to, (2, 3))
        t = self.radar_token_project(self.radar_enc(x[..., :1]))
        t = (t + self.radar_r_emb.weight[None, :, None, None] + self.radar_a_emb.weight[None, None, :, None]
             + self.radar_e_emb.weight[None, None, None])
        return t.reshape(t.shape[0], -1, t.shape[-1])

    def denoise(self, x, sigma, cond):
        sigma = torch.as_tensor(sigma, dtype=torch.float32, device=x.device).reshape(-1, 1, 1)
        sigma = sigma.expand(x.shape[0], 1, 1)
        c_skip, c_out, c_in = 1 / (sigma ** 2 + 1), sigma * torch.rsqrt(sigma ** 2 + 1), torch.rsqrt(sigma ** 2 + 1)
        return c_skip * x + c_out * self.model(c_in * x, (torch.log(sigma) / 4).reshape(-1), cond)


def karras_sigmas(num_steps=18, sigma_min=0.002, sigma_max=80.0, rho=7.0, device=None):
    idx = torch.arange(num_steps, dtype=torch.float32, device=device)
    t = (sigma_max ** (1 / rho) + idx / (num_steps - 1) * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return torch.cat([t, torch.zeros(1, device=device)])


def heun_sample(net: EDMDenoiser, cond, prior, num_steps=18, sigma_min=0.002, sigma_max=80.0, rho=7.0):
    """Deterministic EDM Heun sampler (2 * num_steps - 1 evaluations)."""
    t = karras_sigmas(num_steps, sigma_min, sigma_max, rho, prior.device)
    x = prior.float() * t[0]
    for i in range(num_steps - 1):
        d = (x - net.denoise(x, t[i], cond)) / t[i]
        x_next = x + (t[i + 1] - t[i]) * d
        d2 = (x_next - net.denoise(x_next, t[i + 1], cond)) / t[i + 1]
        x = x + (t[i + 1] - t[i]) * (0.5 * d + 0.5 * d2)
    return x + (t[-1] - t[-2]) * (x - net.denoise(x, t[-2], cond)) / t[-2]


def edm_loss(net: EDMDenoiser, y, cube, rnd, noise, p_mean=-1.2, p_std=1.2):
    sigma = torch.exp(rnd * p_std + p_mean)
    weight = (sigma ** 2 + 1) / sigma ** 2
    d = net.denoise(y + noise * sigma, sigma, net.condition(cube))
    return torch.mean(weight * (d - y) ** 2)


# --------------------------------------------------------------------- VAE
class PointEmbed(nn.Module):
    def __init__(self, hidden_dim=48, dim=512):
        super().__init__()
        self.hidden_dim, self.mlp = hidden_dim, QLinear(hidden_dim + 3, dim)

    def forward(self, p):
        k = self.hidden_dim // 6
        freqs = (2.0 ** torch.arange(k, dtype=torch.float64) * math.pi).float().to(p.device)
        proj = torch.cat([p[..., a:a + 1] * freqs for a in range(3)], -1)
        return self.mlp(torch.cat([torch.sin(proj), torch.cos(proj), p], -1))


class VecSetVAE(nn.Module):
    """KL VecSet autoencoder with ``mix`` latent queries (static table plus a
    dynamic table that attends to the cloud)."""

    def __init__(self, depth=24, dim=512, num_latents=512, latent_dim=32, heads=8, dim_head=64,
                 query_chunk=65536):
        super().__init__()
        self.query_chunk = query_chunk
        self.point_embed = PointEmbed(dim=dim)
        self.cross_attend_blocks = nn.ModuleList([
            PreNorm(dim, Attention(dim, dim, 1, dim), context_dim=dim), PreNorm(dim, GEGLU(dim))])
        self.s_latents, self.d_latents = nn.Embedding(num_latents, dim), nn.Embedding(num_latents, dim)
        self.mix_attn_layer = PreNorm(dim, Attention(dim, dim, heads, dim_head))
        self.query_proj = QLinear(dim, dim)
        self.layers = nn.ModuleList([nn.ModuleList([PreNorm(dim, Attention(dim, None, heads, dim_head)),
                                                    PreNorm(dim, GEGLU(dim))]) for _ in range(depth)])
        self.decoder_cross_attn = PreNorm(dim, Attention(dim, dim, 1, dim, out_dim=dim), context_dim=dim)
        self.to_outputs = QLinear(dim, 1)
        self.proj = QLinear(latent_dim, dim)
        self.mean_fc, self.logvar_fc = QLinear(dim, latent_dim), QLinear(dim, latent_dim)

    def encode(self, pc, eps):
        emb = self.point_embed(pc)
        b = pc.shape[0]
        mix = self.mix_attn_layer
        dyn = mix.fn(mix.norm(self.d_latents.weight.expand(b, -1, -1)), emb)
        x = self.query_proj(self.s_latents.weight.expand(b, -1, -1) + dyn)
        cross, ff = self.cross_attend_blocks
        x = x + cross.fn(cross.norm(x), cross.norm_context(emb))
        x = x + ff.fn(ff.norm(x))
        mean, logvar = self.mean_fc(x), self.logvar_fc(x).clamp(-30.0, 20.0)
        return mean + torch.exp(0.5 * logvar) * eps

    def decode_latents(self, z):
        x = self.proj(z)
        for attn, ff in self.layers:
            x = x + attn.fn(attn.norm(x))
            x = x + ff.fn(ff.norm(x))
        return x

    def decode_queries(self, h, queries):
        """(B, Q) occupancy logits, in blocks of ``query_chunk`` queries."""
        dca = self.decoder_cross_attn
        ctx = dca.norm_context(h)
        out = [self.to_outputs(dca.fn(dca.norm(self.point_embed(queries[:, s:s + self.query_chunk])), ctx))
               for s in range(0, queries.shape[1], self.query_chunk)]
        return torch.cat(out, 1)[..., 0]
