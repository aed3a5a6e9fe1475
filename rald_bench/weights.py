"""Seeded weights, made on the device in a few large draws, in the
reference's ``state_dict`` layout (the layout both sides load).

Linear and convolution kernels are N(0, 1/fan_in), embedding tables
N(0, 1), biases 0, normalisation scales 1: every weight is drawn, the DiT's
output projection included, so that every layer does work. Two changes
make random weights give real clouds (``bench`` block of the
configuration): the decoder's query projection is scaled
(``decoder_to_q_scale``) so that queries do not all attend alike, and the
occupancy bias is set so that a fifth of each probe frame's queries score
positive (:func:`centred_bias`)."""
from __future__ import annotations

import torch
from torch import nn

from rald_bench.reference.nets import EDMDenoiser, QConv3d, VecSetVAE, float32_matmuls, heun_sample


def reference_models(cfg: dict, sizes: dict, device="meta"):
    """The reference DiT (with its radar encoder) and VAE of ``cfg``."""
    mc = cfg["ar_model"]["configs"]
    with torch.device(device):
        dit = EDMDenoiser(
            channels=sizes["channels"], depth=sizes["depth"], n_latents=sizes["latents"],
            enc_hidden_ch=sizes["enc_ch"], enc_radar_ch=sizes["enc_z"],
            enc_dims=(int(mc["enc_radar_r_dim"]), int(mc["enc_radar_a_dim"]), int(mc["enc_radar_e_dim"])),
            token_channel=sizes["token_channel"], upsample_to=sizes["enc_res"][1:])
        vae = VecSetVAE(depth=sizes["vae_depth"], dim=sizes["vae_dim"],
                        num_latents=sizes["vae_latents"], latent_dim=sizes["channels"])
    return dit, vae


def _rules(model: nn.Module):
    """(name, shape, std or fill) of every parameter: std > 0 draws."""
    out = []
    for mname, m in model.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            name = f"{mname}.{pname}" if mname else pname
            if isinstance(m, (nn.Linear, QConv3d)) and pname == "weight":
                out.append((name, p.shape, p[0].numel() ** -0.5))
            elif isinstance(m, nn.Embedding):
                out.append((name, p.shape, 1.0))
            else:  # biases 0; LayerNorm / GroupNorm scales 1
                fill = 1.0 if isinstance(m, (nn.LayerNorm, nn.GroupNorm)) and pname == "weight" else 0.0
                out.append((name, p.shape, -fill))
    return out


@torch.no_grad()
def make_state_dict(model: nn.Module, seed: int, dtype, device) -> dict:
    """The seeded weights of ``model``'s layout in ``dtype`` on ``device``,
    from one draw on a generator on the device."""
    rules = _rules(model)
    total = sum(shape.numel() for _, shape, s in rules if s > 0)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for name, shape, s in rules:
        if s > 0:
            n = shape.numel()
            sd[name] = (flat[at:at + n].view(shape) * s).to(dtype)
            at += n
        else:
            sd[name] = torch.full(shape, -s, dtype=dtype, device=device)
    return sd


def load_f32(model: nn.Module, sd: dict, device) -> nn.Module:
    """``model`` (built on the meta device) holding ``sd`` in float32."""
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.float() for k, v in sd.items()})
    return model.eval()


@torch.no_grad()
def centred_bias(dit, vae, cubes, priors, ev: dict, probe_seed: int, quantile: float = 0.8,
                 n_probe: int = 65536) -> float:
    """The occupancy bias at which the fewest-positive probe frame still has
    ``1 - quantile`` of its probe queries positive: the reference samples
    each frame and decodes a seeded uniform probe. ``vae`` holds bias 0."""
    dev = ev["device"]
    gen = torch.Generator(dev).manual_seed(probe_seed)
    probe = torch.rand((1, n_probe, 3), generator=gen, device=dev) * 2 - 1
    with float32_matmuls():
        cond = dit.condition(torch.as_tensor(cubes, device=dev))
        lat = heun_sample(dit, cond, torch.as_tensor(priors, device=dev), **ev["sampler"])
        logits = vae.decode_queries(vae.decode_latents(lat), probe.expand(len(lat), -1, -1))
    return -float(torch.quantile(logits[:, ::16], quantile, dim=1).min())
