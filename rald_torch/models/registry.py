"""Name-keyed model factories (``rald_tpu/models/registry.py:18-104``).

Same variant names as the reference, so configs are interchangeable. The
inference flags are arguments, as in JAX (:54-97); ``overrides`` replaces
any constructor argument, as the YAML's ``ar_model.overrides`` /
``lidar_ae.overrides`` blocks do through JAX's ``model.copy(**overrides)``.

Beside RaLD's family, which the JAX package shares, the port builds
Hunyuan3D-2.0's shape generator (arXiv:2501.12202) at its published v2-0
widths: the flow DiT ``hunyuan3d_dit_v2_0`` (:mod:`rald_torch.models.mmdit`)
and the ShapeVAE decoder ``hunyuan3d_vae_v2_0``
(:mod:`rald_torch.models.shape_vae`). Neither has a fused, folded or int8
path: the kernel-flag arguments do not apply to them, and the generation
engine refuses the configuration keys that ask for one.
"""
from __future__ import annotations

from rald_torch.models.latent_dit import EDMPrecond
from rald_torch.models.mmdit import Hunyuan3DDiT
from rald_torch.models.radar_encoder3d import RadarAutoencoder
from rald_torch.models.shape_vae import ShapeVAE
from rald_torch.models.vecset_vae import VecSetVAE


def _ae_variants():
    out = {}
    for l in (512, 64, 32, 16, 8, 4, 2, 1):
        out[f"kl_d512_m512_l{l}"] = dict(dim=512, M=512, latent_dim=l, query_type="point")
    out["kl_d512_m512_l32_learn"] = dict(dim=512, M=512, latent_dim=32, query_type="learnable")
    out["kl_d512_m512_l32_mix"] = dict(dim=512, M=512, latent_dim=32, query_type="mix")
    for m in (512, 256, 128, 64):
        out[f"ae_d512_m{m}"] = dict(dim=512, M=m, deterministic=True)
    for d in (256, 128, 64):
        out[f"ae_d{d}_m512"] = dict(dim=d, M=512, deterministic=True)
    return out


AE_VARIANTS = _ae_variants()

GENERATION_VARIANTS = {
    "kl_d512_m512_l8_edm": dict(channels=8, depth=12),
    "kl_d512_m512_l16_edm": dict(channels=16, depth=12),
    "kl_d512_m512_l32_edm": dict(channels=32, depth=12),
    "kl_d512_m512_l4_d24_edm": dict(channels=4, depth=24),
    "kl_d512_m512_l8_d24_edm": dict(channels=8, depth=24),
    "kl_d512_m512_l32_d24_edm": dict(channels=32, depth=24),
    "kl_d512_m512_l32_d18_edm": dict(channels=32, depth=18),
    "kl_d512_m512_l32_d12_edm": dict(channels=32, depth=12),
}

# Hunyuan3D-2.0, hunyuan3d-dit-v2-0/config.yaml (n_latents: the ShapeVAE's num_latents)
FLOW_VARIANTS = {
    "hunyuan3d_dit_v2_0": dict(in_channels=64, context_in_dim=1536, hidden_size=1024,
                               mlp_ratio=4.0, num_heads=16, depth=16, depth_single_blocks=32,
                               qkv_bias=True, time_factor=1000.0, n_latents=3072),
}

# Hunyuan3D-2.0, hunyuan3d-vae-v2-0/config.yaml (the decoder half)
SHAPE_VAE_VARIANTS = {
    "hunyuan3d_vae_v2_0": dict(num_latents=3072, embed_dim=64, width=1024, heads=16,
                               num_decoder_layers=16, num_freqs=8, include_pi=False,
                               qkv_bias=False, scale_factor=0.9990943042622529),
}


# reference models_radar_encoder.py:423-446
RADAR_ENCODER_VARIANTS = {
    "ae_ch128_mult5_n2_d16": dict(basic_channel=128, embed_dim=16),
    "ae_ch64_mult5_n2_d16": dict(basic_channel=64, embed_dim=16),
    "ae_ch16_mult5_n2_d16": dict(basic_channel=16, embed_dim=16),
}


def get_ae_model(name: str, N: int = 2048, overrides=None, use_fused_ff: bool = False,
                 fold_decode_tail: bool = False):
    if name in SHAPE_VAE_VARIANTS:
        return ShapeVAE(**{**SHAPE_VAE_VARIANTS[name], **dict(overrides or {})})
    kw = dict(AE_VARIANTS[name])
    args = dict(
        depth=24, dim=kw["dim"], queries_dim=kw["dim"], output_dim=1, num_inputs=N,
        num_latents=kw["M"], latent_dim=kw.get("latent_dim", 64), heads=8, dim_head=64,
        query_type=kw.get("query_type", "point"),
        deterministic_latent=kw.get("deterministic", False),
        use_fused_ff=use_fused_ff, fold_decode_tail=fold_decode_tail,
    )
    args.update(dict(overrides or {}))
    return VecSetVAE(**args)


def generation_model_class(name: str) -> type:
    """The class :func:`get_generation_model` builds for ``name``."""
    return Hunyuan3DDiT if name in FLOW_VARIANTS else EDMPrecond


def get_generation_model(name: str, configs, overrides=None, use_fused_ff: bool = False,
                         use_fused_attn: bool = False):
    """Build an EDM model from an ``ar_model.configs`` block, or a flow DiT."""
    if name in FLOW_VARIANTS:
        return Hunyuan3DDiT(**{**FLOW_VARIANTS[name], **dict(overrides or {})})
    kw = GENERATION_VARIANTS[name]
    args = dict(
        n_latents=512,
        channels=kw["channels"],
        depth=kw["depth"],
        cond_type=configs.get("cond_type", "radar"),
        use_radar_enc=configs.get("use_radar_enc", True),
        unfreeze_radar_enc=configs.get("unfreeze_radar_enc", False),
        radar_token_channel=configs.get("radar_token_channel", 512),
        input_radar_dims=(
            configs.get("input_radar_r_dim", 128),
            configs.get("input_radar_a_dim", 8),
            configs.get("input_radar_e_dim", 2),
        ),
        enc_radar_dims=(
            configs.get("enc_radar_r_dim", 8),
            configs.get("enc_radar_a_dim", 4),
            configs.get("enc_radar_e_dim", 2),
        ),
        enc_radar_ch=configs.get("enc_radar_ch", 16),
        enc_hidden_ch=configs.get("enc_hidden_ch", 64),
        use_fused_ff=use_fused_ff,
        use_fused_attn=use_fused_attn,
    )
    args.update(dict(overrides or {}))
    return EDMPrecond(**args)


def get_radar_encoder_model(name: str, in_channels: int = 2, overrides=None,
                            decoder: bool = True) -> RadarAutoencoder:
    """The radar autoencoder of ``radar_enc.name`` (JAX :100-104);
    ``overrides`` as JAX's ``radar_enc.copy(**overrides)``; ``decoder=False``
    builds the encoder alone (the frozen conditioning encoder)."""
    args = dict(RADAR_ENCODER_VARIANTS[name], in_channels=in_channels, decoder=decoder)
    args.update(dict(overrides or {}))
    return RadarAutoencoder(**args)
