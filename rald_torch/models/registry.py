"""Name-keyed model factories (``rald_tpu/models/registry.py:18-97``).

Same variant names as the reference, so configs are interchangeable.
``overrides`` replaces constructor arguments, as the YAML's
``ar_model.overrides`` / ``lidar_ae.overrides`` blocks do in JAX.
"""
from __future__ import annotations

from rald_torch.models.latent_dit import EDMPrecond
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


def get_ae_model(name: str, N: int = 2048, overrides=None) -> VecSetVAE:
    kw = dict(AE_VARIANTS[name])
    args = dict(
        depth=24, dim=kw["dim"], queries_dim=kw["dim"], output_dim=1, num_inputs=N,
        num_latents=kw["M"], latent_dim=kw.get("latent_dim", 64), heads=8, dim_head=64,
        query_type=kw.get("query_type", "point"),
        deterministic_latent=kw.get("deterministic", False),
    )
    args.update(dict(overrides or {}))
    return VecSetVAE(**args)


def get_generation_model(name: str, configs, overrides=None) -> EDMPrecond:
    """Build an EDM model from an ``ar_model.configs`` block."""
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
    )
    args.update(dict(overrides or {}))
    return EDMPrecond(**args)
