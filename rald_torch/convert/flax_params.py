"""Weights bridge: ``rald_tpu`` flax parameter trees -> the port's state_dicts.

Each function is the exact inverse of its converter in
``rald_tpu/convert/torch_ckpt.py``: :func:`edm_state_dict_from_flax` of
``convert_edm_state_dict`` (:222), :func:`vae_state_dict_from_flax` of
``convert_vae_state_dict`` (:99), :func:`radar_encoder_state_dict_from_flax`
of ``convert_radar_encoder_state_dict`` (:165), :func:`radar_decoder_state_dict_from_flax`
of ``convert_radar_decoder_state_dict`` (:189) and
:func:`radar_autoencoder_state_dict_from_flax` of
``convert_radar_autoencoder_state_dict`` (:211). Layout transforms:

- Dense kernel (in, out)          -> Linear weight (out, in)
- Conv kernel (D, H, W, in, out)  -> Conv3d weight (out, in, D, H, W)
- LayerNorm / GroupNorm ``scale`` -> ``weight``
- the DiT's ``to_out``            -> ``to_out.0``
- the DiT's FF ``proj_in``        -> ``net.0.proj`` (the VAE's: ``net.0``)

Inputs are nested dicts of numpy arrays (``jax.device_get`` of a param
tree works); outputs are dicts of CPU tensors.

:func:`train_state_from_flax` carries a JAX ``TrainState`` (params, EMA,
the optax state, step) into the port's :class:`~rald_torch.train.state.TrainState`:
every per-parameter tree (params, EMA, Adam's ``mu`` / ``nu``, the
``MultiSteps`` accumulator) through one tree converter,
:func:`edm_state_dict_from_flax` for the DiT's (``GenerationEngine``) by
default, or e.g. ``functools.partial(vae_state_dict_from_flax, depth=...,
query_type=...)`` for the VAE's (``AEEngine``).
"""
from __future__ import annotations

import functools
import re

import numpy as np
import torch


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))  # a contiguous, writable copy


def _linear(p, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _norm(p, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(p["scale"])
    out[f"{prefix}.bias"] = _t(p["bias"])


def _conv3d(p, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _t(np.transpose(np.asarray(p["kernel"]), (4, 3, 0, 1, 2)))
    if "bias" in p:
        out[f"{prefix}.bias"] = _t(p["bias"])


def _attention(p, prefix: str, out: dict, dit: bool) -> None:
    for name in ("to_q", "to_kv", "to_k", "to_v"):
        if name in p:
            _linear(p[name], f"{prefix}.{name}", out)
    _linear(p["to_out"], f"{prefix}.to_out.0" if dit else f"{prefix}.to_out", out)


def _geglu_ff(p, prefix: str, out: dict, dit: bool) -> None:
    _linear(p["proj_in"], f"{prefix}.net.0.proj" if dit else f"{prefix}.net.0", out)
    _linear(p["proj_out"], f"{prefix}.net.2", out)


def _resnet_block(p, prefix: str, out: dict) -> None:
    for name in ("norm1", "norm2"):
        _norm(p[name], f"{prefix}.{name}", out)
    for name in ("conv1", "conv2", "nin_shortcut"):
        if name in p:
            _conv3d(p[name], f"{prefix}.{name}", out)


def _attn_block3d(p, prefix: str, out: dict) -> None:
    _norm(p["norm"], f"{prefix}.norm", out)
    for name in ("q", "k", "v", "proj_out"):
        _conv3d(p[name], f"{prefix}.{name}", out)


def radar_encoder_state_dict_from_flax(params, prefix: str = "") -> dict:
    """``RadarEncoder3D`` flax params -> reference encoder state_dict."""
    out: dict = {}
    for name, p in params.items():
        if name in ("conv_in", "conv_out"):
            _conv3d(p, prefix + name, out)
        elif name == "norm_out":
            _norm(p, prefix + name, out)
        elif name in ("mid_block_1", "mid_block_2"):
            _resnet_block(p, f"{prefix}mid.{name[4:]}", out)
        elif name == "mid_attn_1":
            _attn_block3d(p, f"{prefix}mid.attn_1", out)
        elif m := re.fullmatch(r"down_(\d+)_block_(\d+)", name):
            _resnet_block(p, f"{prefix}down.{m[1]}.block.{m[2]}", out)
        elif m := re.fullmatch(r"down_(\d+)_attn_(\d+)", name):
            _attn_block3d(p, f"{prefix}down.{m[1]}.attn.{m[2]}", out)
        elif m := re.fullmatch(r"down_(\d+)_downsample", name):
            _conv3d(p["conv"], f"{prefix}down.{m[1]}.downsample.conv", out)
        else:
            raise KeyError(f"unexpected radar encoder param {name!r}")
    return out


def radar_decoder_state_dict_from_flax(params, prefix: str = "") -> dict:
    """``RadarDecoder3D`` flax params -> reference decoder state_dict."""
    out: dict = {}
    for name, p in params.items():
        if name in ("conv_in", "conv_out"):
            _conv3d(p, prefix + name, out)
        elif name == "norm_out":
            _norm(p, prefix + name, out)
        elif name in ("mid_block_1", "mid_block_2"):
            _resnet_block(p, f"{prefix}mid.{name[4:]}", out)
        elif name == "mid_attn_1":
            _attn_block3d(p, f"{prefix}mid.attn_1", out)
        elif m := re.fullmatch(r"up_(\d+)_block_(\d+)", name):
            _resnet_block(p, f"{prefix}up.{m[1]}.block.{m[2]}", out)
        elif m := re.fullmatch(r"up_(\d+)_upsample", name):
            _conv3d(p["conv"], f"{prefix}up.{m[1]}.upsample.conv", out)
        else:
            raise KeyError(f"unexpected radar decoder param {name!r}")
    return out


def radar_autoencoder_state_dict_from_flax(params) -> dict:
    """``RadarAutoencoder`` flax params (``encoder`` and, where present,
    ``decoder``) -> reference ``RadarAutoencoder`` state_dict."""
    out = radar_encoder_state_dict_from_flax(params["encoder"], prefix="encoder.")
    if "decoder" in params:
        out.update(radar_decoder_state_dict_from_flax(params["decoder"], prefix="decoder."))
    return out


def edm_state_dict_from_flax(params, depth: int = 24) -> dict:
    """``EDMPrecond`` flax params -> reference ``EDMPrecond`` state_dict."""
    m = params["model"]
    out: dict = {}
    for name in ("proj_in", "proj_out", "map_layer0", "map_layer1"):
        _linear(m[name], f"model.{name}", out)
    _norm(m["norm"], "model.norm", out)
    for i in range(depth):
        p, b = m[f"block_{i}"], f"model.transformer_blocks.{i}"
        for k in (1, 2, 3):
            _linear(p[f"norm{k}"]["mod"], f"{b}.norm{k}.linear", out)
        _attention(p["attn1"], f"{b}.attn1", out, dit=True)
        _attention(p["attn2"], f"{b}.attn2", out, dit=True)
        _geglu_ff(p["ff"], f"{b}.ff", out, dit=True)
    if "radar_token_project" in params:
        _linear(params["radar_token_project"], "radar_token_project", out)
        for ax in ("r", "a", "e"):
            out[f"radar_{ax}_emb.weight"] = _t(params[f"radar_{ax}_emb"])
    if "radar_enc" in params:
        out.update(radar_encoder_state_dict_from_flax(params["radar_enc"], prefix="radar_enc."))
    return out


def vae_state_dict_from_flax(params, depth: int = 24, query_type: str = "mix") -> dict:
    """``VecSetVAE`` flax params -> reference ``KLAutoEncoder`` state_dict."""
    out: dict = {}
    _linear(params["point_embed"]["mlp"], "point_embed.mlp", out)
    _norm(params["enc_norm_q"], "cross_attend_blocks.0.norm", out)
    _norm(params["enc_norm_ctx"], "cross_attend_blocks.0.norm_context", out)
    _attention(params["enc_cross_attn"], "cross_attend_blocks.0.fn", out, dit=False)
    _norm(params["enc_ff_norm"], "cross_attend_blocks.1.norm", out)
    _geglu_ff(params["enc_ff"], "cross_attend_blocks.1.fn", out, dit=False)
    if query_type == "learnable":
        out["latents.weight"] = _t(params["latent_query"])
    elif query_type == "mix":
        out["s_latents.weight"] = _t(params["s_latents"])
        out["d_latents.weight"] = _t(params["d_latents"])
        _norm(params["mix_norm"], "mix_attn_layer.norm", out)
        _attention(params["mix_attn"], "mix_attn_layer.fn", out, dit=False)
        _linear(params["query_proj"], "query_proj", out)
    for i in range(depth):
        p, b = params[f"block_{i}"], f"layers.{i}"
        _norm(p["attn_norm"], f"{b}.0.norm", out)
        _attention(p["attn"], f"{b}.0.fn", out, dit=False)
        _norm(p["ff_norm"], f"{b}.1.norm", out)
        _geglu_ff(p["ff"], f"{b}.1.fn", out, dit=False)
    _norm(params["dec_norm_q"], "decoder_cross_attn.norm", out)
    _norm(params["dec_norm_ctx"], "decoder_cross_attn.norm_context", out)
    _attention(params["dec_cross_attn"], "decoder_cross_attn.fn", out, dit=False)
    _linear(params["to_outputs"], "to_outputs", out)
    for name in ("proj", "mean_fc", "logvar_fc"):
        if name in params:
            _linear(params[name], name, out)
    return out


_OPTAX_TREES = ("mu", "nu", "acc_grads")
_OPTAX_COUNTERS = ("mini_step", "notfinite_count", "total_notfinite")


def _optax_fields(opt_state, out: dict) -> dict:
    """Walk an optax state (nested NamedTuples: ``MultiStepsState``,
    ``ApplyIfFiniteState``, chain tuples, ``ScaleByAdamState``) and collect
    Adam's ``count`` / ``mu`` / ``nu`` and the wrappers' counters by field
    name."""
    fields = getattr(opt_state, "_fields", None)
    if fields is not None:
        for name in fields:
            v = getattr(opt_state, name)
            if name in _OPTAX_TREES or name in _OPTAX_COUNTERS:
                out.setdefault(name, v)
            elif name == "count" and "mu" in fields:
                out["count"] = v
            else:
                _optax_fields(v, out)
    elif isinstance(opt_state, (tuple, list)):
        for v in opt_state:
            _optax_fields(v, out)
    return out


def train_state_from_flax(state, params, ema_params, opt_state, step, depth: int = 24,
                          convert=None):
    """Load a JAX ``TrainState`` (its ``params``, ``ema_params``,
    ``opt_state`` and ``step`` as numpy trees, e.g. from ``jax.device_get``)
    into the port's ``state`` in place; returns it. ``convert`` maps each
    per-parameter tree to a state_dict: an ``EDMPrecond``'s
    (:func:`edm_state_dict_from_flax` at ``depth``) when None. Adam's
    ``count`` (the updates applied) becomes the schedule's count."""
    if convert is None:
        convert = functools.partial(edm_state_dict_from_flax, depth=depth)
    f = _optax_fields(opt_state, {})
    opt = {"count": int(np.asarray(f["count"])), "mu": convert(f["mu"]), "nu": convert(f["nu"])}
    for name in _OPTAX_COUNTERS:
        if name in f:
            opt[name] = np.asarray(f[name]).item()
    if "acc_grads" in f:
        opt["acc_grads"] = convert(f["acc_grads"])
    return state.load(convert(params), convert(ema_params), opt, int(np.asarray(step)))
