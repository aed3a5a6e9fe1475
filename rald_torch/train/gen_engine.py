"""Generation engine: stage-2 training and the product inference chain on
the card.

Counterpart of ``rald_tpu/train/gen_engine.py``. Training:
:meth:`GenerationEngine.init_state` (:258-277), :meth:`train_step`
(``_train_step_impl`` :372-387), :meth:`train_one_epoch` (:771-809),
:meth:`prepare_inputs` (:811-824), :meth:`vae_encode` (:360-364) and
:meth:`cache_latents` (:1135-1154): frozen-VAE latents (or cached ones) ->
EDM loss on the DiT with its in-graph radar encoder (or on a frozen
encoder's features) -> clip + AdamW + EMA (:class:`TrainState`). Eval:
:meth:`GenerationEngine.sample_tokens` (``_sample_impl`` :389-471),
:meth:`GenerationEngine.decode_queries` (``_decode_impl`` :473-475),
:meth:`GenerationEngine.fused_eval_step` (``_fused_eval_step_impl``
:535-635): radar cube -> on-device upsample -> 3D-CNN condition tokens ->
AdaLN mod table -> 35-NFE Heun sampling -> VAE decode of the grid + CFAR
helper queries -> threshold -> densify + refine decode -> polar->cartesian
-> Chamfer / F-score; and :meth:`GenerationEngine.evaluate` (:826-1133),
the dataset eval loop over a loader, which takes the fused step or, for
the PLY / latent dumps and the other eval modes, the modular path
(sample + decode on the card, grid, helper densify, threshold and refine
on the host). Quantized inference (``eval.inference.int8_ff`` /
``int8_attn``, :93-124) runs the DiT through the int8 kernels, with
:meth:`GenerationEngine.calibrate_act_scales` (:669-768) for the static
activation scales. The frozen external radar encoder
(``use_radar_enc: true``, ``unfreeze_radar_enc: false``, :143-150) encodes
the intensity channel before conditioning (:meth:`encode_radar`).

The engine reads the same YAML as ``rald_tpu`` (``system.compute_dtype``,
``system.fast_inference``, ``ar_model`` / ``lidar_ae`` with their
``overrides``, ``eval.inference``, ``eval.cast_params_bf16``, ``train``)
and keeps two DiTs, as JAX keeps ``model`` and ``model_eval`` (:83-128).
``model`` / ``vae`` are the eval models, built as JAX builds ``model_eval``
/ ``vae_eval`` with the card in the TPU's role: with ``fast_inference``
(the default) the DiT gets the fused FF and the int8 flags, the VAE the
fused FF and the folded decode tail; without it both run as the YAML
builds them (plain modules, unfolded decode, no int8 unless ``overrides``
ask). The DiT keeps the ``use_fused_attn`` of its overrides either way.
They are cast whole to the compute dtype, start from seeded random weights
(:func:`init_random_weights`), and :meth:`load_state_dicts` loads real
ones. ``train_model`` (built by :meth:`init_state`) is the DiT as the YAML
builds it, with plain modules: a kernel has no backward, and JAX's
training differentiates the unfused modules too (it fails on a fused flag,
and so does the port). Its f32 master weights, drawn as JAX's
``model.init`` draws them (:func:`init_train_weights`), live in the
:class:`TrainState`; forward and backward run on the model in the compute
dtype, which the state refreshes from the masters after every update (in
float32 the masters are the model's own parameters). :meth:`evaluate`
loads the state's params or EMA into the eval DiT. Prior noise comes from
:attr:`GenerationEngine.draw_prior`, and with ``eval.inference.s_churn >
0`` the churn noise from :attr:`GenerationEngine.draw_churn`: the functions
that every sampling entry point calls (a test may swap in other draws, such
as the JAX package's per-seed streams); the training draws (posterior noise, sigma,
noise) come from generators seeded from (``system.seed``, epoch, step), or
are injected. Under a process group (:mod:`rald_torch.parallel`) every
rank draws at the global batch and keeps its rows, averages the step's
loss and gradients over the ranks, and so holds the same state as every
other rank; :meth:`evaluate` and :meth:`cache_latents` average their
meters over the ranks. With ``eval.inference.shard_queries`` (JAX
:165, :524-531, :637-664) the ranks of a group evaluate one batch together
instead: rank 0 samples the tokens and broadcasts them, and every decode of
the grid, helper and refine queries is split over the ranks by query
(:meth:`GenerationEngine.decode_logits`), bitwise the one-process result.

The engine also runs Hunyuan3D-2.0's shape generator (arXiv:2501.12202),
which the JAX package does not have: ``ar_model.name: hunyuan3d_dit_v2_0``
(:mod:`rald_torch.models.mmdit`) and ``lidar_ae.name: hunyuan3d_vae_v2_0``
(:mod:`rald_torch.models.shape_vae`). Each DiT brings its sampler, its
settings and what its captured graphs depend on (``SAMPLER``, ``sample``,
``sampler_calls``, ``graph_modes``, ``graph_tensors``), and each model its
``set_fast``, so one path serves both: :meth:`condition` hands an image
encoder's tokens to a DiT that projects them itself (``process_cond``),
:meth:`sample_from_cond` runs the guided flow sampler
(:mod:`rald_torch.diffusion.flow`; ``eval.inference.num_steps``, default
50, and ``guidance_scale``, default 5.0) through the same sampler graphs,
and the rest of :meth:`fused_eval_step` is unchanged; :meth:`flow_counts`
counts the DiT's calls, their rows and the decoded queries. The flow DiT
has no int8, fused-kernel or training path (its ``EVAL_ONLY``): those
flags raise ``ValueError``, :meth:`init_state` ``NotImplementedError``.

On the card the no-churn sampler and the training step replay as captured
CUDA graphs, each through a :class:`~rald_torch.train.cuda_graphs.GraphCache`;
a graph is stale when its key (:func:`tensors_key`, modes, settings) or its
guard (:func:`addresses` of what it reads in place) changes.
"""
from __future__ import annotations

import math
import os
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rald_torch import geometry as geo
from rald_torch import resolve_device
from rald_torch.data.query import aug_query_helper
from rald_torch.diffusion.edm import (
    edm_draws,
    edm_loss,
    edm_sampler,
    sample_churn_noise,
    sample_prior_latents,
    unstack_mods,
)
from rald_torch.dsp.cfar_points import resize_linear_align_corners
from rald_torch.eval.chamfer import batched_cd_fscore_graph, chamfer_and_fscore_batch
from rald_torch.eval.densify import densify_queries
from rald_torch.eval.occupancy import occupancy_metrics
from rald_torch.eval.ply import write_ply
from rald_torch.eval.queries import build_query_grid
from rald_torch.models.registry import (
    generation_model_class,
    get_ae_model,
    get_generation_model,
    get_radar_encoder_model,
)
from rald_torch.ops.attn_kernel import merge_int8_trees, quantize_attn_tree
from rald_torch.ops.geglu_kernel import quantize_ff_tree
from rald_torch.models.latent_dit import FLAGS, LatentArrayTransformer
from rald_torch.parallel.dist import (
    all_gather_rows,
    all_reduce_mean_,
    backend,
    broadcast_,
    is_main_process,
    world_rank,
)
from rald_torch.train.cuda_graphs import GraphCache
from rald_torch.train.metrics import MetricLogger, epoch_1000x
from rald_torch.train.profiler import StageTimer, span, synced_ms
from rald_torch.train.schedule import scale_base_lr, warmup_cosine_schedule
from rald_torch.train.state import TrainState, global_norm, masters_of


def bce_with_logits(logits, labels, mask=None):
    bce = F.binary_cross_entropy_with_logits(logits.float(), labels.float(), reduction="none")
    if mask is None:
        return bce.mean()
    mask = mask.float()
    return (bce * mask).sum() / (mask.sum() + 1e-5)


@torch.no_grad()
def init_random_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights: N(0, 1/fan_in) for linear and conv weights,
    N(0, 1) for embeddings, zero biases, unit norm scales. Every weight is
    drawn, the DiT's zero-initialized out-projection included, so a
    random-weight run exercises the whole chain."""
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            fan_in = m.weight[0].numel()
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * fan_in ** -0.5)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()


@torch.no_grad()
def init_train_weights(module: nn.Module, generator: torch.Generator) -> None:
    """The distributions of JAX's ``model.init`` (flax defaults): linear
    and conv kernels lecun-normal (normal truncated at 2 std, std
    1/sqrt(fan_in) / 0.8796...), zero biases, unit norm scales, N(0, 1)
    tables (the radar axis embeddings), and the DiT's output projection
    zero (``latent_dit.py:232-234``)."""
    lo, hi = (math.erf(v / math.sqrt(2.0)) for v in (-2.0, 2.0))
    for m in module.modules():
        if isinstance(m, (nn.Linear, nn.Conv3d)):
            std = m.weight[0].numel() ** -0.5 / 0.87962566103423978
            w = torch.empty(m.weight.shape).uniform_(lo, hi, generator=generator)
            m.weight.copy_(w.erfinv_().mul_(std * math.sqrt(2.0)).clamp_(-2 * std, 2 * std))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.randn(m.weight.shape, generator=generator))
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
            m.bias.zero_()
    for m in module.modules():
        if isinstance(m, LatentArrayTransformer):
            m.proj_out.weight.zero_()


def seeded_generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key``."""
    seed = np.random.SeedSequence(list(key)).generate_state(1)[0]
    return torch.Generator(device).manual_seed(int(seed))


def _bf16_value(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t


@torch.no_grad()
def _round_to_bf16(module: nn.Module) -> None:
    """``eval.cast_params_bf16``: every f32 weight rounded to bf16 (JAX
    ``cast_tree_bf16``); modules computing in f32 then promote it back."""
    for t in module.state_dict().values():
        t.copy_(_bf16_value(t))


def tensors_key(*tensors) -> tuple:
    """Each tensor's shape, strides and dtype (None where absent)."""
    return tuple(None if t is None else (tuple(t.shape), t.stride(), t.dtype) for t in tensors)


def addresses(tensors) -> tuple:
    """The tensors' storage addresses."""
    return tuple(t.data_ptr() for t in tensors)


def torch_dtype(name):
    """A model's own ``dtype`` override (a torch dtype or its name) or None."""
    return getattr(torch, name) if isinstance(name, str) else name


def act_scales_path(ckpt) -> Path:
    """The default static-int8 scales file of an eval checkpoint: beside a
    ``.pth`` file, named after it (``checkpoint-479.pth`` ->
    ``checkpoint-479.int8_act_scales.npz``); inside a checkpoint directory,
    ``int8_act_scales.npz``, as the JAX package keeps it."""
    ckpt = Path(ckpt)
    if ckpt.is_dir():
        return ckpt / "int8_act_scales.npz"
    return ckpt.with_name(ckpt.stem + ".int8_act_scales.npz")


class GenerationEngine:
    def __init__(self, cfg, device=None, seed: Optional[int] = None, dtype=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = int(cfg.system.get("seed", 0) if seed is None else seed)
        if dtype is None:
            dtype = getattr(torch, str(cfg.system.get("compute_dtype", "float32")))
        self.dtype = dtype

        mc = cfg.ar_model.configs
        self.use_radar_cond = bool(mc.get("use_radar_cond", True))
        self.draw_prior = sample_prior_latents
        self.draw_churn = sample_churn_noise
        # the no-churn sampler's CUDA graphs (:meth:`sample_from_cond`): the
        # dataset loop's batch and its short last batch, with room to spare
        self._sampler_graphs = GraphCache("sample_graph", 4)
        # the training step's CUDA graphs (:meth:`train_step`): the training
        # loader drops its short last batch
        self._train_graphs = GraphCache("train_graph", 1)
        ev = cfg.get("eval", {})
        inf = ev.get("inference", {})
        # Hunyuan3D-2.0's flow DiT has no int8, fused-kernel or training path
        self.eval_only = generation_model_class(cfg.ar_model.name).EVAL_ONLY
        if self.eval_only:
            self._refuse_kernel_flags(inf)

        lidar = cfg.dataset.lidar
        self.model = get_generation_model(cfg.ar_model.name, mc, cfg.ar_model.get("overrides"))
        self.vae = get_ae_model(
            cfg.lidar_ae.name, N=int(lidar.num_samples), overrides=cfg.lidar_ae.get("overrides"),
        )
        # a DiT that projects an image encoder's tokens itself takes them as
        # its condition, and has no radar encoder
        self.token_cond = hasattr(self.model, "process_cond")
        self.frozen_radar_enc = (not self.token_cond and bool(mc.get("use_radar_enc", True))
                                 and not bool(mc.get("unfreeze_radar_enc", False)))
        self.fast_inference = bool(cfg.system.get("fast_inference", True))
        # inference-only weights rounded to bf16 (JAX casts the f32 params
        # before sampling, so its int8 codes come from the rounded weights)
        self.cast_params_bf16 = bool(ev.get("cast_params_bf16", False))
        # quantized inference (default off): the DiT FF runs int8 with
        # dynamic per-token activation scales (True) or calibrated
        # per-(schedule step, block) scales ("static", loaded from
        # eval.inference.int8_act_scales); int8_attn True / "full" also
        # quantizes all four self-attention projections, "vout" only v / out
        int8_ff = inf.get("int8_ff", False)
        if int8_ff not in (False, True, "static"):
            raise ValueError(f"eval.inference.int8_ff must be bool or 'static', got {int8_ff!r}")
        self._act_scales = self._load_act_scales(inf) if int8_ff == "static" else None
        int8_attn = inf.get("int8_attn", False)
        if isinstance(int8_attn, str) and int8_attn not in ("full", "vout"):
            raise ValueError(
                f"eval.inference.int8_attn must be bool, 'full' or 'vout', got {int8_attn!r}"
            )
        if self.fast_inference:
            self.model.set_fast()
            self.vae.set_fast()
        else:  # JAX's model_eval is then the model as built, int8 flags included
            int8_ff, int8_attn = self.model.use_int8_ff, self.model.use_int8_attn
        self.use_int8_ff, self.use_int8_attn = int8_ff, int8_attn
        # the frozen external encoder of the radar cube's intensity channel
        # (the autoencoder's encoder alone: conditioning never decodes)
        self.radar_enc = None
        if self.frozen_radar_enc:
            self.radar_enc = get_radar_encoder_model(
                cfg.radar_enc.name, in_channels=1, overrides=cfg.radar_enc.get("overrides"),
                decoder=False,
            )

        gen = torch.Generator().manual_seed(self.seed)
        for m in self.modules():
            init_random_weights(m, gen)
            if self.cast_params_bf16:
                _round_to_bf16(m)
        self._quantize(self.model.state_dict())  # the f32 weights, before the cast
        for m in self.modules():
            m.to(device=self.device, dtype=torch_dtype(m.compute_dtype) or dtype)
            m.eval().requires_grad_(False)

        radar = cfg.dataset.get("radar", {})
        self.upsample_on_device = bool(radar.get("upsample", False)) and bool(
            radar.get("upsample_on_device", False)
        )
        self._upsample_tgt = (int(radar.get("tgt_a_dim", 0) or 0), int(radar.get("tgt_e_dim", 0) or 0))
        # the DiT's calls and batch rows in the sampler (flow_counts)
        self._flow_counts = {"evaluations": 0, "rows": 0}
        # the DiT's sampler settings, each of its type, defaults the DiT's
        self.sampler_kwargs = {k: type(v)(inf.get(k, v)) for k, v in self.model.SAMPLER.items()}
        self.fscore_tau = float(ev.get("fscore_tau", 0.1))
        # the ranks of a process group decode one batch's queries together
        self.shard_queries = bool(inf.get("shard_queries", False))

        self.latent_std = float(cfg.lidar_ae.get("latent_std", 1.0))
        t = cfg.get("train", {})  # eval-only YAMLs may have none
        self.use_cache_latent = bool(t.get("use_cache_latent", False))
        self.ema_rate = 0.999
        self.clip_grad = float(t.get("clip_grad", 0) or 0)
        self.skip_nonfinite = bool(t.get("skip_nonfinite_updates", False))
        self.accum_iter = int(t.get("accum_iter", 1) or 1)
        self.epochs = int(t.get("epochs", 1))
        self.warmup_epochs = float(t.get("warmup_epochs", 0))
        self.min_lr = float(t.get("min_lr", 0.0))
        self.train_model = None  # built by init_state
        self.lr_schedule = None

    def _refuse_kernel_flags(self, inf) -> None:
        """The flow DiT has no int8 or fused-kernel path: the flags that ask
        for one raise here, by name, instead of failing inside a block."""
        cfg = self.cfg
        over = dict(cfg.ar_model.get("overrides") or {})
        asked = [f"eval.inference.{k}" for k in ("int8_ff", "int8_attn") if inf.get(k)]
        asked += [f"ar_model.overrides.{k}" for k in FLAGS + ("use_int8_ff", "use_int8_attn")
                  if over.get(k)]
        if asked:
            raise ValueError(f"ar_model {cfg.ar_model.name!r} has no int8 or fused-kernel path: "
                             f"{', '.join(asked)} cannot apply to it")

    def modules(self) -> list:
        """The engine's models: the DiT, the VAE and the frozen radar encoder
        where there is one."""
        return [m for m in (self.model, self.vae, self.radar_enc) if m is not None]

    def load_state_dicts(self, edm_state_dict=None, vae_state_dict=None,
                         radar_enc_state_dict=None) -> None:
        """Load reference-layout weights (numpy arrays or tensors), strictly;
        values are cast to the engine's dtype and device. In int8 mode the
        side-tree is rebuilt from the values as given (f32), not from the
        cast copy. ``radar_enc_state_dict``: the frozen encoder's
        ``encoder.*`` entries (:func:`rald_torch.train.checkpoint.split_radar_autoencoder`).
        Drops the sampler's CUDA graphs, and their memory pools with them."""
        self._sampler_graphs.clear()
        if radar_enc_state_dict is not None and self.radar_enc is None:
            raise ValueError("radar_enc_state_dict given, but this engine has no frozen radar encoder")
        for m, sd in ((self.model, edm_state_dict), (self.vae, vae_state_dict),
                      (self.radar_enc, radar_enc_state_dict)):
            if sd is not None:
                sd = {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                      for k, v in sd.items()}
                if self.cast_params_bf16:
                    sd = {k: _bf16_value(v) for k, v in sd.items()}
                m.load_state_dict(sd)
                if m is self.model:
                    self._quantize(sd)

    def _quantize(self, state_dict) -> None:
        """Build the int8 side-tree of the DiT from its weights, once per
        weight set (the JAX engine rebuilds the same numbers in every
        sampling call), and hand it to the model. Its tensors are new, so a
        captured sampler's guard no longer holds (:meth:`_graph_guard`)."""
        if not (self.use_int8_ff or self.use_int8_attn):
            return
        tree = quantize_ff_tree(state_dict) if self.use_int8_ff else {}
        if self.use_int8_attn:
            tree = merge_int8_trees(tree, quantize_attn_tree(state_dict))
        tree = {k: {n: v.to(self.device) for n, v in node.items()} for k, node in tree.items()}
        self.model.set_int8(tree, self.use_int8_ff, self.use_int8_attn)

    def _load_act_scales(self, inf_cfg) -> torch.Tensor:
        """Calibrated FF activation amax for ``int8_ff: "static"``: an npz
        with ``ah`` / ``ag`` of shape (num_steps, depth) and ``num_steps``,
        at ``eval.inference.int8_act_scales`` or by default
        :func:`act_scales_path` of ``eval.ckpt`` (``python -m
        rald_torch.cli.calibrate_int8`` writes it there;
        :meth:`calibrate_act_scales` computes the tables). Returns a
        (num_steps, depth, 2) f32 table on the device, indexed by schedule
        step like the mod table."""
        path = str(inf_cfg.get("int8_act_scales", "") or "")
        if not path:
            ckpt = str(self.cfg.get("eval", {}).get("ckpt", "") or "")
            if not ckpt:
                raise ValueError(
                    "eval.inference.int8_ff: 'static' needs calibrated activation scales — set "
                    "eval.inference.int8_act_scales or eval.ckpt (default: beside the "
                    "checkpoint, <ckpt stem>.int8_act_scales.npz); python -m "
                    "rald_torch.cli.calibrate_int8 produces them"
                )
            path = str(act_scales_path(ckpt))
        if not Path(path).exists():
            raise FileNotFoundError(
                f"int8_ff: 'static' — no activation scales at {path}; calibrate them on the "
                "eval checkpoint first (python -m rald_torch.cli.calibrate_int8)"
            )
        with np.load(path) as z:
            ah, ag = np.asarray(z["ah"], np.float32), np.asarray(z["ag"], np.float32)
            calib_steps = int(z["num_steps"]) if "num_steps" in z else ah.shape[0]
        num_steps = int(inf_cfg.get("num_steps", 18))
        if ah.shape != ag.shape or ah.shape[0] != num_steps or calib_steps != num_steps:
            raise ValueError(
                f"activation scales at {path} were calibrated for num_steps={calib_steps} "
                f"(ah {ah.shape}), but eval.inference.num_steps={num_steps} — recalibrate"
            )
        depth = int(self.model.depth)
        if ah.shape[1] != depth:
            raise ValueError(
                f"activation scales at {path} cover {ah.shape[1]} blocks, model has depth "
                f"{depth} — recalibrate"
            )
        return torch.from_numpy(np.stack([ah, ag], axis=-1)).to(self.device)

    # -------------------------------------------------------------- training
    def init_state(self, steps_per_epoch: int, world_batch: int) -> TrainState:
        """Build the training DiT (plain modules, JAX-init weights seeded from
        ``system.seed``) and its :class:`TrainState`: ``train.lr``, else
        ``blr`` scaled by the world batch (the batch of every rank together,
        as JAX's CLI passes it), under the warmup-cosine schedule;
        clip, ``skip_nonfinite_updates`` and ``accum_iter`` from ``train``."""
        if self.eval_only:
            raise NotImplementedError(f"training {self.cfg.ar_model.name!r} is not ported: the "
                                      "port samples and decodes it only")
        cfg, t = self.cfg, self.cfg.train
        lr = t.get("lr")
        if lr is None:
            lr = scale_base_lr(float(t.blr), world_batch, self.accum_iter, 1)
        self.lr_schedule = warmup_cosine_schedule(lr, self.min_lr, self.warmup_epochs, self.epochs,
                                                  steps_per_epoch)
        model = get_generation_model(cfg.ar_model.name, cfg.ar_model.configs,
                                     cfg.ar_model.get("overrides"))
        if model.use_fused_ff or model.use_fused_attn:
            # JAX's _train_step differentiates the model as built, and a
            # pallas_call has no reverse-mode rule: it fails at the first step
            raise ValueError(
                "ar_model.overrides sets use_fused_ff / use_fused_attn: the fused kernels are "
                "inference-only (no backward), and the JAX package cannot train such a model "
                "either; set them in an eval config only")
        init_train_weights(model, torch.Generator().manual_seed(self.seed))
        dtype = torch_dtype(model.compute_dtype) or self.dtype
        params, working = masters_of(model.to(self.device), dtype)
        model.train().requires_grad_(True)  # JAX's deterministic=False; every rate is 0
        self.train_model = model
        return TrainState(params, self.lr_schedule, clip_grad=self.clip_grad,
                          skip_nonfinite=self.skip_nonfinite, accum_iter=self.accum_iter,
                          ema_rate=self.ema_rate, working=working)

    def _generator(self, *key: int) -> torch.Generator:
        return seeded_generator(self.device, *key)

    def step_generator(self, epoch: int, it: int, *key: int) -> torch.Generator:
        """The generator of step ``it`` of ``epoch``: seeded from (seed,
        epoch, it, *key), as JAX folds (seed, epoch, it) into its key
        (``key`` 99: the posterior draw)."""
        return self._generator(self.seed, epoch, it, *key)

    @torch.no_grad()
    def vae_encode(self, pc, generator: Optional[torch.Generator] = None, eps=None) -> torch.Tensor:
        """Frozen-VAE latents of (B, N, 3) clouds: a posterior sample (``eps``
        from ``generator`` unless given) in float32, divided by ``latent_std``."""
        _, z = self.vae.encode(self._to_dev(pc), generator=generator,
                               eps=None if eps is None else self._to_dev(eps))
        return z.float() / self.latent_std

    def prepare_inputs(self, batch, generator: Optional[torch.Generator] = None, eps=None,
                       timings: Optional[dict] = None):
        """A loader batch -> (latents, condition input) on the device: cached
        latents or :meth:`vae_encode`; the raw radar cube, or its frozen
        encoder's features."""
        with self._stage(timings, "vae_encode"):
            if self.use_cache_latent:
                latents = self._to_dev(batch["cache_latent"])
            else:
                latents = self.vae_encode(batch["lidar_points"], generator, eps)
        radar_cube = None
        if self.use_radar_cond:
            radar_cube = self._to_dev(batch["radar_cube"])
            if self.frozen_radar_enc:
                with self._stage(timings, "radar_encode"):
                    radar_cube = self.encode_radar(radar_cube)
        return latents, radar_cube

    def loss_and_grads(self, latents, radar_cube, generator: Optional[torch.Generator] = None,
                       rnd=None, noise=None, timings: Optional[dict] = None):
        """EDM loss of the training DiT and its gradients: ``(loss, {name: f32
        grad})``. The in-graph encoder's cube is upsampled on the device first.
        ``rnd`` / ``noise``: injected unit-normal draws of :func:`edm_loss`
        (this rank's rows). Under a process group the loss and the gradients
        are the means over the ranks (one all-reduce), as JAX's come out of a
        step on the sharded global batch; every rank then holds the same."""
        radar_cube = self._train_upsample(radar_cube, timings)
        with self._stage(timings, "forward_backward"):
            loss, grads = self._forward_backward(self._to_dev(latents), radar_cube, rnd, noise,
                                                 generator)
        with self._stage(timings, "all_reduce"):
            all_reduce_mean_([loss, *grads.values()])
        return loss, grads

    def _train_upsample(self, radar_cube, timings):
        """The in-graph encoder's cube, upsampled on the device."""
        if radar_cube is not None and not self.frozen_radar_enc:
            with self._stage(timings, "upsample"):
                radar_cube = self._maybe_upsample(radar_cube)
        return radar_cube

    def _forward_backward(self, latents, radar_cube, rnd=None, noise=None, generator=None):
        """The EDM loss of the training DiT on device latents and its float32
        gradients by name, on this rank's rows."""
        model = self.train_model
        with span("forward"):
            loss = edm_loss(lambda x, sigma: model(x, sigma, radar_cube), latents, generator,
                            rnd, noise)
        with span("backward"):
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            grads = {k: torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                     for k, p, g in zip(names, params, grads)}
        return loss.detach(), grads

    def train_step(self, state: TrainState, latents, radar_cube,
                   generator: Optional[torch.Generator] = None, rnd=None, noise=None,
                   timings: Optional[dict] = None):
        """One step (JAX ``_train_step_impl``): loss and gradients, then
        ``state.apply_gradients``. Returns ``(state, {"loss", "grad_norm"})``,
        the norm taken before the clip (of the gradients averaged over the
        ranks). ``timings``, when a dict, gets the synchronised ms of
        ``upsample``, ``forward_backward``, ``all_reduce`` and ``optimizer``
        (clip + AdamW + EMA + working-copy refresh), and each one's host ms
        under ``<stage>.host`` (:func:`synced_ms`).

        On a CUDA device, without a process group and with a
        :attr:`TrainState.device_only` state, the step runs as two captured
        CUDA graphs (:meth:`_step_fns`): eager on a key's first step,
        captured on its second, replayed after, and captured anew when a
        tensor they read has moved (:meth:`_train_guard`). The EDM draws are
        then made eagerly first, from ``generator`` unless given, so the
        graphs hold no RNG; the graphs replay inside the ``forward_backward``
        and ``optimizer`` stages, and there is no ``all_reduce`` stage.
        :meth:`train_graph_counts` says how steps were served."""
        with span("train_step"):
            latents = self._to_dev(latents)
            graphs, step = self._train_graphs, None
            if graphs.applies(latents) and backend() is None and state.device_only:
                step = graphs.lookup(tensors_key(latents, radar_cube, rnd, noise),
                                     self._train_guard(state), self._step_fns(state))
            if step is None:
                return graphs.eager(self._eager_train_step, state, latents, radar_cube,
                                    generator, rnd, noise, timings)
            radar_cube = self._train_upsample(radar_cube, timings)
            with self._stage(timings, "forward_backward"):
                rnd, noise = edm_draws(latents, generator, rnd, noise)
                loss = step.replay(0, latents, radar_cube, rnd, noise)
            with self._stage(timings, "optimizer"):
                g_norm = state.replay_update(lambda: step.replay(1))
        return state, {"loss": loss, "grad_norm": g_norm}

    def _eager_train_step(self, state, latents, radar_cube, generator, rnd, noise, timings):
        """:meth:`train_step` as it runs without graphs."""
        loss, grads = self.loss_and_grads(latents, radar_cube, generator, rnd, noise, timings)
        with self._stage(timings, "optimizer"):
            with span("grad_norm"):
                g_norm = global_norm(grads.values())
            state.apply_gradients(grads)
        return state, {"loss": loss, "grad_norm": g_norm}

    def _step_fns(self, state: TrainState) -> tuple:
        """A captured step's two graphs: forward + backward (the loss; the
        f32 gradients stay for the second), then the optimizer stage's device
        work, the global norm (once, for the clip and the log) and
        :meth:`TrainState.device_update`, with the lr and the counters
        around it on the host (:meth:`TrainState.replay_update`)."""
        grads = {}

        def forward_backward(latents, radar_cube, rnd, noise):
            loss, g = self._forward_backward(latents, radar_cube, rnd, noise)
            grads.update(g)
            return loss

        def update():
            with span("grad_norm"):
                g_norm = global_norm(grads.values())
            state.device_update(grads, g_norm)
            return g_norm

        return forward_backward, update

    def _train_guard(self, state: TrainState) -> tuple:
        """The storage addresses of the training model's parameters and
        buffers, which a captured step reads in place, and the state's own
        guard (:meth:`TrainState.graph_guard`). An in-place update keeps them;
        a new tensor moves one, and the step is captured anew."""
        m = self.train_model
        return addresses((*m.parameters(), *m.buffers())) + state.graph_guard()

    def train_graph_counts(self) -> dict:
        """How :meth:`train_step` calls were served: ``captures`` (captured,
        then replayed once), ``replays`` and ``eager``."""
        return dict(self._train_graphs.counts)

    def train_one_epoch(self, state: TrainState, loader, epoch: int, log_writer=None,
                        print_fn=print):
        """One epoch over ``loader`` (JAX ``train_one_epoch``): per step the
        inputs, the step, and ``lr`` / ``loss`` / ``grad_norm`` into the
        metric logger and the TensorBoard ``log_writer``. A non-finite loss
        stops the process (exit 1), or, with ``skip_nonfinite_updates``,
        warns (the update was skipped). Returns ``(state, averages)``."""
        logger = MetricLogger(print_fn=print_fn)
        steps = len(loader)
        for it, batch in enumerate(logger.log_every(iter(loader), 20, f"Epoch: [{epoch}]")):
            latents, radar_cube = self.prepare_inputs(batch, self.step_generator(epoch, it, 99))
            state, metrics = self.train_step(state, latents, radar_cube,
                                             self.step_generator(epoch, it))
            host = {k: float(v) for k, v in metrics.items()}
            if not math.isfinite(host["loss"]):
                if self.skip_nonfinite:
                    print_fn(f"WARNING: non-finite loss {host['loss']} — update skipped")
                else:
                    print_fn(f"Loss is {host['loss']}, stopping training")
                    sys.exit(1)
            lr = float(self.lr_schedule(epoch * steps + it))
            logger.update(lr=lr, **host)
            if log_writer is not None:
                x = epoch_1000x(it / max(steps, 1) + epoch)
                log_writer.add_scalar("loss", host["loss"], x)
                log_writer.add_scalar("lr", lr, x)
                log_writer.add_scalar("norm", host["grad_norm"], x)
        logger.synchronize_between_processes()
        print_fn(f"Averaged stats: {logger}")
        return state, logger.averages()

    def frame_eps(self, indices) -> torch.Tensor:
        """(len(indices), M, latent_dim) posterior noise, one generator per
        frame seeded from (seed + 3, dataset index): a frame's cached latent
        depends neither on its batch nor on the number of ranks."""
        shape = (self.vae.num_latents, self.vae.latent_dim)
        return torch.stack([torch.randn(shape, generator=self._generator(self.seed + 3, int(i)),
                                        device=self.device) for i in indices])

    @torch.no_grad()
    def cache_latents(self, loader, cache_base_path, print_fn=print) -> dict:
        """Frozen-VAE latents of every frame of ``loader`` (queries on) as
        ``<cache_base_path>/<seq>/<frame>.npz`` (key ``res_tokens``), with the
        decode IoU of each batch on its query points (JAX ``cache_latents``);
        the IoU is averaged over the ranks. Each frame draws its posterior
        noise from its dataset index (:meth:`frame_eps`; the loader's sampler
        gives the indices). A file is written aside and renamed, so two ranks
        that write the same frame (the sampler's padding) never leave a torn
        file."""
        cache_base_path = Path(cache_base_path)
        logger = MetricLogger(print_fn=print_fn)
        order = list(loader.sampler)
        bsz = loader.batch_size
        for it, batch in enumerate(logger.log_every(iter(loader), 50, "Caching: ")):
            pcs = batch["lidar_points"]
            z = self.vae_encode(pcs, eps=self.frame_eps(order[it * bsz:it * bsz + len(pcs)]))
            logits = self.decode_queries(z, batch["query_points"])
            m = occupancy_metrics(logits, self._to_dev(batch["query_labels"]))
            logger.update(iou=float(m["iou"]))
            z_np = z.cpu().numpy()
            for i, lidar_path in enumerate(batch["lidar_path"]):
                p = Path(lidar_path)
                d = cache_base_path / p.parts[-3]
                d.mkdir(parents=True, exist_ok=True)
                path = d / (p.parts[-1] + ".npz")
                tmp = d / f".{p.parts[-1]}.{os.getpid()}.tmp.npz"
                np.savez(tmp, res_tokens=z_np[i])
                os.replace(tmp, path)
        logger.synchronize_between_processes()
        return logger.averages()

    # ---------------------------------------------------------------- pieces
    def _to_dev(self, a, dtype=torch.float32):
        """``a`` (numpy or tensor) on the engine's device, in ``dtype``
        (None: a tensor keeps its own, numpy becomes float32)."""
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a, np.float32 if dtype is None else None))
        return t.to(self.device, dtype or t.dtype)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _maybe_upsample(self, radar_cube):
        if radar_cube is None or not self.upsample_on_device:
            return radar_cube
        return resize_linear_align_corners(radar_cube, self._upsample_tgt, axes=(2, 3))

    @torch.no_grad()
    def encode_radar(self, radar_cube):
        """The frozen external encoder (JAX ``encode_radar`` /
        ``_radar_encode_impl``): upsample the raw (B, R, A, E, C) cube, then
        encode its intensity channel -> (B, R', A', E', enc_radar_ch)."""
        cube = self._maybe_upsample(self._to_dev(radar_cube))
        return self.radar_enc.encode(cube[..., :1])

    @torch.no_grad()
    def condition(self, radar_cube):
        """(B, T, C) condition tokens (or None) from a raw (B, R, A, E, C)
        cube, or, with the frozen encoder, from its :meth:`encode_radar`
        output, as JAX's ``_sample_impl`` takes them. For a DiT that has
        ``process_cond`` (Hunyuan3D-2.0's) the argument holds an image
        encoder's (B, T, C) tokens, which the DiT projects."""
        if radar_cube is None or not self.use_radar_cond:
            return None
        x = self._to_dev(radar_cube, None)
        if self.token_cond:
            return self.model.process_cond(x)
        if not self.frozen_radar_enc:
            x = self._maybe_upsample(x)
        return self.model.process_radar_cond(x)

    def _schedule(self):
        return self.model.schedule(self.device, **self.sampler_kwargs)

    @torch.no_grad()
    def sample_from_cond(self, cond, seeds_or_prior, capture_states: bool = False):
        """35-NFE Heun sampling; ``capture_states`` as in :func:`edm_sampler`.

        Without churn the AdaLN mod table is built once, and in ``int8_ff:
        "static"`` mode each NFE takes its schedule step's row of the
        activation-scale table. With ``s_churn > 0`` (JAX :420-434) the
        sigmas leave the schedule: each NFE calls ``denoise``, which projects
        the AdaLN rows from its own sigma, one row per frame, and takes no
        activation-scale rows, so a static int8 FF runs the dynamic kernel
        (``fused_ln_geglu_residual_int8``). Step ``i``'s churn draws come from
        :attr:`draw_churn` (per-sample streams keyed by (seed, step)).

        On a CUDA device the no-churn path without ``capture_states`` runs
        as one CUDA graph per :meth:`_graph_key`, an entry of a
        :class:`~rald_torch.train.cuda_graphs.GraphCache`: eager on a key's
        first call, captured on its second, replayed after, and captured
        anew when a tensor it reads has moved (:meth:`_graph_guard`).
        The prior is drawn outside the graph; the tokens are a fresh tensor
        either way. Everything else runs eagerly, as on the CPU.

        The flow DiT's sampler runs the same way (:meth:`_sample_table`).
        Each call counts its DiT calls (:meth:`flow_counts`)."""
        m = self.model
        latents = self.draw_prior(seeds_or_prior, m.n_latents, m.channels, self.device)
        kw = self.sampler_kwargs
        calls, rows = m.sampler_calls(latents.shape[0], **kw)
        self._flow_counts["evaluations"] += calls
        self._flow_counts["rows"] += rows
        graphs = self._sampler_graphs
        if kw.get("s_churn", 0) > 0:
            def noise(step):
                return self.draw_churn(seeds_or_prior, step, m.n_latents, m.channels, self.device)

            return graphs.eager(edm_sampler, lambda x, sigma, idx: m.denoise(x, sigma, cond),
                                latents, churn_noise=noise, capture_states=capture_states, **kw)
        g = None
        if not capture_states and graphs.applies(latents):
            g = graphs.lookup(self._graph_key(latents, cond), self._graph_guard(),
                              (self._sample_table,))
        if g is None:
            return graphs.eager(self._sample_table, latents, cond, capture_states)
        return g.replay(0, latents, cond)

    def _sample_table(self, latents, cond, capture_states: bool = False):
        """The DiT's sampler without churn from the prior ``latents``
        (``sample``: the AdaLN rows of every step at once, then the steps),
        in the VAE's latent scale (``from_sampler``)."""
        acts = self._act_scales if self.use_int8_ff == "static" else None
        out = self.model.sample(latents, cond, act_scales=acts, capture_states=capture_states,
                                **self.sampler_kwargs)
        return self.vae.from_sampler(out)

    def _graph_key(self, latents, cond) -> tuple:
        """What a captured sampler is specific to: the prior's shape, the
        condition's shape, strides and dtype (or None), the DiT's int8 and
        fused modes, and the sampler's settings."""
        return (tuple(latents.shape), *tensors_key(cond), self.model.graph_modes(),
                tuple(sorted(self.sampler_kwargs.items())))

    def _graph_guard(self) -> tuple:
        """The storage addresses of the tensors a captured sampler reads in
        place: the DiT's (its parameters, buffers and any int8 side-tree)
        and the activation scales. An in-place update keeps them; a new
        tensor moves one, and the graph is captured anew."""
        ts = self.model.graph_tensors()
        if self._act_scales is not None:
            ts.append(self._act_scales)
        return addresses(ts)

    def flow_counts(self) -> dict:
        """What the DiT and the VAE did: ``evaluations`` (DiT calls of the
        sampler: one an Euler step of the flow DiT), ``rows`` (their batch
        rows, 2B a call under guidance) and ``queries_decoded`` (query
        points the ShapeVAE scored), counted on the host from shapes, per
        call whether it ran eagerly or as a graph replay."""
        return {**self._flow_counts, "queries_decoded": getattr(self.vae, "queries_decoded", 0)}

    def sampler_graph_counts(self) -> dict:
        """How :meth:`sample_from_cond` calls were served: ``captures``
        (captured, then replayed once), ``replays`` and ``eager``."""
        return dict(self._sampler_graphs.counts)

    @torch.no_grad()
    def sample_tokens(self, radar_cube, seeds_or_prior):
        """Cube -> (B, n_latents, channels) f32 latent tokens. ``seeds_or_prior``
        is a list of integer seeds or an injected (B, M, C) prior draw.
        Under ``shard_queries`` in a group, rank 0's tokens
        (:meth:`_tokens_from_rank0`)."""
        return self._tokens_from_rank0(
            lambda: self.sample_from_cond(self.condition(radar_cube), seeds_or_prior),
            len(seeds_or_prior))

    def query_shards(self) -> tuple:
        """``(world, rank)`` of the ranks that split each decode's queries:
        the process group's with ``eval.inference.shard_queries``, else
        ``(1, 0)`` (one process, or each rank its own frames)."""
        return world_rank() if self.shard_queries else (1, 0)

    def _tokens_from_rank0(self, sample, bsz: int) -> torch.Tensor:
        """``sample()``, the (B, M, C) f32 tokens; under ``shard_queries`` in a
        group rank 0 alone samples and :func:`broadcast_` sends its tokens to
        every rank. So the ranks decode the one-process tokens bytewise, with
        no reliance on the 35-NFE sampler computing the same bits in two
        processes, and the other ranks skip the sampler."""
        world, rank = self.query_shards()
        if world == 1:
            return sample()
        m = self.model
        tokens = sample().float() if rank == 0 else torch.empty(
            (bsz, m.n_latents, m.channels), dtype=torch.float32, device=self.device)
        return broadcast_(tokens)

    @torch.no_grad()
    def calibrate_act_scales(self, batches, num_batches: int = 2, margin: float = 1.0,
                             print_fn=print):
        """Per-(schedule step, block) FF activation amax tables for
        ``int8_ff: "static"`` (JAX ``calibrate_act_scales``).

        Runs the engine's own sampler, in its own mode, with
        ``capture_states`` on up to ``num_batches`` batches, so the tables
        see the (step, state) pairs the deployed sampler visits; replays each
        state through the unfused full-precision denoiser and takes
        ``max|h|`` (FF input after LN + mod) and ``max|g|`` (gated product)
        per (step, block) over batches and tokens. ``batches``: dicts with
        ``radar_cube`` and optionally ``seeds_or_prior`` (seeds or an
        injected prior draw, as :meth:`sample_tokens` takes); without it
        batch b of size B draws from seeds b*B .. b*B+B-1, as JAX does.
        Returns ``(ah, ag)`` f32 numpy arrays (num_steps, depth) times
        ``margin``; save them as ``np.savez(path, ah=ah, ag=ag,
        num_steps=num_steps)`` for ``eval.inference.int8_act_scales``, or at
        :func:`act_scales_path` of ``eval.ckpt``. The defaults (2 batches,
        margin 1.0) are JAX's; its gate failed with them, and
        ``python -m rald_torch.cli.calibrate_int8`` passes 8 and 1.10.
        Churn is refused: it moves the sigmas off the schedule the tables
        are indexed by.
        """
        if self.sampler_kwargs["s_churn"] > 0:
            raise ValueError(
                "static activation scales are per-schedule-step; churn perturbs sigma off the "
                "schedule (int8_ff: 'static' is unsupported with s_churn > 0)"
            )
        m = self.model
        depth, num_steps = int(m.depth), int(self.sampler_kwargs["num_steps"])
        t_steps, table = self._schedule()
        amax_h = np.zeros((num_steps, depth), np.float32)
        amax_g = np.zeros((num_steps, depth), np.float32)
        done = 0
        for b, batch in zip(range(num_batches), batches):
            cube = batch.get("radar_cube")
            prior = batch.get("seeds_or_prior")
            if prior is None:
                bsz = len(batch["lidar_points"] if "lidar_points" in batch else cube)
                prior = list(range(b * bsz, (b + 1) * bsz))
            if cube is not None and self.frozen_radar_enc:
                cube = self.encode_radar(cube)
            cond = self.condition(cube)
            _, (idxs, xs) = self.sample_from_cond(cond, prior, capture_states=True)
            for k, idx in enumerate(idxs.tolist()):
                stats = []
                m.denoise_with_mods(xs[k], t_steps[idx], unstack_mods(table[idx]), cond,
                                    quant_stats=stats)
                hg = torch.stack([torch.stack(p) for p in stats]).float().cpu().numpy()
                amax_h[idx] = np.maximum(amax_h[idx], hg[:, 0])
                amax_g[idx] = np.maximum(amax_g[idx], hg[:, 1])
            done += 1
            print_fn(f"calibrate_act_scales: batch {done}/{num_batches} done")
        if not done:
            raise ValueError("calibrate_act_scales: empty loader")
        return amax_h * margin, amax_g * margin

    @torch.no_grad()
    def decode_queries(self, tokens, queries):
        """(B, M, C) tokens + (B, Q, 3) normalized queries -> (B, Q) f32
        logits (JAX ``decode_queries``; query-sharded under
        ``shard_queries``, :meth:`decode_logits`)."""
        h = self.vae.decode_latents(self._to_dev(tokens))
        return self.decode_logits(h, self._to_dev(queries)).float()

    @torch.no_grad()
    def decode_logits(self, h, queries) -> torch.Tensor:
        """(B, Q) logits of (B, Q, 3) queries on the card from the decoder
        state ``h`` (:meth:`VecSetVAE.decode_latents`): the VAE's decode,
        which streams the queries in blocks of ``vae._chunk(B)``.

        With ``eval.inference.shard_queries`` under a process group (JAX's
        ``shard_map`` of the decode over the query axis, :637-650) the
        ranks split the queries: rank ``r`` decodes the ``r``-th run of
        ``ceil(blocks / world)`` whole blocks (the last ranks' runs are
        shorter, or empty when there are fewer blocks than ranks), the runs
        are gathered (:func:`all_gather_rows`) and trimmed to Q. Each rank
        then runs every block at the shape one process runs it at, so the
        logits are bitwise the one-process logits. JAX instead pads the
        queries by duplication to a multiple of the devices and splits them
        evenly (:524-531); on the card that would change the blocks' shapes,
        and a GEMM's summation order may follow its shape. Any Q works: the
        caller pads nothing. At world 1, or with the flag off, the plain
        decode."""
        world, rank = self.query_shards()
        if world == 1:
            return self.vae.decode_queries(h, queries).squeeze(-1)
        n = queries.shape[1]
        block = self.vae._chunk(queries.shape[0])
        blocks = -(-n // block)
        run = -(-blocks // world) * block
        part = self.vae.decode_queries(h, queries[:, rank * run:(rank + 1) * run]).squeeze(-1)
        return all_gather_rows(part, run, dim=1)[:, :n]

    def eval_metrics(self, logits, labels, mask, has_mask=True):
        m = mask if has_mask else None
        om = occupancy_metrics(logits, labels, mask=m)
        return bce_with_logits(logits, labels, m), om["iou"], om["accuracy"]

    def _stage(self, timings, name):
        return synced_ms(timings, name, self.device)

    @torch.no_grad()
    def fused_eval_step(
        self,
        radar_cube,
        seeds_or_prior,
        q_eval,
        labels,
        qmask,
        grid,
        generator: Optional[torch.Generator],
        helper,
        helper_mask,
        surface,
        surface_mask,
        has_mask: bool = False,
        compute_cd: bool = True,
        refine: bool = True,
        helper_aug: bool = False,
        use_device_grid: bool = True,
        timings: Optional[dict] = None,
    ):
        """The whole eval step: sample -> decode eval queries (loss/IoU/acc)
        -> decode [grid ; helper] -> threshold -> refine -> Chamfer + F.

        Returns ``(loss, iou, acc, cd (B,), f (B,), n_pred (B,))``. ``grid``
        is drawn on the device from ``generator`` when ``use_device_grid``;
        ``helper_aug`` densifies raw CFAR helper points on the device.
        ``timings``, when a dict, receives per-stage milliseconds (each
        stage then ends in a synchronize, so only pass it to measure) and
        each stage's host milliseconds under ``<stage>.host``
        (:func:`synced_ms`).
        """
        with span("eval_step"):
            cfg = self.cfg
            inference = cfg.get("eval", {}).get("inference", {})
            lidar = cfg.dataset.lidar
            aniso, iso = bool(lidar.norm_anisotropy), bool(lidar.norm_isotropy)
            num_query = int(inference.get("num_query_points", 500000))
            g = (generator if generator is not None
                 else torch.Generator(self.device).manual_seed(self.seed))
            dev = self.device
            # under shard_queries every rank holds the whole batch and draws what
            # one process draws; rank 0 alone conditions and samples
            first = self.query_shards()[1] == 0

            with self._stage(timings, "cond"):
                cond = self.condition(radar_cube) if first else None
            with self._stage(timings, "sample"):
                tokens = self._tokens_from_rank0(
                    lambda: self.sample_from_cond(cond, seeds_or_prior), len(seeds_or_prior))

            with self._stage(timings, "decode"):
                if use_device_grid:
                    _, scale = geo.norm_scale_offset(lidar.pc_range)
                    hi = scale / scale.max() if iso else np.ones(3, np.float32)
                    lo, hi = torch.as_tensor(-hi, device=dev), torch.as_tensor(hi, device=dev)
                    grid = torch.rand((num_query, 3), generator=g, device=dev) * (hi - lo) + lo
                else:
                    grid = self._to_dev(grid)
                if helper is not None:
                    helper = self._to_dev(helper)
                    if helper_aug:
                        helper, _, _ = densify_queries(
                            helper, self._to_dev(helper_mask, torch.bool),
                            int(float(cfg.dataset.get("query_aug_num", 0))), g, lidar.pc_range,
                            lidar.voxel_size, int(cfg.dataset.get("query_aug_scale", 2)), aniso,
                            iso, global_rows=not self.shard_queries,
                        )
                q_eval = self._to_dev(q_eval)
                bsz = q_eval.shape[0]
                h = self.vae.decode_latents(tokens)
                logits_eval = self.vae.decode_queries(h, q_eval).squeeze(-1).float()
                q_grid = grid[None].expand(bsz, *grid.shape)
                if helper is not None:
                    q_grid = torch.cat([q_grid, helper], dim=1)
                hits = self.decode_logits(h, q_grid) > 0
                loss, iou, acc = self.eval_metrics(
                    logits_eval, self._to_dev(labels), self._to_dev(qmask), has_mask
                )

            with self._stage(timings, "refine"):
                if refine:
                    refined, valid, _ = densify_queries(
                        q_grid, hits, int(float(inference.refine_query_aug_num)), g, lidar.pc_range,
                        lidar.voxel_size, int(inference.refine_query_scale), aniso, iso,
                        global_rows=not self.shard_queries,
                    )
                    hits2 = self.decode_logits(h, refined) > 0
                    pred_pts, pred_mask = refined, hits2 & valid
                else:
                    pred_pts, pred_mask = q_grid, hits
                n_pred = pred_mask.int().sum(1)

            if not compute_cd:
                neg = torch.full((bsz,), -1.0, device=dev)
                return loss, iou, acc, neg, neg, n_pred

            with self._stage(timings, "chamfer"):
                pred_un = geo.inverse_norm_points(pred_pts, lidar.pc_range, aniso, iso)
                gt_un = geo.inverse_norm_points(self._to_dev(surface), lidar.pc_range, aniso, iso)
                if lidar.get("view_cone_mode", False):
                    pred_un = geo.polar2cartesian(pred_un)
                    gt_un = geo.polar2cartesian(gt_un)
                cd, f = batched_cd_fscore_graph(pred_un, pred_mask, gt_un,
                                                self._to_dev(surface_mask, torch.bool),
                                                self.fscore_tau)
            return loss, iou, acc, cd, f, n_pred

    # ------------------------------------------------------- dataset eval
    @torch.no_grad()
    def _decode_hits(self, tokens, queries, h=None):
        """Thresholded decode (JAX ``_decode_hits``): (B, Q) bool on the
        device. ``h``: the tokens' decoder state, if already computed."""
        if h is None:
            h = self.vae.decode_latents(self._to_dev(tokens))
        return self.decode_logits(h, self._to_dev(queries)) > 0

    @torch.no_grad()
    def _sample_and_decode(self, radar_cube, seeds_or_prior, q_eval, grid, helper):
        """JAX ``_sample_and_decode_impl``: sample -> decode the eval queries
        (f32 logits) -> decode [grid ; helper] -> hits. The one (Q, 3) grid
        is shared by every frame; ``helper``: optional (B, H, 3) per-frame
        queries after it. Also returns the decoder state ``h``, which the
        refine decode reuses (JAX recomputes it there: same numbers)."""
        tokens = self.sample_tokens(radar_cube, seeds_or_prior)
        h = self.vae.decode_latents(tokens)
        q_eval = self._to_dev(q_eval)
        logits_eval = self.vae.decode_queries(h, q_eval).squeeze(-1).float()
        grid = self._to_dev(grid)
        q_grid = grid[None].expand(q_eval.shape[0], *grid.shape)
        if helper is not None:
            q_grid = torch.cat([q_grid, self._to_dev(helper)], dim=1)
        return tokens, logits_eval, self._decode_hits(None, q_grid, h), h

    def _densify_helper_host(self, helper, helper_mask, rng_np):
        """Host ``aug_query_helper`` over raw bucket-padded CFAR points: the
        modular path's twin of the fused step's on-device densify (JAX
        :477-498). A frame without CFAR points keeps zeros."""
        lidar = self.cfg.dataset.lidar
        aniso, iso = lidar.norm_anisotropy, lidar.norm_isotropy
        aug_num = int(float(self.cfg.dataset.get("query_aug_num", 0)))
        scale = int(self.cfg.dataset.get("query_aug_scale", 2))
        dense = np.zeros((helper.shape[0], aug_num, 3), np.float32)
        for i in range(helper.shape[0]):
            raw = helper[i][helper_mask[i]]
            if not len(raw):
                continue
            raw_un = geo.inverse_norm_points(raw, lidar.pc_range, aniso, iso)
            dense[i] = geo.norm_points(
                aug_query_helper(raw_un.astype(np.float32), aug_num, lidar.pc_range,
                                 lidar.voxel_size, scale, rng_np),
                lidar.pc_range, aniso, iso,
            ).astype(np.float32)
        return dense

    def _fused_generator(self, it: int) -> torch.Generator:
        """The fused path's device RNG for batch ``it`` (JAX draws from
        ``fold_in(PRNGKey(seed + 11), it)``; torch's stream differs)."""
        return self._generator(self.seed + 11, it)

    @torch.no_grad()
    def evaluate(self, loader, use_ema: bool = False, print_fn=print, stage_timer=None,
                 state_or_params=None) -> dict:
        """The dataset eval loop (JAX ``evaluate``, reference
        engine_generation.py:138-355) over ``loader``'s batches, with the
        engine's weights; returns the mean ``loss`` / ``iou`` /
        ``accuracy`` / ``cd`` / ``fscore`` (-1 where a mode skips them).

        Each batch of ``B`` frames samples from prior seeds ``it*B ..
        it*B+B-1`` (through :attr:`draw_prior`). Under a process group each
        rank evaluates its loader's shard, as JAX does: batch ``it`` of rank
        ``r`` is rows ``r*B .. r*B+B-1`` of a global batch of ``world*B``
        frames, whose seeds start at ``it*world*B``; the device draws of the
        fused step are the rank's rows of the global draw; the meters are
        averaged over every rank's batches (JAX keeps every meter of this
        loop rank-local and gives every rank the seeds ``it*B ..``: ROADMAP
        C10). With ``eval.inference.shard_queries`` every rank instead
        evaluates the whole loader (built unsharded, as
        ``main_generation.build_eval_loader`` builds it then) as one process
        would, seeds ``it*B ..`` and one-process device draws, while the
        decodes split their queries over the ranks (:meth:`decode_logits`);
        every rank ends with the one-process meters, and rank 0 alone writes
        the PLY and latent dumps.
        The host draws (grid, helper densify, refine jitter) come from each
        rank's own ``rng_np``. The one-step fused path
        (:meth:`fused_eval_step`) runs unless ``eval.store_pc`` /
        ``store_latent`` dump, ``use_pred_latent`` decodes stored latents,
        ``test_sample_speed`` times the sampler alone or ``iou_test_only``
        scores the surface only; those take the modular path: sample and
        decode on the card, the query grid, the CFAR helper densify, the
        threshold and the refine jitter on the host, all drawn from one
        ``np.random.default_rng(seed)`` in JAX's order (grid, helper frame
        by frame, refine frame by frame), then one batched Chamfer call.
        PLY files go to ``store_base_dir/exp_name/<seq>/<save_pc_dir_name>/
        <frame>.ply``, with ``seq`` the radar path's great-grandparent.
        ``state_or_params``: a :class:`TrainState`, whose EMA (``use_ema``) or
        params are loaded into the eval DiT first (:meth:`load_state_dicts`:
        the int8 side-tree is rebuilt and ``cast_params_bf16`` rounds a copy),
        or a state_dict to load; None evaluates the weights the eval DiT
        holds (which a checkpoint loader picked by ``use_ema``).
        ``stage_timer``: a :class:`StageTimer` that gets the wall time of
        each stage (profiling only: it synchronises the card at stage ends
        it blocks on).
        """
        st = stage_timer if stage_timer is not None else StageTimer(enabled=False)
        cfg = self.cfg
        if state_or_params is not None:
            params = state_or_params
            if isinstance(params, TrainState):
                params = params.ema_params if use_ema else params.params
            self.load_state_dicts(edm_state_dict=params)
        print_fn(f"Using {'EMA' if use_ema else 'model'} parameters for evaluation")
        ev = cfg.get("eval", {})
        inference = ev.get("inference", {})
        eval_freq = int(ev.get("freq", 1) or 1)
        iou_test_only = bool(ev.get("iou_test_only", False))
        test_sample_speed = bool(ev.get("test_sample_speed", False))
        skip_metric = bool(ev.get("skip_eval_metric", False))
        use_pred_latent = bool(ev.get("use_pred_latent", False))
        store_latent = bool(ev.get("store_latent", False))
        store_pc = bool(ev.get("store_pc", False))
        num_query = int(inference.get("num_query_points", 500000))
        use_helper = bool(inference.get("query_helper", False))
        refine_query = bool(inference.get("refine_query", False))

        lidar = cfg.dataset.lidar
        aniso, iso = lidar.norm_anisotropy, lidar.norm_isotropy
        use_cart_query = bool(ev.get("use_cart_query", False))
        rng_np = np.random.default_rng(self.seed)
        logger = MetricLogger(print_fn=print_fn)
        # shard_queries: every rank evaluates the one-process batches
        world, rank = (1, 0) if self.shard_queries else world_rank()
        writes = not self.shard_queries or is_main_process()

        def make_grid():
            return build_query_grid(lidar, num_query, use_cart_query, rng_np)

        def timed_iter(src):
            src = iter(src)
            while True:
                with st("loader"):
                    try:
                        batch = next(src)
                    except StopIteration:
                        return
                yield batch

        for it, batch in enumerate(logger.log_every(timed_iter(loader), 20, "Test:")):
            if it % eval_freq != 0:
                continue
            surface = np.asarray(batch["lidar_points"])
            bsz = surface.shape[0]
            # bucket-padded ragged eval: real per-frame counts for GT slicing
            pts_num = np.asarray(batch.get("points_num", [surface.shape[1]] * bsz), np.int64)
            # the rows of the global batch ``it`` (every rank's batch ``it``)
            first = (it * world + rank) * bsz
            seeds = list(range(first, first + bsz))
            radar_cube = None
            if self.use_radar_cond:
                with st("radar_encode"):
                    radar_cube = self._to_dev(batch["radar_cube"])
                    if self.frozen_radar_enc:
                        radar_cube = st.block(self.encode_radar(radar_cube))

            fused = not (use_pred_latent or test_sample_speed or iou_test_only)
            # the one-step path keeps refine and Chamfer on the card; the
            # dump modes need the clouds on the host and run modular below
            if fused and not (store_pc or store_latent):
                with st("make_grid"):
                    grid = make_grid() if use_cart_query else None
                helper = helper_mask = None
                if use_helper and "helper_points" in batch:
                    helper = np.asarray(batch["helper_points"], np.float32)
                    if "helper_mask" in batch:  # raw CFAR points -> device densify
                        helper_mask = np.asarray(batch["helper_mask"], bool)
                labels_np = np.asarray(batch["query_labels"], np.float32)
                qmask_np = (np.asarray(batch["query_mask"], np.float32)
                            if "query_mask" in batch else None)
                smask = np.arange(surface.shape[1])[None] < pts_num[:, None]
                with st("fused_eval_step"):
                    loss, iou, acc, cds, fs, _ = st.block(self.fused_eval_step(
                        radar_cube, seeds, batch["query_points"], labels_np,
                        labels_np if qmask_np is None else qmask_np, grid,
                        self._fused_generator(it), helper, helper_mask, surface, smask,
                        has_mask=qmask_np is not None, compute_cd=not skip_metric,
                        refine=refine_query, helper_aug=helper_mask is not None,
                        use_device_grid=not use_cart_query,
                    ))
                with st("metrics_readback"), span("readback"):
                    logger.update(loss=float(loss), iou=float(iou), accuracy=float(acc))
                    if not skip_metric:
                        logger.update(cd=float(cds.float().mean()), fscore=float(fs.float().mean()))
                    else:
                        logger.update(cd=-1.0, fscore=-1.0)
                continue

            grid_hits = grid_b = helper = h = None
            if fused:
                with st("make_grid"):
                    grid = make_grid()
                if use_helper and "helper_points" in batch:
                    helper = np.asarray(batch["helper_points"], np.float32)
                    if "helper_mask" in batch:
                        # raw CFAR points, densified on the host on this path
                        with st("helper_densify"):
                            helper = self._densify_helper_host(
                                helper, np.asarray(batch["helper_mask"], bool), rng_np)
                with st("sample_decode"):
                    tokens, logits, grid_hits, h = st.block(self._sample_and_decode(
                        radar_cube, seeds, batch["query_points"], grid, helper))
                with st("hits_readback"), span("readback"):
                    grid_hits = grid_hits.cpu().numpy()
            elif use_pred_latent:
                tokens = self._to_dev(np.asarray(batch["pred_latent"], np.float32))
                if tokens.ndim == 4:  # reference .pt latents carry (1, M, D) per frame
                    tokens = tokens.squeeze(1)
            else:
                tokens = self.sample_tokens(radar_cube, seeds)

            if store_latent and writes and "lidar_path" in batch:
                base = Path(ev.store_base_dir) / ev.exp_name
                for i in range(bsz):
                    seq = Path(batch["lidar_path"][i]).parent.parent.name
                    d = base / seq / "latent_tokens"
                    d.mkdir(parents=True, exist_ok=True)
                    np.save(d / (Path(batch["radar_path"][i]).stem + ".npy"),
                            tokens[i].float().cpu().numpy())

            if test_sample_speed:
                self._sync()
                logger.update(loss=-1.0, iou=-1.0)
                continue

            # loss/IoU on the eval query set (or the surface for iou_test_only)
            if not fused:
                logits = self.decode_queries(tokens, surface if iou_test_only
                                             else batch["query_points"])
            with st("eval_metrics"):
                labels = self._to_dev(batch["query_labels"])
                qmask = None
                if iou_test_only and "lidar_mask" in batch:  # surface-query mode
                    qmask = self._to_dev(batch["lidar_mask"])
                elif "query_mask" in batch:  # bucket-padded ragged eval
                    qmask = self._to_dev(batch["query_mask"])
                loss, iou, acc = self.eval_metrics(
                    logits, labels, labels if qmask is None else qmask, has_mask=qmask is not None)
                logger.update(loss=float(loss), iou=float(iou), accuracy=float(acc))

            if iou_test_only:
                continue

            # uniform grid (+ helper points) -> thresholded point cloud -> CD
            if grid_hits is None:  # use_pred_latent: the grid decoded per frame
                grid = make_grid()
                grid_b = np.broadcast_to(grid, (bsz, num_query, 3)).copy()
                if use_helper and "helper_points" in batch:
                    helper = np.asarray(batch["helper_points"], np.float32)
                    grid_b = np.concatenate([grid_b, helper], axis=1)
                grid_hits = self._decode_hits(tokens, grid_b).cpu().numpy()

            def frame_positives(i):
                """Host coordinates of frame i's hit queries."""
                m = grid_hits[i]
                if grid_b is not None:
                    return grid_b[i][m]
                pos = grid[m[:num_query]]
                if helper is not None:
                    pos = np.concatenate([pos, helper[i][m[num_query:]]], axis=0)
                return pos

            # threshold per frame, then one batched refine decode; the refine
            # jitter draws from rng_np frame by frame
            preds = []
            if refine_query:
                refine_n = int(float(inference.refine_query_aug_num))
                refined_norm = np.zeros((bsz, refine_n, 3), np.float32)
                do_refine = np.zeros(bsz, dtype=bool)
            for i in range(bsz):
                with st("threshold_invnorm"):
                    pos = frame_positives(i)
                    pred = geo.inverse_norm_points(pos, lidar.pc_range, aniso, iso)
                if refine_query and len(pred):
                    with st("refine_aug"):
                        refined = aug_query_helper(
                            pred, refine_n, lidar.pc_range, lidar.voxel_size,
                            int(inference.refine_query_scale), rng_np,
                        )
                        refined_norm[i] = geo.norm_points(
                            refined, lidar.pc_range, aniso, iso).astype(np.float32)
                        do_refine[i] = True
                preds.append(pred)
            if refine_query and do_refine.any():
                with st("refine_decode"):
                    r_hits = self._decode_hits(tokens, refined_norm, h).cpu().numpy()
                with st("refine_post"):
                    for i in range(bsz):
                        if do_refine[i]:
                            preds[i] = geo.inverse_norm_points(
                                refined_norm[i][r_hits[i]], lidar.pc_range, aniso, iso)

            preds_xyz, gts_xyz = [], []
            for i in range(bsz):
                pred = preds[i]
                with st("gt_prep"):
                    gt = geo.inverse_norm_points(
                        surface[i, : pts_num[i]], lidar.pc_range, aniso, iso)
                    if lidar.get("view_cone_mode", False):
                        pred = geo.polar2cartesian(pred) if len(pred) else pred.reshape(0, 3)
                        gt = geo.polar2cartesian(gt)
                preds_xyz.append(pred)
                gts_xyz.append(gt)

                if store_pc and writes and "radar_path" in batch:
                    with st("store_pc"):
                        seq = Path(batch["radar_path"][i]).parent.parent.parent.name
                        d = Path(ev.store_base_dir) / ev.exp_name / seq / ev.get(
                            "save_pc_dir_name", "pred_pc")
                        write_ply(d / (Path(batch["radar_path"][i]).stem + ".ply"), pred)
            if skip_metric:
                cds, fscores = [-1.0] * bsz, [-1.0] * bsz
            else:
                with st("chamfer"):
                    cds, fscores = chamfer_and_fscore_batch(
                        preds_xyz, gts_xyz, self.fscore_tau, device=self.device)
            logger.update(cd=float(np.mean(cds)), fscore=float(np.mean(fscores)))

        if not self.shard_queries:  # shard_queries: every rank holds the same meters
            logger.synchronize_between_processes()
        stats = logger.averages()
        print_fn(
            "* iou {iou:.3f} loss {loss:.3f} cd {cd:.3f} fscore {f:.3f}".format(
                iou=stats.get("iou", -1.0), loss=stats.get("loss", -1.0),
                cd=stats.get("cd", -1.0), f=stats.get("fscore", -1.0),
            )
        )
        return stats
