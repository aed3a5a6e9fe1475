"""Eval-only generation engine: the product inference chain on the card.

Counterpart of ``rald_tpu/train/gen_engine.py``'s eval programs:
:meth:`GenerationEngine.sample_tokens` (``_sample_impl`` :389-471),
:meth:`GenerationEngine.decode_queries` (``_decode_impl`` :473-475) and
:meth:`GenerationEngine.fused_eval_step` (``_fused_eval_step_impl``
:535-635): radar cube -> on-device upsample -> 3D-CNN condition tokens ->
AdaLN mod table -> 35-NFE Heun sampling -> VAE decode of the grid + CFAR
helper queries -> threshold -> densify + refine decode -> polar->cartesian
-> Chamfer / F-score. Quantized inference (``eval.inference.int8_ff`` /
``int8_attn``, :93-124) runs the DiT through the int8 kernels, with
:meth:`GenerationEngine.calibrate_act_scales` (:669-768) for the static
activation scales. Training, ``evaluate`` and the frozen external radar
encoder come in later slices and raise here.

The engine reads the same YAML as ``rald_tpu`` (``system.compute_dtype``,
``system.fast_inference``, ``ar_model`` / ``lidar_ae`` with their
``overrides``, ``eval.inference``, ``eval.cast_params_bf16``) and builds
the eval models as JAX builds ``model_eval`` / ``vae_eval`` (:87-128),
with the card in the TPU's role: with ``fast_inference`` (the default) the
DiT gets the fused FF and the int8 flags, the VAE the fused FF and the
folded decode tail; without it both run as the YAML builds them (plain
modules, unfolded decode, no int8 unless ``overrides`` ask). The DiT keeps
the ``use_fused_attn`` of its overrides either way. Since the port is
eval-only, ``model`` / ``vae`` are those eval models (JAX shares their
weights with the training models too). Models start from seeded random
weights (:func:`init_random_weights`); :meth:`load_state_dicts` loads real
ones.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from rald_torch import geometry as geo
from rald_torch import resolve_device
from rald_torch.diffusion.edm import (
    edm_sampler,
    karras_sigmas,
    sample_prior_latents,
    stack_mod_table,
    unstack_mods,
)
from rald_torch.dsp.cfar_points import resize_linear_align_corners
from rald_torch.eval.chamfer import batched_cd_fscore_graph
from rald_torch.eval.densify import densify_queries
from rald_torch.eval.occupancy import occupancy_metrics
from rald_torch.models.registry import get_ae_model, get_generation_model
from rald_torch.ops.attn_kernel import merge_int8_trees, quantize_attn_tree
from rald_torch.ops.geglu_kernel import quantize_ff_tree


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


def _bf16_value(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype) if t.dtype == torch.float32 else t


@torch.no_grad()
def _round_to_bf16(module: nn.Module) -> None:
    """``eval.cast_params_bf16``: every f32 weight rounded to bf16 (JAX
    ``cast_tree_bf16``); modules computing in f32 then promote it back."""
    for t in module.state_dict().values():
        t.copy_(_bf16_value(t))


def _torch_dtype(name):
    """A model's own ``dtype`` override (a torch dtype or its name) or None."""
    return getattr(torch, name) if isinstance(name, str) else name


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
        if self.use_radar_cond and bool(mc.get("use_radar_enc", True)) and not bool(
            mc.get("unfreeze_radar_enc", False)
        ):
            raise NotImplementedError("rald_torch: the frozen external radar encoder is not ported yet")
        ev = cfg.get("eval", {})
        inf = ev.get("inference", {})

        lidar = cfg.dataset.lidar
        self.model = get_generation_model(cfg.ar_model.name, mc, cfg.ar_model.get("overrides"))
        self.vae = get_ae_model(
            cfg.lidar_ae.name, N=int(lidar.num_samples), overrides=cfg.lidar_ae.get("overrides"),
        )
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
            self.model.set_flags(use_fused_ff=True)
            self.vae.set_flags(fold_decode_tail=True, use_fused_ff=True)
        else:  # JAX's model_eval is then the model as built, int8 flags included
            int8_ff, int8_attn = self.model.use_int8_ff, self.model.use_int8_attn
        self.use_int8_ff, self.use_int8_attn = int8_ff, int8_attn

        gen = torch.Generator().manual_seed(self.seed)
        for m in (self.model, self.vae):
            init_random_weights(m, gen)
            if self.cast_params_bf16:
                _round_to_bf16(m)
        self._quantize(self.model.state_dict())  # the f32 weights, before the cast
        for m in (self.model, self.vae):
            m.to(device=self.device, dtype=_torch_dtype(m.compute_dtype) or dtype)
            m.eval().requires_grad_(False)

        radar = cfg.dataset.get("radar", {})
        self.upsample_on_device = bool(radar.get("upsample", False)) and bool(
            radar.get("upsample_on_device", False)
        )
        self._upsample_tgt = (int(radar.get("tgt_a_dim", 0) or 0), int(radar.get("tgt_e_dim", 0) or 0))
        self.sampler_kwargs = dict(
            num_steps=int(inf.get("num_steps", 18)),
            sigma_min=float(inf.get("sigma_min", 0.002)),
            sigma_max=float(inf.get("sigma_max", 80.0)),
            rho=float(inf.get("rho", 7.0)),
            s_churn=float(inf.get("s_churn", 0.0)),
            s_min=float(inf.get("s_min", 0.0)),
            s_max=float(inf.get("s_max", float("inf"))),
            s_noise=float(inf.get("s_noise", 1.0)),
        )
        self.fscore_tau = float(ev.get("fscore_tau", 0.1))

    def load_state_dicts(self, edm_state_dict=None, vae_state_dict=None) -> None:
        """Load reference-layout weights (numpy arrays or tensors), strictly;
        values are cast to the engine's dtype and device. In int8 mode the
        side-tree is rebuilt from the values as given (f32), not from the
        cast copy."""
        for m, sd in ((self.model, edm_state_dict), (self.vae, vae_state_dict)):
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
        sampling call), and hand it to the model."""
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
        ``<eval.ckpt>/int8_act_scales.npz`` (the JAX package's
        ``scripts/calibrate_int8.py`` writes it; :meth:`calibrate_act_scales`
        computes the same tables). Returns a (num_steps, depth, 2) f32 table
        on the device, indexed by schedule step like the mod table."""
        path = str(inf_cfg.get("int8_act_scales", "") or "")
        if not path:
            ckpt = str(self.cfg.get("eval", {}).get("ckpt", "") or "")
            if not ckpt:
                raise ValueError(
                    "eval.inference.int8_ff: 'static' needs calibrated activation scales — set "
                    "eval.inference.int8_act_scales or eval.ckpt (default "
                    "<ckpt>/int8_act_scales.npz); GenerationEngine.calibrate_act_scales "
                    "produces them"
                )
            path = str(Path(ckpt) / "int8_act_scales.npz")
        if not Path(path).exists():
            raise FileNotFoundError(
                f"int8_ff: 'static' — no activation scales at {path}; calibrate them on the "
                "eval checkpoint first (GenerationEngine.calibrate_act_scales)"
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

    # ---------------------------------------------------------------- pieces
    def _to_dev(self, a, dtype=torch.float32):
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.from_numpy(np.array(a))
        return t.to(self.device, dtype)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _maybe_upsample(self, radar_cube):
        if radar_cube is None or not self.upsample_on_device:
            return radar_cube
        return resize_linear_align_corners(radar_cube, self._upsample_tgt, axes=(2, 3))

    @torch.no_grad()
    def condition(self, radar_cube):
        """Raw (B, R, A, E, C) cube -> (B, T, C) condition tokens (or None)."""
        if radar_cube is None or not self.use_radar_cond:
            return None
        return self.model.process_radar_cond(self._maybe_upsample(self._to_dev(radar_cube)))

    def _schedule(self):
        kw = self.sampler_kwargs
        t_steps = karras_sigmas(kw["num_steps"], kw["sigma_min"], kw["sigma_max"], kw["rho"],
                                device=self.device)
        return t_steps, stack_mod_table(self.model.compute_mod_table(t_steps[:-1]))

    @torch.no_grad()
    def sample_from_cond(self, cond, seeds_or_prior, capture_states: bool = False):
        """35-NFE Heun sampling with the AdaLN mod table built once; in
        ``int8_ff: "static"`` mode each NFE takes its schedule step's row of
        the activation-scale table. ``capture_states`` as in
        :func:`edm_sampler`."""
        m = self.model
        latents = sample_prior_latents(seeds_or_prior, m.n_latents, m.channels, self.device)
        _, table = self._schedule()
        acts = self._act_scales if self.use_int8_ff == "static" else None

        def denoise_indexed(x, sigma, idx):
            sc = None
            if acts is not None:
                row = acts[idx]  # (depth, 2)
                sc = tuple((row[i, 0], row[i, 1]) for i in range(row.shape[0]))
            return m.denoise_with_mods(x, sigma, unstack_mods(table[idx]), cond, act_scales=sc)

        return edm_sampler(denoise_indexed, latents, capture_states=capture_states,
                           **self.sampler_kwargs)

    @torch.no_grad()
    def sample_tokens(self, radar_cube, seeds_or_prior):
        """Cube -> (B, n_latents, channels) f32 latent tokens. ``seeds_or_prior``
        is a list of integer seeds or an injected (B, M, C) prior draw."""
        return self.sample_from_cond(self.condition(radar_cube), seeds_or_prior)

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
        num_steps=num_steps)`` for ``eval.inference.int8_act_scales``.
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
        """(B, M, C) tokens + (B, Q, 3) normalized queries -> (B, Q) f32 logits."""
        out = self.vae.decode(self._to_dev(tokens), self._to_dev(queries))
        return out.squeeze(-1).float()

    def eval_metrics(self, logits, labels, mask, has_mask=True):
        m = mask if has_mask else None
        om = occupancy_metrics(logits, labels, mask=m)
        return bce_with_logits(logits, labels, m), om["iou"], om["accuracy"]

    @contextmanager
    def _stage(self, timings, name):
        if timings is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        timings[name] = timings.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

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
        stage then ends in a synchronize, so only pass it to measure).
        """
        cfg = self.cfg
        inference = cfg.get("eval", {}).get("inference", {})
        lidar = cfg.dataset.lidar
        aniso, iso = bool(lidar.norm_anisotropy), bool(lidar.norm_isotropy)
        num_query = int(inference.get("num_query_points", 500000))
        g = generator if generator is not None else torch.Generator(self.device).manual_seed(self.seed)
        dev = self.device

        with self._stage(timings, "cond"):
            cond = self.condition(radar_cube)
        with self._stage(timings, "sample"):
            tokens = self.sample_from_cond(cond, seeds_or_prior)

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
                        lidar.voxel_size, int(cfg.dataset.get("query_aug_scale", 2)), aniso, iso,
                    )
            q_eval = self._to_dev(q_eval)
            bsz = q_eval.shape[0]
            h = self.vae.decode_latents(tokens)
            logits_eval = self.vae.decode_queries(h, q_eval).squeeze(-1).float()
            q_grid = grid[None].expand(bsz, *grid.shape)
            if helper is not None:
                q_grid = torch.cat([q_grid, helper], dim=1)
            hits = self.vae.decode_queries(h, q_grid).squeeze(-1) > 0
            loss, iou, acc = self.eval_metrics(
                logits_eval, self._to_dev(labels), self._to_dev(qmask), has_mask
            )

        with self._stage(timings, "refine"):
            if refine:
                refined, valid, _ = densify_queries(
                    q_grid, hits, int(float(inference.refine_query_aug_num)), g, lidar.pc_range,
                    lidar.voxel_size, int(inference.refine_query_scale), aniso, iso,
                )
                hits2 = self.vae.decode_queries(h, refined).squeeze(-1) > 0
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
            cd, f = batched_cd_fscore_graph(
                pred_un, pred_mask, gt_un, self._to_dev(surface_mask, torch.bool), self.fscore_tau
            )
        return loss, iou, acc, cd, f, n_pred
