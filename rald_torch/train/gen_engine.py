"""Eval-only generation engine: the product inference chain on the card.

Counterpart of ``rald_tpu/train/gen_engine.py``'s eval programs:
:meth:`GenerationEngine.sample_tokens` (``_sample_impl`` :389-471),
:meth:`GenerationEngine.decode_queries` (``_decode_impl`` :473-475) and
:meth:`GenerationEngine.fused_eval_step` (``_fused_eval_step_impl``
:535-635): radar cube -> on-device upsample -> 3D-CNN condition tokens ->
AdaLN mod table -> 35-NFE Heun sampling -> VAE decode of the grid + CFAR
helper queries -> threshold -> densify + refine decode -> polar->cartesian
-> Chamfer / F-score. Training, ``evaluate``, int8 and the frozen external
radar encoder come in later slices and raise here.

The engine reads the same YAML as ``rald_tpu`` (``system.compute_dtype``,
``ar_model`` / ``lidar_ae`` with their ``overrides``, ``eval.inference``).
Models start from seeded random weights (:func:`init_random_weights`);
:meth:`GenerationEngine.load_state_dicts` loads real ones.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
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
        if inf.get("int8_ff", False) or inf.get("int8_attn", False):
            raise NotImplementedError("rald_torch: int8 inference is not ported yet")

        lidar = cfg.dataset.lidar
        self.model = get_generation_model(cfg.ar_model.name, mc, cfg.ar_model.get("overrides"))
        self.vae = get_ae_model(
            cfg.lidar_ae.name, N=int(lidar.num_samples), overrides=cfg.lidar_ae.get("overrides"),
        )
        gen = torch.Generator().manual_seed(self.seed)
        for m in (self.model, self.vae):
            init_random_weights(m, gen)
            m.to(device=self.device, dtype=dtype).eval().requires_grad_(False)

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
        values are cast to the engine's dtype and device."""
        for m, sd in ((self.model, edm_state_dict), (self.vae, vae_state_dict)):
            if sd is not None:
                m.load_state_dict({k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                                   for k, v in sd.items()})

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

    @torch.no_grad()
    def sample_from_cond(self, cond, seeds_or_prior):
        """35-NFE Heun sampling with the AdaLN mod table built once."""
        m = self.model
        latents = sample_prior_latents(seeds_or_prior, m.n_latents, m.channels, self.device)
        kw = self.sampler_kwargs
        t_steps = karras_sigmas(kw["num_steps"], kw["sigma_min"], kw["sigma_max"], kw["rho"],
                                device=self.device)
        table = stack_mod_table(m.compute_mod_table(t_steps[:-1]))

        def denoise_indexed(x, sigma, idx):
            return m.denoise_with_mods(x, sigma, unstack_mods(table[idx]), cond)

        return edm_sampler(denoise_indexed, latents, **kw)

    @torch.no_grad()
    def sample_tokens(self, radar_cube, seeds_or_prior):
        """Cube -> (B, n_latents, channels) f32 latent tokens. ``seeds_or_prior``
        is a list of integer seeds or an injected (B, M, C) prior draw."""
        return self.sample_from_cond(self.condition(radar_cube), seeds_or_prior)

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
