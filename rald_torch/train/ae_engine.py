"""Stage-1 VAE engine: training and evaluation of the point-cloud VAE on
the card (``rald_tpu/train/ae_engine.py:50-291``).

- loss = ``vol_weight`` · BCE(logits[:, :k]) + ``near_weight`` ·
  BCE(logits[:, k:]) + 1e-3 · mean(KL), with ``k = in_voxel_num =
  int(num_samples * query_ratio)`` from the config; occupancy IoU and
  accuracy at logit 0 over every query (:meth:`AEEngine.loss_and_metrics`,
  JAX ``_loss_and_metrics`` :132-156);
- a train step (:meth:`AEEngine.train_step`, :158-165): the training
  forward (drop-path on, a posterior sample) and its gradients, then
  clip + AdamW + EMA 0.999 in a :class:`TrainState` of float32 masters
  whose working copy computes in ``system.compute_dtype``;
- :meth:`AEEngine.train_one_epoch` (:189-225) and :meth:`AEEngine.evaluate`
  (:227-291): per evaluated batch the loss / IoU / accuracy of one forward
  on the eval queries and, unless ``eval.iou_test_onlytest``, a second
  forward with another posterior draw on a fresh ``build_query_grid``
  (``eval.use_cart_query``), thresholded at 0, mapped back to metres
  (polar -> cartesian in ``view_cone_mode``) and scored by one
  ``chamfer_and_fscore_batch`` call.

Two VAEs, as JAX keeps ``model`` and ``model_eval``: ``train_model``,
built by :meth:`AEEngine.init_state` as the YAML builds it (plain modules,
JAX-init weights seeded from ``system.seed``), and ``model_eval``, with the
folded decode tail and, on the card, the fused FF kernel (row 1) when
``system.fast_inference`` is on (the default); :meth:`evaluate` loads a
state's params or EMA into it. Draws: a train step's posterior noise and
drop-path masks come from one generator seeded from (``system.seed``,
epoch, step), or are injected (``eps``, ``drop_masks``); an evaluated
batch's two posterior draws from :meth:`AEEngine.eval_eps`, which a test
may replace with JAX's.
"""
from __future__ import annotations

import math
import sys
from typing import Optional

import numpy as np
import torch

from rald_torch import geometry as geo
from rald_torch import resolve_device
from rald_torch.eval.chamfer import chamfer_and_fscore_batch
from rald_torch.eval.occupancy import occupancy_metrics
from rald_torch.eval.queries import build_query_grid
from rald_torch.models.registry import get_ae_model
from rald_torch.parallel.dist import all_reduce_mean_, draw_rows
from rald_torch.train.gen_engine import (
    bce_with_logits,
    init_train_weights,
    seeded_generator,
    torch_dtype,
)
from rald_torch.train.metrics import MetricLogger, epoch_1000x
from rald_torch.train.profiler import span, synced_ms
from rald_torch.train.schedule import scale_base_lr, warmup_cosine_schedule
from rald_torch.train.state import TrainState, global_norm, masters_of

KL_WEIGHT = 1e-3  # reference engine_ae.py:48


def _host(metrics: dict) -> dict:
    """0-d tensors -> floats, in one readback."""
    return dict(zip(metrics, torch.stack([v.float() for v in metrics.values()]).tolist()))


class AEEngine:
    def __init__(self, cfg, device=None, seed: Optional[int] = None, dtype=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.seed = int(cfg.system.get("seed", 0) if seed is None else seed)
        if dtype is None:
            dtype = getattr(torch, str(cfg.system.get("compute_dtype", "float32")))
        self.dtype = dtype

        lidar = cfg.dataset.lidar
        self.num_samples = int(lidar.num_samples)
        self.in_voxel_num = int(self.num_samples * float(lidar.query_ratio))
        self.fscore_tau = float(cfg.get("eval", {}).get("fscore_tau", 0.1))
        # the model is sized by lidar_ae.point_cloud_size (num_samples in the
        # shipped configs)
        self.n_model = int(cfg.lidar_ae.get("point_cloud_size", self.num_samples))
        self.model_eval = self._build()
        if bool(cfg.system.get("fast_inference", True)):  # JAX: fused FF where its kernel runs
            self.model_eval.set_flags(fold_decode_tail=True,
                                      use_fused_ff=self.device.type == "cuda")
        self.model_eval.to(device=self.device, dtype=self._dtype_of(self.model_eval))
        self.model_eval.eval().requires_grad_(False)

        t = cfg.train
        self.vol_weight = float(t.get("vol_weight", 0.1))
        self.near_weight = float(t.get("near_weight", 1.0))
        self.kl_weight = KL_WEIGHT
        self.ema_rate = 0.999
        self.clip_grad = float(t.get("clip_grad", 0) or 0)
        self.skip_nonfinite = bool(t.get("skip_nonfinite_updates", False))
        self.accum_iter = int(t.get("accum_iter", 1) or 1)
        self.epochs = int(t.epochs)
        self.warmup_epochs = float(t.get("warmup_epochs", 0))
        self.min_lr = float(t.get("min_lr", 0.0))
        self.train_model = None  # built by init_state
        self.lr_schedule = None

    def _build(self):
        lae = self.cfg.lidar_ae
        return get_ae_model(lae.name, N=self.n_model, overrides=lae.get("overrides"))

    def _dtype_of(self, model) -> torch.dtype:
        """A model's own ``dtype`` override, else the engine's compute dtype."""
        return torch_dtype(model.compute_dtype) or self.dtype

    # ------------------------------------------------------------------ setup
    def init_state(self, steps_per_epoch: int, world_batch: int) -> TrainState:
        """Build the training VAE (plain modules, JAX-init weights seeded
        from ``system.seed``) and its :class:`TrainState`: ``train.lr``,
        else ``blr`` scaled by the world batch, under the warmup-cosine
        schedule; clip, ``skip_nonfinite_updates`` and ``accum_iter`` from
        ``train``. A second call replaces the training model."""
        t = self.cfg.train
        lr = t.get("lr")
        if lr is None:
            lr = scale_base_lr(float(t.blr), world_batch, self.accum_iter, 1)
        self.lr_schedule = warmup_cosine_schedule(lr, self.min_lr, self.warmup_epochs, self.epochs,
                                                  steps_per_epoch)
        model = self._build()
        init_train_weights(model, torch.Generator().manual_seed(self.seed))
        params, working = masters_of(model.to(self.device), self._dtype_of(model))
        model.train().requires_grad_(True)  # JAX's deterministic=False: drop-path draws
        self.train_model = model
        return TrainState(params, self.lr_schedule, clip_grad=self.clip_grad,
                          skip_nonfinite=self.skip_nonfinite, accum_iter=self.accum_iter,
                          ema_rate=self.ema_rate, working=working)

    @staticmethod
    def param_count(state: TrainState) -> int:
        return sum(p.numel() for p in state.params.values())

    def step_generator(self, epoch: int, it: int) -> torch.Generator:
        """The generator of step ``it`` of ``epoch`` (the drop-path masks and
        the posterior noise, in forward order): seeded from (seed, epoch,
        it), as JAX folds them into its key."""
        return seeded_generator(self.device, self.seed, epoch, it)

    def eval_eps(self, it: int, which: int, shape) -> torch.Tensor:
        """Posterior noise of evaluated batch ``it``: ``which`` 0 for the
        metrics forward, 5 for the grid forward (JAX folds 0 and 5 into the
        batch's key ``fold_in(PRNGKey(seed + 7), it)``; torch's stream
        differs). Under a process group: this rank's rows of the draw at the
        global batch, as JAX draws at the sharded batch's shape."""
        gen = seeded_generator(self.device, self.seed + 7, it, which)
        return draw_rows(torch.randn, shape, generator=gen, device=self.device)

    def _to_dev(self, a) -> Optional[torch.Tensor]:
        if a is None:
            return None
        t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a, np.float32))
        return t.to(self.device, torch.float32)

    # ------------------------------------------------------------- train step
    def loss_and_metrics(self, model, batch, generator: Optional[torch.Generator] = None,
                         eps=None, drop_masks: Optional[dict] = None):
        """``(loss, metrics)`` of ``model`` on a batch (JAX
        ``_loss_and_metrics``): ``loss``, ``loss_vol``, ``loss_near``,
        ``loss_kl``, ``iou``, ``accuracy``, 0-d tensors."""
        out = model(self._to_dev(batch["lidar_points"]), self._to_dev(batch["query_points"]),
                    generator=generator, eps=self._to_dev(eps), drop_masks=drop_masks)
        logits, labels = out["logits"], self._to_dev(batch["query_labels"])
        k = self.in_voxel_num
        loss_vol = bce_with_logits(logits[:, :k], labels[:, :k])
        loss_near = bce_with_logits(logits[:, k:], labels[:, k:])
        loss_kl = out["kl"].mean()
        loss = self.vol_weight * loss_vol + self.near_weight * loss_near + self.kl_weight * loss_kl
        return loss, {"loss": loss, "loss_vol": loss_vol, "loss_near": loss_near,
                      "loss_kl": loss_kl, **occupancy_metrics(logits, labels)}

    def loss_and_grads(self, batch, generator: Optional[torch.Generator] = None, eps=None,
                       drop_masks: Optional[dict] = None, timings: Optional[dict] = None):
        """The training forward and its gradients: ``(metrics, {name: f32
        grad})``, the metrics detached. Under a process group the metrics and
        the gradients are the means over the ranks (one all-reduce), as JAX's
        come out of a step on the sharded global batch; the drop-path masks
        and the posterior noise are this rank's rows of the global draw."""
        model = self.train_model
        with synced_ms(timings, "forward_backward", self.device):
            with span("forward"):
                loss, metrics = self.loss_and_metrics(model, batch, generator, eps, drop_masks)
            with span("backward"):
                names, params = zip(*model.named_parameters())
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                grads = {k: torch.zeros_like(p, dtype=torch.float32) if g is None else g.float()
                         for k, p, g in zip(names, params, grads)}
        metrics = {k: v.detach().clone() for k, v in metrics.items()}
        with synced_ms(timings, "all_reduce", self.device):
            all_reduce_mean_([*metrics.values(), *grads.values()])
        return metrics, grads

    def train_step(self, state: TrainState, batch, generator: Optional[torch.Generator] = None,
                   eps=None, drop_masks: Optional[dict] = None, timings: Optional[dict] = None):
        """One step (JAX ``_train_step_impl``): loss and gradients, then
        ``state.apply_gradients``. Returns ``(state, metrics)`` with
        ``grad_norm``, taken before the clip. ``timings``, when a dict, gets
        the synchronised ms of ``forward_backward`` and ``optimizer`` (clip
        + AdamW + EMA + working-copy refresh), and each one's host ms under
        ``<stage>.host`` (:func:`synced_ms`)."""
        with span("train_step"):
            metrics, grads = self.loss_and_grads(batch, generator, eps, drop_masks, timings)
            with synced_ms(timings, "optimizer", self.device):
                with span("grad_norm"):
                    metrics["grad_norm"] = global_norm(grads.values())
                state.apply_gradients(grads)
        return state, metrics

    # ------------------------------------------------------------ epoch loops
    def train_one_epoch(self, state: TrainState, loader, epoch: int, log_writer=None,
                        print_fn=print):
        """One epoch over ``loader`` (JAX ``train_one_epoch``): per step the
        metrics and ``lr`` into the metric logger and the TensorBoard
        ``log_writer``. A non-finite loss stops the process (exit 1), or,
        with ``skip_nonfinite_updates``, warns (the update was skipped).
        Returns ``(state, averages)``."""
        logger = MetricLogger(print_fn=print_fn)
        steps = len(loader)
        for it, batch in enumerate(logger.log_every(iter(loader), 20, f"Epoch: [{epoch}]")):
            state, metrics = self.train_step(state, batch, self.step_generator(epoch, it))
            host = _host(metrics)
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
                for tag, key in (("loss", "loss"), ("vol_loss", "loss_vol"),
                                 ("near_loss", "loss_near"), ("kl_loss", "loss_kl"),
                                 ("iou", "iou"), ("accuracy", "accuracy"), ("norm", "grad_norm")):
                    log_writer.add_scalar(tag, host[key], x)
                log_writer.add_scalar("lr", lr, x)
        logger.synchronize_between_processes()
        print_fn(f"Averaged stats: {logger}")
        return state, logger.averages()

    def load_eval_params(self, state_or_params, use_ema: bool = False) -> None:
        """A :class:`TrainState`'s EMA (``use_ema``) or params, or a
        state_dict, into ``model_eval`` (cast to its dtype), strictly."""
        params = state_or_params
        if isinstance(params, TrainState):
            params = params.ema_params if use_ema else params.params
        self.model_eval.load_state_dict({k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
                                         for k, v in params.items()})

    @torch.no_grad()
    def evaluate(self, state_or_params, loader, use_ema: bool = False, print_fn=print) -> dict:
        """The eval loop (JAX ``evaluate``, reference engine_ae.py:157-290)
        over ``loader`` with the weights of ``state_or_params`` (see
        :meth:`load_eval_params`); returns the mean ``loss`` /
        ``loss_vol`` / ``loss_near`` / ``loss_kl`` / ``iou`` / ``accuracy``
        and, unless ``eval.iou_test_onlytest``, ``cd`` / ``fscore``. Only
        every ``eval.freq``-th batch is evaluated. Under a process group each
        rank evaluates its loader's shard and the means are over every rank's
        batches (JAX averages its jitted metrics over the global batch and
        keeps ``cd`` / ``fscore`` rank-local: ROADMAP C10)."""
        self.load_eval_params(state_or_params, use_ema)
        print_fn(f"Using {'EMA' if use_ema else 'model'} parameters for evaluation")
        cfg, model = self.cfg, self.model_eval
        ev = cfg.get("eval", {})
        eval_freq = int(ev.get("freq", 1) or 1)
        skip_cd = bool(ev.get("iou_test_onlytest", False))
        num_query = int(ev.get("inference", {}).get("num_query_points", 500000))
        use_cart_query = bool(ev.get("use_cart_query", False))
        lidar = cfg.dataset.lidar
        aniso, iso = lidar.norm_anisotropy, lidar.norm_isotropy
        rng = np.random.default_rng(self.seed)
        logger = MetricLogger(print_fn=print_fn)

        for it, batch in enumerate(logger.log_every(iter(loader), 50, "Test:")):
            if it % eval_freq != 0:
                continue
            surface = np.asarray(batch["lidar_points"])
            bsz = surface.shape[0]
            shape = (bsz, model.num_latents, model.latent_dim)
            _, metrics = self.loss_and_metrics(model, batch, eps=self.eval_eps(it, 0, shape))
            logger.update(**_host(metrics))
            if skip_cd:
                continue
            grid = build_query_grid(lidar, num_query, use_cart_query, rng)
            grid_b = self._to_dev(grid).expand(bsz, -1, -1)
            logits = model(self._to_dev(surface), grid_b, eps=self.eval_eps(it, 5, shape))["logits"]
            hits = (logits > 0).cpu().numpy()
            preds_xyz, gts_xyz = [], []
            for i in range(bsz):
                pred = geo.inverse_norm_points(grid[hits[i]], lidar.pc_range, aniso, iso)
                gt = geo.inverse_norm_points(surface[i], lidar.pc_range, aniso, iso)
                if lidar.get("view_cone_mode", False):
                    pred = geo.polar2cartesian(pred) if len(pred) else pred.reshape(0, 3)
                    gt = geo.polar2cartesian(gt)
                preds_xyz.append(pred)
                gts_xyz.append(gt)
            cds, fscores = chamfer_and_fscore_batch(preds_xyz, gts_xyz, self.fscore_tau,
                                                    device=self.device)
            logger.update(cd=float(np.mean(cds)), fscore=float(np.mean(fscores)))

        logger.synchronize_between_processes()
        stats = logger.averages()
        print_fn(
            "* iou {iou:.3f} loss {loss:.3f} cd {cd:.3f} fscore {f:.3f}".format(
                iou=stats.get("iou", 0.0), loss=stats.get("loss", 0.0),
                cd=stats.get("cd", -1.0), f=stats.get("fscore", -1.0),
            )
        )
        return stats
