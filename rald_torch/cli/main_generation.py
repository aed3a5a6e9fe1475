"""Stage-2 generation entry point: the port of ``rald_tpu/cli/main_generation.py``.

    python -m rald_torch.cli.main_generation --config configs/generation/ge_indoor_unfreeze_enc_ints_only.yml

With ``system.mode: train`` (the default) it trains the DiT
(:meth:`GenerationEngine.train_one_epoch`) on the train split: a shuffled
sampler seeded from ``system.seed``, ``drop_last``, no query points,
latents from the frozen VAE or, with ``train.use_cache_latent``, from the
cache ``python -m rald_torch.cli.main_cache`` writes. Every
``save_ckpt_freq`` epochs (and after the last) it writes
``checkpoint-{epoch}.pth`` (:class:`CheckpointManager`); every
``eval_freq`` epochs (and after the last) it evaluates the EMA weights
(``train.use_ema``) on the val split, or the test split with
``eval.use_test_set``; each epoch appends ``train_*`` / ``val_*`` /
``epoch`` to ``log.txt``, and the steps go to TensorBoard under
``system.log_dir``. ``train.resume`` (a checkpoint file) continues after
its epoch.

With ``system.mode: eval`` it reads the test split of the dataset (one run
per scene when ``dataset.split_file`` is a dict), batches it with
``pad_last``, loads the weights and runs :meth:`GenerationEngine.evaluate`,
which prints ``* iou … loss … cd … fscore`` and, with ``eval.store_pc``,
writes one PLY per frame. ``config.yml`` goes to ``system.output_dir``.

Weights are ``.pth`` files (:mod:`rald_torch.train.checkpoint`):
``eval.ckpt`` (the EDM model: a reference file, or a trainer checkpoint,
whose ``model_ema`` is read with ``train.use_ema``), ``lidar_ae.ckpt``
(the frozen VAE) and, with the frozen radar encoder, ``radar_enc.ckpt`` (a
radar autoencoder, of which the encoder is used). A missing file warns and
leaves the engine's seeded random weights, as JAX does; an orbax
checkpoint directory raises.

One process runs on one card (``--device cpu`` runs the plain versions on
the CPU). N processes, one a card, run under ``torchrun`` (or the same
``MASTER_ADDR`` / ``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK`` environment;
:func:`rald_torch.parallel.init_distributed`; NCCL on the cards, gloo with
``--device cpu``):

    torchrun --nproc_per_node=N -m rald_torch.cli.main_generation --config ...

Each rank reads its shard of the split (``ShardedSampler``), the
gradients are averaged over the ranks every step, ``blr`` is scaled by the
batch of all ranks, and rank 0 alone writes ``config.yml``, ``log.txt``,
TensorBoard and the checkpoints; in eval mode each rank evaluates its shard
and the metrics are averaged over all of them. With
``eval.inference.shard_queries`` the ranks evaluate every batch together
instead: each reads the whole split, rank 0 samples, each rank decodes its
part of the queries (``GenerationEngine.decode_logits``), every rank holds
the one-process metrics and rank 0 alone writes.
"""
from __future__ import annotations

import argparse
import copy
import datetime
import time
from pathlib import Path

from rald_torch import apply_matmul_precision
from rald_torch.config import Config, dump_config, expand_experiment_sweep, finalize_dirs, load_config
from rald_torch.data.loader import DataLoader, ShardedSampler
from rald_torch.data.registry import get_dataset
from rald_torch.parallel.dist import backend, init_distributed, local_device, world_rank
from rald_torch.train.checkpoint import (
    CheckpointManager,
    load_torch_checkpoint,
    split_radar_autoencoder,
)
from rald_torch.train.gen_engine import GenerationEngine
from rald_torch.train.metrics import JsonlLogger, TensorBoardLogger

MODES = ("train", "eval")


def _wire_cache(cfg: Config, print_fn=print) -> None:
    """``train.use_cache_latent`` derives the dataset's cache keys from
    ``lidar_ae`` where they are absent (the layout ``main_cache`` writes:
    ``cache_path / name / cache_name``), as JAX wires them."""
    ds_cfg = cfg.dataset
    if bool(cfg.train.get("use_cache_latent", False)) and not ds_cfg.get("use_cache_latent"):
        ds_cfg.use_cache_latent = True
        ds_cfg.cache_latent_base_dir = str(cfg.lidar_ae.cache_path)
        ds_cfg.cache_latent_sub_dir = f"{cfg.lidar_ae.name}/{cfg.lidar_ae.cache_name}"
        print_fn(f"use_cache_latent: auto-wired dataset cache dir "
                 f"{ds_cfg.cache_latent_base_dir}/{ds_cfg.cache_latent_sub_dir}")


def build_train_loader(cfg: Config, print_fn=print) -> DataLoader:
    """The train side of JAX's ``build_loaders``: the train split without
    query points, ``batch_size`` frames a batch on each rank, this rank's
    shard of a shuffle seeded from ``system.seed`` (its epoch set per
    epoch), ``drop_last``; cached latents with ``train.use_cache_latent``."""
    _wire_cache(cfg, print_fn)
    ds_cfg = cfg.dataset
    seed = int(cfg.system.get("seed", 0))
    train_set = get_dataset(ds_cfg, "train", seed=seed)
    train_set.set_load_query(False)
    return DataLoader(
        train_set,
        batch_size=int(ds_cfg.batch_size),
        sampler=ShardedSampler(len(train_set), *world_rank(), shuffle=True, seed=seed),
        num_workers=int(ds_cfg.get("num_workers", 4)),
        drop_last=True,
    )


def build_eval_loader(cfg: Config, mode: str, print_fn=print) -> DataLoader:
    """The eval side of JAX's ``build_loaders``: this rank's shard of the
    test split in eval mode (or with ``eval.use_test_set``), else of the val
    split, ``eval_batch_size`` frames a batch, ``pad_last``; cached latents
    are never read on this side. With ``eval.inference.shard_queries`` every
    rank reads the whole split: the ranks evaluate each batch together."""
    _wire_cache(cfg, print_fn)
    ds_cfg = cfg.dataset
    eval_cfg = copy.deepcopy(ds_cfg)
    eval_cfg.use_cache_latent = False
    use_test = mode == "eval" or bool(cfg.get("eval", {}).get("use_test_set", False))
    test_set = get_dataset(eval_cfg, "test" if use_test else "val",
                           seed=int(cfg.system.get("seed", 0)))
    shard_queries = bool(cfg.get("eval", {}).get("inference", {}).get("shard_queries", False))
    return DataLoader(
        test_set,
        batch_size=int(ds_cfg.get("eval_batch_size", 1)),
        sampler=ShardedSampler(len(test_set), *((1, 0) if shard_queries else world_rank()),
                               shuffle=False),
        num_workers=int(ds_cfg.get("eval_num_workers", 1)),
        drop_last=False,
        pad_last=True,
    )


def _checkpoint(cfg: Config, key: str):
    section, name = key.split(".")
    path = cfg.get(section, {}).get(name)
    return Path(str(path)) if path and Path(str(path)).exists() else None


def load_eval_checkpoint(cfg: Config, engine: GenerationEngine, print_fn=print) -> None:
    """``eval.ckpt`` -> the EDM model, strictly (a trainer checkpoint's
    ``model_ema`` with ``train.use_ema``); missing: random weights."""
    path = _checkpoint(cfg, "eval.ckpt")
    if path is None:
        print_fn("WARNING: eval.ckpt missing — sampling with random weights")
        return
    engine.load_state_dicts(edm_state_dict=load_torch_checkpoint(
        path, ema=bool(cfg.train.get("use_ema", False))))
    print_fn(f"Loaded generation checkpoint from {path}")


def load_frozen_modules(cfg: Config, engine: GenerationEngine, print_fn=print) -> None:
    """Frozen VAE (+ radar encoder) weights (JAX :74-115), from ``.pth``
    files, strictly. A radar autoencoder checkpoint gives its encoder half
    (:func:`split_radar_autoencoder`): conditioning never decodes, so the
    engine holds no decoder."""
    path = _checkpoint(cfg, "lidar_ae.ckpt")
    if path is not None:
        engine.load_state_dicts(vae_state_dict=load_torch_checkpoint(path))
        print_fn(f"Loaded frozen VAE from {path}")
    else:
        print_fn("WARNING: lidar_ae.ckpt missing — using randomly initialized frozen VAE")
    if not engine.frozen_radar_enc:
        return
    path = _checkpoint(cfg, "radar_enc.ckpt")
    if path is None:
        print_fn("WARNING: radar_enc.ckpt missing — using randomly initialized encoder")
        return
    engine.load_state_dicts(radar_enc_state_dict=split_radar_autoencoder(load_torch_checkpoint(path))[0])
    print_fn(f"Loaded frozen radar encoder from {path}")


def run(cfg: Config, device=None, engine: GenerationEngine | None = None, print_fn=print,
        stage_timer=None) -> dict:
    """One experiment (one scene of a sweep) in its ``system.mode``: returns
    the evaluate stats (in train mode those of the last evaluation, or {}).
    ``system.matmul_precision``, where set, is applied to the process
    first, as JAX's CLI applies it. ``engine`` replaces the one built from
    ``cfg`` (in eval mode also its loading); ``stage_timer`` goes to
    ``evaluate`` in eval mode. The process joins the process group the
    environment describes first (:func:`join`)."""
    mode = cfg.system.get("mode", "train")
    if mode not in MODES:
        raise NotImplementedError(
            f"rald_torch.cli.main_generation: unknown system.mode {mode!r} (one of {MODES})")
    info = join(device, print_fn)
    if cfg.system.get("matmul_precision"):
        apply_matmul_precision(cfg.system.matmul_precision)
    output_dir = Path(cfg.system.get("output_dir", "./result/generation"))
    output_dir.mkdir(parents=True, exist_ok=True)
    if info["is_main_process"]:
        dump_config(cfg, output_dir / "config.yml")
    if mode == "eval":
        eval_loader = build_eval_loader(cfg, mode, print_fn)
        if engine is None:
            engine = _build_engine(cfg, device, print_fn)
            load_eval_checkpoint(cfg, engine, print_fn)
            load_frozen_modules(cfg, engine, print_fn)
        return engine.evaluate(eval_loader, use_ema=bool(cfg.train.get("use_ema", False)),
                               print_fn=print_fn, stage_timer=stage_timer)
    return train(cfg, output_dir, device, engine, print_fn)


def join(device=None, print_fn=print) -> dict:
    """:func:`init_distributed` on ``device`` (default: ``cuda:{LOCAL_RANK}``)
    and, under a process group, one line naming rank, world, backend and
    device; returns the process info."""
    info = init_distributed(device)
    if backend() is not None:
        print_fn(f"distributed: rank {info['rank']}/{info['world_size']} backend {backend()} "
                 f"device {local_device(device)}")
    return info


def _build_engine(cfg: Config, device, print_fn) -> GenerationEngine:
    engine = GenerationEngine(cfg, device=device)
    n_params = sum(p.numel() for m in engine.modules() for p in m.parameters())
    print_fn(f"number of params (M): {n_params / 1e6:.2f}")
    return engine


def train(cfg: Config, output_dir: Path, device=None, engine: GenerationEngine | None = None,
          print_fn=print) -> dict:
    """The train loop (JAX ``run``'s train branch, :130-178): every rank
    trains on its shard; rank 0 logs and writes the checkpoints."""
    t = cfg.train
    world, rank = world_rank()
    train_loader = build_train_loader(cfg, print_fn)
    eval_freq = int(t.get("eval_freq", 0) or 0)
    eval_loader = build_eval_loader(cfg, "train", print_fn) if eval_freq else None
    if engine is None:
        engine = _build_engine(cfg, device, print_fn)
    state = engine.init_state(len(train_loader), int(cfg.dataset.batch_size) * world)
    print_fn(f"number of trained params (M): "
             f"{sum(p.numel() for p in state.params.values()) / 1e6:.2f}")
    load_frozen_modules(cfg, engine, print_fn)
    ckpt = CheckpointManager(output_dir)
    jsonl = JsonlLogger(output_dir, enabled=rank == 0)
    tb = TensorBoardLogger(cfg.system.get("log_dir"), enabled=rank == 0)

    start_epoch = 0
    if t.get("resume") and Path(str(t.resume)).exists():
        state, last_epoch = ckpt.restore(state, str(t.resume))
        start_epoch = last_epoch + 1
        print_fn(f"resumed from epoch {last_epoch}")

    epochs = int(t.epochs)
    save_freq = int(t.get("save_ckpt_freq", 10))
    use_ema = bool(t.get("use_ema", False))
    t0 = time.time()
    stats = {}
    for epoch in range(start_epoch, epochs):
        train_loader.set_epoch(epoch)
        state, train_stats = engine.train_one_epoch(state, train_loader, epoch, log_writer=tb,
                                                    print_fn=print_fn)
        if (epoch + 1) % save_freq == 0 or epoch + 1 == epochs:
            ckpt.save(state, epoch)
        log = {f"train_{k}": v for k, v in train_stats.items()}
        if eval_freq and ((epoch + 1) % eval_freq == 0 or epoch + 1 == epochs):
            stats = engine.evaluate(eval_loader, use_ema=use_ema, print_fn=print_fn,
                                    state_or_params=state)
            log.update({f"val_{k}": v for k, v in stats.items()})
        log.update({"epoch": epoch})
        jsonl.write(log)
    tb.flush()
    print_fn(f"Training time {datetime.timedelta(seconds=int(time.time() - t0))}")
    return stats


def main(argv=None) -> dict:
    """Every scene of the sweep in turn; returns ``{scene: stats}`` (the
    scene is None without a sweep)."""
    parser = argparse.ArgumentParser("rald_torch stage-2 generation (train / eval)")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    cfg = finalize_dirs(load_config(args.config))
    results = {}
    for scene, sub in expand_experiment_sweep(cfg):
        if scene:
            print(f"=== scene sweep: {scene} ===")
        results[scene] = run(sub, device=args.device)
    return results


if __name__ == "__main__":
    main()
