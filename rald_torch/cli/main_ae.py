"""Stage-1 VAE entry point: the port of ``rald_tpu/cli/main_ae.py``.

    python -m rald_torch.cli.main_ae --config configs/ae/ae_indoor_aniso_mix_view_cone.yml

With ``system.mode: train`` (the default) it trains the VAE
(:meth:`AEEngine.train_one_epoch`) on the train split (a shuffled sampler
seeded from ``system.seed``, ``drop_last``, ``batch_size`` frames a step,
``train.lr`` or ``blr`` scaled by that batch). Every ``save_ckpt_freq``
epochs (and after the last) it writes ``checkpoint-{epoch}.pth``
(:class:`CheckpointManager`); every ``eval_freq`` epochs (and after the
last) it evaluates the params, or the EMA with ``train.use_ema``, on the
val split (``eval_batch_size`` frames a batch, ``pad_last``); each epoch
appends ``train_*`` / ``val_*`` / ``epoch`` to ``log.txt``, and the steps go
to TensorBoard under ``system.log_dir``. ``train.resume`` (a checkpoint
file) continues after its epoch.

With ``system.mode: eval`` it evaluates the weights of ``eval.ckpt`` on the
val split: a ``.pth`` file, a trainer checkpoint (its ``model_ema`` with
``train.use_ema``) or a reference ``KLAutoEncoder`` state_dict; None means
the latest checkpoint under ``system.output_dir``. An orbax checkpoint
directory (the JAX package's trainer writes them) raises, as a missing
file does.

Either mode snapshots the config into ``system.output_dir/config.yml``,
applies ``system.matmul_precision`` where set, and runs once per scene when
``dataset.split_file`` is a dict. One process runs on one card (``--device
cpu`` runs the plain versions on the CPU); N processes, one a card, under
``torchrun --nproc_per_node=N -m rald_torch.cli.main_ae --config ...`` (or
the same environment, as ``main_generation``): each rank trains and
evaluates on its shard of the split, the gradients and metrics are averaged
over the ranks, ``blr`` is scaled by the batch of all ranks, and rank 0
alone writes ``config.yml``, ``log.txt``, TensorBoard and the checkpoints.
"""
from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

from rald_torch import apply_matmul_precision
from rald_torch.config import Config, dump_config, expand_experiment_sweep, finalize_dirs, load_config
from rald_torch.data.loader import DataLoader, ShardedSampler
from rald_torch.cli.main_generation import join
from rald_torch.data.registry import get_dataset
from rald_torch.parallel.dist import world_rank
from rald_torch.train.ae_engine import AEEngine
from rald_torch.train.checkpoint import CheckpointManager, load_torch_checkpoint
from rald_torch.train.metrics import JsonlLogger, TensorBoardLogger

MODES = ("train", "eval")


def build_loaders(cfg: Config) -> tuple:
    """JAX's ``build_loaders``: ``(train loader, val loader, batch)``, each
    this rank's shard (the val loader with ``pad_last``), ``batch`` frames a
    train batch on each rank. The datasets load no radar cube: stage 1 reads none,
    and the shipped stage-1 YAMLs have no ``dataset.radar`` section (JAX's
    CLI loads the cubes and fails on them there). The cube is read after
    every draw of a frame, so the frames are the same either way."""
    ds_cfg = cfg.dataset
    seed = int(cfg.system.get("seed", 0))
    train_set = get_dataset(ds_cfg, "train", seed=seed)
    val_set = get_dataset(ds_cfg, "val", seed=seed)
    for ds in (train_set, val_set):
        ds.set_load_radar(False)
    batch = int(ds_cfg.batch_size)
    train_loader = DataLoader(
        train_set,
        batch_size=batch,
        sampler=ShardedSampler(len(train_set), *world_rank(), shuffle=True, seed=seed),
        num_workers=int(ds_cfg.get("num_workers", 4)),
        drop_last=True,
    )
    val_loader = DataLoader(
        val_set,
        batch_size=int(ds_cfg.get("eval_batch_size", 1)),
        sampler=ShardedSampler(len(val_set), *world_rank(), shuffle=False),
        num_workers=int(ds_cfg.get("eval_num_workers", 1)),
        drop_last=False,
        pad_last=True,
    )
    return train_loader, val_loader, batch


def eval_weights(cfg: Config, output_dir: Path) -> tuple:
    """``(state_dict, path)`` of ``eval.ckpt`` (the latest checkpoint under
    ``output_dir`` when None), ``model_ema`` with ``train.use_ema``."""
    path = cfg.get("eval", {}).get("ckpt")
    if path is None:
        epoch = CheckpointManager(output_dir).latest_epoch()
        if epoch is None:
            raise FileNotFoundError(f"No checkpoints under {output_dir}")
        path = output_dir / f"checkpoint-{epoch}.pth"
    path = Path(str(path))
    if not path.exists():
        raise FileNotFoundError(f"eval.ckpt {path} does not exist")
    return load_torch_checkpoint(path, ema=bool(cfg.train.get("use_ema", False))), path


def run(cfg: Config, device=None, engine: AEEngine | None = None, print_fn=print) -> dict:
    """One experiment (one scene of a sweep) in its ``system.mode``: returns
    the evaluate stats (in train mode those of the last evaluation, or
    {}). ``engine`` replaces the one built from ``cfg``. The process joins
    the process group the environment describes first."""
    mode = cfg.system.get("mode", "train")
    if mode not in MODES:
        raise NotImplementedError(
            f"rald_torch.cli.main_ae: unknown system.mode {mode!r} (one of {MODES})")
    info = join(device, print_fn)
    if cfg.system.get("matmul_precision"):
        apply_matmul_precision(cfg.system.matmul_precision)
    output_dir = Path(cfg.system.get("output_dir", "./result/ae"))
    output_dir.mkdir(parents=True, exist_ok=True)
    if info["is_main_process"]:
        dump_config(cfg, output_dir / "config.yml")

    train_loader, val_loader, batch = build_loaders(cfg)
    if engine is None:
        engine = AEEngine(cfg, device=device)
    use_ema = bool(cfg.train.get("use_ema", False))
    if mode == "eval":
        params, path = eval_weights(cfg, output_dir)
        print_fn(f"Loaded VAE weights from {path}")
        return engine.evaluate(params, val_loader, use_ema=use_ema, print_fn=print_fn)

    t = cfg.train
    state = engine.init_state(len(train_loader), batch * info["world_size"])
    print_fn(f"number of params (M): {engine.param_count(state) / 1e6:.2f}")
    ckpt = CheckpointManager(output_dir)
    jsonl = JsonlLogger(output_dir, enabled=info["is_main_process"])
    tb = TensorBoardLogger(cfg.system.get("log_dir"), enabled=info["is_main_process"])

    start_epoch = 0
    if t.get("resume"):
        state, last_epoch = ckpt.restore(state, str(t.resume))
        start_epoch = last_epoch + 1
        print_fn(f"resumed from epoch {last_epoch}")

    epochs = int(t.epochs)
    save_freq = int(t.get("save_ckpt_freq", 10))
    eval_freq = int(t.get("eval_freq", 0) or 0)
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
            stats = engine.evaluate(state, val_loader, use_ema=use_ema, print_fn=print_fn)
            log.update({f"val_{k}": v for k, v in stats.items()})
        log.update({"epoch": epoch})
        jsonl.write(log)
    tb.flush()
    print_fn(f"Training time {datetime.timedelta(seconds=int(time.time() - t0))}")
    return stats


def main(argv=None) -> dict:
    """Every scene of the sweep in turn; returns ``{scene: stats}`` (the
    scene is None without a sweep)."""
    parser = argparse.ArgumentParser("rald_torch stage-1 VAE (train / eval)")
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
