"""Latent-cache entry point: the port of ``rald_tpu/cli/main_cache.py:23-57``.

    python -m rald_torch.cli.main_cache --config configs/generation/ge_indoor_unfreeze_enc_ints_only.yml

Runs the frozen VAE (``lidar_ae.ckpt``, a ``.pth`` file; missing: seeded
random weights, with a warning) over the train split, queries on and
radar off, in order, and writes each frame's posterior latents as
``<lidar_ae.cache_path>/<lidar_ae.name>/<lidar_ae.cache_name>/<seq>/<frame>.npz``
(key ``res_tokens``), the layout ``train.use_cache_latent`` reads; prints
the decode IoU on the query points. Each frame's posterior noise is drawn
from its dataset index. One process on one card (``--device cpu`` runs on
the CPU), or N under ``torchrun --nproc_per_node=N -m
rald_torch.cli.main_cache ...``: each rank caches its shard of the frames
(the sampler pads the last shard with duplicates, which write the same
file with the same latents; every file is written aside and renamed), and
the union of the ranks' files is the one-process cache.
"""
from __future__ import annotations

import argparse
import datetime
import time
from pathlib import Path

from rald_torch import apply_matmul_precision
from rald_torch.cli.main_generation import join, load_frozen_modules
from rald_torch.config import finalize_dirs, load_config
from rald_torch.data.loader import DataLoader, ShardedSampler
from rald_torch.data.registry import get_dataset
from rald_torch.parallel.dist import world_rank
from rald_torch.train.gen_engine import GenerationEngine


def run(cfg, device=None, engine: GenerationEngine | None = None, print_fn=print) -> Path:
    """Write the cache; returns its directory. ``engine`` replaces the one
    built (and loaded) from ``cfg``. Under a process group (joined first)
    each rank caches its shard of the train split (JAX's
    ``rald_tpu/cli/main_cache.py:35``)."""
    join(device, print_fn)
    if cfg.system.get("matmul_precision"):
        apply_matmul_precision(cfg.system.matmul_precision)
    dataset = get_dataset(cfg.dataset, "train", seed=int(cfg.system.get("seed", 0)))
    dataset.set_load_query(True)
    dataset.set_load_radar(False)
    loader = DataLoader(
        dataset,
        batch_size=int(cfg.dataset.batch_size),
        sampler=ShardedSampler(len(dataset), *world_rank(), shuffle=False),
        num_workers=int(cfg.dataset.get("num_workers", 4)),
        drop_last=False,
    )
    if engine is None:
        engine = GenerationEngine(cfg, device=device)
        load_frozen_modules(cfg, engine, print_fn)
    cache_path = Path(cfg.lidar_ae.cache_path) / cfg.lidar_ae.name / cfg.lidar_ae.cache_name
    cache_path.mkdir(parents=True, exist_ok=True)
    print_fn(f"Cache path: {cache_path}")
    t0 = time.time()
    stats = engine.cache_latents(loader, cache_path, print_fn=print_fn)
    print_fn(f"Caching time {datetime.timedelta(seconds=int(time.time() - t0))} "
             f"iou={stats.get('iou')}")
    return cache_path


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser("rald_torch latent caching")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    return run(finalize_dirs(load_config(args.config)), device=args.device)


if __name__ == "__main__":
    main()
