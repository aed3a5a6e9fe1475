"""Stage-2 generation entry point, eval mode: the port of
``rald_tpu/cli/main_generation.py``.

    python -m rald_torch.cli.main_generation --config configs/generation/ge_indoor_unfreeze_enc_ints_only_eval.yml

With ``system.mode: eval`` it reads the test split of the dataset (one run
per scene when ``dataset.split_file`` is a dict), batches it with
``pad_last``, loads the weights and runs :meth:`GenerationEngine.evaluate`,
which prints ``* iou … loss … cd … fscore`` and, with ``eval.store_pc``,
writes one PLY per frame. ``config.yml`` goes to ``system.output_dir``.

Weights are reference-layout ``.pth`` files (:mod:`rald_torch.train.checkpoint`):
``eval.ckpt`` (the EDM model), ``lidar_ae.ckpt`` (the frozen VAE) and,
with the frozen radar encoder, ``radar_enc.ckpt`` (a radar autoencoder,
of which the encoder is used). A missing file warns and leaves the
engine's seeded random weights, as JAX does; an orbax checkpoint
directory raises. ``system.mode: train`` is not ported yet and raises.
The run is one process on one card (``--device cpu`` runs the plain
versions on the CPU).
"""
from __future__ import annotations

import argparse
import copy
from pathlib import Path

from rald_torch import apply_matmul_precision
from rald_torch.config import Config, dump_config, expand_experiment_sweep, finalize_dirs, load_config
from rald_torch.data.loader import DataLoader, ShardedSampler
from rald_torch.data.registry import get_dataset
from rald_torch.train.checkpoint import load_torch_checkpoint, split_radar_autoencoder
from rald_torch.train.gen_engine import GenerationEngine


def build_eval_loader(cfg: Config, mode: str, print_fn=print) -> DataLoader:
    """The eval side of JAX's ``build_loaders`` for one process: the test
    split in eval mode (or with ``eval.use_test_set``), else the val split,
    ``eval_batch_size`` frames a batch, ``pad_last``; cached latents are
    never read on this side. ``train.use_cache_latent`` derives the
    dataset's cache keys from ``lidar_ae`` where they are absent, as JAX
    wires them for its train loader."""
    ds_cfg = cfg.dataset
    if bool(cfg.train.get("use_cache_latent", False)) and not ds_cfg.get("use_cache_latent"):
        ds_cfg.use_cache_latent = True
        ds_cfg.cache_latent_base_dir = str(cfg.lidar_ae.cache_path)
        ds_cfg.cache_latent_sub_dir = f"{cfg.lidar_ae.name}/{cfg.lidar_ae.cache_name}"
        print_fn(f"use_cache_latent: auto-wired dataset cache dir "
                 f"{ds_cfg.cache_latent_base_dir}/{ds_cfg.cache_latent_sub_dir}")
    eval_cfg = copy.deepcopy(ds_cfg)
    eval_cfg.use_cache_latent = False
    use_test = mode == "eval" or bool(cfg.get("eval", {}).get("use_test_set", False))
    test_set = get_dataset(eval_cfg, "test" if use_test else "val",
                           seed=int(cfg.system.get("seed", 0)))
    return DataLoader(
        test_set,
        batch_size=int(ds_cfg.get("eval_batch_size", 1)),
        sampler=ShardedSampler(len(test_set), 1, 0, shuffle=False),
        num_workers=int(ds_cfg.get("eval_num_workers", 1)),
        drop_last=False,
        pad_last=True,
    )


def _checkpoint(cfg: Config, key: str):
    section, name = key.split(".")
    path = cfg.get(section, {}).get(name)
    return Path(str(path)) if path and Path(str(path)).exists() else None


def load_eval_checkpoint(cfg: Config, engine: GenerationEngine, print_fn=print) -> None:
    """``eval.ckpt`` -> the EDM model, strictly; missing: random weights."""
    path = _checkpoint(cfg, "eval.ckpt")
    if path is None:
        print_fn("WARNING: eval.ckpt missing — sampling with random weights")
        return
    engine.load_state_dicts(edm_state_dict=load_torch_checkpoint(path))
    print_fn(f"Loaded generation checkpoint from {path}")


def load_frozen_modules(cfg: Config, engine: GenerationEngine, print_fn=print) -> None:
    """Frozen VAE (+ radar encoder) weights (JAX :74-115), from ``.pth``
    files, strictly. A radar autoencoder checkpoint gives its ``encoder.*``
    keys; its ``decoder.*`` keys are named and left unused."""
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
    sd, unused = split_radar_autoencoder(load_torch_checkpoint(path))
    engine.load_state_dicts(radar_enc_state_dict=sd)
    print_fn(f"Loaded frozen radar encoder from {path}")
    if unused:
        print_fn(f"radar_enc.ckpt: {len(unused)} decoder keys unused (the port has no "
                 f"RadarDecoder3D): {', '.join(unused[:4])}{', ...' if len(unused) > 4 else ''}")


def run(cfg: Config, device=None, engine: GenerationEngine | None = None, print_fn=print,
        stage_timer=None) -> dict:
    """One experiment (one scene of a sweep) in eval mode: returns the
    evaluate stats. ``system.matmul_precision``, where set, is applied to
    the process first, as JAX's CLI applies it. ``engine`` replaces the one
    built (and loaded) from ``cfg``; ``stage_timer`` goes to ``evaluate``."""
    mode = cfg.system.get("mode", "train")
    if mode != "eval":
        raise NotImplementedError(
            f"rald_torch.cli.main_generation: system.mode {mode!r} is not ported yet; only "
            "'eval' runs (training is ROADMAP A8)"
        )
    if cfg.system.get("matmul_precision"):
        apply_matmul_precision(cfg.system.matmul_precision)
    output_dir = Path(cfg.system.get("output_dir", "./result/generation"))
    output_dir.mkdir(parents=True, exist_ok=True)
    dump_config(cfg, output_dir / "config.yml")

    eval_loader = build_eval_loader(cfg, mode, print_fn)
    if engine is None:
        engine = GenerationEngine(cfg, device=device)
        n_params = sum(p.numel() for m in engine.modules() for p in m.parameters())
        print_fn(f"number of params (M): {n_params / 1e6:.2f}")
        load_eval_checkpoint(cfg, engine, print_fn)
        load_frozen_modules(cfg, engine, print_fn)
    return engine.evaluate(eval_loader, use_ema=bool(cfg.train.get("use_ema", False)),
                           print_fn=print_fn, stage_timer=stage_timer)


def main(argv=None) -> dict:
    """Every scene of the sweep in turn; returns ``{scene: stats}`` (the
    scene is None without a sweep)."""
    parser = argparse.ArgumentParser("rald_torch stage-2 generation (eval mode)")
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
