"""Offline inference: radar cube files -> dense point clouds (PLY), on the card.

The counterpart of ``rald_tpu/cli/infer.py``. It reads the same YAML as
``main_generation``'s eval mode, builds the engine once, streams cubes
through it in fixed-size batches (pad-last: the last batch repeats its last
cube, so every batch has the same shape), decodes the query grid,
thresholds the occupancy logits and writes one ``.ply`` per input file,
mirroring the inputs' directory structure below their common directory so
same-named frames of different sequences do not collide.

    python -m rald_torch.cli.infer --config configs/generation/..._eval.yml \\
        --input '/data/**/radar_cube/*.npy' --out ./pred --batch 8 [--device cpu]

Inputs: ``.npy`` radar cubes shaped like the dataset's raw cubes
``(r, a, e, c)``, or ``.npz`` archives holding one under ``radar_cube``.
Each cube gets the dataset's host preprocessing
(``rald_torch/data/radar_proc.py``, per ``dataset.radar``) unless
``--preprocessed``; a raw cube is upsampled on the card by the engine when
``dataset.radar.upsample_on_device`` is set. Frame ``i`` of the file list
samples from prior seed ``i``. Every inference key of the YAML applies
(``num_query_points``, ``use_cart_query``, ``cast_params_bf16``,
``int8_ff`` / ``int8_attn``, ``system.fast_inference``, the models'
``overrides``).

Weights: ``eval.ckpt``, ``lidar_ae.ckpt`` and, with the frozen external
radar encoder (which encodes each cube before sampling, as JAX's tool
does), ``radar_enc.ckpt`` are reference-layout ``.pth`` files, read as
``main_generation`` reads them; a missing one warns and samples seeded
random weights, as JAX does.

N processes (``torchrun --nproc_per_node=N -m rald_torch.cli.infer ...``, or
the same ``MASTER_ADDR`` / ``WORLD_SIZE`` / ``RANK`` environment) split the
file list: rank ``r`` takes files ``r, r + N, ...`` and writes their PLY
files, and each frame keeps the prior seed of its index in the whole list,
so its cloud does not depend on how many ranks share the job (JAX's
``rald_tpu/cli/infer.py:125-131``, ``:173``).

Where it differs from the JAX tool: ``shard_queries`` has nothing to shard
over (one card a process); an orbax checkpoint directory raises
``NotImplementedError`` (reading orbax is not ported).
"""
from __future__ import annotations

import argparse
import glob
import os
import time
from pathlib import Path

import numpy as np
import torch

from rald_torch import apply_matmul_precision
from rald_torch import geometry as geo
from rald_torch.cli.main_generation import join, load_eval_checkpoint, load_frozen_modules
from rald_torch.config import Config, load_config
from rald_torch.data.radar_proc import process_radar_cube
from rald_torch.eval.ply import write_ply
from rald_torch.eval.queries import build_query_grid
from rald_torch.train.gen_engine import GenerationEngine


def collect_inputs(pattern: str) -> list[Path]:
    p = Path(pattern)
    if p.is_dir():
        files = sorted(list(p.rglob("*.npy")) + list(p.rglob("*.npz")))
    else:
        files = sorted(Path(f) for f in glob.glob(pattern, recursive=True))
    if not files:
        raise FileNotFoundError(f"no .npy/.npz radar cubes match {pattern!r}")
    return files


def output_paths(files: list[Path], out: Path) -> list[Path]:
    """One .ply per input, mirroring the inputs' structure below their
    common directory."""
    base = Path(os.path.commonpath([str(f.parent) for f in files]))
    return [(out / f.parent.relative_to(base) / f.name).with_suffix(".ply") for f in files]


def load_cube(path: Path) -> np.ndarray:
    if path.suffix == ".npz":
        with np.load(path) as z:
            return np.asarray(z["radar_cube"], np.float32)
    return np.asarray(np.load(path), np.float32)


def query_grid(cfg: Config) -> np.ndarray:
    """The (num_query_points, 3) normalized grid every frame decodes, drawn
    from ``system.seed``."""
    ev = cfg.get("eval", {})
    num_query = int(ev.get("inference", {}).get("num_query_points", 500000))
    rng = np.random.default_rng(int(cfg.system.get("seed", 0)))
    return np.asarray(build_query_grid(cfg.dataset.lidar, num_query,
                                       bool(ev.get("use_cart_query", False)), rng), np.float32)


def preprocess(cube: np.ndarray, radar_cfg) -> np.ndarray:
    """The dataset's host transform of a raw cube (``dataset.radar``); the
    upsample is left to the card when ``upsample_on_device`` is set."""
    r = radar_cfg
    return process_radar_cube(
        cube,
        norm_intensity=r.norm_intensity,
        max_intensity=r.max_intensity,
        norm_dopp=r.norm_dopp,
        max_dopp=r.max_dopp,
        upsample=r.get("upsample", False) and not r.get("upsample_on_device", False),
        tgt_a=r.get("tgt_a_dim"),
        tgt_e=r.get("tgt_e_dim"),
    )


def run(cfg: Config, inputs: str, out_dir: str, batch: int = 0, threshold: float = 0.0,
        preprocessed: bool = False, device=None, engine: GenerationEngine | None = None,
        print_fn=print) -> dict:
    """Cubes matching ``inputs`` -> PLY files under ``out_dir``. ``engine``
    replaces the one built (and loaded) from ``cfg``, with its weights. Returns the
    file count, per-file point counts, mean points, seconds and frames/s
    (IO included). ``system.matmul_precision``, where set, is applied to the
    process first (:func:`rald_torch.apply_matmul_precision`), as JAX's CLI
    applies it; the engine itself changes no global state. Under a process
    group (joined first) the counts and times are this rank's, over its
    files ``rank::world``."""
    info = join(device, print_fn)
    world, rank = info["world_size"], info["rank"]
    if cfg.system.get("matmul_precision"):
        apply_matmul_precision(cfg.system.matmul_precision)
    if engine is None:
        engine = GenerationEngine(cfg, device=device)
        load_eval_checkpoint(cfg, engine, print_fn)
        load_frozen_modules(cfg, engine, print_fn)
    lidar = cfg.dataset.lidar
    aniso, iso = lidar.norm_anisotropy, lidar.norm_isotropy
    grid = query_grid(cfg)
    all_files = collect_inputs(inputs)
    # rank r: files r, r + world, ... (as ShardedSampler without shuffling)
    files = all_files[rank::world]
    outs = output_paths(all_files, Path(out_dir))[rank::world]
    if world > 1:
        print_fn(f"rank {rank}/{world}: {len(files)} files")
    bsz = batch or int(cfg.dataset.get("eval_batch_size", 1))

    def prep(cube: np.ndarray) -> np.ndarray:
        return cube if preprocessed else preprocess(cube, cfg.dataset.get("radar", {}))

    # the query grid goes to the card once
    grid_dev = torch.from_numpy(grid).to(engine.device)[None].expand(bsz, -1, -1)
    n_points = []
    t0 = time.perf_counter()
    for start in range(0, len(files), bsz):
        chunk = files[start:start + bsz]
        cubes = np.stack([prep(load_cube(f)) for f in chunk])
        if len(chunk) < bsz:  # pad-last: every batch has the same shape
            cubes = np.concatenate([cubes, np.repeat(cubes[-1:], bsz - len(chunk), axis=0)])
        if engine.frozen_radar_enc:
            cubes = engine.encode_radar(cubes)
        # seeds by index in the whole list, so a frame's cloud does not
        # depend on how many ranks share the job
        tokens = engine.sample_tokens(cubes, [i * world + rank for i in range(start, start + bsz)])
        hits = (engine.decode_queries(tokens, grid_dev) > threshold).cpu().numpy()
        for i, out_path in enumerate(outs[start:start + len(chunk)]):
            pred = geo.inverse_norm_points(grid[hits[i]], lidar.pc_range, aniso, iso)
            if lidar.get("view_cone_mode", False):
                pred = geo.polar2cartesian(pred) if len(pred) else pred.reshape(0, 3)
            write_ply(out_path, pred)
            n_points.append(len(pred))
    dt = time.perf_counter() - t0
    stats = {
        "files": len(files),
        "points": n_points,
        "mean_points": float(np.mean(n_points)) if n_points else 0.0,
        "seconds": dt,
        "frames_per_sec": len(files) / dt if dt > 0 else 0.0,
    }
    print_fn(
        f"* {stats['files']} point clouds -> {out_dir} "
        f"({stats['mean_points']:.0f} pts/frame mean, "
        f"{stats['frames_per_sec']:.2f} frames/s incl. IO)"
    )
    return stats


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--config", required=True)
    parser.add_argument("--input", required=True, help="directory or glob of .npy/.npz radar cubes")
    parser.add_argument("--out", required=True, help="output directory for .ply files")
    parser.add_argument("--batch", type=int, default=0,
                        help="batch size (default: dataset.eval_batch_size)")
    parser.add_argument("--threshold", type=float, default=0.0,
                        help="occupancy logit threshold (reference uses 0)")
    parser.add_argument("--preprocessed", action="store_true",
                        help="inputs were already processed by the dataset pipeline; "
                             "skip the host intensity/doppler normalization")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args()
    run(load_config(args.config), args.input, args.out, batch=args.batch,
        threshold=args.threshold, preprocessed=args.preprocessed, device=args.device)


if __name__ == "__main__":
    main()
