"""Voxel-cache dumping: pre-voxelize LiDAR frames into ``.npy`` dicts; the
port of ``rald_tpu/cli/dump_voxel.py``.

    python -m rald_torch.cli.dump_voxel --config configs/preprocess/coloradar.yml --mode sc_cone

Capability parity with ``dataset_preprocessor/dump_voxel.py`` (:43-158):
for each sequence, voxelize every ``lidar_sc/*.bin`` frame (cartesian, or
polar "cone" mode for ``--mode sc_cone``) into
``{cone,voxel}_{sc,cc}_<vx>_<vy>_<vz>/<frame>.npy`` dicts with keys
``voxels`` / ``voxel_coords`` / ``voxel_num_points``, written under
``voxel_output_dir`` and symlinked into the dataset tree: the caches that
``dataset.lidar.cache_voxel: true`` reads. Voxelizes with the port's numpy
voxelizer on the host, as JAX's tool does with its own; ``--device`` is
resolved as in the other preprocessing CLIs (the card unless ``cpu``).
"""
from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from rald_torch import geometry as geo
from rald_torch import resolve_device
from rald_torch.config import load_config
from rald_torch.data.voxelizer import voxelize
from rald_torch.utils.concurrent import thread_map


def dir_name(mode: str, voxel_size) -> str:
    kind = "cone" if mode == "sc_cone" else "voxel"
    chip = "cc" if mode == "cc" else "sc"
    vs = [round(float(v), 2) for v in voxel_size]
    return f"{kind}_{chip}_{vs[0]}_{vs[1]}_{vs[2]}"


def voxelize_sequence(seq_dir: Path, voxel_dir: Path, link_dir: Path, cfg, mode: str) -> int:
    lidar_dir = seq_dir / ("lidar_cc" if mode == "cc" else "lidar_sc")
    if not lidar_dir.exists():
        raise ValueError(f"lidar_dir {lidar_dir} not exists")
    voxel_dir.mkdir(parents=True, exist_ok=True)
    lidar_cfg = cfg.single_chip_mode.lidar
    files = sorted(lidar_dir.glob("*.bin"))

    def work(f: Path):
        out = voxel_dir / f"{f.stem}.npy"
        if out.exists():
            return
        pts = np.fromfile(f, dtype=np.float32).reshape(-1, 3)
        if len(pts) == 0:
            print(f"Skipping empty lidar file {f}")
            return
        if mode == "sc_cone":
            pts = geo.cartesian2polar(pts).astype(np.float32)
        grid = voxelize(
            pts,
            lidar_cfg.voxel_size,
            lidar_cfg.pc_range,
            lidar_cfg.voxel_max_num_points,
            lidar_cfg.max_voxels,
        )
        np.save(
            out,
            {
                "voxels": grid.voxels,
                "voxel_coords": grid.coords,
                "voxel_num_points": grid.num_points,
            },
        )

    thread_map(work, files, workers=8, desc=seq_dir.name)

    if not link_dir.exists():
        os.symlink(voxel_dir, link_dir)
    return len(files)


def run(cfg, mode: str = "sc_cone", device=None) -> int:
    """Every sequence under ``output_dir`` -> its voxel cache; returns the
    frame count."""
    resolve_device(device)
    dataset_base = Path(cfg.output_dir)
    voxel_output = Path(cfg.voxel_output_dir)
    name = dir_name(mode, cfg.single_chip_mode.lidar.voxel_size)
    seq_dirs = [d for d in dataset_base.iterdir() if d.is_dir()]
    print(f"Found {len(seq_dirs)} sequences in {dataset_base}")
    total = 0
    for seq_dir in seq_dirs:
        total += voxelize_sequence(
            seq_dir, voxel_output / seq_dir.name / name, seq_dir / name, cfg, mode
        )
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rald_torch voxel cache dump")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--mode", default="sc_cone", choices=["sc", "cc", "sc_cone"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs without one)")
    args = parser.parse_args(argv)
    return run(load_config(args.config), mode=args.mode, device=args.device)


if __name__ == "__main__":
    main()
