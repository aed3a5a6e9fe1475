"""LiDAR preprocessing: raw scans -> FOV-cropped ground truth; the port of
``rald_tpu/cli/preprocess_lidar.py``.

    python -m rald_torch.cli.preprocess_lidar --config configs/preprocess/coloradar.yml [--dataset hust]

Capability parity with ``dataset_preprocessor/lidar.py`` (:123-194) and the
HUST variant ``lidar_hustradar.py`` (:102-151): per aligned frame, load the
4-attribute ``.bin`` scan, drop zero returns, rigid-transform into the radar
frame (``T_RADAR_TO_LIDAR`` / ``HUST_T_LIDAR_TO_SINGLE_CHIP``), crop to the
radar FOV in polar coordinates, write ``lidar_sc/%04d.bin`` float32 xyz.
Alignment indices from ``lidar/lidar_index_sequence.txt`` (ColoRadar) /
``lidar_index_sequence.txt`` (HUST).

Numpy on the host, as in JAX: this is IO-bound, and its output is bitwise
JAX's. ``--device`` is resolved as in the other preprocessing CLIs (the
card unless ``cpu``).
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rald_torch import geometry as geo
from rald_torch import resolve_device
from rald_torch.config import load_config
from rald_torch.constants import (
    EXCLUDE_DIR_NAMES,
    HUST_DIR_NAMES,
    HUST_T_LIDAR_TO_SINGLE_CHIP,
    NUMBER_RECORDING_ATTRIBUTES,
    T_RADAR_TO_LIDAR,
)
from rald_torch.utils.concurrent import thread_map


def load_lidar_scan(path: Path, num_attrs: int = NUMBER_RECORDING_ATTRIBUTES) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32).reshape(-1, num_attrs)[:, :3]


def fov_limits(fov) -> list:
    """``[[0, max_range], az_range, el_range]`` of a config's ``FOV``."""
    return [
        [0.0, float(fov.max_range)],
        [float(fov.az_range[0]), float(fov.az_range[1])],
        [float(fov.el_range[0]), float(fov.el_range[1])],
    ]


def process_frame(points: np.ndarray, transform: np.ndarray, fov) -> np.ndarray:
    """zero-drop -> rigid transform -> polar FOV crop -> cartesian
    (reference lidar.py:173-190)."""
    points = geo.remove_empty_points(points)
    points = geo.transform_points(points, transform)
    polar = geo.filter_points_polar(geo.cartesian2polar(points), fov_limits(fov))
    return geo.polar2cartesian(polar).astype(np.float32)


def process_sequence(seq_dir: Path, out_dir: Path, cfg, dataset: str, io_workers: int = 8) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    if dataset == "coloradar":
        lidar_dir = seq_dir / "lidar" / "pointclouds"
        index_file = seq_dir / "lidar" / "lidar_index_sequence.txt"
        transform = T_RADAR_TO_LIDAR
        files = sorted(lidar_dir.glob("*.bin"), key=lambda x: int(x.stem.split("_")[-1]))
    else:  # hust
        lidar_dir = seq_dir / "lidar"
        index_file = seq_dir / "lidar_index_sequence.txt"
        transform = HUST_T_LIDAR_TO_SINGLE_CHIP
        files = sorted(lidar_dir.glob("*.bin"), key=lambda x: float(x.stem.split("_")[-1]))

    with open(index_file) as f:
        lindex = [int(line) for line in f if line.strip()]
    fov = cfg.single_chip_mode.lidar.FOV

    def work(i):
        out = process_frame(load_lidar_scan(files[lindex[i]]), transform, fov)
        out.tofile(out_dir / f"{i:04d}.bin")

    thread_map(work, range(len(lindex)), workers=io_workers, desc=seq_dir.name)
    return len(lindex)


def run(cfg, mode: str = "sc", dataset: str = "coloradar", device=None) -> int:
    """Every sequence under ``root_dir`` -> ``output_dir/<seq>/lidar_sc``;
    returns the frame count."""
    resolve_device(device)
    if mode != "sc":
        raise NotImplementedError("cascade radar is not supported (reference parity)")
    dataset_dir = Path(cfg.root_dir)
    out_base = Path(cfg.output_dir)
    if dataset == "hust":
        seq_dirs = [d for d in dataset_dir.iterdir() if d.is_dir() and d.name in HUST_DIR_NAMES]
    else:
        seq_dirs = [
            d for d in dataset_dir.iterdir() if d.is_dir() and d.name not in EXCLUDE_DIR_NAMES
        ]
    print(f"Found {len(seq_dirs)} sequences in {dataset_dir}")
    total = 0
    for seq_dir in seq_dirs:
        out_dir = out_base / seq_dir.name / "lidar_sc"
        n = process_sequence(seq_dir, out_dir, cfg, dataset)
        print(f"{seq_dir.name}: {n} frames -> {out_dir}")
        total += n
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rald_torch lidar preprocessing")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--mode", default="sc", choices=["sc", "cc"])
    parser.add_argument("--dataset", default="coloradar", choices=["coloradar", "hust"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs without one)")
    args = parser.parse_args(argv)
    return run(load_config(args.config), mode=args.mode, dataset=args.dataset, device=args.device)


if __name__ == "__main__":
    main()
