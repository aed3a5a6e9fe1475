"""CFAR helper-point caching: high-res cubes -> sparse polar points; the
port of ``rald_tpu/cli/cache_cfar.py``.

    python -m rald_torch.cli.cache_cfar --config configs/preprocess/coloradar_test_set.yml

Capability parity with ``dataset_preprocessor/cache_test_cfar.py``
(:77-178) and the HUST variant ``cache_test_cfar_hust_radar.py``
(:81-185, the same flow): per test frame, take the intensity channel of
the (128, 32, 16) high-res cube, trilinearly upsample it to (256, 256, 128),
pick a per-range-slice weighted budget of top-k peaks (8e5 in all), map the
indices to polar coordinates (arcsin angle axes with
``WAVELENGTH_TO_APERTURE_RATIO``), FOV-filter, and write
``single_chip/radar_cfar_low_thrd/%04d.bin``.

Upsample, budget, top-k and coordinates run on the card
(:func:`rald_torch.dsp.cfar_points.cfar_points_from_cube`; ``--device cpu``
runs them on the CPU), four frames at a time on threads; the FOV
compaction (a ragged output) stays on the host.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from rald_torch import geometry as geo
from rald_torch import resolve_device
from rald_torch.cli.preprocess_lidar import fov_limits
from rald_torch.config import load_config
from rald_torch.dsp.cfar_points import cfar_points_from_cube
from rald_torch.dsp.params import RadarParams
from rald_torch.utils.concurrent import thread_map


def run(cfg, mode: str = "sc", device=None) -> int:
    """Every test sequence's high-res cubes -> its helper points; returns
    the frame count."""
    dev = resolve_device(device)
    if mode != "sc":
        raise NotImplementedError("cascade radar is not supported (reference parity)")
    out_base = Path(cfg.output_dir)
    radar_cfg = cfg.single_chip_mode.radar
    cfar = radar_cfg.cfar
    r_in, a_in, e_in = int(cfar.input_r_dim), int(cfar.input_a_dim), int(cfar.input_e_dim)
    tgt = (int(cfar.tgt_r_dim), int(cfar.tgt_a_dim), int(cfar.tgt_e_dim))
    total = int(float(cfar.cfar_num_point))
    # max range from the radar chirp config (cache_test_cfar.py uses the
    # same derived quantity through read_radar_map_bin's config)
    max_range = RadarParams.from_yaml(radar_cfg.config).max_range
    limits = fov_limits(cfg.single_chip_mode.lidar.FOV)

    split_file = cfg.get("split_file")
    if split_file:
        with open(out_base / split_file) as f:
            seq_names = json.load(f)[cfg.get("split", "test")]
        seq_dirs = [out_base / s for s in seq_names]
    else:
        seq_dirs = [d for d in out_base.iterdir() if d.is_dir()]
    print(f"Caching CFAR points for {len(seq_dirs)} sequences")

    total_frames = 0
    for seq_dir in seq_dirs:
        cube_dir = seq_dir / "single_chip" / "radarcube_high_res"
        out_dir = seq_dir / "single_chip" / "radar_cfar_low_thrd"
        out_dir.mkdir(parents=True, exist_ok=True)
        files = sorted(cube_dir.glob("*.bin"))

        def work(f: Path):
            cube = np.fromfile(f, dtype=np.float32).reshape(r_in, a_in, e_in, -1)
            intensity = torch.from_numpy(np.ascontiguousarray(cube[..., 0])).to(dev)
            coords, _ = cfar_points_from_cube(intensity, *tgt, total, max_range)
            coords = geo.filter_points_polar(coords.cpu().numpy(), limits)
            coords.astype(np.float32).tofile(out_dir / f"{f.stem}.bin")

        thread_map(work, files, workers=4, desc=seq_dir.name)
        print(f"{seq_dir.name}: {len(files)} frames -> {out_dir}")
        total_frames += len(files)
    return total_frames


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rald_torch CFAR helper-point caching")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--mode", default="sc", choices=["sc", "cc"])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    return run(load_config(args.config), mode=args.mode, device=args.device)


if __name__ == "__main__":
    main()
