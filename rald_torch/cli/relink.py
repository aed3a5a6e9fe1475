"""Dataset relinker: the port of ``rald_tpu/cli/relink.py`` (reference
``dataset_preprocessor/relink_coloradar.py:9-30``).

    python -m rald_torch.cli.relink --src /data/coloradar_raw --dst /data/coloradar

Symlinks each sequence's ``cascade``, ``groundtruth``, ``imu``, ``lidar``
and ``single_chip`` directories, and the top-level ``calib``, into a
working tree. File-system work on the host; ``--device`` is resolved as in
the other preprocessing CLIs (the card unless ``cpu``).
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rald_torch import resolve_device

BASE_DIR_NAMES = ["cascade", "groundtruth", "imu", "lidar", "single_chip"]
EXCLUDE_DIR_NAMES = ["ColoRadar_tools-master", "zip"]
SPECIAL_DIR_NAMES = ["calib"]


def create_baselink(src_dir: Path, dst_dir: Path) -> int:
    seq_dirs = [
        d
        for d in src_dir.iterdir()
        if d.is_dir() and d.name not in EXCLUDE_DIR_NAMES and d.name not in SPECIAL_DIR_NAMES
    ]
    print(f"Found {len(seq_dirs)} sequences in {src_dir}")
    for seq_dir in seq_dirs:
        dst_seq = dst_dir / seq_dir.name
        dst_seq.mkdir(parents=True, exist_ok=True)
        for name in BASE_DIR_NAMES:
            dst = dst_seq / name
            if not dst.exists():
                dst.symlink_to(seq_dir / name, target_is_directory=True)
    for name in SPECIAL_DIR_NAMES:
        dst = dst_dir / name
        if not dst.exists():
            dst.symlink_to(src_dir / name, target_is_directory=True)
    return len(seq_dirs)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rald_torch dataset relinker")
    parser.add_argument("--src", required=True, type=str)
    parser.add_argument("--dst", required=True, type=str)
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs without one)")
    args = parser.parse_args(argv)
    resolve_device(args.device)
    return create_baselink(Path(args.src), Path(args.dst))


if __name__ == "__main__":
    main()
