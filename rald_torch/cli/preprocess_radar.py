"""Radar DSP preprocessing: raw ADC -> RAE intensity / velocity cubes; the
port of ``rald_tpu/cli/preprocess_radar.py``.

    python -m rald_torch.cli.preprocess_radar --config configs/preprocess/coloradar.yml
    python -m rald_torch.cli.preprocess_radar --config configs/preprocess/coloradar_test_set.yml --test-set

Capability parity with ``dataset_preprocessor/radar.py`` (:118-172, train
cubes into ``single_chip/radarcube_raw``) and ``radar_test_set.py``
(:137-202, ``--test-set``: high-res 32x16 angle FFTs into
``single_chip/radarcube_high_res``, test split only, ``.npy`` ADC support).

On-disk conventions as JAX's: sequences under ``root_dir`` (skip
``EXCLUDE_DIR_NAMES``), frame alignment from
``single_chip/adc_samples/radar_index_sequence.txt``, ADC files sorted by
trailing frame number, outputs ``%04d.bin`` float32 (R, A, E, 3).

ADC files are read on a thread pool, ``batch_frames`` at a time, and each
batch goes through :func:`rald_torch.dsp.rae.raeivv_map_batch` in one call
on the card (``--device cpu`` runs it on the CPU). The tail batch is not
padded: only real frames are computed and written.
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from rald_torch import resolve_device
from rald_torch.config import load_config
from rald_torch.constants import EXCLUDE_DIR_NAMES
from rald_torch.dsp.params import RadarParams, parse_antenna_array
from rald_torch.dsp.rae import load_adc_frame, raeivv_map_batch
from rald_torch.utils.concurrent import thread_map


def load_npy_adc_frame(path: Path, params: RadarParams) -> np.ndarray:
    """.npy complex ADC (test-set variant, radar_test_set.py:126-129)."""
    adc = np.load(path)
    adc = adc.reshape(params.num_tx, params.num_rx, params.num_chirps, params.num_adc_samples)
    adc = adc - adc.mean()
    return np.stack([adc.real, adc.imag], axis=-1).astype(np.float32)


def read_index(seq_dir: Path) -> list[int]:
    index_file = seq_dir / "single_chip" / "adc_samples" / "radar_index_sequence.txt"
    with open(index_file) as f:
        return [int(line) for line in f if line.strip()]


def sorted_adc_files(adc_dir: Path) -> list[Path]:
    files = list(adc_dir.glob("*.bin")) + list(adc_dir.glob("*.npy"))
    files.sort(key=lambda x: int(x.stem.split("_")[-1]))
    return files


def process_sequence(
    seq_dir: Path,
    out_dir: Path,
    params: RadarParams,
    txl: np.ndarray,
    rxl: np.ndarray,
    device: torch.device,
    batch_frames: int = 8,
    io_workers: int = 8,
) -> int:
    out_dir.mkdir(parents=True, exist_ok=True)
    rindex = read_index(seq_dir)
    adc_files = sorted_adc_files(seq_dir / "single_chip" / "adc_samples" / "data")

    def load(i):
        f = adc_files[rindex[i]]
        if f.suffix == ".npy":
            return load_npy_adc_frame(f, params)
        return load_adc_frame(f, params)

    n = len(rindex)
    for start in range(0, n, batch_frames):
        idxs = list(range(start, min(start + batch_frames, n)))
        batch = torch.from_numpy(np.stack(thread_map(load, idxs, workers=io_workers, desc=None)))
        cubes = raeivv_map_batch(batch.to(device), params, txl, rxl).cpu().numpy()

        def save(j):
            cubes[j].tofile(out_dir / f"{idxs[j]:04d}.bin")

        thread_map(save, range(len(idxs)), workers=io_workers, desc=None)
    return n


def run(cfg, mode: str = "sc", test_set: bool = False, device=None) -> int:
    """Every sequence (the test split with ``test_set``) -> its cubes;
    returns the frame count."""
    dev = resolve_device(device)
    if mode != "sc":
        raise NotImplementedError("cascade radar is not supported (reference parity)")
    dataset_dir = Path(cfg.root_dir)
    out_base = Path(cfg.output_dir)

    if test_set and cfg.get("split_file"):
        with open(out_base / cfg.split_file) as f:
            seq_names = set(json.load(f)[cfg.get("split", "test")])
        seq_dirs = [dataset_dir / s for s in sorted(seq_names)]
    else:
        seq_dirs = [
            d for d in dataset_dir.iterdir() if d.is_dir() and d.name not in EXCLUDE_DIR_NAMES
        ]
    print(f"Found {len(seq_dirs)} sequences in {dataset_dir}")

    params = RadarParams.from_yaml(cfg.single_chip_mode.radar.config)
    txl, rxl = parse_antenna_array(cfg.single_chip_mode.radar.antenna_file_path)
    out_name = "radarcube_high_res" if test_set else "radarcube_raw"

    total = 0
    for seq_dir in seq_dirs:
        out_dir = out_base / seq_dir.name / "single_chip" / out_name
        n = process_sequence(seq_dir, out_dir, params, txl, rxl, dev)
        print(f"{seq_dir.name}: {n} frames -> {out_dir}")
        total += n
    return total


def main(argv=None) -> int:
    parser = argparse.ArgumentParser("rald_torch radar preprocessing")
    parser.add_argument("--config", required=True, type=str)
    parser.add_argument("--mode", default="sc", choices=["sc", "cc"])
    parser.add_argument(
        "--test-set", action="store_true",
        help="high-res cubes for the test split (reference radar_test_set.py)",
    )
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    return run(load_config(args.config), mode=args.mode, test_set=args.test_set, device=args.device)


if __name__ == "__main__":
    main()
