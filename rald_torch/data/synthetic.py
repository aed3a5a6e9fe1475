"""Synthetic ColoRadar-layout dataset generator: the port's own copy of
``rald_tpu/data/synthetic.py`` (same seeds, same files, byte for byte).

The real ColoRadar/HUST-Radar data is not shipped with either repo; this
module writes a miniature dataset tree with the exact on-disk layout the
datasets expect (split JSON, ``lidar_sc/*.bin`` float32 xyz, single-chip
``radarcube_raw/*.bin`` (R, A, E, 3) cubes, ``radar_cfar_low_thrd/*.bin``
helper points) so the full input pipeline, training loop, and eval harness
can be exercised end-to-end anywhere.

Scenes are simple rooms (floor + two walls + a few boxes) so the occupancy
task has learnable structure, not pure noise.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from rald_torch import geometry as geo


def _room_points(rng: np.random.Generator, n: int) -> np.ndarray:
    """Sample points on a synthetic room inside the radar FOV (cartesian)."""
    surfaces = []
    # floor at z = -1.5, x in [1, 12], y in [-6, 6]
    k = n // 3
    xy = rng.uniform([1.0, -6.0], [12.0, 6.0], size=(k, 2))
    surfaces.append(np.column_stack([xy, np.full(k, -1.5)]))
    # back wall at x = 12
    yz = rng.uniform([-6.0, -1.5], [6.0, 3.0], size=(k, 2))
    surfaces.append(np.column_stack([np.full(k, 12.0), yz]))
    # a few boxes
    m = n - 2 * k
    centers = rng.uniform([3.0, -4.0, -1.0], [10.0, 4.0, 1.0], size=(4, 3))
    box = rng.uniform(-0.5, 0.5, size=(m, 3))
    surfaces.append(centers[rng.integers(0, 4, m)] + box)
    pts = np.concatenate(surfaces).astype(np.float32)
    # jitter for realism
    pts += rng.normal(scale=0.01, size=pts.shape).astype(np.float32)
    # keep inside the view cone FOV
    polar = geo.cartesian2polar(pts)
    keep = geo.polar_range_mask(polar, [[0.5, 15.5], [-85, 85], [-19, 19]])
    return pts[keep]


def _scene_radar_cube(
    pts: np.ndarray, shape: tuple[int, int, int], rng: np.random.Generator,
    max_range: float = 16.0,
) -> np.ndarray:
    """Simulate a (R, A, E, 3) radar cube from the scene's points.

    Intensity is a log point-density splat over the polar grid (+ speckle),
    so the conditioning genuinely encodes scene structure — stage-2 models
    can *learn* the radar->scene mapping on synthetic data instead of
    memorizing a prior against noise cubes.
    """
    r_dim, a_dim, e_dim = shape
    polar = geo.cartesian2polar(pts[:, :3])
    r_idx = np.clip((polar[:, 0] / max_range * r_dim).astype(np.int64), 0, r_dim - 1)
    a_idx = np.clip(((polar[:, 1] + 90.0) / 180.0 * a_dim).astype(np.int64), 0, a_dim - 1)
    e_idx = np.clip(((polar[:, 2] + 20.0) / 40.0 * e_dim).astype(np.int64), 0, e_dim - 1)
    counts = np.zeros(shape, dtype=np.float64)
    np.add.at(counts, (r_idx, a_idx, e_idx), 1.0)

    cube = np.zeros((*shape, 3), dtype=np.float32)
    speckle = rng.gamma(2.0, 1.0, size=shape)
    cube[..., 0] = 10.0 * np.log10(1.0 + 8.0 * counts + speckle)
    cube[..., 1] = rng.normal(scale=0.2, size=shape)  # static scene: ~0 velocity
    cube[..., 2] = (counts > 0).astype(np.float32)
    return cube


def make_synthetic_coloradar(
    root: str | Path,
    num_train_seqs: int = 2,
    num_eval_seqs: int = 1,
    frames_per_seq: int = 4,
    points_per_frame: int = 16000,
    radar_shape: tuple[int, int, int] = (128, 8, 2),
    helper_points: int = 512,
    seed: int = 0,
) -> Path:
    """Write a synthetic dataset tree; returns the root path."""
    root = Path(root)
    rng = np.random.default_rng(seed)
    r_dim, a_dim, e_dim = radar_shape

    seqs = [f"synth_seq_{i}" for i in range(num_train_seqs + 2 * num_eval_seqs)]
    split = {
        "train": seqs[:num_train_seqs],
        "val": seqs[num_train_seqs : num_train_seqs + num_eval_seqs],
        "test": seqs[num_train_seqs + num_eval_seqs :],
    }
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "split_synth.json", "w") as f:
        json.dump(split, f)

    for seq in seqs:
        lidar_dir = root / seq / "lidar_sc"
        radar_dir = root / seq / "single_chip" / "radarcube_raw"
        helper_dir = root / seq / "single_chip" / "radar_cfar_low_thrd"
        for d in (lidar_dir, radar_dir, helper_dir):
            d.mkdir(parents=True, exist_ok=True)
        for i in range(frames_per_seq):
            pts = _room_points(rng, points_per_frame)
            while pts.shape[0] < points_per_frame:  # FOV crop may drop a few
                pts = np.concatenate([pts, _room_points(rng, points_per_frame)])
            pts = pts[:points_per_frame]
            pts.astype(np.float32).tofile(lidar_dir / f"{i:04d}.bin")

            cube = _scene_radar_cube(pts, (r_dim, a_dim, e_dim), rng)
            cube.tofile(radar_dir / f"{i:04d}.bin")

            hp = geo.cartesian2polar(_room_points(rng, helper_points * 2)[:helper_points])
            hp.astype(np.float32).tofile(helper_dir / f"{i:04d}.bin")

    return root


def make_synthetic_hustradar(
    root: str | Path,
    frames_per_seq: int = 4,
    points_per_frame: int = 4000,
    radar_shape: tuple[int, int, int] = (32, 8, 2),
    highres_shape: tuple[int, int, int] = (32, 16, 8),
    seed: int = 0,
) -> Path:
    """Write a synthetic RAW HUST-Radar tree (the preprocess CLIs' input).

    Layout per the reference's HUST scripts (lidar_hustradar.py:102-151,
    hustRadar_dataset.py:59-114):

    - sequence dirs named from the fixed HUST recording list
      (``constants.HUST_DIR_NAMES``; preprocess_lidar filters on them);
    - ``<seq>/lidar/<timestamp>.bin`` — float32 (N, 4) scans in the LIDAR
      frame (sorted by float stem), with zero returns to be dropped;
    - ``<seq>/lidar_index_sequence.txt`` — aligned raw-frame indices;
    - ``<seq>/rae_map/<n>.npy`` — per aligned frame, the (R, A, E, 3) radar
      cube the HUST dataset ships precomputed (numeric stems, so numeric
      sort != lexical sort is exercised when frames_per_seq > 10);
    - ``<seq>/single_chip/radarcube_high_res/%04d.bin`` — high-res cubes
      for the CFAR helper-point caching flow
      (cache_test_cfar_hust_radar.py:162-172 reads this exact path).

    Scene points are generated in the single-chip (radar) frame and written
    back through ``HUST_T_SINGLE_CHIP_TO_LIDAR`` so that preprocess_lidar's
    forward transform + FOV crop recovers them.
    """
    from rald_torch.constants import HUST_DIR_NAMES, HUST_T_SINGLE_CHIP_TO_LIDAR

    root = Path(root)
    rng = np.random.default_rng(seed)
    raw_per_seq = frames_per_seq + 2  # alignment subsamples the raw stream

    for seq in HUST_DIR_NAMES:
        lidar_dir = root / seq / "lidar"
        rae_dir = root / seq / "rae_map"
        hires_dir = root / seq / "single_chip" / "radarcube_high_res"
        for d in (lidar_dir, rae_dir, hires_dir):
            d.mkdir(parents=True, exist_ok=True)

        frame_pts = []
        for i in range(raw_per_seq):
            pts = _room_points(rng, points_per_frame)
            while pts.shape[0] < points_per_frame:
                pts = np.concatenate([pts, _room_points(rng, points_per_frame)])
            pts = pts[:points_per_frame]
            frame_pts.append(pts)
            # raw scan lives in the lidar frame with a 4th (intensity) attr
            lidar_pts = geo.transform_points(pts, HUST_T_SINGLE_CHIP_TO_LIDAR)
            scan = np.column_stack(
                [lidar_pts, rng.uniform(0, 1, len(lidar_pts))]
            ).astype(np.float32)
            scan[: max(len(scan) // 50, 1)] = 0.0  # zero returns to drop
            scan.tofile(lidar_dir / f"{1000.0 + 0.1 * i:.1f}.bin")

        # alignment: every raw frame except the first/last is kept
        idx = list(range(1, raw_per_seq - 1))[:frames_per_seq]
        (root / seq / "lidar_index_sequence.txt").write_text(
            "\n".join(str(i) for i in idx)
        )
        for n, raw_i in enumerate(idx):
            cube = _scene_radar_cube(frame_pts[raw_i], radar_shape, rng)
            np.save(rae_dir / f"{n}.npy", cube)
            hires = _scene_radar_cube(frame_pts[raw_i], highres_shape, rng)
            hires.tofile(hires_dir / f"{n:04d}.bin")

    return root


def synthetic_dataset_config(root: str | Path, view_cone: bool = True):
    """A Config matching the synthetic tree (mirrors configs/ae/*.yml keys)."""
    from rald_torch.config import Config

    return Config(
        {
            "dataset_name": "AlignedColoRadar",
            "root_dir": str(root),
            "split_file": "split_synth.json",
            "radar_type": "scRadar",
            "lidar": {
                "pc_range": [0, -90, -20, 15.8, 90, 20] if view_cone else [0, -15, -5, 15, 15, 5],
                "num_point_features": 3,
                "voxel_size": [0.05, 0.25, 0.5] if view_cone else [0.05, 0.05, 0.05],
                "max_points_per_voxel": 10,
                "max_number_of_voxels": 50000,
                "sampling": True,
                "num_samples": 10000,
                "query_ratio": 0.0625,
                "norm_isotropy": False,
                "norm_anisotropy": True,
                "cache_voxel": False,
                "view_cone_mode": view_cone,
            },
            "radar": {
                "input_r_dim": 128,
                "input_a_dim": 8,
                "input_e_dim": 2,
                "input_ch": 3,
                "upsample": True,
                "tgt_r_dim": 128,
                "tgt_a_dim": 64,
                "tgt_e_dim": 32,
                "norm_intensity": True,
                "max_intensity": 45,
                "norm_dopp": True,
                "max_dopp": 2.4958,
            },
            "batch_size": 2,
            "num_workers": 2,
            "eval_batch_size": 1,
            "eval_num_workers": 1,
        }
    )
