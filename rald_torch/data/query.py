"""Occupancy query-point sampling and CFAR helper augmentation in numpy:
the port's own copy of ``rald_tpu/data/query.py`` (reference
``Coloradar_dataset.py`` ``transform_voxels_to_query_points`` :237-294,
``get_empty_voxel_centers`` :335-363, and ``query_helper.py``
``aug_query_helper`` :3-43).

Every function takes an explicit ``np.random.Generator`` and draws from it
in the JAX package's order, so the same seed gives the same arrays.
"""
from __future__ import annotations

import numpy as np


def voxel_centers(coords_zyx: np.ndarray, voxel_size, pc_range) -> np.ndarray:
    """(z, y, x) voxel coords -> metric voxel-center coordinates
    (reference: Coloradar_dataset.py:245-251)."""
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    pc_range = np.asarray(pc_range, dtype=np.float32)
    xyz = coords_zyx[:, ::-1].astype(np.float32)
    return xyz * voxel_size + voxel_size / 2 + pc_range[:3]


def empty_voxel_centers(
    coords_xyz: np.ndarray,
    grid_size,
    n: int,
    voxel_size,
    pc_range,
    rng: np.random.Generator,
) -> np.ndarray:
    """Sample n centers of *unoccupied* voxels
    (reference: Coloradar_dataset.py:335-363).

    Same distribution as the reference (uniform with replacement over empty
    cells), different algorithm: the reference materializes the full dense
    occupancy grid + the index list of every empty cell per frame (the
    view-cone grid is 316x720x80 = 18M cells, ~144 MB of indices) — the
    hottest host-pipeline op. Occupancy is capped at max_voxels (50k), i.e.
    <= 0.3% of cells, so rejection sampling against the sorted occupied set
    is exact and ~1000x cheaper. Dense fallback for small/test grids where
    occupancy can be a large fraction.
    """
    grid_size = tuple(int(g) for g in grid_size)
    gz = grid_size[2]
    gy = grid_size[1]
    total = grid_size[0] * gy * gz
    ci = coords_xyz.astype(np.int64)
    occ_flat = np.unique((ci[:, 0] * gy + ci[:, 1]) * gz + ci[:, 2])

    if total <= 1_000_000 or len(occ_flat) > total // 4:
        occupied = np.zeros(total, dtype=bool)
        occupied[occ_flat] = True
        empty_flat = np.flatnonzero(~occupied)
        pick = empty_flat[rng.integers(0, len(empty_flat), size=n)]
    else:
        out = np.empty(0, dtype=np.int64)
        while len(out) < n:
            cand = rng.integers(0, total, size=max(2 * (n - len(out)), 64))
            pos = np.searchsorted(occ_flat, cand)
            pos_c = np.minimum(pos, len(occ_flat) - 1)
            is_occ = occ_flat[pos_c] == cand
            out = np.concatenate([out, cand[~is_occ]])
        pick = out[:n]

    x = pick // (gy * gz)
    y = (pick // gz) % gy
    z = pick % gz
    centers = np.stack([x, y, z], axis=1).astype(np.float32)
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    pc_range = np.asarray(pc_range, dtype=np.float32)
    return centers * voxel_size + voxel_size / 2 + pc_range[:3]


def sample_train_queries(
    coords_zyx: np.ndarray,
    grid_size,
    voxel_size,
    pc_range,
    in_num: int,
    out_num: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Training queries: ``in_num`` jittered points inside occupied voxels
    (label 1) + ``out_num`` jittered points inside empty voxels (label 0)
    (reference: Coloradar_dataset.py:254-278)."""
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    centers = voxel_centers(coords_zyx, voxel_size, pc_range)
    coords_xyz = coords_zyx[:, ::-1]

    jitter_in = rng.uniform(-voxel_size / 2, voxel_size / 2, size=(in_num, 3)).astype(np.float32)
    pick = rng.choice(len(centers), in_num, replace=True)
    points_in = centers[pick] + jitter_in

    jitter_out = rng.uniform(-voxel_size / 2, voxel_size / 2, size=(out_num, 3)).astype(np.float32)
    empties = empty_voxel_centers(coords_xyz, grid_size, out_num, voxel_size, pc_range, rng)
    points_out = empties + jitter_out

    queries = np.concatenate([points_in, points_out], axis=0).astype(np.float32)
    labels = np.concatenate([np.ones(in_num), np.zeros(out_num)]).astype(np.float32)
    return queries, labels


def sample_eval_queries(
    coords_zyx: np.ndarray,
    voxel_size,
    pc_range,
    num: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """Eval queries: ``num`` jittered in-voxel points, all labeled 1
    (reference: Coloradar_dataset.py:279-290)."""
    voxel_size = np.asarray(voxel_size, dtype=np.float32)
    centers = voxel_centers(coords_zyx, voxel_size, pc_range)
    jitter = rng.uniform(-voxel_size / 2, voxel_size / 2, size=(num, 3)).astype(np.float32)
    pick = rng.choice(len(centers), num, replace=True)
    queries = (centers[pick] + jitter).astype(np.float32)
    return queries, np.ones(num, dtype=np.float32)


def aug_query_helper(
    helper_points: np.ndarray,
    aug_num: int,
    pc_range,
    voxel_size,
    aug_bias_scale: int = 2,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Densify CFAR helper points to a fixed count by jittering
    (reference: datasets/utils/query_helper.py:3-43).

    If there are already >= aug_num points, the first aug_num are returned;
    otherwise the originals are kept and the remainder is filled with points
    jittered by up to ``scale * voxel_size`` (scale sampled in
    [1, aug_bias_scale]), clipped to pc_range.

    Draws the picks, the scales, then the f32 jitter (U[0, 1) straight into
    the output), in that order.
    """
    assert helper_points.shape[1] == 3
    if rng is None:
        rng = np.random.default_rng()
    pc_range = np.asarray(pc_range, dtype=np.float32)
    voxel_size = np.asarray(voxel_size, dtype=np.float32)

    n = helper_points.shape[0]
    if n >= aug_num:
        return np.array(helper_points[:aug_num], dtype=np.float32)

    gen = aug_num - n
    pick = rng.integers(0, n, size=gen)
    scales = rng.integers(1, aug_bias_scale + 1, size=gen).astype(np.float32)
    out = np.empty((aug_num, 3), dtype=np.float32)
    out[:n] = helper_points
    aug = out[n:]
    rng.random(out=aug, dtype=np.float32)  # U[0,1), drawn straight into out
    aug *= 2.0
    aug -= 1.0
    aug *= voxel_size  # (3,) broadcast
    aug *= scales[:, None]
    aug += helper_points.astype(np.float32, copy=False)[pick]
    np.maximum(aug, pc_range[:3], out=aug)
    np.minimum(aug, pc_range[3:6], out=aug)
    return out
