"""Point -> voxel conversion in numpy: the port's own copy of
``rald_tpu/data/voxelizer.py`` (spconv ``Point2VoxelCPU3d`` semantics).

- a point's voxel index is ``floor((p - range_min) / voxel_size)``; points
  outside ``[0, grid)`` on any axis are dropped;
- voxels appear in order of *first appearance* in the point scan order;
- each voxel keeps at most ``max_points_per_voxel`` points (first come);
- at most ``max_voxels`` voxels are kept (later ones dropped);
- returned coordinates are (z, y, x).

``native/rald_native.cpp`` implements the same contract in C++;
:func:`rald_torch.native.voxelize` binds it and falls back to this one.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class VoxelGrid:
    voxels: np.ndarray        # (n_vox, max_points_per_voxel, C) float32
    coords: np.ndarray        # (n_vox, 3) int32 in (z, y, x) order
    num_points: np.ndarray    # (n_vox,) int32
    grid_size: np.ndarray     # (3,) int64 in (x, y, z) order


def grid_size_of(pc_range, voxel_size) -> np.ndarray:
    pc_range = np.asarray(pc_range, dtype=np.float64)
    voxel_size = np.asarray(voxel_size, dtype=np.float64)
    return np.round((pc_range[3:6] - pc_range[0:3]) / voxel_size).astype(np.int64)


def voxelize(
    points: np.ndarray,
    voxel_size,
    pc_range,
    max_points_per_voxel: int,
    max_voxels: int,
) -> VoxelGrid:
    """Vectorized first-come voxelization of an (N, C>=3) point array."""
    points = np.asarray(points, dtype=np.float32)
    voxel_size = np.asarray(voxel_size, dtype=np.float64)
    pc_range = np.asarray(pc_range, dtype=np.float64)
    grid = grid_size_of(pc_range, voxel_size)

    idx = np.floor((points[:, :3].astype(np.float64) - pc_range[:3]) / voxel_size).astype(np.int64)
    valid = np.all((idx >= 0) & (idx < grid), axis=1)
    pts = points[valid]
    idx = idx[valid]

    if len(pts) == 0:
        return VoxelGrid(
            voxels=np.zeros((0, max_points_per_voxel, points.shape[1]), np.float32),
            coords=np.zeros((0, 3), np.int32),
            num_points=np.zeros((0,), np.int32),
            grid_size=grid,
        )

    keys = (idx[:, 2] * grid[1] + idx[:, 1]) * grid[0] + idx[:, 0]
    uniq, first_pos, inverse = np.unique(keys, return_index=True, return_inverse=True)

    # rank voxels by first appearance in scan order
    appearance = np.argsort(first_pos, kind="stable")
    rank_of_uniq = np.empty(len(uniq), dtype=np.int64)
    rank_of_uniq[appearance] = np.arange(len(uniq))
    vox_rank = rank_of_uniq[inverse]  # per-point voxel slot

    # ordinal of each point within its voxel (scan order)
    perm = np.argsort(vox_rank, kind="stable")
    sorted_rank = vox_rank[perm]
    group_start = np.zeros(len(uniq), dtype=np.int64)
    counts = np.bincount(sorted_rank, minlength=len(uniq))
    group_start[1:] = np.cumsum(counts)[:-1]
    ord_in_vox = np.empty(len(pts), dtype=np.int64)
    ord_in_vox[perm] = np.arange(len(pts)) - group_start[sorted_rank]

    n_vox = min(len(uniq), max_voxels)
    keep = (vox_rank < n_vox) & (ord_in_vox < max_points_per_voxel)

    voxels = np.zeros((n_vox, max_points_per_voxel, points.shape[1]), dtype=np.float32)
    voxels[vox_rank[keep], ord_in_vox[keep]] = pts[keep]
    # counts is already indexed by appearance rank (bincount of sorted_rank)
    num_points = np.minimum(counts[:n_vox], max_points_per_voxel).astype(np.int32)

    first_idx = idx[first_pos[appearance[:n_vox]]]
    coords = first_idx[:, ::-1].astype(np.int32)  # (z, y, x)
    return VoxelGrid(voxels=voxels, coords=coords, num_points=num_points, grid_size=grid)
