"""Point normalization, polar <-> cartesian, FOV masks and filters, rigid
transforms (``rald_tpu/geometry.py:28-158``).

The first six functions take a torch tensor or a numpy array and return
the same kind; the host-side filters and transforms take numpy arrays. Conventions are the reference's: polar points are (range [m],
azimuth [deg], elevation [deg]); ``cartesian2polar`` negates azimuth and
``polar2cartesian`` inverts that.
"""
from __future__ import annotations

import numpy as np
import torch


def norm_scale_offset(pc_range):
    """Per-axis (offset, scale) of the [-1, 1] normalization box (numpy f32)."""
    pc_range = np.asarray(pc_range, dtype=np.float32)
    offset = (pc_range[3:6] + pc_range[0:3]) / 2.0
    scale = (pc_range[3:6] - pc_range[0:3]) / 2.0
    return offset, scale


def _consts(points, *arrays):
    if isinstance(points, torch.Tensor):
        return tuple(torch.as_tensor(a, device=points.device) for a in arrays)
    return arrays


def norm_points(points, pc_range, anisotropic: bool = True, isotropic: bool = False):
    """Normalize points into [-1, 1]^3; isotropic wins if both are set."""
    offset, scale = norm_scale_offset(pc_range)
    off, sc = _consts(points, offset, scale)
    out = points
    if anisotropic:
        out = (points - off) / sc
    if isotropic:
        out = (points - off) / float(scale.max())
    if not anisotropic and not isotropic:
        out = points * 0
    return out


def inverse_norm_points(points, pc_range, anisotropic: bool = True, isotropic: bool = False):
    """Undo :func:`norm_points`."""
    offset, scale = norm_scale_offset(pc_range)
    off, sc = _consts(points, offset, scale)
    out = points
    if anisotropic:
        out = points * sc + off
    if isotropic:
        out = points * float(scale.max()) + off
    if not anisotropic and not isotropic:
        out = points * 0
    return out


def polar2cartesian(points):
    """(r, az [deg], el [deg]) -> (x, y, z)."""
    xp = torch if isinstance(points, torch.Tensor) else np
    r = points[..., 0]
    az = -xp.deg2rad(points[..., 1])
    el = xp.deg2rad(points[..., 2])
    x = r * xp.cos(el) * xp.cos(az)
    y = r * xp.cos(el) * xp.sin(az)
    z = r * xp.sin(el)
    return xp.stack([x, y, z], axis=-1) if xp is np else torch.stack([x, y, z], dim=-1)


def cartesian2polar(points):
    """(x, y, z) -> (r, az [deg], el [deg])."""
    xp = torch if isinstance(points, torch.Tensor) else np
    x, y, z = points[..., 0], points[..., 1], points[..., 2]
    r = xp.sqrt(x * x + y * y + z * z)
    az = -xp.rad2deg(xp.arctan2(y, x))
    el = xp.rad2deg(xp.arcsin(z / r))
    return xp.stack([r, az, el], axis=-1) if xp is np else torch.stack([r, az, el], dim=-1)


def fov_mask(points, eps: float = 0.0):
    """Boolean mask of points strictly inside the open cube (-1, 1)^3."""
    inside = (points > -1 + eps) & (points < 1 - eps)
    return inside.all(-1) if isinstance(points, torch.Tensor) else np.all(inside, axis=-1)


def polar_range_mask(points: np.ndarray, range_limits) -> np.ndarray:
    """Mask of (numpy) polar points inside ``[[r_lo, r_hi], [az_lo, az_hi],
    [el_lo, el_hi]]`` (``rald_tpu/geometry.py:112-121``)."""
    lo = np.asarray([range_limits[0][0], range_limits[1][0], range_limits[2][0]])
    hi = np.asarray([range_limits[0][1], range_limits[1][1], range_limits[2][1]])
    return np.all((points >= lo) & (points <= hi), axis=-1)


def transform_points(points: np.ndarray, T) -> np.ndarray:
    """Apply a 4x4 homogeneous transform to (numpy) (..., 3) points
    (``rald_tpu/geometry.py:136-142``)."""
    return points @ np.asarray(T[:3, :3], dtype=points.dtype).T + np.asarray(
        T[:3, 3], dtype=points.dtype
    )


def remove_points_outside_fov(points: np.ndarray) -> np.ndarray:
    """Host-side compacting FOV filter (reference: utils/utils.py:106-112)."""
    points = np.asarray(points)
    return points[fov_mask(points)]


def filter_points_polar(points: np.ndarray, range_limits) -> np.ndarray:
    """Host-side compacting polar FOV filter (reference: lidar.py:92-109)."""
    points = np.asarray(points)
    return points[polar_range_mask(points, range_limits)]


def remove_empty_points(points: np.ndarray) -> np.ndarray:
    """Drop all-zero (invalid) lidar returns (reference: lidar.py:111-121)."""
    return points[np.linalg.norm(points[:, :3], axis=1) > 0]


def get_inverse_tf(T) -> np.ndarray:
    """Closed-form inverse of a rigid 4x4 transform (reference: utils/utils.py:9-21)."""
    T = np.asarray(T)
    R = T[0:3, 0:3]
    t = T[0:3, 3].reshape(3, 1)
    top = np.concatenate([R.T, -R.T @ t], axis=1)
    return np.concatenate([top, np.asarray([[0.0, 0.0, 0.0, 1.0]], dtype=top.dtype)], axis=0)


def compact_points(points: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Host-boundary compaction of a masked point set."""
    return np.asarray(points)[np.asarray(mask)]
