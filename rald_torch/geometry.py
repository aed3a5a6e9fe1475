"""Point normalization, polar <-> cartesian and the FOV mask
(``rald_tpu/geometry.py:28-104``).

Every function takes a torch tensor or a numpy array and returns the same
kind. Conventions are the reference's: polar points are (range [m],
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
