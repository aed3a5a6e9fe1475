"""Point normalization and polar -> cartesian (``rald_tpu/geometry.py:28-90``).

Every function takes a torch tensor or a numpy array and returns the same
kind. Conventions are the reference's: polar points are (range [m],
azimuth [deg], elevation [deg]) and ``polar2cartesian`` negates azimuth.
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
