"""Radar-cube resizes and the test-set CFAR helper-point extraction
(``rald_tpu/dsp/cfar_points.py:26-177``; reference
``dataset_preprocessor/cache_test_cfar_utils.py``: ``rae_interpo`` :26-53,
``weighted_allocation`` :100-141, ``RA2DDetector`` :55-98, ``cube_idx2coord``
:162-208).

Each range slice of the upsampled cube is argsorted once (descending), and
the budgeted selection is one gather: output position j belongs to slice r
with rank ``j - offset[r]``, where ``offset = cumsum(budgets)``. The result
is the reference's slice-major, intensity-sorted point list with a fixed
total count.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from rald_torch.constants import WAVELENGTH_TO_APERTURE_RATIO


def resize_linear_align_corners(x: torch.Tensor, out_sizes, axes) -> torch.Tensor:
    """Multi-axis linear resize with align_corners=True semantics, one axis
    at a time (the dataset's ``F.interpolate(..., align_corners=True)``)."""
    for axis, out_size in zip(axes, out_sizes):
        n_in = x.shape[axis]
        if n_in == out_size:
            continue
        if out_size == 1 or n_in == 1:
            pos = torch.zeros((out_size,), dtype=torch.float32, device=x.device)
        else:
            pos = torch.linspace(0.0, n_in - 1.0, out_size, dtype=torch.float32, device=x.device)
        lo = torch.clamp(torch.floor(pos).long(), 0, n_in - 1)
        hi = torch.clamp(lo + 1, 0, n_in - 1)
        frac = (pos - lo.float()).to(x.dtype)
        x_lo = torch.index_select(x, axis, lo)
        x_hi = torch.index_select(x, axis, hi)
        shape = [1] * x.dim()
        shape[axis] = -1
        x = x_lo + frac.reshape(shape) * (x_hi - x_lo)
    return x


def rae_interpo(rae_map: torch.Tensor, R: int, A: int, E: int) -> torch.Tensor:
    """Trilinear (half-pixel, align_corners=False) resize of (..., R, A, E)
    (reference: cache_test_cfar_utils.py:26-53): the same upsample as JAX's
    ``jax.image.resize(..., "trilinear")``."""
    batch_shape = rae_map.shape[:-3]
    x = rae_map.reshape(-1, 1, *rae_map.shape[-3:])
    up = F.interpolate(x, size=(R, A, E), mode="trilinear", align_corners=False)
    return up.reshape(*batch_shape, R, A, E)


def weighted_allocation(weights: torch.Tensor, total: int) -> torch.Tensor:
    """Proportional integer allocation; the max-weight item absorbs the
    rounding residue, and all-zero weights split evenly with the first
    ``total % n`` slots one more (reference: cache_test_cfar_utils.py:100-141).
    Returns int32 (n,)."""
    weights = weights.float()
    n = weights.shape[0]
    wsum = weights.sum()
    ratios = weights / torch.where(wsum == 0, torch.ones_like(wsum), wsum)
    alloc = torch.floor(ratios * total).int()
    alloc[torch.argmax(weights)] += total - alloc.sum(dtype=torch.int32)
    even = torch.full((n,), total // n, dtype=torch.int32, device=weights.device)
    even[: total % n] += 1
    return torch.where(wsum == 0, even, alloc)


def budgeted_topk(cube: torch.Tensor, budgets: torch.Tensor, total: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-range-slice budgeted peak picking with a fixed output count.

    Args:
        cube: (R, A, E) intensity cube.
        budgets: (R,) int budgets summing to ``total``.
        total: output count.

    Returns:
        ``(peaks, intensities)``: (total, 3) int32 (r, a, e) indices ordered
        slice-major, then by descending intensity within each slice (a
        stable sort: equal intensities keep their cell order), as the
        reference's per-slice argpartition + sort loop
        (cache_test_cfar_utils.py:70-91) orders them, and the (total,)
        intensities.
    """
    R, A, E = cube.shape
    dev = cube.device
    flat = cube.reshape(R, A * E)
    order = torch.argsort(-flat, dim=1, stable=True)

    offsets = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         torch.cumsum(budgets, 0, dtype=torch.int32)])
    j = torch.arange(total, dtype=torch.int32, device=dev)
    r = (torch.searchsorted(offsets, j, right=True) - 1).clamp(0, R - 1)
    k = (j - offsets[r]).clamp(0, A * E - 1)
    cell = order[r, k]
    peaks = torch.stack([r, cell // E, cell % E], dim=1).int()
    return peaks, flat[r, cell]


def cube_idx2coord_axes(r_size: int, a_size: int, e_size: int, max_range: float,
                        return_in_degrees: bool = False):
    """Range / azimuth / elevation axes (float64 numpy) of the upsampled cube
    (reference: cache_test_cfar_utils.py:162-208)."""
    range_cell_size = max_range / r_size
    range_axis = np.arange(range_cell_size, max_range + range_cell_size / 2, range_cell_size)

    def angle_axis(n):
        w = np.flip(np.linspace(-np.pi, np.pi, n))
        ax = np.arcsin(np.clip(w / (2 * np.pi * WAVELENGTH_TO_APERTURE_RATIO), -1, 1))
        ax[0] = np.pi / 2
        ax[-1] = -np.pi / 2
        return -ax

    azimuth_axis = angle_axis(a_size)
    elevation_axis = angle_axis(e_size)
    if return_in_degrees:
        azimuth_axis = np.rad2deg(azimuth_axis)
        elevation_axis = np.rad2deg(elevation_axis)
    return range_axis, azimuth_axis, elevation_axis


def cube_idx2coord(idx: torch.Tensor, r_size: int, a_size: int, e_size: int, max_range: float,
                   return_in_degrees: bool = False) -> torch.Tensor:
    """(N, 3) (r, a, e) cube indices -> float32 polar coordinates."""
    axes = cube_idx2coord_axes(r_size, a_size, e_size, max_range, return_in_degrees)
    idx = idx.long()
    return torch.stack([torch.as_tensor(ax, dtype=torch.float32, device=idx.device)[idx[:, i]]
                        for i, ax in enumerate(axes)], dim=1)


def cfar_points_from_cube(intensity_cube: torch.Tensor, tgt_r: int, tgt_a: int, tgt_e: int,
                          total: int, max_range: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The test-set CFAR helper points of one (R, A, E) intensity cube:
    upsample -> per-slice budgets -> budgeted top-k -> polar coordinates, on
    the cube's device (``cache_test_cfar.py:_subproc_process_radar``
    :77-107). Returns ``(points, intensities)``: (total, 3) polar (r [m],
    az [deg], el [deg]) and (total,); the FOV filter is left to the host."""
    up = rae_interpo(intensity_cube, tgt_r, tgt_a, tgt_e)  # (R', A', E')
    weights = up.sum(dim=(1, 2)) / up.sum()
    budgets = weighted_allocation(weights, total)
    peaks, intensities = budgeted_topk(up, budgets, total)
    coords = cube_idx2coord(peaks, tgt_r, tgt_a, tgt_e, max_range, return_in_degrees=True)
    return coords, intensities
