"""Inference query points, in numpy: the port's own copy of
``rald_tpu/eval/queries.py`` (reference ``utils/utils.py:147-176``).

Uniform random points in the normalized box: the full [-1, 1]^3 under
anisotropic normalization, per-axis scaled bounds under isotropic, drawn
from an explicit numpy Generator so that the same seed gives the same grid
as the JAX package.
"""
from __future__ import annotations

import numpy as np

from rald_torch import geometry as geo


def generate_query_points(
    num_points: int,
    pc_range,
    anisotropic: bool = True,
    isotropic: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    rng = rng or np.random.default_rng()
    pc_range = np.asarray(pc_range, np.float64)
    scale = (pc_range[3:6] - pc_range[0:3]) / 2.0
    if anisotropic:
        lo, hi = -np.ones(3), np.ones(3)
    if isotropic:
        lo = -(scale / scale.max())
        hi = scale / scale.max()
    return rng.uniform(lo, hi, size=(num_points, 3)).astype(np.float32)


def generate_query_points_cart(
    num_points: int,
    pc_range_cart,
    pc_range,
    anisotropic: bool = True,
    isotropic: bool = False,
    rng: np.random.Generator | None = None,
    max_rounds: int = 64,
) -> np.ndarray:
    """Cartesian-uniform query points mapped into the normalized polar box
    (``eval.use_cart_query``): sample in the cartesian box, convert to
    polar, normalize, keep the points inside (-1, 1)^3, and resample until
    exactly ``num_points`` survive."""
    rng = rng or np.random.default_rng()
    out = []
    remaining = num_points
    for _ in range(max_rounds):
        cart = generate_query_points(
            max(2 * remaining, 1024), pc_range_cart, anisotropic, isotropic, rng
        )
        cart = geo.inverse_norm_points(cart, pc_range_cart, anisotropic, isotropic)
        polar = geo.cartesian2polar(cart)
        normed = geo.norm_points(polar, pc_range, anisotropic, isotropic)
        keep = normed[geo.fov_mask(normed)]
        if len(keep):
            out.append(keep.astype(np.float32))
            remaining -= len(keep)
        if remaining <= 0:
            break
    if remaining > 0:
        raise ValueError(
            "cartesian query box barely intersects the polar FOV — "
            f"{num_points - remaining}/{num_points} points after {max_rounds} rounds"
        )
    return np.concatenate(out)[:num_points]


def build_query_grid(lidar_cfg, num_points: int, use_cart_query: bool, rng) -> np.ndarray:
    """The eval grid the engine and the inference CLI decode: uniform
    normalized queries over the scene box, or the cartesian-rejection
    variant when ``eval.use_cart_query`` is set."""
    aniso, iso = lidar_cfg.norm_anisotropy, lidar_cfg.norm_isotropy
    if use_cart_query:
        return generate_query_points_cart(
            num_points, lidar_cfg.pc_range_cart, lidar_cfg.pc_range, aniso, iso, rng
        )
    return generate_query_points(num_points, lidar_cfg.pc_range, aniso, iso, rng)
