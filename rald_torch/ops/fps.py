"""Farthest point sampling (``rald_tpu/ops/fps.py:26-63``), in plain PyTorch.

JAX runs it as a ``lax.fori_loop`` in ``jnp`` (no Pallas kernel): each
iteration takes the exact f32 squared distance of every point to the last
pick, keeps the running minimum and picks its argmax (ties to the lowest
index). This is the same loop over a (B, N) running minimum. It serves the
VAE's ``query_type: point`` only.
"""
from __future__ import annotations

import torch


def _sq_dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """f32 ``sum((a - b)^2)`` over the last axis as XLA's CPU backend
    computes it inside the JAX loop: fma(dz, dz, fma(dy, dy, dx * dx)).
    Each fma is one f64 product-and-sum (the f32 product is exact in f64)
    rounded to f32."""
    d = (a - b).double()
    s = (d[..., 0] * d[..., 0]).float()
    s = (d[..., 1] * d[..., 1] + s).float()
    return (d[..., 2] * d[..., 2] + s).float()


def farthest_point_sampling(points: torch.Tensor, num_samples: int, start_idx=0) -> torch.Tensor:
    """FPS indices for ``points`` of shape (N, 3) or (B, N, 3): int64 of
    shape (num_samples,) or (B, num_samples). ``start_idx`` (a scalar or
    one per batch entry) is the first pick."""
    single = points.ndim == 2
    pts = (points[None] if single else points).float()
    b, n = pts.shape[:2]
    rows = torch.arange(b, device=pts.device)
    idx = torch.zeros((b, num_samples), dtype=torch.int64, device=pts.device)
    idx[:, 0] = torch.as_tensor(start_idx, device=pts.device).expand(b)
    min_d2 = torch.full((b, n), float("inf"), device=pts.device)
    last = pts[rows, idx[:, 0]]
    for i in range(1, num_samples):
        d2 = _sq_dist(pts, last[:, None])
        min_d2 = torch.minimum(min_d2, d2)
        nxt = torch.argmax(min_d2, dim=1)  # first maximum: ties to the lowest index
        idx[:, i] = nxt
        last = pts[rows, nxt]
    return idx[0] if single else idx


def fps_points(points: torch.Tensor, num_samples: int, start_idx=0) -> torch.Tensor:
    """The FPS-selected points themselves ((B, N, 3) -> (B, M, 3))."""
    idx = farthest_point_sampling(points, num_samples, start_idx)
    if points.ndim == 2:
        return points[idx]
    return torch.gather(points, 1, idx[..., None].expand(-1, -1, points.shape[-1]))
