"""On-device radar-cube resize (``rald_tpu/dsp/cfar_points.py:26-51``)."""
from __future__ import annotations

import torch


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
