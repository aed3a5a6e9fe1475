"""Host-side radar-cube conditioning preprocessing, in numpy: the port's own
copy of ``rald_tpu/data/radar_proc.py:15-73``.

The dataset's transform (reference ``Coloradar_dataset.py:432-475``):
truncated intensity normalization, validity-masked doppler, and bilinear
(align_corners=True) upsampling of the azimuth / elevation axes. The
on-device resize is ``rald_torch.dsp.cfar_points.resize_linear_align_corners``.
"""
from __future__ import annotations

import numpy as np


def _linear_resize_align_corners_np(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    n_in = x.shape[axis]
    if n_in == out_size:
        return x
    if out_size == 1 or n_in == 1:
        pos = np.zeros(out_size, dtype=np.float64)
    else:
        pos = np.linspace(0.0, n_in - 1.0, out_size)
    lo = np.clip(np.floor(pos).astype(np.int64), 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = (pos - lo).astype(x.dtype)
    x_lo = np.take(x, lo, axis=axis)
    x_hi = np.take(x, hi, axis=axis)
    shape = [1] * x.ndim
    shape[axis] = -1
    return x_lo + frac.reshape(shape) * (x_hi - x_lo)


def process_radar_cube(
    radar_cube: np.ndarray,
    norm_intensity: bool = True,
    max_intensity: float = 45.0,
    norm_dopp: bool = True,
    max_dopp: float = 2.4958,
    upsample: bool = False,
    tgt_a: int | None = None,
    tgt_e: int | None = None,
    early_return: bool = False,
) -> np.ndarray:
    """(R, A, E, 3) raw cube -> (R, A', E', 2) conditioning cube.

    Channels in: (intensity dB, velocity, validity). Channels out:
    (normalized intensity, masked + normalized doppler)."""
    r, a, e, _ = radar_cube.shape
    out = np.zeros((r, a, e, 2), dtype=np.float32)
    if norm_intensity:
        out[..., 0] = np.clip(radar_cube[..., 0], 0, max_intensity) / max_intensity
    mask = radar_cube[..., -1]
    out[..., 1] = radar_cube[..., 1] * mask
    if early_return:
        return out
    if norm_dopp:
        out[..., 1] = out[..., 1] / max_dopp
    if upsample:
        if tgt_a is None or tgt_e is None:
            raise ValueError("process_radar_cube: upsample needs tgt_a and tgt_e")
        i = _linear_resize_align_corners_np(
            _linear_resize_align_corners_np(out[..., 0], tgt_a, axis=1), tgt_e, axis=2)
        d = _linear_resize_align_corners_np(
            _linear_resize_align_corners_np(out[..., 1], tgt_a, axis=1), tgt_e, axis=2)
        out = np.stack([i, d], axis=-1)
    return out
