"""CFAR detectors on tensors (``rald_tpu/dsp/cfar.py:27-203``; reference
``dataset_preprocessor/utils/radardsp.py``: ``os_cfar`` :307-338,
``nq_cfar_2d`` :363-443, ``mask_real_2d`` :447-523).

Every cell's training window is a fixed (2 * ws + 1)^2 gather with a
validity mask that reproduces the reference's region logic exactly,
including its edge quirks (region 4 of ``nq_cfar_2d`` compares y against
nx, radardsp.py:430; ``mask_real_2d`` compares the clamped indices,
:497, :511). The Weibull-interpolated quantile is a sort and a gather over
the masked window.
"""
from __future__ import annotations

import numpy as np
import torch

from rald_torch.dsp.bins import get_bins
from rald_torch.dsp.params import RadarParams


def weibull_quantile(values: torch.Tensor, q: float) -> torch.Tensor:
    """``np.quantile(values, q, method='weibull')`` over the last axis."""
    return masked_weibull_quantile(values, torch.ones_like(values, dtype=torch.bool), q)


def masked_weibull_quantile(values: torch.Tensor, mask: torch.Tensor, q: float) -> torch.Tensor:
    """Weibull-interpolated (Hyndman-Fan type 6) quantile of masked entries.

    ``values`` / ``mask`` share shape (..., W); reduces the last axis.
    Entries where ``mask`` is False are excluded. Windows with no valid
    entry yield +inf (so no detection fires).
    """
    big = torch.tensor(float("inf"), dtype=values.dtype, device=values.device)
    vals = torch.sort(torch.where(mask, values, big), dim=-1).values
    n = mask.sum(dim=-1, dtype=torch.int32)

    # 1-based virtual index h = q * (n + 1), clamped to [1, n].
    h = q * (n + 1.0)
    top = torch.clamp(n - 1, min=0)
    lo = torch.minimum(torch.clamp(torch.floor(h).int() - 1, min=0), top)
    hi = torch.minimum(torch.clamp(torch.ceil(h).int() - 1, min=0), top)
    frac = torch.clamp(h - torch.floor(h), 0.0, 1.0)
    frac = torch.where((h < 1.0) | (h >= n), torch.zeros_like(frac), frac)

    v_lo = torch.gather(vals, -1, lo.long()[..., None])[..., 0]
    v_hi = torch.gather(vals, -1, hi.long()[..., None])[..., 0]
    out = v_lo + frac * (v_hi - v_lo)
    return torch.where(n > 0, out, big)


def os_cfar(samples: torch.Tensor, ws: int, ngc: int = 2, tos: int = 8,
            order_statistic_fraction: float = 0.75) -> torch.Tensor:
    """1-D Ordered-Statistic CFAR (reference: radardsp.py:307-338).

    The reference zero-pads by ws on both sides, so edge windows contain
    literal zeros as training cells, as here.
    """
    ns = samples.shape[-1]
    k = int(ws * order_statistic_fraction)
    padded = torch.nn.functional.pad(samples, (ws, ws))
    offs = np.concatenate([np.arange(-ngc - ws // 2, -ngc), np.arange(ngc + 1, ngc + ws // 2 + 1)])
    idx = torch.as_tensor(np.arange(ns)[:, None] + ws + offs[None, :], device=samples.device)
    tsorted = torch.sort(padded[idx], dim=-1).values
    return (samples > tsorted[:, k] * tos).float()


def _window_offsets(ws: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    d = np.arange(-ws, ws + 1)
    dx = torch.as_tensor(np.repeat(d, 2 * ws + 1), device=device)
    dy = torch.as_tensor(np.tile(d, 2 * ws + 1), device=device)
    return dx, dy  # each (W,) with W = (2ws+1)^2


def _clipped(xs: torch.Tensor, d: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Window indices ``xs[..., None] + d`` clamped to [0, n), and whether
    each was in bounds."""
    u = xs[..., None] + d
    return u.clamp(0, n - 1), (u >= 0) & (u < n)


def nq_cfar_2d(samples: torch.Tensor, ws: int, ngc: int, quantile: float = 0.75,
               tos: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """2-D n'th-quantile CFAR (reference: radardsp.py:363-443).

    Returns ``(mask, snr)`` maps of the input shape; ``snr`` is
    ``samples / noise_estimate`` wherever the mask fires, else 0: the array
    form of the reference's ObjectDetected list (:438-442).
    """
    nx, ny = samples.shape
    dx, dy = _window_offsets(ws, samples.device)
    xs = torch.arange(nx, device=samples.device).repeat_interleave(ny)
    ys = torch.arange(ny, device=samples.device).repeat(nx)
    u, in_x = _clipped(xs, dx, nx)
    v, in_y = _clipped(ys, dy, ny)
    vals = samples[u, v]  # (P, W)

    x, y = xs[:, None], ys[:, None]
    dxb, dyb = dx[None, :], dy[None, :]
    # the reference's slice arithmetic (radardsp.py:383-434), with region
    # 4's y-vs-nx comparison (:430)
    r1 = (x > ngc) & (dxb <= -ngc - 1)
    r2 = (x + ngc + 1 < nx - 1) & (dxb >= ngc + 1)
    r3 = (y > ngc) & (dxb >= -ngc) & (dxb <= ngc) & (dyb <= -ngc - 1)
    r4 = (y + ngc + 1 < nx - 1) & (dxb >= -ngc) & (dxb <= ngc) & (dyb >= ngc + 1)
    tmask = (r1 | r2 | r3 | r4) & in_x & in_y

    m = masked_weibull_quantile(vals, tmask, quantile).reshape(nx, ny)
    mask = (samples > m * tos).float()
    snr = torch.where(mask > 0, samples / m, torch.zeros_like(samples))
    return mask, snr


def mask_real_2d(cfar_power: torch.Tensor, params: RadarParams, ws: int, ngc: int,
                 quantile: float = 0.75, tos: int = 2) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(el, az, range) doppler-peak CFAR (reference: radardsp.py:447-523).

    ``cfar_power`` has shape (ne, na, nv, nr). For each (e, a, r) the cell
    under test is the doppler peak; the training window lives in the
    (doppler, range) plane. All ne * na planes go in one batched call.
    Returns ``(mask, doppler_real)`` of shape (ne, na, nr) where
    ``doppler_real`` holds the peak velocity bin where the mask fires
    (:516-522).
    """
    ne, na, nv, nr = cfar_power.shape
    dev = cfar_power.device
    _, vbins, _, _ = get_bins(nr, nv, na, ne, params)
    vbins = torch.as_tensor(vbins, dtype=cfar_power.dtype, device=dev)

    planes = cfar_power.reshape(ne * na, nv, nr)
    vpk = torch.argmax(planes, dim=1)  # (planes, nr)
    dx, dy = _window_offsets(ws, dev)
    rs = torch.arange(nr, device=dev).expand(ne * na, nr)
    u, in_v = _clipped(vpk, dx, nv)
    v, in_r = _clipped(rs, dy, nr)
    pidx = torch.arange(ne * na, device=dev)[:, None, None]
    vals = planes[pidx, u, v]  # (planes, nr, W)

    pv, r = vpk[..., None], rs[..., None]
    # regions (reference: radardsp.py:458-515) over (doppler offset dx,
    # range offset dy); the conditions compare the clamped bounds (:497, :511)
    r1 = (pv > ngc) & (dx <= -ngc - 1)
    r2 = (torch.clamp(pv + ngc + 1, max=nv) < nv - 1) & (dx >= ngc + 1)
    r3 = (r > ngc) & (dx >= -ngc) & (dx <= ngc) & (dy <= -ngc - 1)
    r4 = (torch.clamp(r + ngc + 1, max=nr) < nr - 1) & (dx >= -ngc) & (dx <= ngc) & (dy >= ngc + 1)
    tmask = (r1 | r2 | r3 | r4) & in_v & in_r
    m = masked_weibull_quantile(vals, tmask, quantile)  # (planes, nr)
    cut = torch.gather(planes, 1, vpk[:, None, :])[:, 0, :]
    fire = cut > m * tos
    dreal = torch.where(fire, vbins[vpk.clamp(max=len(vbins) - 1)], torch.zeros_like(cut))
    return fire.float().reshape(ne, na, nr), dreal.reshape(ne, na, nr)
