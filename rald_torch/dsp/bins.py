"""Range / velocity / angle bin computation.

Numerical parity with reference ``dataset_preprocessor/utils/radardsp.py``:
``_get_bins`` (:135-206), ``get_max_range`` (:126), ``get_max_velocity``
(:209), ``get_range_bins`` (:267), ``get_velocity_bins`` (:285), resolution
helpers (:220-263), ``fft_size`` (:114).

These are tiny host-side numpy constants (the port's own copy of
``rald_tpu/dsp/bins.py``); the DSP functions move them to the device.
"""
from __future__ import annotations

import numpy as np

from rald_torch.constants import C
from rald_torch.dsp.params import RadarParams


def fft_size(size: int) -> int:
    """Closest power of two >= size (reference: radardsp.py:114-123)."""
    return 2 ** int(np.ceil(np.log(size) / np.log(2)))


def get_max_range(fs: float, fslope: float) -> float:
    return fs * C / (2 * fslope)


def get_max_velocity(ntx: int, fstart: float, tc: float) -> float:
    return (C / fstart) / (4.0 * tc * ntx)


def get_range_resolution(ns: int, fs: float, fslope: float, is_adc_filtered: bool = True) -> float:
    rres = C / (ns * fslope / fs)
    return rres if is_adc_filtered else rres / 2


def get_velocity_resolution(nc: int, fstart: float, tc: float, is_adc_filtered: bool = True) -> float:
    vres = (C / fstart) / (tc * nc)
    return vres if is_adc_filtered else vres / 2


def get_range_bins(ns: int, fs: float, fslope: float) -> np.ndarray:
    rmax = get_max_range(fs, fslope)
    rres = rmax / ns
    return np.arange(0, rmax, rres)


def get_velocity_bins(ntx: int, nv: int, fstart: float, tc: float) -> np.ndarray:
    vmax = get_max_velocity(ntx, fstart, tc)
    vres = (2 * vmax) / nv
    return np.arange(-vmax, vmax, vres)


def _aperture_d(p: RadarParams) -> float:
    """Antenna aperture constant (reference: radardsp.py:179)."""
    return 0.5 * (
        (p.start_frequency / 1e9 + (p.kr / 1e9 * p.num_adc_samples / p.fs) / 2) / p.f_design
    )


def get_angle_bins(n: int, fov_deg: tuple[float, float], d: float) -> np.ndarray:
    """Angle bins for an n-point angle FFT (reference: radardsp.py:187-205)."""
    fov = np.deg2rad(fov_deg[1] - fov_deg[0])
    res = 2 * fov / n
    return -1 * np.arcsin(np.arange(-fov, fov, res) / (2 * np.pi * d))


def get_bins(ns: int, nc: int, na: int, ne: int, params: RadarParams):
    """(range, velocity, azimuth, elevation) bins (reference: radardsp.py:135-206).

    Any of the sizes may be 0/None to skip that axis (returns empty array).
    """
    d = _aperture_d(params)
    rbins = get_range_bins(ns, params.fs, params.kr) if ns else np.array([])
    vbins = (
        get_velocity_bins(params.num_tx, nc, params.start_frequency, params.chirp_time)
        if nc
        else np.array([])
    )
    abins = get_angle_bins(na, params.angles_doa_az, d) if na else np.array([])
    ebins = get_angle_bins(ne, params.angles_doa_ele, d) if ne else np.array([])
    return rbins, vbins, abins, ebins
