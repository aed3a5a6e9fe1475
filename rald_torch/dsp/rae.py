"""RAE intensity / velocity / validity cube builder: the radar DSP hot path
(``rald_tpu/dsp/rae.py:29-133``; reference
``dataset_preprocessor/utils/radar_preprocessing.py`` ``RAEIVVmap`` :6-62).

Blackman window -> range FFT -> doppler FFT (+shift) -> TDM velocity
compensation -> virtual-array synthesis -> azimuth FFT (+shift) ->
elevation FFT (+shift) -> range crop -> per-cell doppler statistics -> dB
map, as PyTorch ops on the input's device (``torch.fft`` on the card), over
any leading frame axes in one call. The range crop is a mask that zeroes
the cropped bins, as in JAX: the zeros stay in the noise-floor quantile.
"""
from __future__ import annotations

import numpy as np
import torch

from rald_torch.dsp.bins import get_bins
from rald_torch.dsp.params import RadarParams
from rald_torch.dsp.virtual_array import velocity_compensation, virtual_array

# 30th-percentile noise floor (reference: radar_preprocessing.py:4).
NOISE_THRESHOLD = 0.30


def raeivv_map_batch(adc_batch: torch.Tensor, params: RadarParams, txl, rxl) -> torch.Tensor:
    """ADC frames -> (..., range, azimuth, elevation, 3) float32 cubes.

    Args:
        adc_batch: float32 raw ADC I/Q samples, shape (..., ntx, nrx, nc, ns, 2).
        params: chirp / FFT configuration.
        txl/rxl: antenna layouts ((n, 3) arrays or nested tuples).

    Returns:
        channels = (intensity dB, velocity m/s, validity), one cube per frame.
    """
    txl = np.asarray(txl)
    rxl = np.asarray(rxl)
    dev = adc_batch.device
    adc = torch.complex(adc_batch[..., 0].float(), adc_batch[..., 1].float())
    ns = adc.shape[-1]

    # Window + range FFT (reference: radar_preprocessing.py:22-24).
    x = adc * torch.as_tensor(np.blackman(ns), dtype=torch.float32, device=dev)
    rfft = torch.fft.fft(x, n=params.range_fftsize, dim=-1)

    # Doppler FFT + shift + TDM velocity compensation (:26-29).
    dfft = torch.fft.fftshift(torch.fft.fft(rfft, n=params.doppler_fftsize, dim=-2), dim=-2)
    dfft = dfft * velocity_compensation(adc.shape[-4], params.doppler_fftsize, device=dev)

    # Virtual array synthesis (:31): (..., el, az, doppler, range).
    va = virtual_array(dfft, txl, rxl)

    # Azimuth + elevation FFTs with spectral shift (:33-39).
    afft = torch.fft.fftshift(torch.fft.fft(va, n=params.azimuth_fftsize, dim=-3), dim=-3)
    efft = torch.fft.fftshift(torch.fft.fft(afft, n=params.elevation_fftsize, dim=-4), dim=-4)

    # Range crop as a mask (:42-43).
    nr = efft.shape[-1]
    lo = int(nr * params.crop_low)
    hi = int(nr * params.crop_high)
    ridx = torch.arange(nr, device=dev)
    efft = efft * ((ridx >= lo) & (ridx < nr - hi))

    ne, na, nv, nr = efft.shape[-4:]
    # The reference's argument order (radar_preprocessing.py:45): the
    # doppler size in the range slot and the range size in the doppler slot,
    # so vbins has nr entries, indexed by the doppler argmax (clamped, as
    # JAX's gather clamps).
    _, vbins, _, _ = get_bins(nv, nr, na, ne, params)
    vbins = torch.as_tensor(vbins, dtype=torch.float32, device=dev)

    power = efft.abs() ** 2  # (..., el, az, doppler, range)

    # Doppler-peak velocity (:48-50); ties go to the first index.
    max_idx = torch.argmax(power, dim=-2)
    max_velocity = vbins[max_idx.clamp(max=len(vbins) - 1)]

    # Peak-validity mask: top1 * (1 - thr) > top2 along doppler (:51-53).
    top2 = torch.topk(power, 2, dim=-2).values
    valid = top2[..., 0, :] * (1.0 - NOISE_THRESHOLD) > top2[..., 1, :]

    # Doppler-summed power normalized by each frame's 30th-pct noise floor (:54-58).
    psum = power.sum(dim=-2)  # (..., el, az, range)
    lead = psum.shape[:-3]
    noise = torch.quantile(psum.reshape(*lead, -1), NOISE_THRESHOLD, dim=-1)
    psum = psum / (noise.reshape(*lead, 1, 1, 1) + 1e-6)
    dpcl = 10.0 * torch.log10(psum + 1.0)

    # (el, az, range) -> (range, az, el), stack channels (:59-61).
    out = torch.stack([dpcl, max_velocity, valid.float()], dim=-1)
    nlead = len(lead)
    return out.permute(*range(nlead), nlead + 2, nlead + 1, nlead, nlead + 3).contiguous()


def raeivv_map(adc_iq: torch.Tensor, params: RadarParams, txl, rxl) -> torch.Tensor:
    """One ADC frame (ntx, nrx, nc, ns, 2) -> its (R, A, E, 3) cube."""
    return raeivv_map_batch(adc_iq[None], params, txl, rxl)[0]


def load_adc_frame(path, params: RadarParams) -> np.ndarray:
    """int16 interleaved IQ file -> float32 (ntx, nrx, nc, ns, 2) with DC removal
    (reference: radar.py:64-76). The DC offset is subtracted per I/Q channel,
    equivalent to subtracting the complex mean."""
    raw = np.fromfile(path, dtype=np.int16)
    raw = raw.reshape(params.num_tx, params.num_rx, params.num_chirps, params.num_adc_samples, 2)
    iq = raw.astype(np.float32)
    iq -= iq.mean(axis=(0, 1, 2, 3), keepdims=True)
    return iq


def complex_to_iq(adc: np.ndarray) -> np.ndarray:
    """Pack a complex ADC frame into the real (…, 2) layout."""
    return np.stack([adc.real, adc.imag], axis=-1).astype(np.float32)


def as_static_layout(arr: np.ndarray) -> tuple:
    """Antenna layout array -> nested tuple of ints (as JAX's callers pass it)."""
    return tuple(tuple(int(v) for v in row) for row in np.asarray(arr))
