"""Radar chirp / sensor parameters: the port's own copy of
``rald_tpu/dsp/params.py``.

Loads the reference's sensor YAMLs (``dataset_preprocessor/config/1843_coloradar.yml``,
``1843_coloradar_test_set.yml``) into a frozen dataclass; every derived
quantity is a host constant.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import yaml


@dataclasses.dataclass(frozen=True)
class RadarParams:
    """Chirp + FFT configuration (reference YAML keys in comments)."""

    num_tx: int = 3                 # numTxChan
    num_rx: int = 4                 # numRxChan
    num_chirps: int = 128           # numChirpsPerFrame
    num_adc_samples: int = 128      # numAdcSamples
    start_frequency: float = 77.0e9  # StartFrequency
    idle_time: float = 110.0e-6     # Ideltime
    f_design: float = 76.8          # F_design
    range_fftsize: int = 128
    doppler_fftsize: int = 128
    azimuth_fftsize: int = 8        # ANGLE_fftsize
    elevation_fftsize: int = 2      # ELEVATION_fftsize
    fs: float = 10_666_000.0        # Fs
    sample_per_chirp_up: int = 128  # SamplePerChripUp
    kr: float = 1.00000000377e14    # Kr (chirp slope)
    chirp_ramp_time: float = 13.0e-6
    adc_start_time: float = 7.0e-6
    angles_doa_az: tuple[float, float] = (-90.0, 90.0)
    angles_doa_ele: tuple[float, float] = (-20.0, 20.0)
    crop_low: float = 0.05
    crop_high: float = 0.05

    @classmethod
    def from_yaml(cls, path: str | Path) -> "RadarParams":
        with open(path, "r") as f:
            raw = yaml.safe_load(f)
        return cls(
            num_tx=raw["numTxChan"],
            num_rx=raw["numRxChan"],
            num_chirps=raw["numChirpsPerFrame"],
            num_adc_samples=raw["numAdcSamples"],
            start_frequency=float(raw["StartFrequency"]),
            idle_time=float(raw["Ideltime"]),
            f_design=float(raw["F_design"]),
            range_fftsize=raw["range_fftsize"],
            doppler_fftsize=raw["doppler_fftsize"],
            azimuth_fftsize=raw["ANGLE_fftsize"],
            elevation_fftsize=raw["ELEVATION_fftsize"],
            fs=float(raw["Fs"]),
            sample_per_chirp_up=raw["SamplePerChripUp"],
            kr=float(raw["Kr"]),
            chirp_ramp_time=float(raw["chirpRampTime"]),
            adc_start_time=float(raw["adc_start_time"]),
            angles_doa_az=tuple(raw["angles_DOA_az"]),
            angles_doa_ele=tuple(raw["angles_DOA_ele"]),
            crop_low=float(raw.get("crop_low", 0.05)),
            crop_high=float(raw.get("crop_high", 0.05)),
        )

    # Derived chirp timings (reference: radardsp.py:163-167).
    @property
    def ramp_end_time(self) -> float:
        return self.chirp_ramp_time + self.adc_start_time

    @property
    def chirp_time(self) -> float:
        return self.idle_time + self.ramp_end_time

    @property
    def max_range(self) -> float:
        """max unambiguous range (reference: cache_test_cfar.py:134-136)."""
        chirp_bandwidth = self.kr * self.chirp_ramp_time
        return (3e8 * self.chirp_ramp_time * self.fs) / (2 * chirp_bandwidth)


def parse_antenna_array(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    """Parse the TX/RX layout file (reference: radar.py:36-54 format).

    Each non-comment line is ``{tx|rx} idx azimuth elevation`` in units of
    half a wavelength. Returns ``(txl, rxl)`` int arrays of shape (n, 3).
    """
    txl, rxl = [], []
    with open(path, "r") as fh:
        for line in fh:
            if line.startswith("# "):
                continue
            chunks = line.strip().split(" ")
            if not chunks:
                continue
            if chunks[0] == "rx":
                rxl.append([int(x) for x in chunks[1:]])
            elif chunks[0] == "tx":
                txl.append([int(x) for x in chunks[1:]])
    return np.array(txl), np.array(rxl)
