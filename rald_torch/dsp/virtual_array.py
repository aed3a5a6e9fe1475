"""TDM-MIMO virtual antenna array synthesis and velocity compensation
(``rald_tpu/dsp/virtual_array.py:18-81``; reference
``dataset_preprocessor/utils/radardsp.py``: ``virtual_array`` :54-111,
``velocity_compensation`` :526-545, ``steering_matrix`` :29-52).

The (tx, rx) pairs land on the virtual (el, az) grid through host-built
gather indices: each grid position sums the pairs that map to it, padded
with an all-zero pair. The sum is exact in complex64, as JAX's 0/1 matmul
is, and no TF32 product can round the samples.
"""
from __future__ import annotations

import numpy as np
import torch


def virtual_array_shape(txl: np.ndarray, rxl: np.ndarray) -> tuple[int, int]:
    """(n_elevation, n_azimuth) of the virtual array (reference: radardsp.py:82-97)."""
    ne = int(np.max(txl[:, 2]) + np.max(rxl[:, 2]) + 1)
    na = int(np.max(txl[:, 1]) + np.max(rxl[:, 1]) + 1)
    return ne, na


def _position_pairs(txl: np.ndarray, rxl: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host-side (tx, rx) of every pair, and for each of the ne * na grid
    positions the pairs that sum into it, padded with index ``npairs`` (the
    zero pair): ``(tx_idx, rx_idx, gather)`` with gather (ne * na, kmax)."""
    ne, na = virtual_array_shape(txl, rxl)
    tx_idx, rx_idx, members = [], [], [[] for _ in range(ne * na)]
    for tidx, taz, tel in txl:
        for ridx, raz, rel in rxl:
            members[(tel + rel) * na + taz + raz].append(len(tx_idx))
            tx_idx.append(tidx)
            rx_idx.append(ridx)
    kmax = max(len(m) for m in members)
    gather = np.full((ne * na, kmax), len(tx_idx), dtype=np.int64)
    for pos, m in enumerate(members):
        gather[pos, : len(m)] = m
    return np.asarray(tx_idx), np.asarray(rx_idx), gather


def virtual_array(adc_samples: torch.Tensor, txl: np.ndarray, rxl: np.ndarray) -> torch.Tensor:
    """Map (..., ntx, nrx, nc, ns) samples into the (..., nel, naz, nc, ns)
    virtual array. Colliding (el, az) positions accumulate, matching the
    reference's "+=" (radardsp.py:105-111)."""
    txl = np.asarray(txl)
    rxl = np.asarray(rxl)
    ne, na = virtual_array_shape(txl, rxl)
    tx_idx, rx_idx, gather = _position_pairs(txl, rxl)
    dev = adc_samples.device
    pairs = adc_samples[..., torch.as_tensor(tx_idx, device=dev), torch.as_tensor(rx_idx, device=dev), :, :]
    pairs = torch.cat([pairs, torch.zeros_like(pairs[..., :1, :, :])], dim=-3)
    va = pairs[..., torch.as_tensor(gather, device=dev), :, :].sum(dim=-3)
    return va.reshape(*adc_samples.shape[:-4], ne, na, *adc_samples.shape[-2:])


def velocity_compensation(ntx: int, nc: int, device=None) -> torch.Tensor:
    """TDM-MIMO velocity-induced phase-shift correction matrix
    (reference: radardsp.py:526-545). Shape (ntx, 1, nc, 1), complex64."""
    tl = np.arange(0, ntx)
    cl = np.arange(-(nc // 2), nc // 2)
    tcl = np.kron(tl, cl) / (ntx * nc)
    vcomp = np.exp(-2j * np.pi * tcl).reshape(ntx, 1, nc, 1)
    return torch.as_tensor(vcomp, dtype=torch.complex64, device=device)


def steering_matrix(txl: np.ndarray, rxl: np.ndarray, az: np.ndarray, el: np.ndarray) -> np.ndarray:
    """Virtual-array steering matrix (reference: radardsp.py:29-52)."""
    taz, tel = txl[:, 1], txl[:, 2]
    raz, rel = rxl[:, 1], rxl[:, 2]
    laz = (np.kron(taz, np.ones(len(raz))).reshape(-1, len(raz)) + raz).reshape(-1, 1)
    lel = (np.kron(tel, np.ones(len(rel))).reshape(-1, len(rel)) + rel).reshape(-1, 1)
    return np.exp(1j * np.pi * (laz * (np.cos(az) * np.sin(el)) + lel * np.cos(el)))
