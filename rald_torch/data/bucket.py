"""Bucket padding for ragged eval shapes: the port's own copy of
``rald_tpu/data/bucket.py``.

The reference's eval configs run ``dataset.lidar.sampling: false`` (raw
per-frame point counts). The dataset pads ragged arrays up to a small
fixed ladder of bucket sizes with a validity mask, so every consumer sees
at most ``len(buckets)`` distinct shapes and a batch of the port equals
the JAX package's batch element for element.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

DEFAULT_EVAL_BUCKETS = (8192, 16384, 32768, 65536)


def pick_bucket(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n, else the largest bucket (caller truncates)."""
    for b in sorted(buckets):
        if n <= b:
            return int(b)
    return int(max(buckets))


def pad_axis0(arr: np.ndarray, size: int, fill: float = 0.0) -> tuple[np.ndarray, np.ndarray]:
    """Pad (or truncate) ``arr`` along axis 0 to ``size``.

    Returns ``(padded, mask)`` with ``mask`` float32 (size,): 1 for real
    rows, 0 for padding.
    """
    n = arr.shape[0]
    if n >= size:
        return np.ascontiguousarray(arr[:size]), np.ones(size, dtype=np.float32)
    pad_shape = (size - n,) + arr.shape[1:]
    padded = np.concatenate([arr, np.full(pad_shape, fill, dtype=arr.dtype)], axis=0)
    mask = np.zeros(size, dtype=np.float32)
    mask[:n] = 1.0
    return padded, mask
