"""Both nearest-neighbour minima of exact squared distances: CUDA kernel and
plain version.

Counterpart of ``rald_tpu/ops/nn_dist_kernel.py::nn_min_sq_both`` (Pallas
body ``_nn_min_both_kernel`` :57-83). The CUDA kernel is
``rald_torch/csrc/nn_dist.cu``; :func:`nn_min_sq_both_plain` is the same
exact subtract-square in PyTorch ops, and the two are bitwise equal.

Padding contract (as the JAX wrapper's): rows beyond a frame's real count
carry ``BIG`` coordinates so they never win a min against real rows; their
own outputs are garbage the caller masks.
"""
from __future__ import annotations

import ctypes

import torch

from rald_torch.ops import _build

BIG = 1e9  # pad coordinate: real points are O(10 m), d2 vs a pad ~ 1e18


def nn_min_sq_both_plain(a: torch.Tensor, b: torch.Tensor, chunk_elems: int = 1 << 24):
    """(B, N, 3), (B, M, 3) f32 -> ((B, N), (B, M)) min squared distances.

    ``dx*dx + dy*dy + dz*dz`` as separate tensor ops, left to right (no
    fused multiply-add), chunked over the a rows to bound memory.
    """
    bsz, n, _ = a.shape
    m = b.shape[1]
    a = a.float()
    b = b.float()
    row = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    col = torch.full((bsz, m), float("inf"), dtype=torch.float32, device=a.device)
    step = max(1, chunk_elems // max(m, 1))
    bx, by, bz = (b[:, None, :, k] for k in range(3))
    for s in range(0, n, step):
        ac = a[:, s:s + step]
        dx = ac[:, :, None, 0] - bx
        dy = ac[:, :, None, 1] - by
        dz = ac[:, :, None, 2] - bz
        d = dx * dx + dy * dy
        d = d + dz * dz
        row[:, s:s + step] = d.amin(2)
        col = torch.minimum(col, d.amin(1))
    return row, col


def nn_min_sq_both(a: torch.Tensor, b: torch.Tensor):
    """Row and column minima from one sweep; kernel on CUDA, plain version on CPU."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"nn_min_sq_both: need (B, N, 3) and (B, M, 3), got {tuple(a.shape)}, {tuple(b.shape)}"
        )
    if a.device.type == "cpu":
        return nn_min_sq_both_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"nn_min_sq_both: unsupported device {a.device}")
    for t in (a, b):
        if t.device != a.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"nn_min_sq_both: operands must be contiguous f32 on {a.device}")
    bsz, n, _ = a.shape
    m = b.shape[1]
    if n == 0 or m == 0:
        raise ValueError("nn_min_sq_both: empty point set (pad with BIG rows instead)")
    row = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    col = torch.empty((bsz, m), dtype=torch.float32, device=a.device)
    fn = _build.load("nn_dist").rald_nn_min_sq_both_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rc = fn(
        a.data_ptr(), b.data_ptr(), row.data_ptr(), col.data_ptr(), bsz, n, m,
        torch.cuda.current_stream(a.device).cuda_stream,
    )
    _build.check(rc, "nn_min_sq_both")
    nn_min_sq_both.launches += 1
    return row, col


nn_min_sq_both.launches = 0
