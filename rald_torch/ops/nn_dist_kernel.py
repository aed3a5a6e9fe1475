"""Nearest-neighbour minima of exact squared distances: CUDA kernels and
plain versions.

Counterparts of ``rald_tpu/ops/nn_dist_kernel.py``: ``nn_min_sq_both``
(both minima from one sweep; Pallas body ``_nn_min_both_kernel`` :57-83)
and ``nn_min_sq_batch`` (the row minimum only; ``_nn_min_kernel`` :36-54,
wrapper :144-179). The CUDA kernels are ``rald_torch/csrc/nn_dist.cu``;
the ``*_plain`` functions are the same exact subtract-square in PyTorch
ops, and each kernel is bitwise equal to its plain version. The row output
of ``nn_min_sq_batch`` is bitwise that of ``nn_min_sq_both``, as the JAX
module promises (:97-100).

Padding contract (as the JAX wrapper's): rows beyond a frame's real count
carry ``BIG`` coordinates so they never win a min against real rows; their
own outputs are garbage the caller masks.
"""
from __future__ import annotations

import ctypes

import torch

from rald_torch.ops import _build

BIG = 1e9  # pad coordinate: real points are O(10 m), d2 vs a pad ~ 1e18


def _sq_dist_chunks(a: torch.Tensor, b: torch.Tensor, chunk_elems: int):
    """Yield ``(start, d)``: the (B, step, M) squared distances of a-row
    chunks, ``dx*dx + dy*dy + dz*dz`` as separate tensor ops, left to right
    (no fused multiply-add)."""
    a, b = a.float(), b.float()
    step = max(1, chunk_elems // max(b.shape[1], 1))
    bx, by, bz = (b[:, None, :, k] for k in range(3))
    for s in range(0, a.shape[1], step):
        ac = a[:, s:s + step]
        dx = ac[:, :, None, 0] - bx
        dy = ac[:, :, None, 1] - by
        dz = ac[:, :, None, 2] - bz
        d = dx * dx + dy * dy
        yield s, d + dz * dz


def nn_min_sq_both_plain(a: torch.Tensor, b: torch.Tensor, chunk_elems: int = 1 << 24):
    """(B, N, 3), (B, M, 3) f32 -> ((B, N), (B, M)) min squared distances,
    chunked over the a rows to bound memory."""
    bsz, n, _ = a.shape
    row = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    col = torch.full((bsz, b.shape[1]), float("inf"), dtype=torch.float32, device=a.device)
    for s, d in _sq_dist_chunks(a, b, chunk_elems):
        row[:, s:s + d.shape[1]] = d.amin(2)
        col = torch.minimum(col, d.amin(1))
    return row, col


def nn_min_sq_batch_plain(a: torch.Tensor, b: torch.Tensor, chunk_elems: int = 1 << 24):
    """(B, N, 3), (B, M, 3) f32 -> (B, N) min squared distances."""
    row = torch.empty(a.shape[:2], dtype=torch.float32, device=a.device)
    for s, d in _sq_dist_chunks(a, b, chunk_elems):
        row[:, s:s + d.shape[1]] = d.amin(2)
    return row


def _check_pair(name, a, b):
    if a.dim() != 3 or b.dim() != 3 or a.shape[-1] != 3 or b.shape[-1] != 3 or a.shape[0] != b.shape[0]:
        raise ValueError(
            f"{name}: need (B, N, 3) and (B, M, 3), got {tuple(a.shape)}, {tuple(b.shape)}"
        )


def _check_card(name, a, b):
    if a.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {a.device}")
    for t in (a, b):
        if t.device != a.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous f32 on {a.device}")
    if a.shape[1] == 0 or b.shape[1] == 0:
        raise ValueError(f"{name}: empty point set (pad with BIG rows instead)")


def nn_min_sq_both(a: torch.Tensor, b: torch.Tensor):
    """Row and column minima from one sweep; kernel on CUDA, plain version on CPU."""
    _check_pair("nn_min_sq_both", a, b)
    if a.device.type == "cpu":
        return nn_min_sq_both_plain(a, b)
    _check_card("nn_min_sq_both", a, b)
    bsz, n, _ = a.shape
    m = b.shape[1]
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


def nn_min_sq_batch(a: torch.Tensor, b: torch.Tensor):
    """(B, N, 3), (B, M, 3) f32 -> (B, N): for each a row, the min squared
    distance to the b rows. Rows carrying ``BIG`` never win; their own
    outputs are garbage the caller masks. Kernel on CUDA, plain on CPU."""
    _check_pair("nn_min_sq_batch", a, b)
    if a.device.type == "cpu":
        return nn_min_sq_batch_plain(a, b)
    _check_card("nn_min_sq_batch", a, b)
    bsz, n, _ = a.shape
    row = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    fn = _build.load("nn_dist").rald_nn_min_sq_batch_f32
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    rc = fn(a.data_ptr(), b.data_ptr(), row.data_ptr(), bsz, n, b.shape[1],
            torch.cuda.current_stream(a.device).cuda_stream)
    _build.check(rc, "nn_min_sq_batch")
    nn_min_sq_batch.launches += 1
    return row


nn_min_sq_both.launches = 0
nn_min_sq_batch.launches = 0
