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

On the card the M axis is cut into :func:`split_plan` slices, one block per
(a tile, slice, frame), so that a small row set still fills every SM; the
slices' minima combine exactly.

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


# the kernels' geometry, as csrc/nn_dist.cu: a rows per block and b points per
# split chunk (a slice is a run of whole chunks)
TILE_A, CHUNK = 4096, 64
WAVES = 4  # blocks wanted: at least this many per SM


def split_plan(bsz: int, n: int, m: int, sm_count: int) -> int:
    """The number S of slices of the M axis, one block per (a tile, slice,
    frame), on a card of ``sm_count`` SMs: 1 where the a tiles alone give
    ``WAVES`` blocks per SM (the main path's batch 8), else the least S that
    does, at most one chunk a slice."""
    tiles = bsz * -(-n // TILE_A)
    target = WAVES * sm_count
    if tiles >= target:
        return 1
    return min(-(-m // CHUNK), -(-target // tiles))


def _run(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor, col: bool):
    """Launch one of ``lib``'s kernels on checked operands: ``(row, col,
    S)``, col None for the row-only kernel."""
    bsz, n, _ = a.shape
    m = b.shape[1]
    sms = torch.cuda.get_device_properties(a.device).multi_processor_count
    nsplit = split_plan(bsz, n, m, sms)
    row = torch.empty((bsz, n), dtype=torch.float32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if col:
        cm = torch.empty((bsz, m), dtype=torch.float32, device=a.device)
        fn = lib.rald_nn_min_sq_both_f32
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        rc = fn(a.data_ptr(), b.data_ptr(), row.data_ptr(), cm.data_ptr(), bsz, n, m, nsplit,
                stream)
    else:
        cm = None
        fn = lib.rald_nn_min_sq_batch_f32
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        rc = fn(a.data_ptr(), b.data_ptr(), row.data_ptr(), bsz, n, m, nsplit, stream)
    _build.check(rc, "nn_min_sq_both" if col else "nn_min_sq_batch")
    return row, cm, nsplit


def nn_min_sq_both(a: torch.Tensor, b: torch.Tensor):
    """Row and column minima from one sweep; kernel on CUDA, plain version on CPU."""
    _check_pair("nn_min_sq_both", a, b)
    if a.device.type == "cpu":
        return nn_min_sq_both_plain(a, b)
    _check_card("nn_min_sq_both", a, b)
    row, col, nn_min_sq_both.split = _run(_build.load("nn_dist"), a, b, True)
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
    row, _, nn_min_sq_batch.split = _run(_build.load("nn_dist"), a, b, False)
    nn_min_sq_batch.launches += 1
    return row


nn_min_sq_both.launches = 0
nn_min_sq_batch.launches = 0
# the slice count S of each wrapper's last launch
nn_min_sq_both.split = None
nn_min_sq_batch.split = None
