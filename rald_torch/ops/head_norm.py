"""RMS QK-norm of 128-wide attention heads in the projections' own layout:
a CUDA kernel (``rald_torch/csrc/head_norm.cu``) and its plain version.

Hunyuan3D-2.1's DiT (:mod:`rald_torch.models.hunyuan_dit`) projects q and
k with separate bias-free ``to_q`` / ``to_k`` layers into (B, L, H * Dh)
rows, q over the tokens and k over the tokens or, in cross-attention, the
condition tokens, and RMS-norms each head with the norm's own ``weight``.
The plain version (:func:`head_rms_norm_plain`, CPU tensors) is a view, a
transpose and ``F.rms_norm``. On the card one launch norms q and k in
place, where the projections wrote them, and returns their (B, H, L, Dh)
views, which ``F.scaled_dot_product_attention`` reads as they lie. The
kernel takes bf16 at a head width of 128.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rald_torch.ops import _build

HEAD_DIM = 128  # the kernel's head width (csrc/head_norm.cu HD)


def heads_view(rows: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, L, H * Dh) -> its (B, H, L, Dh) view."""
    b, n, _ = rows.shape
    return rows.view(b, n, heads, -1).transpose(1, 2)


def head_rms_norm_plain(rows: torch.Tensor, weight: torch.Tensor, heads: int,
                        eps: float = 1e-6) -> torch.Tensor:
    """(B, L, H * Dh) rows -> (B, H, L, Dh) heads, each ``F.rms_norm``-ed
    with ``weight`` (statistics and scale in float32, rounded to the
    input's dtype once)."""
    t = heads_view(rows, heads)
    return F.rms_norm(t, (t.shape[-1],), weight, eps)


def check_part(rows, weight, heads: int) -> None:
    """Raise ``ValueError`` unless the kernel takes this tensor: (B, L,
    heads * 128) bf16 rows with unit stride along a row and 16-byte row and
    batch steps, and a contiguous 128-value bf16 weight, both 16-byte
    aligned."""
    if rows.dim() != 3:
        raise ValueError(f"head_rms_norm: rows must be (B, L, H * Dh), got {tuple(rows.shape)}")
    if rows.dtype != torch.bfloat16:
        raise ValueError(f"head_rms_norm: dtype {rows.dtype} (the kernel takes bfloat16)")
    if heads <= 0 or rows.shape[-1] != heads * HEAD_DIM:
        raise ValueError(f"head_rms_norm: {rows.shape[-1]} channels over {heads} heads is not a "
                         f"head width of {HEAD_DIM}")
    if weight.shape != (HEAD_DIM,) or weight.dtype != rows.dtype or not weight.is_contiguous():
        raise ValueError(f"head_rms_norm: weight must be contiguous ({HEAD_DIM},) {rows.dtype}")
    step = 16 // rows.element_size()
    if rows.stride(2) != 1 or rows.stride(0) % step or rows.stride(1) % step:
        raise ValueError(f"head_rms_norm: rows strides {rows.stride()} need unit stride along a "
                         f"row and row and batch steps of 16 bytes")
    if rows.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("head_rms_norm: every tensor 16-byte aligned")


def head_rms_norm(q_rows: torch.Tensor, k_rows: torch.Tensor, q_weight: torch.Tensor,
                  k_weight: torch.Tensor, heads: int, eps: float = 1e-6) -> tuple:
    """q (B, Lq, heads * Dh) and k (B, Lk, heads * Dh) projection rows ->
    q, k (B, heads, L, Dh), each head RMS-normed with its weight at ``eps``.

    The kernel on CUDA norms the rows in place and returns (B, heads, L, Dh)
    views of them, one launch for both; the plain version on the CPU returns
    ``F.rms_norm``'s own tensors and leaves the rows as they were. The
    kernel has no backward: off the CPU it raises where autograd would need
    one."""
    pairs = ((q_rows, q_weight), (k_rows, k_weight))
    if q_rows.device.type == "cpu":
        return tuple(head_rms_norm_plain(r, w, heads, eps) for r, w in pairs)
    for r, w in pairs:
        check_part(r, w, heads)
    if q_rows.shape[0] != k_rows.shape[0]:
        raise ValueError("head_rms_norm: q and k differ in batch")
    tensors = (q_rows, k_rows, q_weight, k_weight)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise ValueError("head_rms_norm: the kernel has no backward; call it under torch.no_grad()")
    if q_rows.device.type != "cuda":
        raise ValueError(f"head_rms_norm: unsupported device {q_rows.device}")
    if any(t.device != q_rows.device for t in tensors):
        raise ValueError(f"head_rms_norm: every tensor on {q_rows.device}")
    qs, ks = ((ctypes.c_longlong * 2)(*r.stride()[:2]) for r in (q_rows, k_rows))
    fn = _build.load("head_norm").rald_head_rms_norm
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] * 2
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(q_rows.device).cuda_stream
    rc = fn(q_rows.data_ptr(), qs, q_weight.data_ptr(), q_rows.shape[1], k_rows.data_ptr(), ks,
            k_weight.data_ptr(), k_rows.shape[1], q_rows.shape[0], heads, eps, stream)
    _build.check(rc, "head_rms_norm")
    head_rms_norm.launches += 1
    return heads_view(q_rows, heads), heads_view(k_rows, heads)


head_rms_norm.launches = 0
