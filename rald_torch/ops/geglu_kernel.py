"""Fused (LN + mod) -> GEGLU FF -> residual: CUDA kernel and plain version.

Counterpart of ``rald_tpu/ops/geglu_kernel.py::fused_ln_geglu_residual``
(Pallas body ``_ln_kernel`` :96-128). The CUDA kernel is
``rald_torch/csrc/geglu.cu``; :func:`fused_ln_geglu_residual_plain` repeats
its arithmetic, rounding point by rounding point, in plain PyTorch.

:func:`fused_ln_geglu_residual` launches the kernel for CUDA tensors and
runs the plain version for CPU tensors (tests, CPU runs); a CUDA tensor
launches the kernel or raises, with no fallback to the plain version.

Weights are in the torch layout: ``w1`` (2*inner, D) — value rows
``[:inner]``, gate rows ``[inner:]`` — and ``w2`` (D, inner).
"""
from __future__ import annotations

import ctypes

import torch

from rald_torch.ops import _build


def _mod_rows(a: torch.Tensor, bsz: int, dim: int, name: str) -> torch.Tensor:
    rows = a.reshape(-1, dim)
    if a.dim() >= 2 and a.shape[-2] != 1 or rows.shape[0] not in (1, bsz):
        raise ValueError(
            f"fused_ln_geglu_residual: {name} must be (B, 1, D)- or (1, D)-"
            f"broadcastable, got {tuple(a.shape)}"
        )
    return rows


def fused_ln_geglu_residual_plain(
    x, scale, shift, w1, b1, w2, b2, scale_shift_mod: bool = True, ln_eps: float = 1e-5
):
    """The kernel's arithmetic in PyTorch ops: x (B, N, D) -> (B, N, D)."""
    dt = x.dtype
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - m * m
    h = (xf - m) * torch.rsqrt(var + ln_eps)
    s = scale.to(dt).float()
    b = shift.to(dt).float()
    h = h * (1.0 + s) + b if scale_shift_mod else h * s + b
    h = h.to(dt)
    inner = w1.shape[0] // 2
    p = torch.matmul(h.float(), w1.to(dt).float().t()) + b1.to(dt).float()
    p = p.to(dt)
    val, gate = p[..., :inner], p[..., inner:]
    gl = torch.nn.functional.gelu(gate.float()).to(dt)
    g = (val.float() * gl.float()).to(dt)
    out = torch.matmul(g.float(), w2.to(dt).float().t()) + b2.to(dt).float() + xf
    return out.to(dt)


def fused_ln_geglu_residual(
    x, scale, shift, w1, b1, w2, b2, scale_shift_mod: bool = True, ln_eps: float = 1e-5
):
    """``x + (proj_in -> GEGLU -> proj_out)(mod(LN(x)))`` in one kernel.

    x: (B, N, D); scale/shift: one modulation row per batch element
    (B, 1, D) or one row for all (1, D) / (1, 1, D); AdaLN
    ``h*(1+scale)+shift`` when ``scale_shift_mod``, else ``h*scale+shift``.
    On the card: bf16, D = 512, inner a multiple of 64; anything else raises.
    """
    if x.dim() != 3:
        raise ValueError(f"fused_ln_geglu_residual: x must be (B, N, D), got {tuple(x.shape)}")
    bsz, n, dim = x.shape
    inner = w1.shape[0] // 2
    if w1.shape != (2 * inner, dim) or w2.shape != (dim, inner):
        raise ValueError(
            f"fused_ln_geglu_residual: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
            f"do not match D={dim} (torch layout: w1 (2*inner, D), w2 (D, inner))"
        )
    s_rows = _mod_rows(scale, bsz, dim, "scale")
    b_rows = _mod_rows(shift, bsz, dim, "shift")
    if x.device.type == "cpu":
        return fused_ln_geglu_residual_plain(
            x, scale, shift, w1, b1, w2, b2, scale_shift_mod, ln_eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"fused_ln_geglu_residual: unsupported device {x.device}")
    lib = _build.load("geglu")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"fused_ln_geglu_residual: the CUDA kernel takes bf16, got {x.dtype}")
    if dim != lib.rald_geglu_width() or inner % 64 or n == 0:
        raise ValueError(
            f"fused_ln_geglu_residual: the CUDA kernel takes D={lib.rald_geglu_width()} "
            f"and inner % 64 == 0, got D={dim}, inner={inner}, N={n}"
        )
    if s_rows.shape[0] != b_rows.shape[0]:
        raise ValueError("fused_ln_geglu_residual: scale and shift rows differ in count")
    args = [x, s_rows, b_rows, w1, b1, w2, b2]
    for t in args:
        if t.device != x.device or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(
                "fused_ln_geglu_residual: every operand must be a contiguous bf16 "
                f"tensor on {x.device}"
            )
    if w1.data_ptr() % 32 or w2.data_ptr() % 32:
        raise ValueError("fused_ln_geglu_residual: weights must be 32-byte aligned")
    splits = lib.rald_geglu_splits(bsz, n, inner)
    n_pad = -(-n // lib.rald_geglu_row_tile()) * lib.rald_geglu_row_tile()
    part = torch.empty((splits, bsz, n_pad, dim), dtype=torch.float32, device=x.device)
    out = torch.empty_like(x)
    fn = lib.rald_fused_ln_geglu_residual_bf16
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(
        x.data_ptr(), s_rows.data_ptr(), b_rows.data_ptr(),
        0 if s_rows.shape[0] == 1 else dim,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), part.data_ptr(),
        out.data_ptr(), bsz, n, inner, splits, int(bool(scale_shift_mod)), float(ln_eps),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, "fused_ln_geglu_residual")
    fused_ln_geglu_residual.launches += 1
    return out


fused_ln_geglu_residual.launches = 0
