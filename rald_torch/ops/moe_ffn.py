"""The routed experts' feed-forward of a mixture-of-experts layer, grouped
by expert: a CUDA kernel (``rald_torch/csrc/moe_ffn.cu``) and its plain
version.

The rows come sorted by expert: expert ``e`` owns rows ``[offsets[e],
offsets[e + 1])``, ``offsets`` an (E + 1,) int32 device tensor. Each row's
output is its expert's FFN times the row's gate weight:

    y = gate * (W2_e gelu(W1_e x + b1_e) + b2_e)

with exact GELU. Rounding points, in the rows' dtype: the first product +
b1, the GELU, the second product + b2, the product with the float32 gate.

The plain version (:func:`moe_grouped_ffn_plain`) is the per-expert loop
with the offsets read on the host. The kernel (bf16) reads the offsets in
device memory instead, so its launches never wait for the host and a CUDA
graph can hold them: two launches a call (one a GEMM) whatever the routing.
Each 128-row tile of a GEMM's grid finds its expert and rows from the
offsets; tiles that straddle an expert's end compute past it and store
only its rows, so no row is dropped and an expert is padded only to its
last tile.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rald_torch.ops import _build

# the kernel's column tile (csrc/moe_ffn.cu BN): both widths are multiples of it
INNER_MULTIPLE = 128


def moe_grouped_ffn_plain(x, offsets, w1, b1, w2, b2, gate):
    """The per-expert loop over expert-sorted rows ``x`` (R, D): w1 (E,
    inner, D), b1 (E, inner), w2 (E, D, inner), b2 (E, D), gate (R,)
    float32, offsets (E + 1,). Host indexing: not for a captured graph."""
    out = torch.empty(x.shape[0], w2.shape[1], dtype=x.dtype, device=x.device)
    off = offsets.tolist()
    for e in range(w1.shape[0]):
        a, b = off[e], off[e + 1]
        if a == b:
            continue
        h = F.gelu(F.linear(x[a:b], w1[e], b1[e]))
        out[a:b] = (F.linear(h, w2[e], b2[e]).float() * gate[a:b, None]).to(x.dtype)
    return out


def check_args(x, offsets, w1, b1, w2, b2, gate) -> None:
    """Raise ``ValueError`` unless the kernel takes these: bf16 rows and
    weights, contiguous, widths multiples of 128, int32 offsets, float32
    gate weights, all on one device."""
    if x.dtype != torch.bfloat16 or any(t.dtype != x.dtype for t in (w1, b1, w2, b2)):
        raise ValueError(f"moe_grouped_ffn: the kernel takes bfloat16 rows and weights, got {x.dtype}")
    e, inner, d = w1.shape
    if (x.dim() != 2 or x.shape[1] != d or w2.shape != (e, d, inner) or b1.shape != (e, inner)
            or b2.shape != (e, d) or offsets.shape != (e + 1,) or gate.shape != (x.shape[0],)):
        raise ValueError("moe_grouped_ffn: shapes x (R, D), w1 (E, inner, D), b1 (E, inner), "
                         "w2 (E, D, inner), b2 (E, D), offsets (E + 1,), gate (R,)")
    if d % INNER_MULTIPLE or inner % INNER_MULTIPLE:
        raise ValueError(f"moe_grouped_ffn: widths {d} and {inner} must be multiples of "
                         f"{INNER_MULTIPLE}")
    if offsets.dtype != torch.int32 or gate.dtype != torch.float32:
        raise ValueError("moe_grouped_ffn: int32 offsets and float32 gate weights")
    ts = (x, offsets, w1, b1, w2, b2, gate)
    if any(not t.is_contiguous() or t.device != x.device for t in ts):
        raise ValueError("moe_grouped_ffn: every tensor contiguous and on one device")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("moe_grouped_ffn: rows and weights 16-byte aligned")


def moe_grouped_ffn(x, offsets, w1, b1, w2, b2, gate):
    """``x`` (R, D) rows sorted by expert, expert ``e`` owning rows
    ``[offsets[e], offsets[e + 1])``; returns (R, D) ``gate * FFN_e(x)``.
    Kernel on CUDA (bf16; two launches), plain version on the CPU. The
    kernel has no backward."""
    if x.device.type == "cpu":
        return moe_grouped_ffn_plain(x, offsets, w1, b1, w2, b2, gate)
    check_args(x, offsets, w1, b1, w2, b2, gate)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, w1, b1, w2, b2, gate)):
        raise ValueError("moe_grouped_ffn: the kernel has no backward; call it under torch.no_grad()")
    if x.device.type != "cuda":
        raise ValueError(f"moe_grouped_ffn: unsupported device {x.device}")
    e, inner, d = w1.shape
    rows = x.shape[0]
    h = torch.empty(rows, inner, dtype=x.dtype, device=x.device)
    out = torch.empty(rows, d, dtype=x.dtype, device=x.device)
    fn = _build.load("moe_ffn").rald_moe_grouped_ffn
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = fn(x.data_ptr(), offsets.data_ptr(), e, rows, d, inner, w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), gate.data_ptr(), h.data_ptr(), out.data_ptr(), stream)
    _build.check(rc, "moe_grouped_ffn")
    moe_grouped_ffn.launches += 2
    return out


moe_grouped_ffn.launches = 0
