"""The split of a QKV projection's rows into attention heads with RMS
QK-norm: a CUDA kernel (``rald_torch/csrc/qk_norm.cu``) and its plain
version.

Hunyuan3D's DiT (:mod:`rald_torch.models.mmdit`) turns each stream's
``qkv`` rows, ``[q | k | v]`` of ``heads`` heads each, into the (B, H, L,
Dh) tensors that ``F.scaled_dot_product_attention`` reads, q and k
RMS-normed with their own scales. A dual-stream block joins two streams
along the tokens, in the order given (condition, then latents); a
single-stream block passes one stream, a slice of ``linear1``'s wider
rows. The plain version (:func:`split_qk_norm_plain`, CPU tensors) is a
view, a permute, ``F.rms_norm`` and, for two streams, ``torch.cat``. On
the card the kernel writes q, k and, for two streams, v into tensors the
wrapper allocates, one launch a stream at the stream's token offset; one
stream's v stays a view of its rows, as in the plain version, since SDPA
reads it in place. It takes bf16 or float32 at a head width of 64.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from rald_torch.ops import _build

HEAD_DIM = 64  # the kernel's head width (csrc/qk_norm.cu HD)


def _heads(qkv: torch.Tensor, heads: int):
    """(B, L, 3 * H * Dh) rows -> q, k, v views (B, H, L, Dh)."""
    b, n, _ = qkv.shape
    return qkv.view(b, n, 3, heads, -1).permute(2, 0, 3, 1, 4).unbind(0)


def split_qk_norm_plain(parts, heads: int, eps: float = 1e-6):
    """Each part ``(qkv, q_scale, k_scale)`` -> its q, k, v (B, H, L, Dh),
    q and k ``F.rms_norm``-ed (statistics and scale in float32, rounded to
    the input's dtype once); two or more parts joined along L in order."""
    out = []
    for qkv, q_scale, k_scale in parts:
        q, k, v = _heads(qkv, heads)
        dh = (q.shape[-1],)
        out.append((F.rms_norm(q, dh, q_scale, eps), F.rms_norm(k, dh, k_scale, eps), v))
    if len(out) == 1:
        return out[0]
    return tuple(torch.cat(t, 2) for t in zip(*out))


def check_part(qkv, q_scale, k_scale, heads: int, n_tot: int, offset: int) -> None:
    """Raise ``ValueError`` unless the kernel takes this part: (B, L, >= 3 *
    heads * 64) rows of bf16 or float32 with unit stride along a row and
    16-byte row and batch steps, two contiguous 64-value scales of the same
    dtype, and tokens ``[offset, offset + L)`` inside ``[0, n_tot)``."""
    if qkv.dim() != 3:
        raise ValueError(f"split_qk_norm: qkv must be (B, L, 3 * H * Dh), got {tuple(qkv.shape)}")
    if qkv.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"split_qk_norm: dtype {qkv.dtype} (the kernel takes bfloat16 or float32)")
    if heads <= 0 or qkv.shape[-1] % (3 * heads) or qkv.shape[-1] // (3 * heads) != HEAD_DIM:
        raise ValueError(f"split_qk_norm: {qkv.shape[-1]} channels over 3 x {heads} heads is not "
                         f"a head width of {HEAD_DIM}")
    for s in (q_scale, k_scale):
        if s.shape != (HEAD_DIM,) or s.dtype != qkv.dtype or not s.is_contiguous():
            raise ValueError(f"split_qk_norm: scales must be contiguous ({HEAD_DIM},) {qkv.dtype}")
    step = 16 // qkv.element_size()
    if qkv.stride(2) != 1 or qkv.stride(0) % step or qkv.stride(1) % step:
        raise ValueError(f"split_qk_norm: qkv strides {qkv.stride()} need unit stride along a "
                         f"row and row and batch steps of 16 bytes")
    if offset < 0 or offset + qkv.shape[1] > n_tot:
        raise ValueError(f"split_qk_norm: tokens [{offset}, {offset + qkv.shape[1]}) outside "
                         f"the {n_tot} of the outputs")


def split_qk_norm(parts, heads: int, eps: float = 1e-6):
    """``parts``: ``(qkv, q_scale, k_scale)`` per stream, each qkv (B, L_i,
    3 * heads * Dh), its rows possibly wider (a slice of a larger
    projection). Returns q, k, v (B, heads, sum L_i, Dh): q and k RMS-normed
    with the part's scales at ``eps``, the parts in order along L. Kernel on
    CUDA (one launch a part), plain version on CPU. The kernel has no
    backward: off the CPU it raises where autograd would need one."""
    parts = [tuple(p) for p in parts]
    first = parts[0][0]
    if first.device.type == "cpu":
        return split_qk_norm_plain(parts, heads, eps)
    bsz = first.shape[0]
    n_tot = sum(p[0].shape[1] for p in parts)
    offset = 0
    for qkv, q_scale, k_scale in parts:
        check_part(qkv, q_scale, k_scale, heads, n_tot, offset)
        offset += qkv.shape[1]
        if qkv.shape[0] != bsz or qkv.dtype != first.dtype:
            raise ValueError("split_qk_norm: the parts differ in batch or dtype")
    if torch.is_grad_enabled() and any(t.requires_grad for p in parts for t in p):
        raise ValueError("split_qk_norm: the kernel has no backward; call it under torch.no_grad()")
    if first.device.type != "cuda":
        raise ValueError(f"split_qk_norm: unsupported device {first.device}")
    if any(t.device != first.device or t.data_ptr() % 16 for p in parts for t in p):
        raise ValueError(f"split_qk_norm: every tensor 16-byte aligned on {first.device}")
    shape = (bsz, heads, n_tot, HEAD_DIM)
    q = torch.empty(shape, dtype=first.dtype, device=first.device)
    k = torch.empty_like(q)
    v = torch.empty_like(q) if len(parts) > 1 else None
    fn = _build.load("qk_norm").rald_split_qk_norm
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(first.device).cuda_stream
    offset = 0
    for qkv, q_scale, k_scale in parts:
        n = qkv.shape[1]
        rc = fn(qkv.data_ptr(), qkv.stride(0), qkv.stride(1), q_scale.data_ptr(),
                k_scale.data_ptr(), q.data_ptr(), k.data_ptr(), None if v is None else v.data_ptr(),
                bsz, n, heads, n_tot, offset, int(first.dtype == torch.float32), eps, stream)
        _build.check(rc, "split_qk_norm")
        split_qk_norm.launches += 1
        offset += n
    if v is None:
        v = _heads(first, heads)[2]
    return q, k, v


split_qk_norm.launches = 0
