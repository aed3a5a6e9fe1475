"""Fused self-attention sublayer, bf16 and int8: CUDA kernels and plain
versions.

Counterparts of ``rald_tpu/ops/attn_kernel.py``:

- :func:`fused_self_attention_block` (``_kernel`` :44-79, wrapper
  :82-137): all four (D, D) projections bf16 (x's dtype). Rounding points:
  scale, shift, the weights and ``bo`` cast to x's dtype; LN (f32, one-pass
  variance) + mod, h rounded; q, k, v each summed in f32 and rounded; per
  head f32 scores times ``dh**-0.5``, ``a = e / sum(e)`` rounded, and each
  head's ``a @ v`` rounded (the int8 kernels keep it f32); ``attn_out @ wo``
  in f32 ``+ bo + x`` rounded once;
- :func:`fused_self_attention_block_int8` (``_int8_kernel`` :140-191,
  wrapper :238-288): all four (D, D) projections int8;
- :func:`fused_self_attention_block_int8_vout` (``_int8_vout_kernel``
  :291-336, wrapper :339-390): q / k projections bf16, v and out int8;
- the side-tree functions :func:`quantize_attn_tree` and
  :func:`merge_int8_trees` (:194-235).

All compute ``x + Wo MHA(mod(LN x)) + bo`` for one batch element at a
time in the JAX package; here the CUDA kernels (``rald_torch/csrc/attn.cu``:
an LN pass, TMA-fed ``wgmma`` projection GEMMs, an exact two-pass softmax
core, a row quantizer for the int8 modes and an out-projection GEMM) tile
it over the card, with tile sizes chosen here (:func:`core_rows`,
``geglu_kernel.gemm2_tile``) so that every launch fills the card. Rounding
points of the int8 kernels, which the plain versions repeat one by one:
h = LN + mod in f32, quantized per row once
(``round(h * (127/hmax))``, half to even) and shared by the int8
projections; projections dequantized ``(acc * (hmax/127)) * s`` and rounded
to x's dtype (vout: q / k from ``hb = h`` rounded to x's dtype, f32 sums
rounded); per head f32 scores times ``dh**-0.5``, ``e = exp(s - max)``,
``a = e / sum(e)`` rounded to x's dtype; ``a @ v`` summed in f32 and kept
f32 (attn_out); attn_out quantized per row over all heads; ``(acc *
(amax/127)) * so + bo + x`` rounded once.

Weights are in the torch layout (out, in) with one f32 scale per output
row; ``bo`` is f32. A wrapper launches its kernel for CUDA tensors and runs
the plain version for CPU tensors; a CUDA tensor never falls back.

On the card x may be bf16 or float32 (JAX's ``compute_dtype``): x's dtype
picks the instantiation, and the modulation rows and the weights of x's
type are cast to it, as the JAX wrappers cast them. Under float32 every
rounding to x's dtype is a no-op, the f32 projections and the attention
core compute exact f32 products on the CUDA cores, and the int8
projections keep their codes: whatever
``torch.get_float32_matmul_precision()`` says, since PyTorch's setting
grants leave to use less precision and does not require it.
"""
from __future__ import annotations

import ctypes

import torch

from rald_torch.ops import _build
from rald_torch.ops.geglu_kernel import (
    _as_act,
    _mod_rows,
    _sm_count,
    check_act_dtype,
    gemm2_tile,
    int_matmul,
    ln_mod_f32,
    quant_rows,
    quantize_cols,
)

_PROJ = (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"), ("to_out", "to_out.0"))


def quantize_attn_tree(state_dict) -> dict:
    """The int8 side-tree of every DiT self-attention: for each
    ``<path>.attn1`` holding ``to_q`` / ``to_k`` / ``to_v`` / ``to_out.0``
    Linear weights, ``{to_q_q, to_q_s, ..., to_out_q, to_out_s}`` as
    :func:`quantize_cols` gives them, plus ``to_out_b``, an f32 copy of the
    out-projection bias. Cross-attention (``attn2``) is not quantized, as in
    the JAX package. Keys are the module paths; pass the f32 weights."""
    sd = state_dict.state_dict() if isinstance(state_dict, torch.nn.Module) else state_dict
    out = {}
    for key in sd:
        if not key.endswith(".attn1.to_q.weight"):
            continue
        path = key[: -len(".to_q.weight")]
        if not all(f"{path}.{mod}.weight" in sd for _, mod in _PROJ):
            continue
        node = {}
        for name, mod in _PROJ:
            node[f"{name}_q"], node[f"{name}_s"] = quantize_cols(sd[f"{path}.{mod}.weight"])
        node["to_out_b"] = sd[f"{path}.to_out.0.bias"].float().clone()
        out[path] = node
    return out


def merge_int8_trees(a: dict, b: dict) -> dict:
    """Deep-merge two int8 side-trees (disjoint leaves)."""
    out = dict(a)
    for k, v in b.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_int8_trees(out[k], v)
        else:
            out[k] = v
    return out


def _attend(q, k, v, heads: int, round_heads: bool = False):
    """Per-head softmax attention at the kernels' rounding points: q, k, v
    (B, N, D) in the working dtype -> attn_out (B, N, D) f32, each head's
    ``a @ v`` rounded to the working dtype when ``round_heads``."""
    bsz, n, d = q.shape
    dh = d // heads

    def split(t):
        return t.reshape(bsz, n, heads, dh).transpose(1, 2).float()

    qh, kh, vh = split(q), split(k), split(v)
    s = torch.matmul(qh, kh.transpose(-1, -2)) * (dh ** -0.5)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    a = (e / e.sum(-1, keepdim=True)).to(q.dtype).float()
    o = torch.matmul(a, vh)
    if round_heads:
        o = o.to(q.dtype).float()
    return o.transpose(1, 2).reshape(bsz, n, d)


def _out_proj(o, xf, wo_q, wo_s, bo, dt):
    aq, arow = quant_rows(o)
    y = int_matmul(aq, wo_q) * arow * wo_s.float().reshape(-1)
    return (y + bo.float().reshape(-1) + xf).to(dt)


def fused_self_attention_block_plain(
    x, scale, shift, wq, wk, wv, wo, bo, heads: int = 8, ln_eps: float = 1e-5,
    scale_shift_mod: bool = True,
):
    """``_kernel`` in PyTorch ops: x (B, N, D) -> (B, N, D); weights in the
    torch layout (out, in)."""
    dt = x.dtype
    xf, h = ln_mod_f32(x, scale, shift, scale_shift_mod, ln_eps)
    hb = h.to(dt).float()
    q, k, v = (torch.matmul(hb, w.to(dt).float().t()).to(dt) for w in (wq, wk, wv))
    o = _attend(q, k, v, heads, round_heads=True)
    y = torch.matmul(o, wo.to(dt).float().t()) + bo.to(dt).float().reshape(-1) + xf
    return y.to(dt)


def fused_self_attention_block_int8_plain(
    x, scale, shift, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, bo,
    heads: int = 8, ln_eps: float = 1e-5, scale_shift_mod: bool = True,
):
    """``_int8_kernel`` in PyTorch ops: x (B, N, D) -> (B, N, D)."""
    dt = x.dtype
    xf, h = ln_mod_f32(x, scale, shift, scale_shift_mod, ln_eps)
    hq, hrow = quant_rows(h)

    def proj(w8, s):
        return (int_matmul(hq, w8) * hrow * s.float().reshape(-1)).to(dt)

    o = _attend(proj(wq_q, wq_s), proj(wk_q, wk_s), proj(wv_q, wv_s), heads)
    return _out_proj(o, xf, wo_q, wo_s, bo, dt)


def fused_self_attention_block_int8_vout_plain(
    x, scale, shift, wq, wk, wv_q, wv_s, wo_q, wo_s, bo,
    heads: int = 8, ln_eps: float = 1e-5, scale_shift_mod: bool = True,
):
    """``_int8_vout_kernel`` in PyTorch ops: q / k from the bf16 (x's dtype)
    ``wq`` / ``wk`` (torch layout), v and out int8."""
    dt = x.dtype
    xf, h = ln_mod_f32(x, scale, shift, scale_shift_mod, ln_eps)
    hb = h.to(dt).float()
    q = torch.matmul(hb, wq.to(dt).float().t()).to(dt)
    k = torch.matmul(hb, wk.to(dt).float().t()).to(dt)
    hq, hrow = quant_rows(h)
    v = (int_matmul(hq, wv_q) * hrow * wv_s.float().reshape(-1)).to(dt)
    return _out_proj(_attend(q, k, v, heads), xf, wo_q, wo_s, bo, dt)


def _check(name, x, scale, shift, weights, heads):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    bsz, n, d = x.shape
    if d % heads:
        raise ValueError(f"{name}: D={d} is not a multiple of heads={heads}")
    for wname, w in weights:
        if w.shape != (d, d):
            raise ValueError(f"{name}: {wname} has shape {tuple(w.shape)}, want ({d}, {d})")
    return _mod_rows(scale, bsz, d, "scale"), _mod_rows(shift, bsz, d, "shift")


def _check_card(name, lib, x, heads) -> int:
    """The card's shape limits; returns 1 for float32 x, 0 for bf16."""
    bsz, n, d = x.shape
    f32 = check_act_dtype(name, x)
    if d != lib.rald_attn_width() or d // heads != lib.rald_attn_head_dim() or not (
            0 < n <= lib.rald_attn_max_tokens()):
        raise ValueError(
            f"{name}: the CUDA kernel takes D={lib.rald_attn_width()}, head dim "
            f"{lib.rald_attn_head_dim()} and 1..{lib.rald_attn_max_tokens()} tokens, "
            f"got D={d}, heads={heads}, N={n}"
        )
    return f32


def _check_operands(name, x, want, what):
    for t, dt in want:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous on {x.device}: {what}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")


# query rows per block of the attention core (16 a warp), largest first:
# each block reads all keys of one head of one frame (K twice, V once), so
# the largest block reads the least, and a small batch needs a smaller block
# to give every SM one
CORE_ROWS = (128, 64, 32)


def core_rows(bsz: int, n: int, heads: int, sms: int) -> int:
    """The attention core's query rows per block for (bsz, n) tokens on a
    card of ``sms`` SMs: the largest whose grid gives every SM a block, else
    the smallest."""
    for rows in CORE_ROWS:
        if -(-n // rows) * heads * bsz >= sms:
            return rows
    return CORE_ROWS[-1]


def launch_tiles(bsz: int, n: int, d: int, heads: int, nproj: int, sms: int) -> tuple:
    """``(core warps, (pm, pn), (om, on))``: the core's block and the
    projection GEMM's (``nproj`` weights of ``d`` columns in one launch) and
    the out GEMM's tiles, each filling a card of ``sms`` SMs."""
    rows = bsz * n
    return (core_rows(bsz, n, heads, sms) // 16, gemm2_tile(rows, nproj * d, sms),
            gemm2_tile(rows, d, sms))


def _launch(name, x, s_rows, b_rows, projs, wo, so, bo, heads, vout, scale_shift_mod, ln_eps):
    """Shared launcher of the int8 kernels: ``projs`` = ((wq, sq), (wk, sk),
    (wv, sv)), with ``sq`` / ``sk`` None for vout's q / k weights of x's
    dtype."""
    bsz, n, d = x.shape
    lib = _build.load("attn")
    f32 = _check_card(name, lib, x, heads)
    if s_rows.shape[0] != b_rows.shape[0]:
        raise ValueError(f"{name}: scale and shift rows differ in count")
    want = [(x, x.dtype), (s_rows, x.dtype), (b_rows, x.dtype),
            (wo, torch.int8), (so, torch.float32), (bo, torch.float32)]
    for w, s in projs:
        want += [(w, torch.int8), (s, torch.float32)] if s is not None else [(w, x.dtype)]
    _check_operands(name, x, want, f"x / scale / shift{' / wq / wk' if vout else ''} of x's "
                                   "dtype, int8 weights, f32 scales and bias")
    m, dev = bsz * n, x.device
    warps, (pm, pn), (om, on) = launch_tiles(bsz, n, d, heads, 2 if vout else 3, _sm_count(dev))
    hb, q, k, v = torch.empty((4, m, d), dtype=x.dtype, device=dev).unbind(0)
    hq, aq = torch.empty((2, m, d), dtype=torch.int8, device=dev).unbind(0)
    o = torch.empty((m, d), dtype=torch.float32, device=dev)
    hmax = torch.empty((m, heads), dtype=torch.float32, device=dev)
    hrow, arow = torch.empty((2, m), dtype=torch.float32, device=dev).unbind(0)
    out = torch.empty_like(x)
    fn = lib.rald_fused_self_attention_block_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 20 + [
        ctypes.c_int] * 11 + [ctypes.c_float, ctypes.c_void_p]
    (wq, sq), (wk, sk), (wv, sv) = projs
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rc = fn(
        x.data_ptr(), s_rows.data_ptr(), b_rows.data_ptr(), 0 if s_rows.shape[0] == 1 else d,
        wq.data_ptr(), ptr(sq), wk.data_ptr(), ptr(sk), wv.data_ptr(), sv.data_ptr(),
        wo.data_ptr(), so.data_ptr(), bo.data_ptr(),
        hq.data_ptr(), hrow.data_ptr(), hb.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), hmax.data_ptr(), arow.data_ptr(), aq.data_ptr(), out.data_ptr(),
        bsz, n, heads, int(vout), warps, pm, pn, om, on, f32, int(bool(scale_shift_mod)),
        float(ln_eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, name)
    return out


def fused_self_attention_block(
    x, scale, shift, wq, wk, wv, wo, bo, heads: int = 8, ln_eps: float = 1e-5,
    scale_shift_mod: bool = True,
):
    """``x + Wo MHA(mod(LN x)) + bo`` with projections of x's dtype.
    x (B, N, D); scale / shift (B, 1, D) or (1, D) mod rows (AdaLN
    ``h*(1+scale)+shift``, or ``h*scale+shift`` without ``scale_shift_mod``);
    wq / wk / wv / wo (D, D) in the torch layout; bo (D,). On the card: bf16
    or float32 x (rows, weights and bo cast to it; float32: exact f32
    products under any matmul precision), D = 512, 8 heads of 64, N up to
    ``rald_attn_max_tokens()``."""
    name = "fused_self_attention_block"
    s_rows, b_rows = _check(name, x, scale, shift, (("wq", wq), ("wk", wk), ("wv", wv),
                                                    ("wo", wo)), heads)
    if bo.numel() != x.shape[-1]:
        raise ValueError(f"{name}: bo has {bo.numel()} values, want {x.shape[-1]}")
    if x.device.type == "cpu":
        return fused_self_attention_block_plain(x, scale, shift, wq, wk, wv, wo, bo, heads,
                                                ln_eps, scale_shift_mod)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    lib = _build.load("attn")
    f32 = _check_card(name, lib, x, heads)
    if s_rows.shape[0] != b_rows.shape[0]:
        raise ValueError(f"{name}: scale and shift rows differ in count")
    bsz, n, d = x.shape
    # the rows, weights and bias rounded to x's dtype
    s_rows, b_rows, *ws, bo_x = _as_act(x, (s_rows, b_rows, wq, wk, wv, wo, bo.reshape(-1)))
    _check_operands(name, x, [(t, x.dtype) for t in (x, s_rows, b_rows, bo_x, *ws)],
                    "x / scale / shift / weights of x's dtype")
    m, dev = bsz * n, x.device
    warps, (pm, pn), (om, on) = launch_tiles(bsz, n, d, heads, 3, _sm_count(dev))
    hb, q, k, v, o = torch.empty((5, m, d), dtype=x.dtype, device=dev).unbind(0)
    out = torch.empty_like(x)
    fn = lib.rald_fused_self_attention_block
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 11 + [
        ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(
        x.data_ptr(), s_rows.data_ptr(), b_rows.data_ptr(), 0 if s_rows.shape[0] == 1 else d,
        *(w.data_ptr() for w in ws), bo_x.data_ptr(), hb.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), out.data_ptr(), bsz, n, heads, warps, pm, pn, om, on, f32,
        int(bool(scale_shift_mod)), float(ln_eps), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, name)
    fused_self_attention_block.launches += 1
    return out


def fused_self_attention_block_int8(
    x, scale, shift, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, bo,
    heads: int = 8, ln_eps: float = 1e-5, scale_shift_mod: bool = True,
):
    """``x + Wo MHA(mod(LN x)) + bo`` with all four projections int8
    (weights from :func:`quantize_attn_tree`, dynamic per-token int8
    activations). scale / shift: (B, 1, D) or (1, D) mod rows. On the card:
    bf16 or float32 x (rows cast to it; float32: the int8 codes unchanged,
    the attention core in exact f32 products), D = 512, 8 heads of 64, N up
    to ``rald_attn_max_tokens()``."""
    name = "fused_self_attention_block_int8"
    s_rows, b_rows = _check(name, x, scale, shift, (("wq_q", wq_q), ("wk_q", wk_q),
                                                    ("wv_q", wv_q), ("wo_q", wo_q)), heads)
    if x.device.type == "cpu":
        return fused_self_attention_block_int8_plain(
            x, scale, shift, wq_q, wq_s, wk_q, wk_s, wv_q, wv_s, wo_q, wo_s, bo,
            heads, ln_eps, scale_shift_mod)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch(name, x, *_as_act(x, (s_rows, b_rows)),
                  ((wq_q, wq_s.reshape(-1)), (wk_q, wk_s.reshape(-1)), (wv_q, wv_s.reshape(-1))),
                  wo_q, wo_s.reshape(-1), bo.reshape(-1), heads, False, scale_shift_mod, ln_eps)
    fused_self_attention_block_int8.launches += 1
    return out


def fused_self_attention_block_int8_vout(
    x, scale, shift, wq, wk, wv_q, wv_s, wo_q, wo_s, bo,
    heads: int = 8, ln_eps: float = 1e-5, scale_shift_mod: bool = True,
):
    """:func:`fused_self_attention_block_int8` with q / k projections of x's
    dtype (``wq`` / ``wk`` (D, D), cast to it); only v and out are int8."""
    name = "fused_self_attention_block_int8_vout"
    s_rows, b_rows = _check(name, x, scale, shift, (("wq", wq), ("wk", wk), ("wv_q", wv_q),
                                                    ("wo_q", wo_q)), heads)
    if x.device.type == "cpu":
        return fused_self_attention_block_int8_vout_plain(
            x, scale, shift, wq, wk, wv_q, wv_s, wo_q, wo_s, bo, heads, ln_eps, scale_shift_mod)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch(name, x, *_as_act(x, (s_rows, b_rows)),
                  ((wq.to(x.dtype).contiguous(), None), (wk.to(x.dtype).contiguous(), None),
                   (wv_q, wv_s.reshape(-1))),
                  wo_q, wo_s.reshape(-1), bo.reshape(-1), heads, True, scale_shift_mod, ln_eps)
    fused_self_attention_block_int8_vout.launches += 1
    return out


fused_self_attention_block.launches = 0
fused_self_attention_block_int8.launches = 0
fused_self_attention_block_int8_vout.launches = 0
