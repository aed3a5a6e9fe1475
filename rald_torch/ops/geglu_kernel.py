"""Fused (LN + mod) -> GEGLU FF -> residual: CUDA kernels and plain versions.

Counterparts of ``rald_tpu/ops/geglu_kernel.py``:

- :func:`fused_ln_geglu_residual` (bf16; Pallas body ``_ln_kernel``
  :96-128) -> ``rald_torch/csrc/geglu.cu``;
- :func:`geglu_ff` (the FF without LN and residual, token-flattened, any
  ``out_dim``; ``_kernel`` :478-488, wrapper :491-538) -> the same source's
  second entry point;
- :func:`fused_ln_geglu_residual_int8` (int8 weights, dynamic per-token
  int8 activations; ``_ln_int8_kernel`` :206-248, wrapper :408-475) and
  :func:`fused_ln_geglu_residual_int8_static` (calibrated static activation
  scales; ``_ln_int8_static_kernel`` :251-291, wrapper :294-372) ->
  ``rald_torch/csrc/geglu_int8.cu``;
- the weight quantizer :func:`quantize_cols` / :func:`quantize_ff_tree`
  (:375-405) and the int8 kernels' transcendental-free GELU
  (``_ERF_POLY`` / ``_erf_poly`` / ``_gelu_poly`` :51-93), copied here.

Each ``*_plain`` function repeats its kernel's arithmetic, rounding point
by rounding point, in plain PyTorch. A wrapper launches its kernel for CUDA
tensors and runs the plain version for CPU tensors (tests, CPU runs); a
CUDA tensor launches the kernel or raises, with no fallback.

On the card x may be bf16 or float32 (JAX's ``compute_dtype``); x's dtype
picks the kernel's instantiation, and weights, biases and modulation rows
are cast to it, as the JAX wrappers cast them. Under float32 every
rounding to x's dtype is a no-op and the kernels compute exact f32
products (FFMA on the CUDA cores) whatever
``torch.get_float32_matmul_precision()`` says: PyTorch's setting grants
leave to use less precision, it does not require it.

Weights are in the torch layout: ``w1`` (2*inner, D) — value rows
``[:inner]``, gate rows ``[inner:]`` — and ``w2`` (D, inner); int8 weights
carry one f32 scale per output row (the JAX layout's per-column scale).
"""
from __future__ import annotations

import ctypes
import functools

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


def ln_mod_f32(x, scale, shift, scale_shift_mod: bool, ln_eps: float):
    """LN statistics as E[x^2]-E[x]^2 in f32, then the (scale, shift) mod
    rows rounded to ``x``'s dtype: returns ``(x as f32, h f32)``."""
    dt = x.dtype
    xf = x.float()
    m = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - m * m
    h = (xf - m) * torch.rsqrt(var + ln_eps)
    s = scale.to(dt).float()
    b = shift.to(dt).float()
    return xf, (h * (1.0 + s) + b if scale_shift_mod else h * s + b)


def fused_ln_geglu_residual_plain(
    x, scale, shift, w1, b1, w2, b2, scale_shift_mod: bool = True, ln_eps: float = 1e-5
):
    """The kernel's arithmetic in PyTorch ops: x (B, N, D) -> (B, N, D)."""
    dt = x.dtype
    xf, h = ln_mod_f32(x, scale, shift, scale_shift_mod, ln_eps)
    h = h.to(dt)
    inner = w1.shape[0] // 2
    p = torch.matmul(h.float(), w1.to(dt).float().t()) + b1.to(dt).float()
    p = p.to(dt)
    val, gate = p[..., :inner], p[..., inner:]
    gl = torch.nn.functional.gelu(gate.float()).to(dt)
    g = (val.float() * gl.float()).to(dt)
    out = torch.matmul(g.float(), w2.to(dt).float().t()) + b2.to(dt).float() + xf
    return out.to(dt)


# GEMM2 output tiles (rows, columns), largest first: each block runs one
# K loop over all ``inner`` columns, so a small batch needs smaller tiles to
# give every SM a block
GEMM2_TILES = ((128, 128), (128, 64), (64, 128), (64, 64))


def gemm2_tile(rows: int, cols: int, sms: int) -> tuple:
    """The output GEMM's tile for a (rows, cols) output on a card of ``sms``
    SMs: the largest tile whose grid gives every SM a block, else the
    smallest."""
    for bm, bn in GEMM2_TILES:
        if -(-rows // bm) * -(-cols // bn) >= sms:
            return bm, bn
    return GEMM2_TILES[-1]


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_tma(name: str, tensors) -> None:
    """TMA, and the f32 kernels' vector loads, read their operands from
    16-byte-aligned addresses."""
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name}: x and the weights must be 16-byte aligned (TMA)")


# activation dtypes the CUDA kernels take; x's dtype picks the instantiation
ACT_DTYPES = (torch.bfloat16, torch.float32)


def check_act_dtype(name: str, x: torch.Tensor) -> int:
    """1 for float32 x, 0 for bf16; any other dtype raises ``TypeError``."""
    if x.dtype not in ACT_DTYPES:
        raise TypeError(f"{name}: the CUDA kernel takes bf16 or float32 activations, got {x.dtype}")
    return int(x.dtype == torch.float32)


def _as_act(x: torch.Tensor, tensors):
    """Each tensor in x's dtype, contiguous (a no-op where it already is)."""
    return [t.to(x.dtype).contiguous() for t in tensors]


def fused_ln_geglu_residual(
    x, scale, shift, w1, b1, w2, b2, scale_shift_mod: bool = True, ln_eps: float = 1e-5
):
    """``x + (proj_in -> GEGLU -> proj_out)(mod(LN(x)))`` in one kernel.

    x: (B, N, D); scale/shift: one modulation row per batch element
    (B, 1, D) or one row for all (1, D) / (1, 1, D); AdaLN
    ``h*(1+scale)+shift`` when ``scale_shift_mod``, else ``h*scale+shift``.
    On the card: bf16 or float32 x (the weights, biases and rows are cast
    to it), D = 512, inner a multiple of 64, x and the weights 16-byte
    aligned; anything else raises. float32 x gets exact f32 products under
    any ``torch.get_float32_matmul_precision()`` (module docstring).
    """
    name = "fused_ln_geglu_residual"
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    bsz, n, dim = x.shape
    inner = w1.shape[0] // 2
    if w1.shape != (2 * inner, dim) or w2.shape != (dim, inner):
        raise ValueError(
            f"{name}: w1 {tuple(w1.shape)} / w2 {tuple(w2.shape)} "
            f"do not match D={dim} (torch layout: w1 (2*inner, D), w2 (D, inner))"
        )
    s_rows = _mod_rows(scale, bsz, dim, "scale")
    b_rows = _mod_rows(shift, bsz, dim, "shift")
    if x.device.type == "cpu":
        return fused_ln_geglu_residual_plain(
            x, scale, shift, w1, b1, w2, b2, scale_shift_mod, ln_eps
        )
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    f32 = check_act_dtype(name, x)
    lib = _build.load("geglu")
    mult = lib.rald_geglu_inner_multiple()
    if dim != lib.rald_geglu_width() or inner % mult or n == 0:
        raise ValueError(
            f"{name}: the CUDA kernel takes D={lib.rald_geglu_width()} "
            f"and inner % {mult} == 0, got D={dim}, inner={inner}, N={n}"
        )
    if s_rows.shape[0] != b_rows.shape[0]:
        raise ValueError(f"{name}: scale and shift rows differ in count")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous")
    args = [x] + _as_act(x, (s_rows, b_rows, w1, b1, w2, b2))
    if any(t.device != x.device for t in args):
        raise ValueError(f"{name}: every operand must be on {x.device}")
    x, s_rows, b_rows, w1, b1, w2, b2 = args
    _check_tma(name, (x, w1, w2))
    rows = bsz * n
    h = torch.empty((rows, dim), dtype=x.dtype, device=x.device)
    g = torch.empty((rows, inner), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    bm, bn = gemm2_tile(rows, dim, _sm_count(x.device))
    fn = lib.rald_fused_ln_geglu_residual
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 7 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    rc = fn(
        x.data_ptr(), s_rows.data_ptr(), b_rows.data_ptr(),
        0 if s_rows.shape[0] == 1 else dim,
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), h.data_ptr(), g.data_ptr(),
        out.data_ptr(), bsz, n, inner, bm, bn, f32, int(bool(scale_shift_mod)),
        float(ln_eps), torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(rc, name)
    fused_ln_geglu_residual.launches += 1
    return out


fused_ln_geglu_residual.launches = 0


def geglu_ff_plain(x, w1, b1, w2, b2):
    """``geglu_ff``'s arithmetic in PyTorch ops: x (..., D) -> (..., out_dim).

    Every weight and bias is cast to x's dtype; ``x @ W1 + b1`` summed in f32
    and rounded; the exact-erf GELU of the gate (the JAX kernel's A&S erf is
    within 1.5e-7 of it) rounded; the gated product rounded; ``g @ W2 + b2``
    summed in f32 and rounded."""
    dt = x.dtype
    inner = w1.shape[0] // 2
    p = (torch.matmul(x.float(), w1.to(dt).float().t()) + b1.to(dt).float()).to(dt)
    val, gate = p[..., :inner], p[..., inner:]
    gl = torch.nn.functional.gelu(gate.float()).to(dt)
    g = (val.float() * gl.float()).to(dt)
    return (torch.matmul(g.float(), w2.to(dt).float().t()) + b2.to(dt).float()).to(dt)


def geglu_ff(x, w1, b1, w2, b2):
    """``(proj_in -> GEGLU -> proj_out)(x)`` in one kernel: x (..., D), w1
    (2*inner, D), b1 (2*inner,), w2 (out_dim, inner), b2 (out_dim,) in the
    torch layout; the leading axes are flattened into tokens. On the card:
    bf16 or float32 x (the weights and biases are cast to it; float32:
    exact f32 products under any matmul precision), D = 512, inner a
    multiple of 64, out_dim a multiple of 16, x and the weights 16-byte
    aligned."""
    name = "geglu_ff"
    dim = x.shape[-1]
    inner = w1.shape[0] // 2
    out_dim = w2.shape[0]
    if w1.shape != (2 * inner, dim) or w2.shape != (out_dim, inner) or b1.numel() != 2 * inner \
            or b2.numel() != out_dim:
        raise ValueError(
            f"{name}: w1 {tuple(w1.shape)} / b1 {tuple(b1.shape)} / w2 {tuple(w2.shape)} / "
            f"b2 {tuple(b2.shape)} do not match D={dim} (torch layout: w1 (2*inner, D), "
            "w2 (out_dim, inner))"
        )
    if x.device.type == "cpu":
        return geglu_ff_plain(x, w1, b1, w2, b2)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    f32 = check_act_dtype(name, x)
    lib = _build.load("geglu")
    lead = x.shape[:-1]
    xt = x.reshape(-1, dim).contiguous()
    n = xt.shape[0]
    mult = lib.rald_geglu_inner_multiple()
    if dim != lib.rald_geglu_width() or inner % mult or out_dim % 16 or n == 0:
        raise ValueError(
            f"{name}: the CUDA kernel takes D={lib.rald_geglu_width()}, inner % {mult} == 0 and "
            f"out_dim % 16 == 0, got D={dim}, inner={inner}, out_dim={out_dim}, tokens={n}"
        )
    args = [xt] + _as_act(xt, (w1, b1, w2, b2))
    for t in args:
        if t.device != x.device:
            raise ValueError(f"{name}: every operand must be on {x.device}")
    _check_tma(name, (args[0], args[1], args[3]))
    g = torch.empty((n, inner), dtype=x.dtype, device=x.device)
    out = torch.empty((n, out_dim), dtype=x.dtype, device=x.device)
    bm, bn = gemm2_tile(n, out_dim, _sm_count(x.device))
    fn = lib.rald_geglu_ff
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    rc = fn(*(t.data_ptr() for t in args), g.data_ptr(), out.data_ptr(), n, inner, out_dim,
            bm, bn, f32, torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, name)
    geglu_ff.launches += 1
    return out.reshape(*lead, out_dim)


geglu_ff.launches = 0


# ------------------------------------------------------------------ int8
# erf(x) ~= clamp(x, -3, 3) * P(x^2), the constrained minimax fit of
# rald_tpu/ops/geglu_kernel.py:51-69 (max |erf error| 9.3e-5 in range,
# saturating to 1 f32 ulp beyond it); copied verbatim, so the int8 kernels
# use the same transcendental-free GELU as the JAX package's.
_ERF_POLY = (
    1.1278664111e+00, -3.7308188663e-01, 1.0751176122e-01, -2.2562818144e-02,
    3.2815626959e-03, -3.0865364415e-04, 1.6680301565e-05, -3.9017459733e-07,
)


def _erf_poly(x):
    x = x.clamp(-3.0, 3.0)
    x2 = x * x
    p = torch.full_like(x2, _ERF_POLY[-1])
    for c in _ERF_POLY[-2::-1]:
        p = p * x2 + c
    return x * p


def _gelu_poly(x):
    """Transcendental-free GELU of the int8 kernels (f32 in, f32 out)."""
    return x * (0.5 * (1.0 + _erf_poly(x * 0.7071067811865476)))


def div127(v):
    """``v / 127`` as one correctly rounded f32 division (``tensor / 127.0``
    may be taken as a multiply by the reciprocal on the card)."""
    return v / torch.full_like(v, 127.0)


def inv127(v):
    """``127 / v`` as one correctly rounded f32 division (``127.0 / tensor``
    is ``reciprocal() * 127`` in PyTorch)."""
    return torch.full_like(v, 127.0) / v


def quant_rows(v):
    """Dynamic per-row symmetric int8: ``(codes as f32, row scale amax/127)``
    with ``amax = max(max|v|, 1e-6)``; codes ``round(v * (127 / amax))``,
    rounded half to even."""
    vmax = v.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    return torch.round(v * inv127(vmax)), div127(vmax)


def int_matmul(codes, wq):
    """Exact integer product of int8 codes (..., K) and an int8 weight
    (N, K), returned in f32 (rounded once, as the kernels' int32 -> f32).
    float64 holds every partial sum exactly (|sum| <= 127^2 * K << 2^53);
    f32 would not (127^2 * 2048 > 2^24)."""
    return torch.matmul(codes.double(), wq.double().t()).float()


def quantize_cols(w):
    """Per-output symmetric int8 of a torch-layout (out, in) weight:
    ``(w_q int8 (out, in), s f32 (out,))`` with ``w ~= w_q * s[:, None]``.
    The JAX function (rald_tpu/ops/geglu_kernel.py:375) gives the same codes
    and scales for the transposed (in, out) weight."""
    w = w.float()
    s = div127(w.abs().amax(dim=1).clamp_min(1e-8))
    wq = torch.round(w / s[:, None]).clamp(-127, 127).to(torch.int8)
    return wq, s


def quantize_ff_tree(state_dict) -> dict:
    """The int8 side-tree of every DiT FF: for each ``<path>.ff`` holding
    ``net.0.proj`` / ``net.2`` Linear weights, ``{w1q, s1, w2q, s2}`` as
    :func:`quantize_cols` gives them, plus f32 copies ``b1`` / ``b2`` of the
    biases (the JAX wrappers pass the biases as f32). Keys are the module
    paths. Pass the f32 weights: quantizing a bf16 copy gives other codes.
    """
    sd = state_dict.state_dict() if isinstance(state_dict, torch.nn.Module) else state_dict
    out = {}
    for key in sd:
        if key.endswith(".ff.net.0.proj.weight"):
            path = key[: -len(".net.0.proj.weight")]
            w1q, s1 = quantize_cols(sd[key])
            w2q, s2 = quantize_cols(sd[f"{path}.net.2.weight"])
            out[path] = {
                "w1q": w1q, "s1": s1, "w2q": w2q, "s2": s2,
                "b1": sd[f"{path}.net.0.proj.bias"].float().clone(),
                "b2": sd[f"{path}.net.2.bias"].float().clone(),
            }
    return out


def _check_int8_ff(name, x, scale, shift, w1q, w2q, vecs):
    if x.dim() != 3:
        raise ValueError(f"{name}: x must be (B, N, D), got {tuple(x.shape)}")
    bsz, n, dim = x.shape
    inner = w1q.shape[0] // 2
    if w1q.shape != (2 * inner, dim) or w2q.shape != (dim, inner):
        raise ValueError(
            f"{name}: w1q {tuple(w1q.shape)} / w2q {tuple(w2q.shape)} do not match "
            f"D={dim} (torch layout: w1q (2*inner, D), w2q (D, inner))"
        )
    for vname, v, size in vecs:
        if v.numel() != size:
            raise ValueError(f"{name}: {vname} has {v.numel()} values, want {size}")
    return _mod_rows(scale, bsz, dim, "scale"), _mod_rows(shift, bsz, dim, "shift")


def fused_ln_geglu_residual_int8_plain(
    x, scale, shift, w1q, s1, b1, w2q, s2, b2, scale_shift_mod: bool = True, ln_eps: float = 1e-5
):
    """``_ln_int8_kernel`` in PyTorch ops: x (B, N, D) -> (B, N, D).

    h (LN + mod) stays f32 and is quantized per row; both products are
    exact integer sums; dequant ``(acc * (hmax/127)) * s1 + b1``; the gate
    goes through :func:`_gelu_poly` in f32; the gated product g (f32) is
    quantized per row over all ``inner`` columns; ``(acc2 * (gmax/127)) *
    s2 + b2 + x`` is rounded once to x's dtype."""
    xf, h = ln_mod_f32(x, scale, shift, scale_shift_mod, ln_eps)
    hq, hrow = quant_rows(h)
    inner = w1q.shape[0] // 2
    p = int_matmul(hq, w1q) * hrow * s1.float().reshape(-1) + b1.float().reshape(-1)
    g = p[..., :inner] * _gelu_poly(p[..., inner:])
    gq, grow = quant_rows(g)
    out = int_matmul(gq, w2q) * grow * s2.float().reshape(-1)
    return (out + b2.float().reshape(-1) + xf).to(x.dtype)


def fused_ln_geglu_residual_int8_static_plain(
    x, scale, shift, w1q, d1, b1, w2q, d2, b2, inv_h, inv_g,
    scale_shift_mod: bool = True, ln_eps: float = 1e-5,
):
    """``_ln_int8_static_kernel`` in PyTorch ops: the activations are
    quantized with the fixed multipliers ``inv_h`` / ``inv_g`` (127/amax),
    saturating at +-127, and dequantized by the premultiplied rows ``d1`` /
    ``d2`` (``s * amax/127``)."""
    xf, h = ln_mod_f32(x, scale, shift, scale_shift_mod, ln_eps)
    ih = torch.as_tensor(inv_h, dtype=torch.float32, device=x.device).reshape(())
    ig = torch.as_tensor(inv_g, dtype=torch.float32, device=x.device).reshape(())
    hq = torch.round((h * ih).clamp(-127.0, 127.0))
    inner = w1q.shape[0] // 2
    p = int_matmul(hq, w1q) * d1.float().reshape(-1) + b1.float().reshape(-1)
    g = p[..., :inner] * _gelu_poly(p[..., inner:])
    gq = torch.round((g * ig).clamp(-127.0, 127.0))
    out = int_matmul(gq, w2q) * d2.float().reshape(-1)
    return (out + b2.float().reshape(-1) + xf).to(x.dtype)


def _launch_int8_ff(name, x, s_rows, b_rows, w1q, c1, b1, w2q, c2, b2, inv_h, inv_g,
                    scale_shift_mod, ln_eps):
    """Shared launcher of the two int8 FF kernels (``inv_h`` None: dynamic)."""
    bsz, n, dim = x.shape
    inner = w1q.shape[0] // 2
    f32 = check_act_dtype(name, x)
    lib = _build.load("geglu_int8")
    mult = lib.rald_int8_inner_multiple()
    if dim != lib.rald_int8_width() or inner % mult or n == 0:
        raise ValueError(
            f"{name}: the CUDA kernel takes D={lib.rald_int8_width()} and inner % {mult} == 0, "
            f"got D={dim}, inner={inner}, N={n}"
        )
    if s_rows.shape[0] != b_rows.shape[0]:
        raise ValueError(f"{name}: scale and shift rows differ in count")
    want = [(x, x.dtype), (s_rows, x.dtype), (b_rows, x.dtype),
            (w1q, torch.int8), (w2q, torch.int8), (c1, torch.float32), (b1, torch.float32),
            (c2, torch.float32), (b2, torch.float32)]
    if inv_h is not None:
        want += [(inv_h, torch.float32), (inv_g, torch.float32)]
    for t, dt in want:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: operands must be contiguous on {x.device}: x / scale / shift of x's "
                "dtype, int8 weights, f32 scales, biases and multipliers"
            )
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must be 16-byte aligned")
    m = bsz * n
    dev = x.device
    static = inv_h is not None
    hq = torch.empty((m, dim), dtype=torch.int8, device=dev)
    gq = torch.empty((m, inner), dtype=torch.int8, device=dev)
    # dynamic scales only: h's row scale, g (f32), the row maxima of g per
    # 64-column tile, g's row scale
    hrow = g = gpart = grow = None
    if not static:
        g = torch.empty((m, inner), dtype=torch.float32, device=dev)
        gpart = torch.empty((m, inner // 64), dtype=torch.float32, device=dev)
        hrow, grow = torch.empty((2, m), dtype=torch.float32, device=dev).unbind(0)
    out = torch.empty_like(x)
    bm, bn = gemm2_tile(m, dim, _sm_count(dev))
    fn = lib.rald_fused_ln_geglu_residual_int8
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_void_p] * 15 + [
        ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    ptr = lambda t: 0 if t is None else t.data_ptr()
    rc = fn(
        x.data_ptr(), s_rows.data_ptr(), b_rows.data_ptr(), 0 if s_rows.shape[0] == 1 else dim,
        w1q.data_ptr(), c1.data_ptr(), b1.data_ptr(), w2q.data_ptr(), c2.data_ptr(),
        b2.data_ptr(), ptr(inv_h), ptr(inv_g), hq.data_ptr(), ptr(hrow), ptr(g), ptr(gpart),
        gq.data_ptr(), ptr(grow), out.data_ptr(),
        bsz, n, inner, bm, bn, f32, int(bool(scale_shift_mod)), float(ln_eps),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(rc, name)
    return out


def fused_ln_geglu_residual_int8(
    x, scale, shift, w1q, s1, b1, w2q, s2, b2, scale_shift_mod: bool = True, ln_eps: float = 1e-5
):
    """:func:`fused_ln_geglu_residual` with int8 weights (``w1q`` (2*inner,
    D), ``w2q`` (D, inner), f32 row scales ``s1`` / ``s2`` from
    :func:`quantize_cols`, f32 biases) and dynamic per-token int8
    activations. On the card: bf16 or float32 x (scale / shift cast to
    it; the int8 codes and products are the same for both), D = 512,
    inner a multiple of 128."""
    name = "fused_ln_geglu_residual_int8"
    s_rows, b_rows = _check_int8_ff(
        name, x, scale, shift, w1q, w2q,
        (("s1", s1, w1q.shape[0]), ("b1", b1, w1q.shape[0]),
         ("s2", s2, w2q.shape[0]), ("b2", b2, w2q.shape[0])))
    if x.device.type == "cpu":
        return fused_ln_geglu_residual_int8_plain(
            x, scale, shift, w1q, s1, b1, w2q, s2, b2, scale_shift_mod, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch_int8_ff(name, x, *_as_act(x, (s_rows, b_rows)), w1q, s1.reshape(-1),
                          b1.reshape(-1), w2q, s2.reshape(-1), b2.reshape(-1), None, None,
                          scale_shift_mod, ln_eps)
    fused_ln_geglu_residual_int8.launches += 1
    return out


def fused_ln_geglu_residual_int8_static(
    x, scale, shift, w1q, d1, b1, w2q, d2, b2, inv_h, inv_g,
    scale_shift_mod: bool = True, ln_eps: float = 1e-5,
):
    """:func:`fused_ln_geglu_residual_int8` with calibrated static activation
    scales: ``inv_h`` / ``inv_g`` one-element f32 multipliers ``127/amax``,
    ``d1`` (2*inner,) / ``d2`` (D,) the row scales premultiplied by
    ``amax/127`` (folded by the caller). Activations beyond the calibrated
    amax saturate."""
    name = "fused_ln_geglu_residual_int8_static"
    s_rows, b_rows = _check_int8_ff(
        name, x, scale, shift, w1q, w2q,
        (("d1", d1, w1q.shape[0]), ("b1", b1, w1q.shape[0]), ("d2", d2, w2q.shape[0]),
         ("b2", b2, w2q.shape[0]), ("inv_h", torch.as_tensor(inv_h), 1),
         ("inv_g", torch.as_tensor(inv_g), 1)))
    if x.device.type == "cpu":
        return fused_ln_geglu_residual_int8_static_plain(
            x, scale, shift, w1q, d1, b1, w2q, d2, b2, inv_h, inv_g, scale_shift_mod, ln_eps)
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    out = _launch_int8_ff(name, x, *_as_act(x, (s_rows, b_rows)), w1q, d1.reshape(-1),
                          b1.reshape(-1), w2q, d2.reshape(-1), b2.reshape(-1),
                          inv_h.reshape(-1), inv_g.reshape(-1), scale_shift_mod, ln_eps)
    fused_ln_geglu_residual_int8_static.launches += 1
    return out


fused_ln_geglu_residual_int8.launches = 0
fused_ln_geglu_residual_int8_static.launches = 0
