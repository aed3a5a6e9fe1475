#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rald_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. device: the card's name, count and power limit (``nvidia-smi``); no
   CUDA device -> exit 1 with no result.
2. build: compiles every hand-written kernel under ``rald_torch/csrc`` for
   ``sm_90a`` (one ``nvcc`` per source, all at once) and prints the ptxas
   register / shared-memory / spill report.
3. kernels: each of the nine kernels against its plain PyTorch version at
   main-path shapes, batch 1 and 8 (and a ragged batch; geglu_ff also at an
   out_dim of 768), with checks that the bar catches a kernel dropping a
   bias or a scale row or computing the other mod mode (the nearest-
   neighbour kernels: bitwise, and nn_min_sq_batch bitwise equal to
   nn_min_sq_both's rows), then timed with CUDA events beside the plain
   version, a composite of library calls the port never makes
   (``library_ms``) and the card's bound for the same work.
4. main path: the product eval chain of
   ``configs/generation/ge_indoor_unfreeze_enc_ints_only_eval.yml`` at full
   width (DiT dim 512 x 24 blocks, VAE dim 512 x 24 blocks, bf16) on seeded
   random weights, through ``GenerationEngine.fused_eval_step``: raw cube
   upsampled on the device -> 3D-CNN condition tokens -> 35-NFE Heun
   sampler -> decode of 5e5 grid + 7e5 densified CFAR helper queries ->
   threshold -> 5e5 refine queries decoded -> polar->cartesian ->
   Chamfer / F-score against a 1e4-point synthetic surface, at batch 1
   and 8; the port's infer CLI (``rald_torch.cli.infer.run``) on 9
   synthetic raw cubes in two directories at batch 8; the chain in
   quantized inference (``eval.inference.int8_ff`` / ``int8_attn``):
   dynamic int8 FF + "vout" attention (bench.py's operating point) at
   batch 1 and 8, dynamic FF + "full" attention at batch 1, and static FF
   (scales from ``calibrate_act_scales`` on one synthetic batch) + "vout"
   at batch 1; with ``ar_model.overrides: {use_fused_attn: true}`` at
   batch 1 and 8 and through the CLI; ``GEGLUFeedForward(use_fused=True)``
   once; and ``system.fast_inference: false`` at batch 1 (plain modules,
   unfolded decode). Launch counters are zeroed just before each run and
   read just after, and every kernel's count is checked exactly.
5. reference: reduced-depth chains (bf16; bf16 + use_fused_attn; int8
   dynamic + vout; int8 static + full) each run twice on the card, once
   through the kernels and once through their plain versions; tokens and
   Chamfer must agree. Then the host ``chamfer_and_fscore`` once on the
   card against the CPU.

Then one ``kernels`` JSON line, the ``nvidia-smi`` line again, and the last
line ``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

REPO = Path(__file__).resolve().parent
PRODUCT_CFG = REPO / "configs" / "generation" / "ge_indoor_unfreeze_enc_ints_only_eval.yml"

# NVIDIA H100 SXM data-sheet peaks at 700 W (dense): the bound of a kernel
# is the larger of its bytes over the memory rate and its operations over
# the peak rate of their type.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_F32 = 67e12

D, INNER = 512, 2048  # product DiT / VAE width and GEGLU inner width
SCRATCH = REPO / "build" / "chip_smoke"  # calibrated scales written by the run (git-ignored)
KERNEL_NAMES = ("fused_ln_geglu_residual", "nn_min_sq_both", "nn_min_sq_batch",
                "fused_ln_geglu_residual_int8", "fused_ln_geglu_residual_int8_static",
                "geglu_ff", "fused_self_attention_block", "fused_self_attention_block_int8",
                "fused_self_attention_block_int8_vout")
NN_N, NN_M = 500_000, 10_000  # refined predictions, GT surface points


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds per call over ``iters`` warmed-up calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, ops: float, peak_ops: float):
    return bound_t(n_bytes, ops / peak_ops)


def bound_t(n_bytes: float, t_ops: float):
    """The larger of the bytes over the memory rate and ``t_ops``, the
    seconds the operations take at the peak rate of their type (summed over
    types where a kernel mixes them)."""
    t_bytes = n_bytes / PEAK_BYTES
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# --------------------------------------------------------------- phase 2
def phase_build() -> None:
    from rald_torch.ops import _build

    t0 = time.perf_counter()
    _build.build_all()
    print(f"[build] {len(_build.SOURCES)} kernel libraries in {time.perf_counter() - t0:.1f} s "
          f"(nvcc, sm_90a, into {_build.BUILD_DIR.relative_to(REPO)})")
    for name, report in sorted(_build.ptxas_report.items()):
        for line in report.splitlines():
            print(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------- phase 3
def _geglu_inputs(bsz: int, n: int, adaln: bool, gen: torch.Generator):
    dev, bf = "cuda", torch.bfloat16

    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * std).to(bf)

    x = rnd(bsz, n, D)
    if adaln:  # DiT: one AdaLN (scale, shift) row shared by the batch
        s, b = rnd(1, D, std=0.1), rnd(1, D, std=0.1)
    else:  # VAE: the ff LayerNorm's weight and bias
        s, b = 1.0 + rnd(D, std=0.1), rnd(D, std=0.1)
    # biases at std 0.5, so that a kernel leaving out b1 or b2 moves the
    # output by far more than the tolerance (checked in phase_kernels)
    w1, b1 = rnd(2 * INNER, D, std=D ** -0.5), rnd(2 * INNER, std=0.5)
    w2, b2 = rnd(D, INNER, std=INNER ** -0.5), rnd(D, std=0.5)
    return x, s, b, w1, b1, w2, b2


def _geglu_library(x, s, b, w1, b1, w2, b2, adaln: bool):
    """Yardstick only: the sublayer as a composite of torch.nn.functional
    calls in bf16 (the port never calls this)."""
    if adaln:
        h = F.layer_norm(x, (D,), eps=1e-5) * (1 + s) + b
    else:
        h = F.layer_norm(x, (D,), s, b, eps=1e-5)
    a, g = F.linear(h, w1, b1).chunk(2, dim=-1)
    return x + F.linear(a * F.gelu(g), w2, b2)


def _nn_library(a, b, chunk: int = 16384, both: bool = True):
    """Yardstick only: exact (non-matmul) cdist in chunks, both minima (or
    the row minima alone)."""
    row = torch.empty(a.shape[:2], device=a.device)
    col = torch.full(b.shape[:2], float("inf"), device=a.device)
    for s in range(0, a.shape[1], chunk):
        d = torch.cdist(a[:, s:s + chunk], b, compute_mode="donot_use_mm_for_euclid_dist")
        row[:, s:s + chunk] = d.amin(2)
        if both:
            col = torch.minimum(col, d.amin(1))
    return row, col


# int8 kernels: main-path operands (DiT: one AdaLN row shared by the batch),
# weights quantized from f32 as the engine does, biases at std 0.5 so that a
# kernel dropping one misses the bar by far
INT8_SHAPES = ((1, 512), (8, 512), (3, 300))
INT8_BAR = 2e-2  # bf16 output over dequantized 512/2048-term sums, as geglu


def _int8_ff_inputs(bsz: int, n: int, gen: torch.Generator):
    from rald_torch.ops.geglu_kernel import quantize_cols

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    x = rnd(bsz, n, D).bfloat16()
    s, b = rnd(1, D, std=0.1).bfloat16(), rnd(1, D, std=0.1).bfloat16()
    w1q, s1 = quantize_cols(rnd(2 * INNER, D, std=D ** -0.5))
    w2q, s2 = quantize_cols(rnd(D, INNER, std=INNER ** -0.5))
    return x, s, b, w1q, s1, rnd(2 * INNER, std=0.5), w2q, s2, rnd(D, std=0.5)


def _int8_static_inputs(ff_args):
    """The dynamic operands with calibrated-looking scales folded in as
    latent_dit folds them: max|h| ~ 4.5 after AdaLN, max|g| ~ 2.5."""
    from rald_torch.ops.geglu_kernel import div127, inv127

    x, s, b, w1q, s1, b1, w2q, s2, b2 = ff_args
    ah = torch.full((1,), 4.5, device="cuda")
    ag = torch.full((1,), 2.5, device="cuda")
    return (x, s, b, w1q, s1 * div127(ah), b1, w2q, s2 * div127(ag), b2, inv127(ah),
            inv127(ag))


def _int8_attn_inputs(bsz: int, n: int, vout: bool, gen: torch.Generator):
    from rald_torch.ops.geglu_kernel import quantize_cols

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    x = rnd(bsz, n, D).bfloat16()
    s, b = rnd(1, D, std=0.1).bfloat16(), rnd(1, D, std=0.1).bfloat16()
    w = [rnd(D, D, std=D ** -0.5) for _ in range(4)]
    qk = (w[0].bfloat16(), w[1].bfloat16()) if vout else (*quantize_cols(w[0]),
                                                           *quantize_cols(w[1]))
    return (x, s, b, *qk, *quantize_cols(w[2]), *quantize_cols(w[3]), rnd(D, std=0.5))


def _ln_mod_lib(x, s, b):
    return F.layer_norm(x.float(), (D,), eps=1e-5) * (1 + s.float()) + b.float()


def _quant_lib(v):
    amax = v.abs().amax(-1, keepdim=True).clamp_min(1e-6)
    return torch.round(v * (127.0 / amax)).to(torch.int8), amax / 127.0


def _int8_ff_library(x, s, b, w1q, c1, b1, w2q, c2, b2, inv_h=None, inv_g=None):
    """Yardstick only: the int8 FF sublayer as F.layer_norm + torch._int_mm
    + F.gelu (the port never calls this)."""
    h = _ln_mod_lib(x, s, b).reshape(-1, D)
    if inv_h is None:
        hq, hr = _quant_lib(h)
        p = torch._int_mm(hq, w1q.t()).float() * hr * c1 + b1
    else:
        hq = torch.round((h * inv_h).clamp(-127, 127)).to(torch.int8)
        p = torch._int_mm(hq, w1q.t()).float() * c1 + b1
    a, gate = p.chunk(2, dim=-1)
    g = a * F.gelu(gate)
    if inv_g is None:
        gq, gr = _quant_lib(g)
        y = torch._int_mm(gq, w2q.t()).float() * gr * c2
    else:
        y = torch._int_mm(torch.round((g * inv_g).clamp(-127, 127)).to(torch.int8),
                          w2q.t()).float() * c2
    return (y + b2 + x.reshape(-1, D).float()).to(x.dtype).reshape(x.shape)


def _int8_attn_library(x, s, b, *w, vout: bool):
    """Yardstick only: the int8 self-attention sublayer as F.layer_norm +
    torch._int_mm (+ F.linear for vout's q / k) + F.scaled_dot_product_attention."""
    bsz, n, _ = x.shape
    h = _ln_mod_lib(x, s, b).reshape(-1, D)
    hq, hr = _quant_lib(h)

    def proj(wq8, sc):
        return (torch._int_mm(hq, wq8.t()).float() * hr * sc).bfloat16()

    if vout:
        (wq, wk), (wv, sv, wo, so, bo) = w[:2], w[2:]
        q, k = F.linear(h.bfloat16(), wq), F.linear(h.bfloat16(), wk)
    else:
        (wq, sq, wk, sk), (wv, sv, wo, so, bo) = w[:4], w[4:]
        q, k = proj(wq, sq), proj(wk, sk)
    heads = lambda t: t.reshape(bsz, n, 8, 64).transpose(1, 2)
    o = F.scaled_dot_product_attention(heads(q), heads(k), heads(proj(wv, sv)))
    oq, orow = _quant_lib(o.transpose(1, 2).reshape(-1, D).float())
    y = torch._int_mm(oq, wo.t()).float() * orow * so + bo + x.reshape(-1, D).float()
    return y.to(x.dtype).reshape(x.shape)


def _int8_bound(name: str, bsz: int, n: int):
    rows = bsz * n
    act_bytes = 2 * (2 * rows * D) + 2 * 2 * D  # x in, out (bf16), mod rows
    if name.startswith("fused_ln_geglu_residual_int8"):
        int8_ops = rows * (2 * D * 2 * INNER + 2 * INNER * D)
        n_bytes = act_bytes + 3 * D * INNER + 4 * (2 * 2 * INNER + 2 * D)
        return bound_t(n_bytes, int8_ops / PEAK_INT8)
    attn_ops = 2 * 2 * bsz * n * n * D  # q.k^T and a.v over all heads, bf16
    if name.endswith("_vout"):
        int8_ops, bf16_ops = 2 * 2 * rows * D * D, 2 * 2 * rows * D * D + attn_ops
        n_bytes = act_bytes + 2 * 2 * D * D + 2 * D * D + 4 * 3 * D
    else:
        int8_ops, bf16_ops = 4 * 2 * rows * D * D, attn_ops
        n_bytes = act_bytes + 4 * D * D + 4 * 5 * D
    return bound_t(n_bytes, int8_ops / PEAK_INT8 + bf16_ops / PEAK_BF16)


def _drop_checks(label, plain, args, want, bar, drops, kw=None) -> dict:
    """Each entry of ``drops`` (key -> (operand index, replacement), or key ->
    a dict of keyword changes) must move the plain output by more than the
    bar: the parity check then catches a kernel that leaves that operand out
    (or computes the other mode)."""
    moved = {}
    for key, change in drops.items():
        a, k = list(args), dict(kw or {})
        if isinstance(change, dict):
            k.update(change)
        else:
            i, repl = change
            a[i] = repl(a[i])
        moved[key] = (plain(*a, **k).float() - want.float()).abs().max().item()
        check(moved[key] > bar, f"{label}: dropping {key} moves the output only "
                                f"{moved[key]:.3e} <= bar {bar:.3e}")
    return moved


def _int8_kernel_entries(gen: torch.Generator) -> list:
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk

    zero, one = torch.zeros_like, torch.ones_like
    specs = [  # name, kernel, plain, inputs, library, drop checks, TPU kernel
        ("fused_ln_geglu_residual_int8", gk.fused_ln_geglu_residual_int8,
         gk.fused_ln_geglu_residual_int8_plain, lambda b, n: _int8_ff_inputs(b, n, gen),
         _int8_ff_library,
         {"b1": (5, zero), "b2": (8, zero), "s1": (4, one), "s2": (7, one)},
         "rald_tpu/ops/geglu_kernel.py:411", "rald_torch/csrc/geglu_int8.cu"),
        ("fused_ln_geglu_residual_int8_static", gk.fused_ln_geglu_residual_int8_static,
         gk.fused_ln_geglu_residual_int8_static_plain,
         lambda b, n: _int8_static_inputs(_int8_ff_inputs(b, n, gen)), _int8_ff_library,
         {"b1": (5, zero), "b2": (8, zero), "d1": (4, one), "d2": (7, one),
          "inv_h": (9, one), "inv_g": (10, one)},
         "rald_tpu/ops/geglu_kernel.py:297", "rald_torch/csrc/geglu_int8.cu"),
        ("fused_self_attention_block_int8", ak.fused_self_attention_block_int8,
         ak.fused_self_attention_block_int8_plain,
         lambda b, n: _int8_attn_inputs(b, n, False, gen),
         lambda *a: _int8_attn_library(*a, vout=False),
         {"bo": (11, zero), "so": (10, one), "sv": (8, one), "sq": (4, one)},
         "rald_tpu/ops/attn_kernel.py:241", "rald_torch/csrc/attn_int8.cu"),
        ("fused_self_attention_block_int8_vout", ak.fused_self_attention_block_int8_vout,
         ak.fused_self_attention_block_int8_vout_plain,
         lambda b, n: _int8_attn_inputs(b, n, True, gen),
         lambda *a: _int8_attn_library(*a, vout=True),
         {"bo": (9, zero), "so": (8, one), "sv": (6, one)},
         "rald_tpu/ops/attn_kernel.py:342", "rald_torch/csrc/attn_int8.cu"),
    ]
    entries = []
    for name, fn, plain, make, library, drops, replaces, source in specs:
        rows = {}
        for bsz, n in INT8_SHAPES:
            args = make(bsz, n)
            got = fn(*args)
            want = plain(*args)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            ref = want.float().abs().max().item()
            check(math.isfinite(err) and err <= INT8_BAR * ref,
                  f"{name} ({bsz},{n},{D}): max err {err:.3e} > {INT8_BAR} * {ref:.3e}")
            line = {"shape": [bsz, n, D], "max_abs_err": err, "max_abs_out": ref,
                    "dropped": _drop_checks(f"{name} ({bsz},{n},{D})", plain, args, want,
                                            INT8_BAR * ref, drops)}
            if n == 512:
                iters = 200 if bsz == 1 else 50
                line["ms"] = cuda_ms(lambda: fn(*args), iters)
                line["plain_ms"] = cuda_ms(lambda: plain(*args), iters // 4)
                line["library_ms"] = cuda_ms(lambda: library(*args), iters)
                line["bound_ms"], line["bound_by"] = _int8_bound(name, bsz, n)
            rows[bsz] = line
            print(f"[kernels] {name} " + json.dumps(line))
        r1 = rows[1]
        entries.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "shape": r1["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
            "ms": r1["ms"], "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
            "bound_by": r1["bound_by"], "library_ms": r1["library_ms"], "ms_b8": rows[8]["ms"],
            "plain_ms_b8": rows[8]["plain_ms"], "bound_ms_b8": rows[8]["bound_ms"],
            "library_ms_b8": rows[8]["library_ms"],
        })
    return entries


# bf16 self-attention sublayer (fused_self_attention_block): DiT AdaLN rows
# at std 0.5, so that dropping the scale row moves the output past the bar,
# or the VAE-style affine LayerNorm rows
ATTN_SHAPES = ((1, 512), (8, 512), (3, 300))


def _attn_inputs(bsz: int, n: int, adaln: bool, gen: torch.Generator):
    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).bfloat16()

    x = rnd(bsz, n, D)
    s, b = (rnd(1, D, std=0.5), rnd(1, D, std=0.1)) if adaln else (
        (1.0 + rnd(D, std=0.1).float()).bfloat16(), rnd(D, std=0.1))
    w = [rnd(D, D, std=D ** -0.5) for _ in range(4)]
    return (x, s, b, *w, rnd(D, std=0.5))


def _attn_library(x, s, b, wq, wk, wv, wo, bo, scale_shift_mod=True):
    """Yardstick only: F.layer_norm + 3 x F.linear + SDPA + F.linear in bf16
    (the port never calls this)."""
    bsz, n, _ = x.shape
    if scale_shift_mod:
        h = F.layer_norm(x, (D,), eps=1e-5) * (1 + s) + b
    else:
        h = F.layer_norm(x, (D,), s, b, eps=1e-5)
    heads = lambda t: t.reshape(bsz, n, 8, 64).transpose(1, 2)
    o = F.scaled_dot_product_attention(heads(F.linear(h, wq)), heads(F.linear(h, wk)),
                                       heads(F.linear(h, wv)))
    return x + F.linear(o.transpose(1, 2).reshape(bsz, n, D), wo, bo)


def _attn_bound(bsz: int, n: int):
    rows = bsz * n
    flops = 4 * 2 * rows * D * D + 2 * 2 * bsz * n * n * D
    n_bytes = 2 * (2 * rows * D + 4 * D * D + D + 2 * D)
    return bound(n_bytes, flops, PEAK_BF16)


# geglu_ff: token-flattened x (the main-path widths, a ragged count and an
# out_dim of 768 that takes two 512-column blocks, the second half-masked)
GEGLU_FF_SHAPES = (((1, 512, D), D), ((8, 512, D), D), ((1000, D), D), ((2, 256, D), 768))


def _geglu_ff_inputs(shape, out_dim: int, gen: torch.Generator):
    def rnd(*sh, std=1.0):
        return (torch.randn(sh, generator=gen, device="cuda") * std).bfloat16()

    return (rnd(*shape), rnd(2 * INNER, D, std=D ** -0.5), rnd(2 * INNER, std=0.5),
            rnd(out_dim, INNER, std=INNER ** -0.5), rnd(out_dim, std=0.5))


def _geglu_ff_library(x, w1, b1, w2, b2):
    """Yardstick only: 2 x F.linear + F.gelu in bf16."""
    a, g = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2, b2)


def _geglu_ff_bound(rows: int, out_dim: int):
    flops = rows * (2 * D * 2 * INNER + 2 * INNER * out_dim)
    n_bytes = 2 * (rows * (D + out_dim) + 2 * INNER * D + INNER * out_dim + 2 * INNER + out_dim)
    return bound(n_bytes, flops, PEAK_BF16)


def _parity(label, fn, plain, args, bar_rel, drops, kw=None) -> dict:
    """Kernel against plain version on the same inputs (max |diff| <=
    bar_rel * max|out|), with the drop checks."""
    kw = kw or {}
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    check(tuple(got.shape) == tuple(want.shape), f"{label}: shape {tuple(got.shape)}")
    check(math.isfinite(err) and err <= bar_rel * ref,
          f"{label}: max err {err:.3e} > {bar_rel} * {ref:.3e}")
    return {"max_abs_err": err, "max_abs_out": ref,
            "dropped": _drop_checks(label, plain, args, want, bar_rel * ref, drops, kw)}


def _timed(line, fn, plain, library, args, kw, iters, bnd):
    line["ms"] = cuda_ms(lambda: fn(*args, **kw), iters)
    line["plain_ms"] = cuda_ms(lambda: plain(*args, **kw), max(iters // 4, 2))
    line["library_ms"] = cuda_ms(lambda: library(*args, **kw), iters)
    line["bound_ms"], line["bound_by"] = bnd


def _entry(name, source, replaces, rows: dict, b1, b8) -> dict:
    r1, r8 = rows[b1], rows[b8]
    return {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "shape": r1["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": r1["ms"], "plain_ms": r1["plain_ms"], "bound_ms": r1["bound_ms"],
        "bound_by": r1["bound_by"], "library_ms": r1["library_ms"], "ms_b8": r8["ms"],
        "plain_ms_b8": r8["plain_ms"], "bound_ms_b8": r8["bound_ms"],
        "library_ms_b8": r8.get("library_ms"),
    }


def _bf16_kernel_entries(gen: torch.Generator) -> list:
    """fused_self_attention_block and geglu_ff: bf16 outputs over 512- to
    2048-term sums in another order than the plain version, so the bar is
    geglu's 2e-2 * max|out|."""
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk

    zero = torch.zeros_like
    rows = {}
    for bsz, n in ATTN_SHAPES:
        for adaln in (True, False):
            args = _attn_inputs(bsz, n, adaln, gen)
            kw = {"scale_shift_mod": adaln}
            label = f"fused_self_attention_block ({bsz},{n},{D}) {'adaln' if adaln else 'affine'}"
            line = {"shape": [bsz, n, D], "mode": "adaln" if adaln else "affine", **_parity(
                label, ak.fused_self_attention_block, ak.fused_self_attention_block_plain, args,
                INT8_BAR, {"bo": (7, zero), "scale": (1, zero),
                           "mode": {"scale_shift_mod": not adaln}}, kw)}
            if n == 512 and adaln:
                _timed(line, ak.fused_self_attention_block, ak.fused_self_attention_block_plain,
                       _attn_library, args, kw, 200 if bsz == 1 else 50, _attn_bound(bsz, n))
                rows[bsz] = line
            rows.setdefault((bsz, n, adaln), line)
            print("[kernels] fused_self_attention_block " + json.dumps(line))
    attn = _entry("fused_self_attention_block", "rald_torch/csrc/attn_int8.cu",
                  "rald_tpu/ops/attn_kernel.py:85", rows, 1, 8)
    attn["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())

    rows = {}
    for shape, out_dim in GEGLU_FF_SHAPES:
        args = _geglu_ff_inputs(shape, out_dim, gen)
        tokens = math.prod(shape[:-1])
        line = {"shape": list(shape), "out_dim": out_dim, **_parity(
            f"geglu_ff {shape} -> {out_dim}", gk.geglu_ff, gk.geglu_ff_plain, args, INT8_BAR,
            {"b1": (2, zero), "b2": (4, zero)})}
        if shape[-2] == 512 and out_dim == D:
            _timed(line, gk.geglu_ff, gk.geglu_ff_plain, _geglu_ff_library, args, {},
                   200 if tokens == 512 else 50, _geglu_ff_bound(tokens, out_dim))
            rows[shape[0]] = line
        rows.setdefault((shape, out_dim), line)
        print("[kernels] geglu_ff " + json.dumps(line))
    ff = _entry("geglu_ff", "rald_torch/csrc/geglu.cu", "rald_tpu/ops/geglu_kernel.py:492",
                rows, 1, 8)
    ff["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return [attn, ff]


def phase_kernels() -> list:
    from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual, fused_ln_geglu_residual_plain
    from rald_torch.ops.nn_dist_kernel import (
        BIG,
        nn_min_sq_batch,
        nn_min_sq_batch_plain,
        nn_min_sq_both,
        nn_min_sq_both_plain,
    )

    gen = torch.Generator("cuda").manual_seed(0)
    entries = []

    # fused_ln_geglu_residual: bf16 keeps ~3 significant digits, and the
    # kernel and its plain version sum the 512- and 2048-term products in
    # different orders, so they agree to a fraction of max|out|, not bitwise
    tol = 2e-2
    geglu_rows = {}
    for bsz, n, adaln in ((1, 512, True), (1, 512, False), (8, 512, True), (8, 512, False),
                          (3, 300, True), (2, 77, False)):
        args = _geglu_inputs(bsz, n, adaln, gen)
        got = fused_ln_geglu_residual(*args, scale_shift_mod=adaln)
        want = fused_ln_geglu_residual_plain(*args, scale_shift_mod=adaln)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs().max().item()
        ref = want.float().abs().max().item()
        check(math.isfinite(err) and err <= tol * ref,
              f"geglu ({bsz},{n},{D}) adaln={adaln}: max err {err:.3e} > {tol} * {ref:.3e}")
        # the bar must catch a kernel that drops a bias: each bias alone
        # moves the plain version by more than the tolerance
        x, s, b, w1, b1, w2, b2 = args
        bias_shift = {}
        for key, bias_args in (("b1", (x, s, b, w1, torch.zeros_like(b1), w2, b2)),
                               ("b2", (x, s, b, w1, b1, w2, torch.zeros_like(b2)))):
            drop = fused_ln_geglu_residual_plain(*bias_args, scale_shift_mod=adaln)
            bias_shift[key] = (drop.float() - want.float()).abs().max().item()
            check(bias_shift[key] > tol * ref,
                  f"geglu ({bsz},{n},{D}): dropping {key} moves the output only "
                  f"{bias_shift[key]:.3e} <= {tol} * {ref:.3e}")
        line = {"shape": [bsz, n, D], "mode": "adaln" if adaln else "affine",
                "max_abs_err": err, "max_abs_out": ref, "bias_shift": bias_shift}
        if n == 512:
            iters = 200 if bsz == 1 else 50
            line["ms"] = cuda_ms(lambda: fused_ln_geglu_residual(*args, scale_shift_mod=adaln), iters)
            line["plain_ms"] = cuda_ms(
                lambda: fused_ln_geglu_residual_plain(*args, scale_shift_mod=adaln), iters // 4)
            line["library_ms"] = cuda_ms(lambda: _geglu_library(*args, adaln), iters)
            rows = bsz * n
            flops = rows * (2 * D * 2 * INNER + 2 * INNER * D)
            n_bytes = 2 * (2 * rows * D + 3 * D * INNER + 2 * INNER + 3 * D)
            line["bound_ms"], line["bound_by"] = bound(n_bytes, flops, PEAK_BF16)
            geglu_rows[(bsz, adaln)] = line
        print("[kernels] fused_ln_geglu_residual " + json.dumps(line))

    # nn_min_sq_both: exact f32 subtract-square on both sides -> bitwise, at
    # batch 1 and at batch 8 (the main path's two batches), where each frame
    # has its own data and its own BIG-padded tail, as batched_cd_fscore_graph
    # pads a ragged batch
    nn_rows, batch_rows = {}, {}
    for bsz in (1, 8):
        a = torch.rand((bsz, NN_N, 3), generator=gen, device="cuda") * 16.0
        b = torch.rand((bsz, NN_M, 3), generator=gen, device="cuda") * 16.0
        for i in range(bsz):
            a[i] += i  # frames apart: a kernel reading another frame's rows disagrees
            b[i] += i
            a[i, NN_N - 1000 * (i + 1):] = BIG
            b[i, NN_M - 100 * (i + 1):] = BIG
        row, col = nn_min_sq_both(a, b)
        row_p, col_p = nn_min_sq_both_plain(a, b)
        col_sw, row_sw = nn_min_sq_both(b.contiguous(), a.contiguous())  # one-direction check
        torch.cuda.synchronize()
        check(torch.equal(row, row_p) and torch.equal(col, col_p),
              f"nn_min_sq_both B={bsz} is not bitwise equal to its plain version")
        check(torch.equal(row, row_sw) and torch.equal(col, col_sw),
              f"nn_min_sq_both B={bsz} is not bitwise equal to the swapped-operand pass")
        line = {
            "shape": [bsz, NN_N, NN_M], "bitwise_equal": True,
            "max_abs_err": (row - row_p).abs().max().item(),
            "ms": cuda_ms(lambda: nn_min_sq_both(a, b), 20 if bsz == 1 else 5),
            "plain_ms": cuda_ms(lambda: nn_min_sq_both_plain(a, b), 2, warmup=1),
        }
        if bsz == 1:
            line["library_ms"] = cuda_ms(lambda: _nn_library(a, b), 2, warmup=1)
        line["bound_ms"], line["bound_by"] = bound(
            4 * bsz * (3 * (NN_N + NN_M) + NN_N + NN_M), 8 * bsz * NN_N * NN_M, PEAK_F32)
        print("[kernels] nn_min_sq_both " + json.dumps(line))
        nn_rows[bsz] = line
        # nn_min_sq_batch: the row pass alone, bitwise its plain version and
        # the two-way kernel's row output
        rb = nn_min_sq_batch(a, b)
        rb_p = nn_min_sq_batch_plain(a, b)
        torch.cuda.synchronize()
        check(torch.equal(rb, rb_p), f"nn_min_sq_batch B={bsz} is not bitwise equal to its plain version")
        check(torch.equal(rb, row), f"nn_min_sq_batch B={bsz} differs from nn_min_sq_both's rows")
        line = {
            "shape": [bsz, NN_N, NN_M], "bitwise_equal": True,
            "max_abs_err": (rb - rb_p).abs().max().item(),
            "ms": cuda_ms(lambda: nn_min_sq_batch(a, b), 20 if bsz == 1 else 5),
            "plain_ms": cuda_ms(lambda: nn_min_sq_batch_plain(a, b), 2, warmup=1),
        }
        if bsz == 1:  # the cdist composite takes ~6 s a frame
            line["library_ms"] = cuda_ms(lambda: _nn_library(a, b, both=False), 2, warmup=1)
        line["bound_ms"], line["bound_by"] = bound(
            4 * bsz * (3 * (NN_N + NN_M) + NN_N), 8 * bsz * NN_N * NN_M, PEAK_F32)
        print("[kernels] nn_min_sq_batch " + json.dumps(line))
        batch_rows[bsz] = line
    nn_line = nn_rows[1]

    entries += _int8_kernel_entries(gen)
    entries += _bf16_kernel_entries(gen)
    entries.append(_entry("nn_min_sq_batch", "rald_torch/csrc/nn_dist.cu",
                          "rald_tpu/ops/nn_dist_kernel.py:145", batch_rows, 1, 8))

    g1 = geglu_rows[(1, True)]
    entries.insert(0, {
        "name": "fused_ln_geglu_residual", "route": "cuda", "source": "rald_torch/csrc/geglu.cu",
        "replaces": "rald_tpu/ops/geglu_kernel.py:134", "shape": g1["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in geglu_rows.values()),
        "ms": g1["ms"], "plain_ms": g1["plain_ms"], "bound_ms": g1["bound_ms"],
        "bound_by": g1["bound_by"], "library_ms": g1["library_ms"],
        "ms_b8": geglu_rows[(8, True)]["ms"],
    })
    entries.insert(1, {
        "name": "nn_min_sq_both", "route": "cuda", "source": "rald_torch/csrc/nn_dist.cu",
        "replaces": "rald_tpu/ops/nn_dist_kernel.py:87", "shape": nn_line["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in nn_rows.values()), "ms": nn_line["ms"],
        "plain_ms": nn_line["plain_ms"], "bound_ms": nn_line["bound_ms"],
        "bound_by": nn_line["bound_by"], "library_ms": nn_line["library_ms"],
        "ms_b8": nn_rows[8]["ms"],
    })
    for e in entries:
        e["max_err"] = e["max_abs_err"]
    return entries


# --------------------------------------------------------------- phase 4
def _inputs(cfg, bsz: int, rng: np.random.Generator, n_eval: int = 16384, n_cfar: int = 4096,
            n_surface: int = 10_000) -> dict:
    """Seeded synthetic eval batch in the product config's shapes."""
    r = cfg.dataset.radar
    cube = rng.normal(size=(bsz, int(r.input_r_dim), int(r.input_a_dim), int(r.input_e_dim),
                            int(r.input_ch))).astype(np.float32)
    q_eval = rng.uniform(-1, 1, size=(bsz, n_eval, 3)).astype(np.float32)
    labels = (rng.uniform(size=(bsz, n_eval)) < 0.1).astype(np.float32)
    # raw CFAR detections: a ragged number of valid points per frame
    helper = rng.uniform(-1, 1, size=(bsz, n_cfar, 3)).astype(np.float32)
    helper_mask = np.arange(n_cfar)[None] < rng.integers(n_cfar // 2, n_cfar, size=(bsz, 1))
    # GT surface: a synthetic room shell (range ~ a box wall) in normalized
    # polar coordinates, 1e4 points per frame
    surface = rng.uniform(-1, 1, size=(bsz, n_surface, 3)).astype(np.float32)
    surface[..., 0] = np.clip(0.3 + 0.05 * rng.normal(size=(bsz, n_surface)), -1, 1)
    return dict(
        radar_cube=cube, seeds_or_prior=list(range(bsz)), q_eval=q_eval, labels=labels,
        qmask=np.ones_like(labels), grid=None, helper=helper, helper_mask=helper_mask,
        surface=surface, surface_mask=np.ones((bsz, n_surface), bool),
    )


def _center_occupancy(eng, batches) -> float:
    """Make random weights give a real cloud on every frame. Random weights
    attend almost uniformly, so each query gets about its frame's mean
    logit and frames differ by more than queries do: the decoder's query
    projection is sharpened 10x and the occupancy bias set so that at least
    a fifth of each frame's probe queries score positive (the centring
    scripts/full_parity.py does, per frame)."""
    probe = np.random.default_rng(1).uniform(-1, 1, size=(1, 65536, 3)).astype(np.float32)
    with torch.no_grad():
        eng.vae.decoder_cross_attn.fn.to_q.weight.mul_(10.0)
    q80 = []
    for inputs in batches:
        tokens = eng.sample_tokens(inputs["radar_cube"], inputs["seeds_or_prior"])
        logits = eng.decode_queries(tokens, np.broadcast_to(probe, (len(tokens),) + probe.shape[1:]))
        q80 += torch.quantile(logits.float()[:, ::16], 0.8, dim=1).tolist()
    shift = -min(q80)
    with torch.no_grad():
        eng.vae.to_outputs.bias += shift
    return shift


def _run_step(eng, inputs, seed: int, timings=None, **kw):
    gen = torch.Generator("cuda").manual_seed(seed)
    out = eng.fused_eval_step(**inputs, generator=gen, has_mask=False, timings=timings, **kw)
    torch.cuda.synchronize()
    return out


def _product_cfg(int8_ff=False, int8_attn=False, act_scales=None, fused_attn=False, fast=True):
    from rald_torch.config import load_config

    cfg = load_config(PRODUCT_CFG)
    cfg.eval.inference.int8_ff = int8_ff
    cfg.eval.inference.int8_attn = int8_attn
    if act_scales is not None:
        cfg.eval.inference.int8_act_scales = str(act_scales)
    if fused_attn:
        cfg.ar_model.overrides = {"use_fused_attn": True}
    if not fast:
        cfg.system.fast_inference = False
    return cfg


def _per_nfe(eng) -> int:
    """DiT block evaluations per sample: 35 NFEs x depth."""
    return (2 * eng.sampler_kwargs["num_steps"] - 1) * eng.model.depth


def _want_launches(eng) -> dict:
    """Exact launches of every kernel in one eval step of the engine's mode."""
    per_nfe, vdepth = _per_nfe(eng), len(eng.vae.layers)
    want = {name: 0 for name in KERNEL_NAMES}
    want["nn_min_sq_both"] = 1  # one Chamfer call, both directions
    if not eng.fast_inference:  # plain modules: no FF or attention kernel
        return want
    int8_ff, int8_attn = eng.use_int8_ff, eng.use_int8_attn
    want["fused_ln_geglu_residual"] = vdepth + (0 if int8_ff else per_nfe)
    if int8_ff:
        want["fused_ln_geglu_residual_int8" + ("_static" if int8_ff == "static" else "")] = per_nfe
    if int8_attn:
        want["fused_self_attention_block_int8" + ("_vout" if int8_attn == "vout" else "")] = per_nfe
    elif eng.model.use_fused_attn:
        want["fused_self_attention_block"] = per_nfe
    return want


def _check_counts(counts: dict, want: dict, label: str) -> None:
    for name, n in want.items():
        check(counts[name] == n, f"{label}: {counts[name]} {name} launches, want {n}")


# ------------------------------------------------------- the infer CLI
CLI_FRAMES = (5, 4)  # raw cubes in two sequence directories with colliding names


def _cli_cubes(cfg) -> Path:
    """Synthetic raw cubes of the product shape (intensity dB, velocity,
    validity), written as the dataset lays them out."""
    import shutil

    root = SCRATCH / "cli_cubes"
    shutil.rmtree(root, ignore_errors=True)
    r = cfg.dataset.radar
    shape = (int(r.input_r_dim), int(r.input_a_dim), int(r.input_e_dim))
    rng = np.random.default_rng(11)
    for seq, n in zip(("seq_a", "seq_b"), CLI_FRAMES):
        d = root / seq / "radar_cube"
        d.mkdir(parents=True)
        for i in range(n):
            cube = np.stack([rng.uniform(0, 60, shape), rng.normal(0, 1.5, shape),
                             (rng.uniform(size=shape) < 0.7)], axis=-1).astype(np.float32)
            np.save(d / f"{i:04d}.npy", cube)
    return root


def _cli_run(eng, cfg, label: str, src: Path, bsz: int = 8) -> dict:
    """``rald_torch.cli.infer.run`` over the cubes at ``src`` with this
    engine (its weights), batch 8: two batches, the last one pad-last. The
    threshold sits at the 90th percentile of the first frame's logits, so
    the clouds are real; the first batch's point counts must equal
    (decode > threshold).sum() of a separate pass, and every kernel count
    is exact."""
    import shutil

    from rald_torch.cli import infer
    from rald_torch.eval.ply import read_ply
    from rald_torch.ops import launch_counts, reset_launch_counts

    out = SCRATCH / f"cli_{label}"
    shutil.rmtree(out, ignore_errors=True)
    files = infer.collect_inputs(str(src))
    check(len(files) == sum(CLI_FRAMES), f"cli {label}: {len(files)} inputs")
    grid = torch.from_numpy(infer.query_grid(cfg)).cuda()[None].expand(bsz, -1, -1)
    cubes = np.stack([infer.preprocess(infer.load_cube(f), cfg.dataset.radar)
                      for f in files[:bsz]])
    logits = eng.decode_queries(eng.sample_tokens(cubes, list(range(bsz))), grid)
    thr = float(torch.quantile(logits[0, ::16], 0.9))
    want_points = (logits > thr).sum(1).tolist()
    reset_launch_counts()
    stats = infer.run(cfg, str(src), str(out), batch=bsz, threshold=thr, engine=eng,
                      print_fn=lambda *_: None)
    counts = launch_counts()
    n_batches = -(-len(files) // bsz)
    want = {name: 0 for name in KERNEL_NAMES}
    per_nfe, vdepth = _per_nfe(eng), len(eng.vae.layers)
    want["fused_ln_geglu_residual"] = n_batches * (per_nfe + vdepth)
    if eng.model.use_fused_attn:
        want["fused_self_attention_block"] = n_batches * per_nfe
    _check_counts(counts, want, f"cli {label}")
    got = sorted(str(p.relative_to(out)) for p in out.rglob("*.ply"))
    expect = sorted(f"{seq}/radar_cube/{i:04d}.ply"
                    for seq, n in zip(("seq_a", "seq_b"), CLI_FRAMES) for i in range(n))
    check(got == expect, f"cli {label}: PLY files {got}")
    check(stats["files"] == len(files), f"cli {label}: {stats['files']} files")
    for f, n in zip(infer.output_paths(files, out), stats["points"]):
        check(len(read_ply(f)) == n, f"cli {label}: {f} holds {len(read_ply(f))} points, not {n}")
    check(stats["points"][:bsz] == want_points,
          f"cli {label}: points {stats['points'][:bsz]} != decode > thr {want_points}")
    check(sum(stats["points"]) > 0, f"cli {label}: every cloud is empty")
    line = {"mode": label, "batch": bsz, "files": stats["files"], "threshold": thr,
            "points": stats["points"], "seconds": stats["seconds"],
            "frames_per_s": stats["frames_per_sec"], "launches": counts}
    print("[cli] " + json.dumps(line))
    return line


def _main_run(eng, inputs, bsz: int, label: str, want: dict) -> dict:
    from rald_torch.ops import launch_counts, reset_launch_counts

    kw = dict(compute_cd=True, refine=True, helper_aug=True, use_device_grid=True)
    _run_step(eng, inputs, seed=bsz, **kw)  # warm-up: cuBLAS/cuDNN plans
    torch.cuda.reset_peak_memory_stats()
    timings = {}
    reset_launch_counts()
    t0 = time.perf_counter()
    loss, iou, acc, cd, f, n_pred = _run_step(eng, inputs, seed=bsz, timings=timings, **kw)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    cd, f, n_pred = cd.cpu().numpy(), f.cpu().numpy(), n_pred.cpu().numpy()
    _check_counts(counts, want, f"{label} B={bsz}")
    check(bool((n_pred > 0).all()), f"{label} B={bsz}: empty prediction n_pred={n_pred.tolist()}")
    check(bool(np.isfinite(cd).all()) and bool(np.isfinite(f).all()),
          f"{label} B={bsz}: non-finite Chamfer/F {cd.tolist()} {f.tolist()}")
    check(all(math.isfinite(float(v)) for v in (loss, iou, acc)),
          f"{label} B={bsz}: non-finite loss/IoU")
    line = {
        "mode": label, "batch": bsz, "stage_ms": {k: round(v, 3) for k, v in timings.items()},
        "step_ms": wall * 1e3, "frames_per_s": bsz / wall,
        "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "launches": counts, "n_pred": n_pred.tolist(), "cd": cd.tolist(), "f": f.tolist(),
        "loss": float(loss), "iou": float(iou), "acc": float(acc),
    }
    print("[main] " + json.dumps(line))
    return line


def _build(cfg, label: str, batches):
    from rald_torch.train.gen_engine import GenerationEngine

    t0 = time.perf_counter()
    eng = GenerationEngine(cfg)  # device None -> the card
    built = time.perf_counter() - t0
    shift = _center_occupancy(eng, batches)
    print(f"[main] {label}: engine built in {built:.1f} s, occupancy bias shift {shift:+.6f}")
    return eng


def _geglu_ff_module_run(eng) -> dict:
    """``GEGLUFeedForward(use_fused=True)``: the module that reaches
    geglu_ff (no inference chain of the JAX package does), at full width
    with the DiT's block-0 FF weights, against the unfused module."""
    from rald_torch.ops import launch_counts, reset_launch_counts

    ff = eng.model.model.transformer_blocks[0].ff
    x = torch.randn((8, 512, D), generator=torch.Generator("cuda").manual_seed(5),
                    device="cuda").bfloat16()
    want = ff(x)
    reset_launch_counts()
    ff.use_fused = True
    try:
        got = ff(x)
        torch.cuda.synchronize()
    finally:
        ff.use_fused = False
    counts = launch_counts()
    err = (got.float() - want.float()).abs().max().item()
    ref = want.float().abs().max().item()
    check(err <= INT8_BAR * ref, f"GEGLUFeedForward(use_fused=True): err {err:.3e} vs {ref:.3e}")
    _check_counts(counts, {name: int(name == "geglu_ff") for name in KERNEL_NAMES},
                  "GEGLUFeedForward(use_fused=True)")
    line = {"mode": "GEGLUFeedForward(use_fused=True)", "shape": [8, 512, D],
            "max_abs_err_vs_unfused": err, "launches": counts}
    print("[main] " + json.dumps(line))
    return line


def phase_main() -> dict:
    """Returns the runs by (mode, batch)."""
    cfg = _product_cfg()
    rng = np.random.default_rng(cfg.system.seed)
    inputs = {b: _inputs(cfg, b, rng) for b in (1, 8)}
    cli_src = _cli_cubes(cfg)
    eng = _build(cfg, "bf16", inputs.values())
    depth, vdepth = eng.model.depth, len(eng.vae.layers)
    n_params = sum(p.numel() for m in (eng.model, eng.vae) for p in m.parameters())
    print(f"[main] {cfg.ar_model.name} (depth {depth}) + {cfg.lidar_ae.name} (depth {vdepth}), "
          f"{n_params / 1e6:.1f}M params, {eng.dtype}; decoder query projection x10")
    runs = {}
    for bsz in (1, 8):
        runs[("bf16", bsz)] = _main_run(eng, inputs[bsz], bsz, "bf16", _want_launches(eng))
    runs[("cli bf16", 8)] = _cli_run(eng, cfg, "bf16", cli_src)

    # static activation scales: the port's calibration on one synthetic batch
    t0 = time.perf_counter()
    ah, ag = eng.calibrate_act_scales(
        [{"radar_cube": inputs[1]["radar_cube"], "seeds_or_prior": inputs[1]["seeds_or_prior"]}],
        num_batches=1, margin=1.1, print_fn=lambda *_: None)
    scales = SCRATCH / "int8_act_scales.npz"
    scales.parent.mkdir(parents=True, exist_ok=True)
    np.savez(scales, ah=ah, ag=ag, num_steps=eng.sampler_kwargs["num_steps"])
    check(ah.shape == (eng.sampler_kwargs["num_steps"], depth) and bool(np.isfinite(ah).all())
          and bool((ah > 0).all()) and bool((ag > 0).all()), "calibrate_act_scales: bad tables")
    print(f"[main] calibrate_act_scales (1 batch, margin 1.1) in {time.perf_counter() - t0:.1f} s: "
          f"ah {float(ah.min()):.4f}..{float(ah.max()):.4f}, "
          f"ag {float(ag.min()):.4f}..{float(ag.max()):.4f}")
    del eng
    torch.cuda.empty_cache()

    for int8_ff, int8_attn, batches in ((True, "vout", (1, 8)), (True, "full", (1,)),
                                        ("static", "vout", (1,))):
        label = f"int8_ff={int8_ff},int8_attn={int8_attn}"
        eng = _build(_product_cfg(int8_ff, int8_attn, scales if int8_ff == "static" else None),
                     label, [inputs[b] for b in batches])
        for bsz in batches:
            runs[(label, bsz)] = _main_run(eng, inputs[bsz], bsz, label, _want_launches(eng))
        del eng
        torch.cuda.empty_cache()

    # ar_model.overrides: {use_fused_attn: true}: the bf16 attention kernel
    cfg = _product_cfg(fused_attn=True)
    eng = _build(cfg, "use_fused_attn", inputs.values())
    for bsz in (1, 8):
        runs[("use_fused_attn", bsz)] = _main_run(eng, inputs[bsz], bsz, "use_fused_attn",
                                                  _want_launches(eng))
    runs[("cli use_fused_attn", 8)] = _cli_run(eng, cfg, "use_fused_attn", cli_src)
    runs[("GEGLUFeedForward(use_fused=True)", 1)] = _geglu_ff_module_run(eng)
    del eng
    torch.cuda.empty_cache()

    # system.fast_inference: false: plain modules, unfolded decode, no kernel
    # but the Chamfer pass
    eng = _build(_product_cfg(fast=False), "fast_inference=false", [inputs[1]])
    runs[("fast_inference=false", 1)] = _main_run(eng, inputs[1], 1, "fast_inference=false",
                                                  _want_launches(eng))
    del eng
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------- phase 5
def _reference_chain(int8_ff=False, int8_attn=False, act_scales=None, bf16_tokens=None,
                     fused_attn=False):
    """The chain at depth 2 / 4 steps, once through the kernels and once
    with their plain versions patched in, on the same card and weights.
    ``bf16_tokens``: the plain bf16 chain's tokens (same weights, cube and
    prior), the yardstick of a chain whose attention is a kernel too.
    Returns the engine, its inputs and the plain tokens."""
    import rald_torch.eval.chamfer as chamfer
    import rald_torch.models.latent_dit as latent_dit
    import rald_torch.models.vecset_vae as vecset_vae
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk
    from rald_torch.ops.nn_dist_kernel import nn_min_sq_both_plain
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _product_cfg(int8_ff, int8_attn, act_scales)
    cfg.ar_model.overrides = {"depth": 2, "use_fused_attn": fused_attn}
    cfg.lidar_ae.overrides = {"depth": 2}
    cfg.eval.inference.num_steps = 4
    cfg.eval.inference.num_query_points = 65536
    cfg.eval.inference.refine_query_aug_num = 65536
    eng = GenerationEngine(cfg)
    inputs = _inputs(cfg, 1, np.random.default_rng(7))
    _center_occupancy(eng, [inputs])
    kw = dict(compute_cd=True, refine=True, helper_aug=False, use_device_grid=True)
    inputs["helper"] = inputs["helper_mask"] = None
    tok_k = eng.sample_tokens(inputs["radar_cube"], [0])
    out_k = _run_step(eng, inputs, seed=3, **kw)
    patches = [(latent_dit, "fused_ln_geglu_residual", gk.fused_ln_geglu_residual_plain),
               (vecset_vae, "fused_ln_geglu_residual", gk.fused_ln_geglu_residual_plain),
               (chamfer, "nn_min_sq_both", nn_min_sq_both_plain)]
    patches += [(latent_dit, name, getattr(mod, name + "_plain"))
                for mod, name in ((gk, "fused_ln_geglu_residual_int8"),
                                  (gk, "fused_ln_geglu_residual_int8_static"),
                                  (ak, "fused_self_attention_block"),
                                  (ak, "fused_self_attention_block_int8"),
                                  (ak, "fused_self_attention_block_int8_vout"))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, plain in patches:
        setattr(mod, name, plain)
    try:
        tok_p = eng.sample_tokens(inputs["radar_cube"], [0])
        out_p = _run_step(eng, inputs, seed=3, **kw)
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    tok_err = (tok_k - tok_p).abs().max().item()
    tok_rms = tok_p.pow(2).mean().sqrt().item()
    cd_k, cd_p = float(out_k[3][0]), float(out_p[3][0])
    line = {"int8_ff": int8_ff, "int8_attn": int8_attn, "use_fused_attn": fused_attn,
            "tokens_max_abs_diff": tok_err,
            "tokens_rms": tok_rms, "cd_kernels": cd_k, "cd_plain": cd_p,
            "n_pred_kernels": int(out_k[5][0]), "n_pred_plain": int(out_p[5][0])}
    line["tokens_rms_diff"] = (tok_k - tok_p).pow(2).mean().sqrt().item()
    if bf16_tokens is None:
        # bf16 chain: the two paths round the FF sums in different orders;
        # the bar is scripts/full_parity.py's 5% of max(rms, 1) on the tokens
        err, bar = tok_err, 0.05 * max(tok_rms, 1.0)
    else:
        # int8 or fused-attention chain: here the attention sublayer is a
        # kernel too, with its own f32 summation order, and the max
        # |difference| of this 4-step random-weight chain saturates under
        # any small perturbation (bf16 chain 0.17, int8 chain 0.33, plain
        # int8 vs plain bf16 0.32 on an H100), so the bar is the same 5% of
        # max(rms, 1) taken on the rms difference over all token values
        # (bf16 chain 0.039, int8 0.075): a kernel that composes wrongly (a
        # dropped bias moves a sublayer by ~30% of max|out|, phase 3)
        # misses it by far
        q = tok_p - bf16_tokens
        line["tokens_vs_bf16_plain"] = q.abs().max().item()
        line["tokens_vs_bf16_plain_rms"] = q.pow(2).mean().sqrt().item()
        err, bar = line["tokens_rms_diff"], 0.05 * max(tok_rms, 1.0)
    line["tokens_bar"] = bar
    print("[reference] " + json.dumps(line))
    check(err <= bar, f"reference {line}: token drift {err:.3e} > {bar:.3e}")
    check(math.isfinite(cd_k) and abs(cd_k - cd_p) <= 0.05 * abs(cd_p),
          f"reference {line}: Chamfer {cd_k} vs plain {cd_p}")
    return eng, inputs, tok_p


def _host_chamfer() -> dict:
    """The host ``chamfer_and_fscore`` on the card (one nn_min_sq_batch per
    direction) against the same call on the CPU: distances are exact on
    both, so F agrees exactly and CD to the order of its f32 sums."""
    from rald_torch.eval.chamfer import chamfer_and_fscore
    from rald_torch.ops import launch_counts, reset_launch_counts

    rng = np.random.default_rng(13)
    pred = rng.uniform(0, 10, size=(20_000, 3)).astype(np.float32)
    gt = rng.uniform(0, 10, size=(5_000, 3)).astype(np.float32)
    reset_launch_counts()
    cd, f = chamfer_and_fscore(pred, gt, 0.25)  # device None -> the card
    counts = launch_counts()
    cd_c, f_c = chamfer_and_fscore(pred, gt, 0.25, device="cpu")
    _check_counts(counts, {name: 2 * (name == "nn_min_sq_batch") for name in KERNEL_NAMES},
                  "host chamfer_and_fscore")
    check(math.isfinite(cd) and abs(cd - cd_c) <= 1e-5 * cd_c and f == f_c and 0 < f < 1,
          f"host chamfer_and_fscore: card ({cd}, {f}) vs CPU ({cd_c}, {f_c})")
    line = {"mode": "host chamfer_and_fscore", "pred": len(pred), "gt": len(gt), "cd": cd,
            "f": f, "cd_cpu": cd_c, "f_cpu": f_c, "launches": counts}
    print("[reference] " + json.dumps(line))
    return line


def phase_reference() -> dict:
    """Returns the host Chamfer call's line (its launch counts)."""
    eng, _, tok_bf16 = _reference_chain()
    del eng
    eng, _, _ = _reference_chain(fused_attn=True, bf16_tokens=tok_bf16)
    del eng
    eng, inputs, _ = _reference_chain(True, "vout", bf16_tokens=tok_bf16)
    ah, ag = eng.calibrate_act_scales([{"radar_cube": inputs["radar_cube"], "seeds_or_prior": [0]}],
                                      num_batches=1, margin=1.1, print_fn=lambda *_: None)
    del eng
    scales = SCRATCH / "int8_act_scales_depth2.npz"
    np.savez(scales, ah=ah, ag=ag, num_steps=4)
    _reference_chain("static", "full", act_scales=scales, bf16_tokens=tok_bf16)
    return _host_chamfer()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    name, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
    smi = smi_line()
    print(f"[device] {name} x{count}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    t_start = time.perf_counter()
    phase_build()
    kernels = phase_kernels()
    runs = phase_main()
    runs[("host chamfer_and_fscore", 1)] = phase_reference()
    # each kernel's launches in the runs of the mode that uses it: the main
    # path's eval step at batch 1 (and 8), or, for the two kernels no
    # inference chain reaches, the module / host API that does
    vout = "int8_ff=True,int8_attn=vout"
    mode_of = {"fused_ln_geglu_residual": "bf16", "nn_min_sq_both": "bf16",
               "nn_min_sq_batch": "host chamfer_and_fscore",
               "fused_ln_geglu_residual_int8": vout, "fused_self_attention_block_int8_vout": vout,
               "fused_self_attention_block_int8": "int8_ff=True,int8_attn=full",
               "fused_ln_geglu_residual_int8_static": "int8_ff=static,int8_attn=vout",
               "geglu_ff": "GEGLUFeedForward(use_fused=True)",
               "fused_self_attention_block": "use_fused_attn"}
    for k in kernels:
        mode = mode_of[k["name"]]
        k["launches_mode"] = mode
        k["launches"] = runs[(mode, 1)]["launches"][k["name"]]
        if (mode, 8) in runs:
            k["launches_b8"] = runs[(mode, 8)]["launches"][k["name"]]
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
