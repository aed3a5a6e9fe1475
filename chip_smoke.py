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
   out_dim of 768; fused_ln_geglu_residual and the three attention kernels
   also with one AdaLN row per frame), with checks that the bar catches a
   kernel dropping a bias or a scale row, computing the other mod mode or
   applying frame 0's modulation row to every frame (the nearest-neighbour
   kernels: bitwise, and nn_min_sq_batch bitwise equal to nn_min_sq_both's
   rows, also at the host Chamfer APIs' shapes: the reverse pass of 1e4 GT
   points padded to 16384 against 5e5 predictions padded to 524288, and
   3e4 predictions padded to 32768 against the GT's 16384, each with the
   slice count S its grid takes), then timed with CUDA events beside the
   plain version, a composite
   of library calls the port never makes (``library_ms``) and the card's
   bound for the same work; the FF and attention kernels and their
   composites also with cold weights (``ms_cold``: 24 weight sets in turn,
   one per DiT layer). Then the float32 instantiations of the seven FF and
   attention kernels (x in f32, ``matmul_precision: highest``) against
   their plain versions in f32 at the same shapes, with their drop checks,
   timed against the f32 bound.
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
   unfolded decode). Then the chain in float32 at batch 1
   (``compute_dtype: float32``, ``matmul_precision: highest`` applied by
   ``rald_torch.apply_matmul_precision``): as shipped, with
   ``use_fused_attn``, int8 dynamic + vout and int8 static + full, plus the
   CLI on that YAML (which must set both torch precision switches) and
   ``GEGLUFeedForward(use_fused=True)`` in f32. Launch counters are zeroed
   just before each run and read just after, and every kernel's count is
   checked exactly.
5. reference: reduced-depth chains (bf16; bf16 + use_fused_attn; int8
   dynamic + vout; int8 static + full; f32 + use_fused_attn, held to a
   strict bar) each run twice on the card, once through the kernels and
   once through their plain versions; tokens and Chamfer must agree. Then
   the host ``chamfer_and_fscore`` once on the card against the CPU.

Then one ``kernels`` JSON line, the ``nvidia-smi`` line again, and the last
line ``{"ok": true, "device": {...}}``. Any failure raises (non-zero exit).

One-offs outside the default run: ``nn_library_b8()`` times the
nearest-neighbour library yardsticks at batch 8, ``ff_breakdown()`` and
``attn_breakdown()`` split the four FF calls (bf16 and int8) and the three
attention calls into host and device time and per-launch device time,
``nn_breakdown()`` does the same for the two nearest-neighbour kernels at
phase 3's four shapes (with the S each launch took and the SM clock under
load), ``nn_sass()`` counts their SASS opcodes, ``int8_ff_dump()`` compares the int8 FF
kernels' outputs with another tree's (bitwise), and
``trace_sample()`` traces the product sampler, as shipped or in a kernel
mode (device busy time and idle share at batch 1 and 8).
"""
from __future__ import annotations

import itertools
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
    for name, secs in sorted(_build.build_seconds.items()):
        print(f"[build] {name}: nvcc {secs:.1f} s")
    for name, report in sorted(_build.ptxas_report.items()):
        for line in report.splitlines():
            print(f"[build] {name}: {line.strip()}")


# --------------------------------------------------------------- phase 3
def _geglu_inputs(bsz: int, n: int, adaln: bool, gen: torch.Generator, per_batch=False,
                  dtype=torch.bfloat16):
    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    x = rnd(bsz, n, D)
    if adaln:  # DiT: AdaLN (scale, shift) rows, one per frame or one shared
        rows = (bsz, 1, D) if per_batch else (1, D)
        s, b = rnd(*rows, std=0.1), rnd(*rows, std=0.1)
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


def _esz_peak(dtype):
    """Bytes per activation or weight value and the peak rate of the float
    products, for activations of ``dtype`` (f32: the CUDA cores)."""
    return (4, PEAK_F32) if dtype == torch.float32 else (2, PEAK_BF16)


def _geglu_bound(bsz: int, n: int, dtype=torch.bfloat16):
    esz, peak = _esz_peak(dtype)
    rows = bsz * n
    flops = rows * (2 * D * 2 * INNER + 2 * INNER * D)
    n_bytes = esz * (2 * rows * D + 3 * D * INNER + 2 * INNER + 3 * D)
    return bound(n_bytes, flops, peak)


# Cold weights: the main path reads each of its 24 layers' weights once per
# NFE, from HBM rather than L2. Rotating through 24 weight sets (FF: 144 MB,
# beyond the 50 MB L2; self-attention: 48 MB bf16 or 24-36 MB int8, within
# it, so some of those reads may still hit L2) times the kernels and their
# library composites that way (ms_cold / library_ms_cold).
COLD_SETS = 24


def _ff_weight_sets(gen: torch.Generator) -> list:
    def rnd(*shape, std):
        return (torch.randn(shape, generator=gen, device="cuda") * std).bfloat16()

    return [(rnd(2 * INNER, D, std=D ** -0.5), rnd(2 * INNER, std=0.5),
             rnd(D, INNER, std=INNER ** -0.5), rnd(D, std=0.5)) for _ in range(COLD_SETS)]


def _cold_ms(fn, wsets, iters: int) -> float:
    """cuda_ms of ``fn(w1, b1, w2, b2)``, each call with the next weight set."""
    it = itertools.cycle(wsets)
    return cuda_ms(lambda: fn(*next(it)), iters)


def _cold_keys(entry: dict, rows: dict) -> dict:
    for key in ("ms_cold", "library_ms_cold"):
        entry[key], entry[key.replace("_cold", "_cold_b8")] = rows[1][key], rows[8][key]
    return entry


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


def _int8_ff_inputs(bsz: int, n: int, gen: torch.Generator, per_batch=False,
                    dtype=torch.bfloat16):
    from rald_torch.ops.geglu_kernel import quantize_cols

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    x = rnd(bsz, n, D).to(dtype)
    rows = (bsz, 1, D) if per_batch else (1, D)  # one AdaLN row per frame, or one shared
    s, b = rnd(*rows, std=0.1).to(dtype), rnd(*rows, std=0.1).to(dtype)
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


def _int8_attn_inputs(bsz: int, n: int, vout: bool, gen: torch.Generator, per_batch=False,
                      dtype=torch.bfloat16):
    from rald_torch.ops.geglu_kernel import quantize_cols

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    x = rnd(bsz, n, D).to(dtype)
    rows = (bsz, 1, D) if per_batch else (1, D)  # one AdaLN row per frame, or one shared
    s, b = rnd(*rows, std=0.1).to(dtype), rnd(*rows, std=0.1).to(dtype)
    w = [rnd(D, D, std=D ** -0.5) for _ in range(4)]
    qk = (w[0].to(dtype), w[1].to(dtype)) if vout else (*quantize_cols(w[0]),
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
        return (torch._int_mm(hq, wq8.t()).float() * hr * sc).to(x.dtype)

    if vout:
        (wq, wk), (wv, sv, wo, so, bo) = w[:2], w[2:]
        q, k = F.linear(h.to(x.dtype), wq), F.linear(h.to(x.dtype), wk)
    else:
        (wq, sq, wk, sk), (wv, sv, wo, so, bo) = w[:4], w[4:]
        q, k = proj(wq, sq), proj(wk, sk)
    heads = lambda t: t.reshape(bsz, n, 8, 64).transpose(1, 2)
    o = F.scaled_dot_product_attention(heads(q), heads(k), heads(proj(wv, sv)))
    oq, orow = _quant_lib(o.transpose(1, 2).reshape(-1, D).float())
    y = torch._int_mm(oq, wo.t()).float() * orow * so + bo + x.reshape(-1, D).float()
    return y.to(x.dtype).reshape(x.shape)


def _int8_bound(name: str, bsz: int, n: int, dtype=torch.bfloat16):
    esz, peak = _esz_peak(dtype)
    rows = bsz * n
    act_bytes = esz * (2 * rows * D) + esz * 2 * D  # x in, out, mod rows (x's type)
    if name.startswith("fused_ln_geglu_residual_int8"):
        int8_ops = rows * (2 * D * 2 * INNER + 2 * INNER * D)
        n_bytes = act_bytes + 3 * D * INNER + 4 * (2 * 2 * INNER + 2 * D)
        return bound_t(n_bytes, int8_ops / PEAK_INT8)
    attn_ops = 2 * 2 * bsz * n * n * D  # q.k^T and a.v over all heads, x's type
    if name.endswith("_vout"):
        int8_ops, float_ops = 2 * 2 * rows * D * D, 2 * 2 * rows * D * D + attn_ops
        n_bytes = act_bytes + esz * 2 * D * D + 2 * D * D + 4 * 3 * D
    else:
        int8_ops, float_ops = 4 * 2 * rows * D * D, attn_ops
        n_bytes = act_bytes + 4 * D * D + 4 * 5 * D
    return bound_t(n_bytes, int8_ops / PEAK_INT8 + float_ops / peak)


def _drop_checks(label, plain, args, want, bar, drops, kw=None) -> dict:
    """Each entry of ``drops`` (key -> (operand index, replacement), a tuple
    of such pairs, or a dict of keyword changes) must move the plain output
    by more than the bar: the parity check then catches a kernel that leaves
    that operand out (or computes the other mode, or reads another frame's
    modulation row)."""
    moved = {}
    for key, change in drops.items():
        a, k = list(args), dict(kw or {})
        if isinstance(change, dict):
            k.update(change)
        else:
            for i, repl in (change if isinstance(change[0], tuple) else (change,)):
                a[i] = repl(a[i])
        moved[key] = (plain(*a, **k).float() - want.float()).abs().max().item()
        check(moved[key] > bar, f"{label}: dropping {key} moves the output only "
                                f"{moved[key]:.3e} <= bar {bar:.3e}")
    return moved


# the attention kernels also with one AdaLN row per frame, as the DiT
# passes them, at batch 8 and at (3, 300), where query tiles straddle frames;
# a drop check gives every frame frame 0's row
ATTN_FRAME_SHAPES = ((8, 512), (3, 300))


def _row0(t):
    return t[:1].expand_as(t).contiguous()  # frame 0's modulation row for every frame


def _attn_weight_sets(gen: torch.Generator, kind: str) -> list:
    """COLD_SETS weight sets of one self-attention sublayer, in the operand
    order the kernel takes after (x, scale, shift): bf16 (wq, wk, wv, wo,
    bo), int8 "full" or "vout" as ``_int8_attn_inputs`` makes them."""
    from rald_torch.ops.geglu_kernel import quantize_cols

    def rnd(*shape, std=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * std

    sets = []
    for _ in range(COLD_SETS):
        w, bo = [rnd(D, D, std=D ** -0.5) for _ in range(4)], rnd(D, std=0.5)
        if kind == "bf16":
            sets.append((*(t.bfloat16() for t in w), bo.bfloat16()))
            continue
        qk = (w[0].bfloat16(), w[1].bfloat16()) if kind == "vout" else (*quantize_cols(w[0]),
                                                                         *quantize_cols(w[1]))
        sets.append((*qk, *quantize_cols(w[2]), *quantize_cols(w[3]), bo))
    return sets


def _int8_ff_weight_sets(gen: torch.Generator, static: bool) -> list:
    """COLD_SETS int8 FF weight sets (3 MB of int8 each, 72 MB in all:
    beyond the 50 MB L2) in the operand order after (x, scale, shift), as
    ``_int8_ff_inputs`` (and ``_int8_static_inputs``) make them."""
    sets = []
    for _ in range(COLD_SETS):
        ops = _int8_ff_inputs(1, 1, gen)
        sets.append((_int8_static_inputs(ops) if static else ops)[3:])
    return sets


def _cold_lines(line, fn, library, args, bsz: int, wsets) -> None:
    """``ms_cold`` / ``library_ms_cold``: the call with the next of COLD_SETS
    weight sets each time, x and the modulation rows fixed."""
    x, s, b = args[:3]
    cold = (4 if bsz == 1 else 2) * COLD_SETS
    line["ms_cold"] = _cold_ms(lambda *w: fn(x, s, b, *w), wsets, cold)
    line["library_ms_cold"] = _cold_ms(lambda *w: library(x, s, b, *w), wsets, cold)


def _int8_kernel_entries(gen: torch.Generator) -> list:
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk

    zero, one = torch.zeros_like, torch.ones_like
    specs = [  # name, kernel, plain, inputs, library, drop checks, TPU kernel, attention
        ("fused_ln_geglu_residual_int8", gk.fused_ln_geglu_residual_int8,
         gk.fused_ln_geglu_residual_int8_plain, lambda b, n, _: _int8_ff_inputs(b, n, gen),
         _int8_ff_library,
         {"b1": (5, zero), "b2": (8, zero), "s1": (4, one), "s2": (7, one)},
         "rald_tpu/ops/geglu_kernel.py:453", "rald_torch/csrc/geglu_int8.cu", None),
        ("fused_ln_geglu_residual_int8_static", gk.fused_ln_geglu_residual_int8_static,
         gk.fused_ln_geglu_residual_int8_static_plain,
         lambda b, n, _: _int8_static_inputs(_int8_ff_inputs(b, n, gen)), _int8_ff_library,
         {"b1": (5, zero), "b2": (8, zero), "d1": (4, one), "d2": (7, one),
          "inv_h": (9, one), "inv_g": (10, one)},
         "rald_tpu/ops/geglu_kernel.py:347", "rald_torch/csrc/geglu_int8.cu", None),
        ("fused_self_attention_block_int8", ak.fused_self_attention_block_int8,
         ak.fused_self_attention_block_int8_plain,
         lambda b, n, per: _int8_attn_inputs(b, n, False, gen, per),
         lambda *a: _int8_attn_library(*a, vout=False),
         {"bo": (11, zero), "so": (10, one), "sv": (8, one), "sq": (4, one)},
         "rald_tpu/ops/attn_kernel.py:274", "rald_torch/csrc/attn.cu", "full"),
        ("fused_self_attention_block_int8_vout", ak.fused_self_attention_block_int8_vout,
         ak.fused_self_attention_block_int8_vout_plain,
         lambda b, n, per: _int8_attn_inputs(b, n, True, gen, per),
         lambda *a: _int8_attn_library(*a, vout=True),
         {"bo": (9, zero), "so": (8, one), "sv": (6, one)},
         "rald_tpu/ops/attn_kernel.py:377", "rald_torch/csrc/attn.cu", "vout"),
    ]
    entries = []
    for name, fn, plain, make, library, drops, replaces, source, attn in specs:
        rows = {}
        wsets = (_attn_weight_sets(gen, attn) if attn else
                 _int8_ff_weight_sets(gen, static=name.endswith("_static")))
        shapes = [(b, n, False) for b, n in INT8_SHAPES]
        if attn:
            shapes += [(b, n, True) for b, n in ATTN_FRAME_SHAPES]
        for bsz, n, per_batch in shapes:
            args = make(bsz, n, per_batch)
            label = f"{name} ({bsz},{n},{D})" + (" per-frame rows" if per_batch else "")
            line = {"shape": [bsz, n, D], "per_frame_rows": per_batch, **_parity(
                label, fn, plain, args, INT8_BAR,
                {**drops, "row0": ((1, _row0), (2, _row0))} if per_batch else drops)}
            if n == 512 and not per_batch:
                _timed(line, fn, plain, library, args, {}, 200 if bsz == 1 else 50,
                       _int8_bound(name, bsz, n))
                _cold_lines(line, fn, library, args, bsz, wsets)
                rows[bsz] = line
            rows.setdefault((bsz, n, per_batch), line)
            print(f"[kernels] {name} " + json.dumps(line))
        entries.append(_cold_keys(_entry(name, source, replaces, rows, 1, 8), rows))
    return entries


# bf16 self-attention sublayer (fused_self_attention_block): DiT AdaLN rows
# at std 0.5, so that dropping the scale row moves the output past the bar,
# or the VAE-style affine LayerNorm rows
ATTN_SHAPES = ((1, 512), (8, 512), (3, 300))


def _attn_inputs(bsz: int, n: int, adaln: bool, gen: torch.Generator, per_batch=False,
                 dtype=torch.bfloat16):
    def rnd(*shape, std=1.0):
        return (torch.randn(shape, generator=gen, device="cuda") * std).to(dtype)

    x = rnd(bsz, n, D)
    rows = (bsz, 1, D) if per_batch else (1, D)  # one AdaLN row per frame, or one shared
    s, b = (rnd(*rows, std=0.5), rnd(*rows, std=0.1)) if adaln else (
        (1.0 + rnd(D, std=0.1).float()).to(dtype), rnd(D, std=0.1))
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


def _attn_bound(bsz: int, n: int, dtype=torch.bfloat16):
    esz, peak = _esz_peak(dtype)
    rows = bsz * n
    flops = 4 * 2 * rows * D * D + 2 * 2 * bsz * n * n * D
    n_bytes = esz * (2 * rows * D + 4 * D * D + D + 2 * D)
    return bound(n_bytes, flops, peak)


# geglu_ff: token-flattened x (the main-path widths, a ragged count and an
# out_dim of 768 that takes two 512-column blocks, the second half-masked)
GEGLU_FF_SHAPES = (((1, 512, D), D), ((8, 512, D), D), ((1000, D), D), ((2, 256, D), 768))


def _geglu_ff_inputs(shape, out_dim: int, gen: torch.Generator, dtype=torch.bfloat16):
    def rnd(*sh, std=1.0):
        return (torch.randn(sh, generator=gen, device="cuda") * std).to(dtype)

    return (rnd(*shape), rnd(2 * INNER, D, std=D ** -0.5), rnd(2 * INNER, std=0.5),
            rnd(out_dim, INNER, std=INNER ** -0.5), rnd(out_dim, std=0.5))


def _geglu_ff_library(x, w1, b1, w2, b2):
    """Yardstick only: 2 x F.linear + F.gelu in bf16."""
    a, g = F.linear(x, w1, b1).chunk(2, dim=-1)
    return F.linear(a * F.gelu(g), w2, b2)


def _geglu_ff_bound(rows: int, out_dim: int, dtype=torch.bfloat16):
    esz, peak = _esz_peak(dtype)
    flops = rows * (2 * D * 2 * INNER + 2 * INNER * out_dim)
    n_bytes = esz * (rows * (D + out_dim) + 2 * INNER * D + INNER * out_dim + 2 * INNER + out_dim)
    return bound(n_bytes, flops, peak)


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


def _bf16_kernel_entries(gen: torch.Generator, wsets: list) -> list:
    """fused_self_attention_block and geglu_ff: bf16 outputs over 512- to
    2048-term sums in another order than the plain version, so the bar is
    geglu's 2e-2 * max|out|."""
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk

    zero = torch.zeros_like
    wsets_attn = _attn_weight_sets(gen, "bf16")
    rows = {}
    cases = [(b, n, adaln, False) for b, n in ATTN_SHAPES for adaln in (True, False)]
    for bsz, n, adaln, per_batch in cases + [(b, n, True, True) for b, n in ATTN_FRAME_SHAPES]:
        args = _attn_inputs(bsz, n, adaln, gen, per_batch)
        kw = {"scale_shift_mod": adaln}
        mode = ("adaln" if adaln else "affine") + (", per-frame rows" if per_batch else "")
        drops = {"bo": (7, zero), "scale": (1, zero), "mode": {"scale_shift_mod": not adaln}}
        if per_batch:
            drops["row0"] = ((1, _row0), (2, _row0))
        line = {"shape": [bsz, n, D], "mode": mode, **_parity(
            f"fused_self_attention_block ({bsz},{n},{D}) {mode}", ak.fused_self_attention_block,
            ak.fused_self_attention_block_plain, args, INT8_BAR, drops, kw)}
        if n == 512 and adaln and not per_batch:
            _timed(line, ak.fused_self_attention_block, ak.fused_self_attention_block_plain,
                   _attn_library, args, kw, 200 if bsz == 1 else 50, _attn_bound(bsz, n))
            _cold_lines(line, ak.fused_self_attention_block, _attn_library, args, bsz, wsets_attn)
            rows[bsz] = line
        rows.setdefault((bsz, n, mode), line)
        print("[kernels] fused_self_attention_block " + json.dumps(line))
    attn = _cold_keys(_entry("fused_self_attention_block", "rald_torch/csrc/attn.cu",
                             "rald_tpu/ops/attn_kernel.py:121", rows, 1, 8), rows)
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
            x, cold = args[0], (4 if tokens == 512 else 2) * COLD_SETS
            line["ms_cold"] = _cold_ms(lambda *w: gk.geglu_ff(x, *w), wsets, cold)
            line["library_ms_cold"] = _cold_ms(lambda *w: _geglu_ff_library(x, *w), wsets, cold)
            rows[shape[0]] = line
        rows.setdefault((shape, out_dim), line)
        print("[kernels] geglu_ff " + json.dumps(line))
    ff = _cold_keys(_entry("geglu_ff", "rald_torch/csrc/geglu.cu",
                           "rald_tpu/ops/geglu_kernel.py:522", rows, 1, 8), rows)
    ff["max_abs_err"] = max(r["max_abs_err"] for r in rows.values())
    return [attn, ff]


# fused_ln_geglu_residual: (batch, tokens, AdaLN?, one modulation row per
# frame?): the main path's batches 1 and 8 in both mod modes, the ragged
# (3, 300) and (2, 77), and distinct per-frame AdaLN rows as the DiT passes
# them, at batch 8 and at (3, 300), where 128-row tiles straddle frames
GEGLU_SHAPES = ((1, 512, True, False), (1, 512, False, False), (8, 512, True, False),
                (8, 512, False, False), (3, 300, True, False), (2, 77, False, False),
                (8, 512, True, True), (3, 300, True, True))


def _geglu_ln_entry(gen: torch.Generator, wsets: list) -> dict:
    """fused_ln_geglu_residual against its plain version. bf16 keeps ~3
    significant digits, and the kernel and its plain version sum the 512-
    and 2048-term products in different orders, so they agree to a fraction
    of max|out| (2e-2), not bitwise. The bar must catch a kernel that drops
    a bias or applies frame 0's modulation row to every frame."""
    from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual, fused_ln_geglu_residual_plain

    zero = torch.zeros_like
    rows = {}
    for bsz, n, adaln, per_batch in GEGLU_SHAPES:
        args = _geglu_inputs(bsz, n, adaln, gen, per_batch)
        kw = {"scale_shift_mod": adaln}
        drops = {"b1": (4, zero), "b2": (6, zero)}
        if per_batch:
            drops["row0"] = ((1, _row0), (2, _row0))
        mode = ("adaln" if adaln else "affine") + (", per-frame rows" if per_batch else "")
        line = {"shape": [bsz, n, D], "mode": mode, **_parity(
            f"fused_ln_geglu_residual ({bsz},{n},{D}) {mode}", fused_ln_geglu_residual,
            fused_ln_geglu_residual_plain, args, INT8_BAR, drops, kw)}
        if n == 512 and adaln and not per_batch:
            _timed(line, fused_ln_geglu_residual, fused_ln_geglu_residual_plain,
                   lambda *a, scale_shift_mod: _geglu_library(*a, scale_shift_mod), args, kw,
                   200 if bsz == 1 else 50, _geglu_bound(bsz, n))
            x, s, b = args[:3]
            cold = (4 if bsz == 1 else 2) * COLD_SETS
            line["ms_cold"] = _cold_ms(lambda *w: fused_ln_geglu_residual(x, s, b, *w, **kw),
                                       wsets, cold)
            line["library_ms_cold"] = _cold_ms(lambda *w: _geglu_library(x, s, b, *w, adaln),
                                               wsets, cold)
            rows[bsz] = line
        rows.setdefault((bsz, n, mode), line)
        print("[kernels] fused_ln_geglu_residual " + json.dumps(line))
    return _cold_keys(_entry("fused_ln_geglu_residual", "rald_torch/csrc/geglu.cu",
                             "rald_tpu/ops/geglu_kernel.py:183", rows, 1, 8), rows)


def _nn_inputs(bsz: int, gen: torch.Generator):
    """(bsz, NN_N, 3) predictions and (bsz, NN_M, 3) surface points, each
    frame offset from the others and with its own BIG-padded tail, as
    batched_cd_fscore_graph pads a ragged batch."""
    from rald_torch.ops.nn_dist_kernel import BIG

    a = torch.rand((bsz, NN_N, 3), generator=gen, device="cuda") * 16.0
    b = torch.rand((bsz, NN_M, 3), generator=gen, device="cuda") * 16.0
    for i in range(bsz):
        a[i] += i  # frames apart: a kernel reading another frame's rows disagrees
        b[i] += i
        a[i, NN_N - 1000 * (i + 1):] = BIG
        b[i, NN_M - 100 * (i + 1):] = BIG
    return a, b


# the host APIs' shapes (one frame, each cloud padded with BIG rows to a power
# of two): (padded, real) a rows and (padded, real) b rows. The reverse pass
# of chamfer_and_fscore at product size (1e4 GT points against 5e5
# predictions), and a small eval prediction (3e4 points) against the GT.
NN_HOST = ((16384, 10_000, 524288, 500_000), (32768, 30_000, 16384, 10_000))


def _nn_host_inputs(n, n_real, m, m_real, gen: torch.Generator):
    from rald_torch.ops.nn_dist_kernel import BIG

    a = torch.rand((1, n, 3), generator=gen, device="cuda") * 16.0
    b = torch.rand((1, m, 3), generator=gen, device="cuda") * 16.0
    a[0, n_real:] = BIG
    b[0, m_real:] = BIG
    return a, b


def _nn_split(fn):
    """The slice count S of ``fn``'s last launch; None on a tree from before
    the split (one block per a tile)."""
    return getattr(fn, "split", None)


def _nn_entries(gen: torch.Generator):
    """nn_min_sq_both and nn_min_sq_batch: exact f32 subtract-square on both
    sides -> bitwise equal to the plain versions, the batch rows bitwise the
    two-way rows and the swapped call the transposed outputs; at batch 1 and
    8 of the main path and at the two host shapes (NN_HOST, ``host`` lists
    of the entries), timed beside the plain version and the bound."""
    from rald_torch.ops.nn_dist_kernel import (
        nn_min_sq_batch,
        nn_min_sq_batch_plain,
        nn_min_sq_both,
        nn_min_sq_both_plain,
    )

    cases = [(bsz, *_nn_inputs(bsz, gen)) for bsz in (1, 8)]
    cases += [(sh, *_nn_host_inputs(*sh, gen)) for sh in NN_HOST]
    both, batch = {}, {}
    for key, a, b in cases:
        bsz, n, m = a.shape[0], a.shape[1], b.shape[1]
        iters = 20 if key == 1 else 5
        tag = f"B={bsz} ({bsz}, {n}) x ({bsz}, {m})"
        row, col = nn_min_sq_both(a, b)
        split = _nn_split(nn_min_sq_both)
        row_p, col_p = nn_min_sq_both_plain(a, b)
        col_sw, row_sw = nn_min_sq_both(b.contiguous(), a.contiguous())  # one-direction check
        torch.cuda.synchronize()
        check(torch.equal(row, row_p) and torch.equal(col, col_p),
              f"nn_min_sq_both {tag} is not bitwise equal to its plain version")
        check(torch.equal(row, row_sw) and torch.equal(col, col_sw),
              f"nn_min_sq_both {tag} is not bitwise equal to the swapped-operand pass")
        line = {
            "shape": [bsz, n, m], "bitwise_equal": True, "split": split,
            "max_abs_err": (row - row_p).abs().max().item(),
            "ms": cuda_ms(lambda: nn_min_sq_both(a, b), iters),
            "plain_ms": cuda_ms(lambda: nn_min_sq_both_plain(a, b), 2, warmup=1),
            "library_ms": (cuda_ms(lambda: _nn_library(a, b), 2, warmup=1)
                           if key == 1 else None),
        }
        line["bound_ms"], line["bound_by"] = bound(
            4 * bsz * (3 * (n + m) + n + m), 8 * bsz * n * m, PEAK_F32)
        print("[kernels] nn_min_sq_both " + json.dumps(line))
        both[key] = line
        # nn_min_sq_batch: the row pass alone, bitwise its plain version and
        # the two-way kernel's row output
        rb = nn_min_sq_batch(a, b)
        split = _nn_split(nn_min_sq_batch)
        rb_p = nn_min_sq_batch_plain(a, b)
        torch.cuda.synchronize()
        check(torch.equal(rb, rb_p), f"nn_min_sq_batch {tag} is not bitwise equal to its plain version")
        check(torch.equal(rb, row), f"nn_min_sq_batch {tag} differs from nn_min_sq_both's rows")
        line = {
            "shape": [bsz, n, m], "bitwise_equal": True, "split": split,
            "max_abs_err": (rb - rb_p).abs().max().item(),
            "ms": cuda_ms(lambda: nn_min_sq_batch(a, b), iters),
            "plain_ms": cuda_ms(lambda: nn_min_sq_batch_plain(a, b), 2, warmup=1),
            # the cdist composite takes ~6 s a frame at the main shape and
            # would hold a (16384, 524288) matrix at the reverse pass
            "library_ms": (cuda_ms(lambda: _nn_library(a, b, both=False), 2, warmup=1)
                           if key == 1 else None),
        }
        line["bound_ms"], line["bound_by"] = bound(
            4 * bsz * (3 * (n + m) + n), 8 * bsz * n * m, PEAK_F32)
        print("[kernels] nn_min_sq_batch " + json.dumps(line))
        batch[key] = line
        del row, col, row_p, col_p, col_sw, row_sw, rb, rb_p

    def entry(name, rows, replaces):
        e = _entry(name, "rald_torch/csrc/nn_dist.cu", replaces, {1: rows[1], 8: rows[8]}, 1, 8)
        e.update(split=rows[1]["split"], split_b8=rows[8]["split"],
                 max_abs_err=max(r["max_abs_err"] for r in rows.values()),
                 host=[{k: rows[sh][k] for k in ("shape", "split", "ms", "plain_ms", "bound_ms",
                                                  "bound_by")}
                       for sh in NN_HOST])
        return e

    return (entry("nn_min_sq_both", both, "rald_tpu/ops/nn_dist_kernel.py:112"),
            entry("nn_min_sq_batch", batch, "rald_tpu/ops/nn_dist_kernel.py:168"))


# float32 activations (JAX's compute_dtype float32 with matmul_precision
# "highest"): each kernel's f32 instantiation against its plain version in
# f32 on the card. Rows 1, 6 and 7 compute exact f32 products on the CUDA
# cores, so only the order of their f32 sums (and the A&S erf's 1.5e-7 and
# expf's last bits) separates them from the plain versions: 1e-4 of
# max|out|. The int8 rows keep their codes, but an LN or softmax sum taken in
# another order can move a code across a .5 tie, and a flipped h code that
# moves a row's max|g| re-scales that row's g codes: up to about one int8
# step (1/127) of max|out|, so 1e-2 (measured on an H100: at most 3.5e-3).
# Every drop check must clear the bar.
F32_BAR, F32_INT8_BAR = 1e-4, 1e-2
F32 = torch.float32


def _f32_kernel_entries(gen: torch.Generator) -> dict:
    """The f32 cases of rows 1 and 4-9, timed against the f32 bound at
    batch 1 and 8; returns each kernel's f32 entries by name."""
    from rald_torch import apply_matmul_precision
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk

    apply_matmul_precision("highest")
    zero, one = torch.zeros_like, torch.ones_like
    frames = [(b, n, True, True) for b, n in ATTN_FRAME_SHAPES]
    int8_shapes = [(b, n, True, False) for b, n in INT8_SHAPES]
    std = lambda a: {"scale_shift_mod": a}

    def geglu_ff_make(shape_out):
        shape, out_dim = shape_out
        return _geglu_ff_inputs(shape, out_dim, gen, F32), {}

    specs = [  # name, kernel, plain, make, library, drops, bound, bar, cases
        ("fused_ln_geglu_residual", gk.fused_ln_geglu_residual, gk.fused_ln_geglu_residual_plain,
         lambda b, n, a, per: (_geglu_inputs(b, n, a, gen, per, F32), std(a)),
         lambda *x, scale_shift_mod: _geglu_library(*x, scale_shift_mod),
         {"b1": (4, zero), "b2": (6, zero)}, lambda b, n: _geglu_bound(b, n, F32), F32_BAR,
         [(1, 512, True, False), (8, 512, True, False), (1, 512, False, False),
          (3, 300, True, False), (2, 77, False, False)] + frames),
        ("fused_ln_geglu_residual_int8", gk.fused_ln_geglu_residual_int8,
         gk.fused_ln_geglu_residual_int8_plain,
         lambda b, n, a, per: (_int8_ff_inputs(b, n, gen, per, F32), {}), _int8_ff_library,
         {"b1": (5, zero), "b2": (8, zero), "s1": (4, one), "s2": (7, one)},
         lambda b, n: _int8_bound("fused_ln_geglu_residual_int8", b, n, F32), F32_INT8_BAR,
         int8_shapes),
        ("fused_ln_geglu_residual_int8_static", gk.fused_ln_geglu_residual_int8_static,
         gk.fused_ln_geglu_residual_int8_static_plain,
         lambda b, n, a, per: (_int8_static_inputs(_int8_ff_inputs(b, n, gen, per, F32)), {}),
         _int8_ff_library,
         {"b1": (5, zero), "b2": (8, zero), "d1": (4, one), "d2": (7, one), "inv_h": (9, one),
          "inv_g": (10, one)},
         lambda b, n: _int8_bound("fused_ln_geglu_residual_int8", b, n, F32), F32_INT8_BAR,
         int8_shapes),
        ("geglu_ff", gk.geglu_ff, gk.geglu_ff_plain, geglu_ff_make, _geglu_ff_library,
         {"b1": (2, zero), "b2": (4, zero)},
         lambda shape, out_dim: _geglu_ff_bound(math.prod(shape[:-1]), out_dim, F32), F32_BAR,
         list(GEGLU_FF_SHAPES)),
        ("fused_self_attention_block", ak.fused_self_attention_block,
         ak.fused_self_attention_block_plain,
         lambda b, n, a, per: (_attn_inputs(b, n, a, gen, per, F32), std(a)), _attn_library,
         {"bo": (7, zero), "scale": (1, zero)}, lambda b, n: _attn_bound(b, n, F32), F32_BAR,
         [(b, n, a, False) for b, n in ATTN_SHAPES for a in (True, False)] + frames),
        ("fused_self_attention_block_int8", ak.fused_self_attention_block_int8,
         ak.fused_self_attention_block_int8_plain,
         lambda b, n, a, per: (_int8_attn_inputs(b, n, False, gen, per, F32), {}),
         lambda *x: _int8_attn_library(*x, vout=False),
         {"bo": (11, zero), "so": (10, one), "sv": (8, one), "sq": (4, one)},
         lambda b, n: _int8_bound("fused_self_attention_block_int8", b, n, F32), F32_INT8_BAR,
         int8_shapes + frames),
        ("fused_self_attention_block_int8_vout", ak.fused_self_attention_block_int8_vout,
         ak.fused_self_attention_block_int8_vout_plain,
         lambda b, n, a, per: (_int8_attn_inputs(b, n, True, gen, per, F32), {}),
         lambda *x: _int8_attn_library(*x, vout=True),
         {"bo": (9, zero), "so": (8, one), "sv": (6, one)},
         lambda b, n: _int8_bound("fused_self_attention_block_int8_vout", b, n, F32), F32_INT8_BAR,
         int8_shapes + frames),
    ]
    out = {}
    for name, fn, plain, make, library, drops, bnd, bar, cases in specs:
        rows = {}
        for case in cases:
            if name == "geglu_ff":
                (shape, out_dim), per = case, False
                args, kw = make(case)
                timed = shape[0] if len(shape) == 3 and out_dim == D else None
                label, key = f"{shape} -> {out_dim}", (shape, out_dim)
                bound_case, line_shape = (shape, out_dim), list(shape)
            else:
                bsz, n, adaln, per = case
                args, kw = make(bsz, n, adaln, per)
                timed = bsz if n == 512 and adaln and not per else None
                label = f"({bsz},{n},{D})" + ("" if adaln else " affine") + (
                    " per-frame rows" if per else "")
                key, bound_case, line_shape = case, (bsz, n), [bsz, n, D]
            case_drops = dict(drops)
            if name == "fused_self_attention_block":  # the other mod mode, as in bf16
                case_drops["mode"] = {"scale_shift_mod": not kw["scale_shift_mod"]}
            if per:
                case_drops["row0"] = ((1, _row0), (2, _row0))
            line = {"shape": line_shape, "case": label, "dtype": "float32", "bar_rel": bar,
                    **_parity(f"{name} f32 {label}", fn, plain, args, bar, case_drops, kw)}
            if timed is not None:
                _timed(line, fn, plain, library, args, kw, 20 if timed == 1 else 10,
                       bnd(*bound_case))
                rows[timed] = line
            rows.setdefault(key, line)
            print(f"[kernels] {name} " + json.dumps(line))
        e = _entry(name, "", "", rows, 1, 8)
        out[name] = {k: e[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "ms_b8", "plain_ms_b8", "bound_ms_b8")}
        out[name].update(bar_rel=bar, bound_by_b8=rows[8]["bound_by"])
    return out


def phase_kernels() -> list:
    gen = torch.Generator("cuda").manual_seed(0)
    wsets = _ff_weight_sets(gen)
    entries = [_geglu_ln_entry(gen, wsets)]

    nn_both, nn_batch = _nn_entries(gen)

    entries += _int8_kernel_entries(gen)
    entries += _bf16_kernel_entries(gen, wsets)
    entries.append(nn_batch)
    f32 = _f32_kernel_entries(gen)
    entries.insert(1, nn_both)
    for e in entries:
        e["max_err"] = e["max_abs_err"]
        # the nearest-neighbour kernels take f32 points only: their entries
        # above are f32
        e["f32"] = f32.get(e["name"], "f32 only: the entries above")
    return entries


def nn_library_b8() -> dict:
    """One-off, outside the default run (about 50 s a call): the chunked
    ``torch.cdist`` yardsticks of nn_min_sq_both and nn_min_sq_batch at
    batch 8, one timed call each, on inputs drawn as phase 3 draws them.

        python3 -c "import chip_smoke as c; c.nn_library_b8()"
    """
    check(torch.cuda.is_available(), "nn_library_b8 needs a CUDA device")
    a, b = _nn_inputs(8, torch.Generator("cuda").manual_seed(0))
    line = {"shape": [8, NN_N, NN_M], "device": torch.cuda.get_device_name(0),
            "nvidia_smi": smi_line(),
            "library_ms_b8": {
                "nn_min_sq_both": cuda_ms(lambda: _nn_library(a, b), 1, warmup=0),
                "nn_min_sq_batch": cuda_ms(lambda: _nn_library(a, b, both=False), 1, warmup=0)}}
    print("[nn_library_b8] " + json.dumps(line))
    return line


def _sass_counts(lib: Path) -> dict:
    from collections import Counter

    from rald_torch.ops import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=120).stdout
    counts, cur = {}, None
    for text in sass.splitlines():
        if "Function :" in text:
            cur = text.split("Function :", 1)[1].strip()
            counts[cur] = Counter()
        elif cur and text.strip().startswith("/*") and "*/" in text:
            toks = [t for t in text.split("*/", 1)[1].split() if not t.startswith("@")]
            if toks and toks[0][0].isalpha():
                counts[cur][toks[0].split(".")[0]] += 1
    return {("both" if "ILb1E" in fn else "batch"): {"all": sum(c.values()), **dict(c.most_common())}
            for fn, c in counts.items() if "nn_min_kernel" in fn}


def nn_sass() -> dict:
    """Opcode counts of each nearest-neighbour kernel in the built library's
    SASS (``cuobjdump -sass``), most frequent first, and all instructions:
    the distances are FADD (FSUB included) and FMUL, the minima VIMNMX3
    (DPX, one for two new distances) and VIMNMX, the point loads LDS, the
    warp minima REDUX.

        python3 -c "import chip_smoke as c; c.nn_sass()"
    """
    from rald_torch.ops import _build

    _build.load("nn_dist")
    line = {"nn_dist": _sass_counts(_build._target("nn_dist")), "nvidia_smi": smi_line()}
    print("[nn_sass] " + json.dumps(line))
    return line


def nn_breakdown() -> list:
    """One-off, outside the default run: nn_min_sq_both and nn_min_sq_batch
    at batch 1 and 8 of the main path and at the two host shapes
    (``NN_HOST``), split into host and device time (``_breakdown``: device
    time by CUDA graph replay, each launch by ``torch.profiler``), with the
    slice count S each launch took (null on a tree from before the split)
    and the SM clock under load. Runs on a parent tree too (copy this file
    into it).

        python3 -c "import chip_smoke as c; c.nn_breakdown()"
    """
    from rald_torch.ops import nn_dist_kernel as tn

    check(torch.cuda.is_available(), "nn_breakdown needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    lines = []
    for key in (1, 8, *NN_HOST):
        a, b = _nn_inputs(key, gen) if key in (1, 8) else _nn_host_inputs(*key, gen)
        calls = {"nn_min_sq_both": lambda: tn.nn_min_sq_both(a, b),
                 "nn_min_sq_batch": lambda: tn.nn_min_sq_batch(a, b)}
        extra = {}
        for name, fn in calls.items():
            fn()
            extra[name] = {"split": _nn_split(getattr(tn, name))}
        shape_lines = _breakdown("nn_breakdown", calls, [a.shape[0], a.shape[1], b.shape[1]],
                                 reps=10, graph_calls=5, extra=extra)
        for line in shape_lines:
            clock = {"name": line["name"], "shape": line["shape"],
                     **_clock_under_load(calls[line["name"]], line["device_ms"])}
            print("[nn_clock] " + json.dumps(clock))
        lines += shape_lines
        del a, b
    return lines


def _clock_under_load(fn, device_ms: float) -> dict:
    """nvidia-smi's SM clock (MHz) and power draw (W) sampled while ``fn``
    runs back to back (about 1.5 s of work enqueued first); null where the
    work had ended before the sample."""
    for _ in range(max(1, min(2000, math.ceil(1500 / device_ms)))):
        fn()
    done = torch.cuda.Event()
    done.record()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                          "--format=csv,noheader,nounits"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    busy = not done.query()
    torch.cuda.synchronize()
    clock, power = (float(v) for v in out.split(","))
    return {"sm_clock_mhz": clock if busy else None, "power_w": power if busy else None}


def _breakdown(tag: str, calls: dict, shape: list, reps: int = 200, graph_calls: int = 20,
               extra: dict = None) -> list:
    """Host and device time of each call: ``host_ms``, host time per call
    with no synchronisation in the loop (``reps`` calls); ``events_ms``, CUDA
    events around ``reps`` back-to-back calls (phase 3's ``ms``);
    ``device_ms``, a CUDA graph of ``graph_calls`` calls replayed, so no host
    work between launches; ``launches_ms``, each kernel's device time per
    call from ``torch.profiler`` over 20 calls. ``extra`` adds keys to a
    call's line, by name."""
    from torch.profiler import ProfilerActivity, profile

    lines = []
    for name, fn in calls.items():
        line = {"name": name, "shape": shape, **(extra or {}).get(name, {}),
                "events_ms": cuda_ms(fn, reps)}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        line["host_ms"] = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
            torch.cuda.synchronize()
            with torch.cuda.graph(graph, stream=stream):
                for _ in range(graph_calls):
                    fn()
        torch.cuda.synchronize()
        line["device_ms"] = cuda_ms(graph.replay, 20 if graph_calls >= 20 else 5) / graph_calls
        del graph
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                key = e.name[:70]  # template arguments included, call arguments cut
                per[key] = per.get(key, 0.0) + (e.time_range.end - e.time_range.start) / 20e3
        line["launches_ms"] = per
        line["nvidia_smi"] = smi_line()
        print(f"[{tag}] " + json.dumps(line))
        lines.append(line)
    return lines


def ff_breakdown(batches=(1, 8)) -> list:
    """One-off, outside the default run: the two bf16 FF calls, the two
    int8 FF calls (dynamic and static scales) and their library composites
    split into host and device time (``_breakdown``: per call, and each
    launch -- LN / quantization, GEMM1, row quantization, GEMM2 -- by
    ``torch.profiler``), at the main path's batches with one AdaLN row per
    frame.

        python3 -c "import chip_smoke as c; c.ff_breakdown()"
    """
    from rald_torch.ops import geglu_kernel as gk

    check(torch.cuda.is_available(), "ff_breakdown needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    lines = []
    for bsz in batches:
        x, s, b, w1, b1, w2, b2 = _geglu_inputs(bsz, 512, True, gen, per_batch=True)
        calls = {
            "fused_ln_geglu_residual": lambda: gk.fused_ln_geglu_residual(x, s, b, w1, b1, w2, b2),
            "geglu_ff": lambda: gk.geglu_ff(x, w1, b1, w2, b2),
            "library (fused_ln_geglu_residual)": lambda: _geglu_library(x, s, b, w1, b1, w2, b2,
                                                                        True),
        }
        q8 = _int8_ff_inputs(bsz, 512, gen, per_batch=True)
        st = _int8_static_inputs(q8)
        calls.update({
            "fused_ln_geglu_residual_int8": lambda: gk.fused_ln_geglu_residual_int8(*q8),
            "fused_ln_geglu_residual_int8_static":
                lambda: gk.fused_ln_geglu_residual_int8_static(*st),
            "library (fused_ln_geglu_residual_int8)": lambda: _int8_ff_library(*q8),
        })
        lines += _breakdown("ff_breakdown", calls, [bsz, 512, D])
    return lines


INT8_FF_CASES = ((1, 512, False), (8, 512, False), (3, 300, False), (8, 512, True),
                 (3, 300, True))


def int8_ff_dump(path: str, compare: str = None) -> dict:
    """One-off, outside the default run: the bf16 outputs of the two int8
    FF kernels on seeded inputs (phase 3's shapes, shared and per-frame
    AdaLN rows) saved to ``path``; with ``compare``, the file another tree
    wrote on the same card (the parent commit unpacked into
    ``build/parent``), each case bitwise equal or its max |difference|. The
    int8 sums are exact and the rounding points the same, so a redesign
    that keeps them matches its parent bit for bit.

        python3 -c "import chip_smoke as c; c.int8_ff_dump('out.pt', 'build/parent/out.pt')"
    """
    from rald_torch.ops import geglu_kernel as gk

    check(torch.cuda.is_available(), "int8_ff_dump needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    outs = {}
    for bsz, n, per in INT8_FF_CASES:
        dyn = _int8_ff_inputs(bsz, n, gen, per)
        key = f"({bsz},{n},{D})" + (" per-frame rows" if per else "")
        outs["int8 " + key] = gk.fused_ln_geglu_residual_int8(*dyn).cpu()
        outs["static " + key] = gk.fused_ln_geglu_residual_int8_static(
            *_int8_static_inputs(dyn)).cpu()
    torch.save(outs, path)
    line = {"path": path, "nvidia_smi": smi_line()}
    if compare:
        ref = torch.load(compare)
        line["vs"] = compare
        line["cases"] = {k: {"bitwise_equal": torch.equal(v, ref[k]),
                             "max_abs_diff": (v.float() - ref[k].float()).abs().max().item()}
                         for k, v in outs.items()}
    print("[int8_ff_dump] " + json.dumps(line))
    return line


def attn_breakdown(batches=(1, 8)) -> list:
    """One-off, outside the default run: the three self-attention kernels
    and the bf16 and int8 "vout" library composites split into host and
    device time (``_breakdown``: per call, and each launch -- LN, every
    GEMM, core, row quantization -- by ``torch.profiler``), at the main
    path's batches with one AdaLN row per frame.

        python3 -c "import chip_smoke as c; c.attn_breakdown()"
    """
    from rald_torch.ops import attn_kernel as ak

    check(torch.cuda.is_available(), "attn_breakdown needs a CUDA device")
    gen = torch.Generator("cuda").manual_seed(0)
    lines = []
    for bsz in batches:
        bf = _attn_inputs(bsz, 512, True, gen, per_batch=True)
        full = _int8_attn_inputs(bsz, 512, False, gen, per_batch=True)
        vout = _int8_attn_inputs(bsz, 512, True, gen, per_batch=True)
        calls = {
            "fused_self_attention_block": lambda: ak.fused_self_attention_block(*bf),
            "fused_self_attention_block_int8": lambda: ak.fused_self_attention_block_int8(*full),
            "fused_self_attention_block_int8_vout":
                lambda: ak.fused_self_attention_block_int8_vout(*vout),
            "library (fused_self_attention_block)": lambda: _attn_library(*bf),
            "library (fused_self_attention_block_int8_vout)":
                lambda: _int8_attn_library(*vout, vout=True),
        }
        lines += _breakdown("attn_breakdown", calls, [bsz, 512, D])
    return lines


def trace_sample(batches=(1, 8), fused_attn: bool = False, int8_ff=False, int8_attn=False) -> list:
    """One-off, outside the default run: where the product sampler's time
    goes, as shipped or in one of the kernel modes (``use_fused_attn``, or
    ``eval.inference.int8_ff`` / ``int8_attn``). For each batch,
    ``sample_tokens`` (cube -> 35-NFE tokens) once untraced (wall ms) and
    once under ``torch.profiler``: the device's busy time (the union of its
    kernels' intervals), its idle share of the untraced wall time, the
    kernel launches, and the kernels by device time.

        python3 -c "import chip_smoke as c; c.trace_sample(int8_ff=True, int8_attn='vout')"
    """
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rald_torch.train.gen_engine import GenerationEngine

    check(torch.cuda.is_available(), "trace_sample needs a CUDA device")
    cfg = _product_cfg(int8_ff, int8_attn, fused_attn=fused_attn)
    mode = ("use_fused_attn" if fused_attn else
            f"int8_ff={int8_ff},int8_attn={int8_attn}" if int8_ff or int8_attn else "bf16")
    rng = np.random.default_rng(cfg.system.seed)
    eng = GenerationEngine(cfg)
    lines = []
    for bsz in batches:
        cube = _inputs(cfg, bsz, rng)["radar_cube"]
        seeds = list(range(bsz))
        eng.sample_tokens(cube, seeds)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.sample_tokens(cube, seeds)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.sample_tokens(cube, seeds)
            torch.cuda.synchronize()
            traced = (time.perf_counter() - t0) * 1e3
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        busy, end = 0.0, -math.inf
        for a, b in spans:  # union of the kernel intervals, microseconds
            if b > end:
                busy += b - max(a, end)
                end = b
        by_name = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
        line = {"mode": mode, "batch": bsz,
                "wall_ms": wall, "traced_wall_ms": traced, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / 1e3 / wall, "kernels": len(spans),
                "top_kernels_ms": {k[:80]: v / 1e3 for k, v in top},
                "nvidia_smi": smi_line()}
        print("[trace_sample] " + json.dumps(line))
        lines.append(line)
    return lines


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


def _product_cfg(int8_ff=False, int8_attn=False, act_scales=None, fused_attn=False, fast=True,
                 f32=False, depth=None):
    """The product YAML in one of its modes; ``f32``: JAX's strict-parity
    setting, ``compute_dtype: float32`` with ``matmul_precision: highest``;
    ``depth``: both models cut to that many blocks (width unchanged)."""
    from rald_torch.config import load_config

    cfg = load_config(PRODUCT_CFG)
    if f32:
        cfg.system.compute_dtype = "float32"
        cfg.system.matmul_precision = "highest"
    cfg.eval.inference.int8_ff = int8_ff
    cfg.eval.inference.int8_attn = int8_attn
    if act_scales is not None:
        cfg.eval.inference.int8_act_scales = str(act_scales)
    if fused_attn:
        cfg.ar_model.overrides = {"use_fused_attn": True}
    if depth is not None:
        cfg.ar_model.overrides = {**cfg.ar_model.get("overrides", {}), "depth": depth}
        cfg.lidar_ae.overrides = {**cfg.lidar_ae.get("overrides", {}), "depth": depth}
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
    is exact. Where the YAML sets ``matmul_precision: highest``, both torch
    precision switches are set away from it before the run and must read it
    after (the CLI applies the YAML's value)."""
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
    precision_check = cfg.system.get("matmul_precision") == "highest"
    if precision_check:
        torch.set_float32_matmul_precision("high")
        torch.backends.cudnn.allow_tf32 = True
    reset_launch_counts()
    stats = infer.run(cfg, str(src), str(out), batch=bsz, threshold=thr, engine=eng,
                      print_fn=lambda *_: None)
    counts = launch_counts()
    switches = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    if precision_check:
        check(switches == ("highest", False),
              f"cli {label}: matmul_precision highest not applied, switches {switches}")
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
            "frames_per_s": stats["frames_per_sec"], "launches": counts,
            "float32_matmul_precision": switches[0], "cudnn_allow_tf32": switches[1]}
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


def _geglu_ff_module_run(eng, label="GEGLUFeedForward(use_fused=True)", bar=INT8_BAR) -> dict:
    """``GEGLUFeedForward(use_fused=True)``: the module that reaches
    geglu_ff (no inference chain of the JAX package does), at full width
    with the DiT's block-0 FF weights, in the engine's dtype, against the
    unfused module."""
    from rald_torch.ops import launch_counts, reset_launch_counts

    ff = eng.model.model.transformer_blocks[0].ff
    x = torch.randn((8, 512, D), generator=torch.Generator("cuda").manual_seed(5),
                    device="cuda").to(eng.dtype)
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
    check(err <= bar * ref, f"{label}: err {err:.3e} vs {ref:.3e}")
    _check_counts(counts, {name: int(name == "geglu_ff") for name in KERNEL_NAMES}, label)
    line = {"mode": label, "shape": [8, 512, D], "max_abs_err_vs_unfused": err,
            "launches": counts}
    print("[main] " + json.dumps(line))
    return line


def phase_main() -> dict:
    """Returns the runs by (mode, batch), the f32 runs included."""
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
    runs.update(phase_main_f32(inputs, cli_src))
    return runs


# DiT and VAE blocks of the f32 runs of phase 4: full width, depth cut from
# 24 so that the four f32 engines keep the script near its time budget
F32_DEPTH = 6


def phase_main_f32(inputs: dict, cli_src: Path) -> dict:
    """The chain in float32 at batch 1, full width, F32_DEPTH blocks:
    ``compute_dtype: float32`` with ``matmul_precision: highest`` applied
    through ``apply_matmul_precision`` (JAX's strict-parity configuration),
    as shipped (rows 1 and 2, plus the CLI on that YAML and
    ``GEGLUFeedForward(use_fused=True)``), with ``use_fused_attn`` (row 7),
    in int8 dynamic + vout (rows 4, 9) and int8 static + full (rows 5, 8,
    scales calibrated on the f32 engine). Returns the runs by (mode, batch)."""
    from rald_torch import apply_matmul_precision

    apply_matmul_precision("highest")
    runs = {}
    cfg = _product_cfg(f32=True, depth=F32_DEPTH)
    eng = _build(cfg, "f32", [inputs[1]])
    check(eng.dtype == torch.float32, f"f32 engine runs in {eng.dtype}")
    runs[("f32", 1)] = _main_run(eng, inputs[1], 1, "f32", _want_launches(eng))
    runs[("cli f32", 8)] = _cli_run(eng, cfg, "f32", cli_src)
    runs[("f32 GEGLUFeedForward(use_fused=True)", 1)] = _geglu_ff_module_run(
        eng, "f32 GEGLUFeedForward(use_fused=True)", F32_BAR)
    del eng
    torch.cuda.empty_cache()

    eng = _build(_product_cfg(fused_attn=True, f32=True, depth=F32_DEPTH), "f32 use_fused_attn", [inputs[1]])
    runs[("f32 use_fused_attn", 1)] = _main_run(eng, inputs[1], 1, "f32 use_fused_attn",
                                                _want_launches(eng))
    del eng
    torch.cuda.empty_cache()

    label = "f32 int8_ff=True,int8_attn=vout"
    eng = _build(_product_cfg(True, "vout", f32=True, depth=F32_DEPTH), label, [inputs[1]])
    runs[(label, 1)] = _main_run(eng, inputs[1], 1, label, _want_launches(eng))
    ah, ag = eng.calibrate_act_scales(
        [{"radar_cube": inputs[1]["radar_cube"], "seeds_or_prior": inputs[1]["seeds_or_prior"]}],
        num_batches=1, margin=1.1, print_fn=lambda *_: None)
    scales = SCRATCH / "int8_act_scales_f32.npz"
    np.savez(scales, ah=ah, ag=ag, num_steps=eng.sampler_kwargs["num_steps"])
    del eng
    torch.cuda.empty_cache()

    label = "f32 int8_ff=static,int8_attn=full"
    eng = _build(_product_cfg("static", "full", scales, f32=True, depth=F32_DEPTH), label, [inputs[1]])
    runs[(label, 1)] = _main_run(eng, inputs[1], 1, label, _want_launches(eng))
    del eng
    torch.cuda.empty_cache()
    return runs


# --------------------------------------------------------------- phase 5
def _reference_chain(int8_ff=False, int8_attn=False, act_scales=None, bf16_tokens=None,
                     fused_attn=False, f32=False):
    """The chain at depth 2 / 4 steps, once through the kernels and once
    with their plain versions patched in, on the same card and weights.
    ``bf16_tokens``: the plain bf16 chain's tokens (same weights, cube and
    prior), the yardstick of a chain whose attention is a kernel too.
    ``f32``: compute_dtype float32 with matmul_precision highest, held to a
    strict bar. Returns the engine, its inputs and the plain tokens."""
    import rald_torch.eval.chamfer as chamfer
    import rald_torch.models.latent_dit as latent_dit
    import rald_torch.models.vecset_vae as vecset_vae
    from rald_torch.ops import attn_kernel as ak
    from rald_torch.ops import geglu_kernel as gk
    from rald_torch.ops.nn_dist_kernel import nn_min_sq_both_plain
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _product_cfg(int8_ff, int8_attn, act_scales, f32=f32)
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
            "dtype": str(eng.dtype), "tokens_max_abs_diff": tok_err,
            "tokens_rms": tok_rms, "cd_kernels": cd_k, "cd_plain": cd_p,
            "n_pred_kernels": int(out_k[5][0]), "n_pred_plain": int(out_p[5][0])}
    line["tokens_rms_diff"] = (tok_k - tok_p).pow(2).mean().sqrt().item()
    if f32:
        # f32 chain: the kernels compute exact f32 products, so the two paths
        # differ only in the order of their f32 sums (relative 1e-7 a
        # sublayer), not in any rounding to bf16: the bar on the max token
        # difference is 1e-3 of max(rms, 1), 50x below the bf16 chain's
        err, bar = tok_err, 1e-3 * max(tok_rms, 1.0)
    elif bf16_tokens is None:
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
    from rald_torch import apply_matmul_precision

    apply_matmul_precision("highest")
    eng, _, _ = _reference_chain(fused_attn=True, f32=True)
    del eng
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
    t = time.perf_counter()
    kernels = phase_kernels()
    print(f"[time] phase 3 (kernels) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    runs = phase_main()
    print(f"[time] phase 4 (main path, bf16 and f32) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    runs[("host chamfer_and_fscore", 1)] = phase_reference()
    print(f"[time] phase 5 (reference) {time.perf_counter() - t:.1f} s")
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
    # and in the f32 runs (batch 1) of the mode that uses it
    f32_mode_of = {"fused_ln_geglu_residual": "f32", "fused_ln_geglu_residual_int8":
                   "f32 int8_ff=True,int8_attn=vout", "fused_self_attention_block_int8_vout":
                   "f32 int8_ff=True,int8_attn=vout", "fused_ln_geglu_residual_int8_static":
                   "f32 int8_ff=static,int8_attn=full", "fused_self_attention_block_int8":
                   "f32 int8_ff=static,int8_attn=full",
                   "geglu_ff": "f32 GEGLUFeedForward(use_fused=True)",
                   "fused_self_attention_block": "f32 use_fused_attn"}
    for k in kernels:
        mode = mode_of[k["name"]]
        k["launches_mode"] = mode
        k["launches"] = runs[(mode, 1)]["launches"][k["name"]]
        if (mode, 8) in runs:
            k["launches_b8"] = runs[(mode, 8)]["launches"][k["name"]]
        if k["name"] in f32_mode_of:
            mode = f32_mode_of[k["name"]]
            k["f32"].update(launches_mode=mode, launches=runs[(mode, 1)]["launches"][k["name"]])
            check(k["f32"]["launches"] > 0, f"{k['name']}: no f32 launch in {mode}")
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
