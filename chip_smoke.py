#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rald_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. device: the card's name, count and power limit (``nvidia-smi``); no
   CUDA device -> exit 1 with no result.
2. build: compiles every hand-written kernel under ``rald_torch/csrc`` for
   ``sm_90a`` (one ``nvcc`` per source, all at once) and prints the ptxas
   register / shared-memory / spill report.
3. kernels: each kernel against its plain PyTorch version at main-path
   shapes, batch 1 and 8, then timed with CUDA events beside the plain version, a
   composite of library calls the port never makes (``library_ms``) and the
   card's bound for the same work.
4. main path: the product eval chain of
   ``configs/generation/ge_indoor_unfreeze_enc_ints_only_eval.yml`` at full
   width (DiT dim 512 x 24 blocks, VAE dim 512 x 24 blocks, bf16) on seeded
   random weights, through ``GenerationEngine.fused_eval_step``: raw cube
   upsampled on the device -> 3D-CNN condition tokens -> 35-NFE Heun
   sampler -> decode of 5e5 grid + 7e5 densified CFAR helper queries ->
   threshold -> 5e5 refine queries decoded -> polar->cartesian ->
   Chamfer / F-score against a 1e4-point synthetic surface, at batch 1
   and 8. Launch counters are zeroed just before each run and read just
   after.
5. reference: a reduced-depth chain run twice on the card, once through the
   kernels and once through their plain versions; tokens and Chamfer must
   agree.

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
PEAK_F32 = 67e12

D, INNER = 512, 2048  # product DiT / VAE width and GEGLU inner width
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
    t_bytes, t_ops = n_bytes / PEAK_BYTES, ops / peak_ops
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


def _nn_library(a, b, chunk: int = 16384):
    """Yardstick only: exact (non-matmul) cdist in chunks, both minima."""
    row = torch.empty(a.shape[:2], device=a.device)
    col = torch.full(b.shape[:2], float("inf"), device=a.device)
    for s in range(0, a.shape[1], chunk):
        d = torch.cdist(a[:, s:s + chunk], b, compute_mode="donot_use_mm_for_euclid_dist")
        row[:, s:s + chunk] = d.amin(2)
        col = torch.minimum(col, d.amin(1))
    return row, col


def phase_kernels() -> list:
    from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual, fused_ln_geglu_residual_plain
    from rald_torch.ops.nn_dist_kernel import BIG, nn_min_sq_both, nn_min_sq_both_plain

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
    nn_rows = {}
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
    nn_line = nn_rows[1]

    g1 = geglu_rows[(1, True)]
    entries.append({
        "name": "fused_ln_geglu_residual", "route": "cuda", "source": "rald_torch/csrc/geglu.cu",
        "replaces": "rald_tpu/ops/geglu_kernel.py:134", "shape": g1["shape"],
        "max_abs_err": max(r["max_abs_err"] for r in geglu_rows.values()),
        "ms": g1["ms"], "plain_ms": g1["plain_ms"], "bound_ms": g1["bound_ms"],
        "bound_by": g1["bound_by"], "library_ms": g1["library_ms"],
        "ms_b8": geglu_rows[(8, True)]["ms"],
    })
    entries.append({
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


def phase_main() -> list:
    from rald_torch.config import load_config
    from rald_torch.ops import launch_counts, reset_launch_counts
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = load_config(PRODUCT_CFG)
    t0 = time.perf_counter()
    eng = GenerationEngine(cfg)  # device None -> the card
    depth, vdepth = eng.model.depth, len(eng.vae.layers)
    n_params = sum(p.numel() for m in (eng.model, eng.vae) for p in m.parameters())
    print(f"[main] {cfg.ar_model.name} (depth {depth}) + {cfg.lidar_ae.name} (depth {vdepth}), "
          f"{n_params / 1e6:.1f}M params, {eng.dtype}, built in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(cfg.system.seed)
    inputs = {b: _inputs(cfg, b, rng) for b in (1, 8)}
    shift = _center_occupancy(eng, inputs.values())
    print(f"[main] decoder query projection x10, occupancy bias shift {shift:+.6f}")
    nfe = 2 * eng.sampler_kwargs["num_steps"] - 1
    want_geglu = nfe * depth + vdepth
    kw = dict(compute_cd=True, refine=True, helper_aug=True, use_device_grid=True)
    results = []
    for bsz in (1, 8):
        _run_step(eng, inputs[bsz], seed=bsz, **kw)  # warm-up: cuBLAS/cuDNN plans
        torch.cuda.reset_peak_memory_stats()
        timings = {}
        reset_launch_counts()
        t0 = time.perf_counter()
        loss, iou, acc, cd, f, n_pred = _run_step(eng, inputs[bsz], seed=bsz, timings=timings, **kw)
        wall = time.perf_counter() - t0
        counts = launch_counts()
        cd, f, n_pred = cd.cpu().numpy(), f.cpu().numpy(), n_pred.cpu().numpy()
        check(counts["fused_ln_geglu_residual"] == want_geglu,
              f"B={bsz}: {counts['fused_ln_geglu_residual']} geglu launches, want {want_geglu}")
        check(counts["nn_min_sq_both"] >= 1, f"B={bsz}: nn_min_sq_both never launched")
        check(bool((n_pred > 0).all()), f"B={bsz}: empty prediction n_pred={n_pred.tolist()}")
        check(bool(np.isfinite(cd).all()) and bool(np.isfinite(f).all()),
              f"B={bsz}: non-finite Chamfer/F {cd.tolist()} {f.tolist()}")
        check(all(math.isfinite(float(v)) for v in (loss, iou, acc)), f"B={bsz}: non-finite loss/IoU")
        line = {
            "batch": bsz, "stage_ms": {k: round(v, 3) for k, v in timings.items()},
            "step_ms": wall * 1e3, "frames_per_s": bsz / wall,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "launches": counts, "n_pred": n_pred.tolist(), "cd": cd.tolist(), "f": f.tolist(),
            "loss": float(loss), "iou": float(iou), "acc": float(acc),
        }
        print("[main] " + json.dumps(line))
        results.append(line)
    return results


# --------------------------------------------------------------- phase 5
def phase_reference() -> None:
    """The chain at depth 2 / 4 steps, once through the kernels and once
    with their plain versions patched in, on the same card and weights."""
    import rald_torch.eval.chamfer as chamfer
    import rald_torch.models.latent_dit as latent_dit
    import rald_torch.models.vecset_vae as vecset_vae
    from rald_torch.config import load_config
    from rald_torch.ops.geglu_kernel import fused_ln_geglu_residual_plain
    from rald_torch.ops.nn_dist_kernel import nn_min_sq_both_plain
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = load_config(PRODUCT_CFG)
    cfg.ar_model.overrides = {"depth": 2}
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
    saved = (latent_dit.fused_ln_geglu_residual, vecset_vae.fused_ln_geglu_residual,
             chamfer.nn_min_sq_both)
    latent_dit.fused_ln_geglu_residual = fused_ln_geglu_residual_plain
    vecset_vae.fused_ln_geglu_residual = fused_ln_geglu_residual_plain
    chamfer.nn_min_sq_both = nn_min_sq_both_plain
    try:
        tok_p = eng.sample_tokens(inputs["radar_cube"], [0])
        out_p = _run_step(eng, inputs, seed=3, **kw)
    finally:
        (latent_dit.fused_ln_geglu_residual, vecset_vae.fused_ln_geglu_residual,
         chamfer.nn_min_sq_both) = saved
    tok_err = (tok_k - tok_p).abs().max().item()
    tok_rms = tok_p.pow(2).mean().sqrt().item()
    cd_k, cd_p = float(out_k[3][0]), float(out_p[3][0])
    line = {"tokens_max_abs_diff": tok_err, "tokens_rms": tok_rms, "cd_kernels": cd_k,
            "cd_plain": cd_p, "n_pred_kernels": int(out_k[5][0]), "n_pred_plain": int(out_p[5][0])}
    print("[reference] " + json.dumps(line))
    # bf16 chain: the two paths round the FF sums in different orders; the
    # bar is scripts/full_parity.py's 5% of max(rms, 1) on the tokens
    check(tok_err <= 0.05 * max(tok_rms, 1.0), f"reference: token drift {tok_err:.3e}")
    check(math.isfinite(cd_k) and abs(cd_k - cd_p) <= 0.05 * abs(cd_p),
          f"reference: Chamfer {cd_k} vs plain {cd_p}")


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
    for k in kernels:
        k["launches"] = runs[0]["launches"][k["name"]]
        k["launches_b8"] = runs[1]["launches"][k["name"]]
    phase_reference()
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
