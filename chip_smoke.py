#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rald_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed before the last line:

1. device: the card's name, count and power limit (``nvidia-smi``); no
   CUDA device -> exit 1 with no result.
2. build: compiles every hand-written kernel under ``rald_torch/csrc`` for
   ``sm_90a`` (one ``nvcc`` per source, all at once) and prints the ptxas
   register / shared-memory / spill report.
3. kernels: each of the twelve kernels against its plain PyTorch version at
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
   timed against the f32 bound. Then split_qk_norm (Hunyuan3D's DiT, which
   no later phase runs) at the ``eval_hy3d_live_b1`` cell's attention shapes
   (``QK_CASES``) in bf16 and f32 against its plain version: q and k within
   1 unit in the last place of bf16 (16 of f32), v bitwise, one launch a
   stream; timed as CUDA graphs of its calls (the wrapper's host time would
   otherwise set the pace) beside its plain version (the ``F.rms_norm`` /
   ``torch.cat`` composite, so also its ``library_ms``) and its bytes bound,
   on one input set (``ms``: warm, largely in L2) and rotating through
   ``QK_COLD_SETS`` sets (``ms_cold``: from HBM). Then moe_grouped_ffn
   (Hunyuan3D-2.1's mixtures) at the ``eval_hy3d21_live_b1`` cell's
   shapes, on the model's own routing and two extreme ones (every row to
   one expert; one expert empty), against its plain version (the
   per-expert cuBLAS loop) within ``MOE_TOL`` in relative norm, two
   launches a call; timed as CUDA graphs, warm and rotating through
   ``MOE_COLD_SETS`` input sets, beside the plain version, the library's
   grouped GEMMs (``torch._grouped_mm``) and its operations bound. Then
   head_rms_norm (Hunyuan3D-2.1's QK-norm) at the same cell's self- and
   cross-attention shapes (``HN_CASES``), in place, against its plain
   version within 1 bf16 unit in the last place, one launch a call; timed
   as CUDA graphs, warm and rotating through ``HN_COLD_SETS`` input sets,
   beside the plain version and its bytes bound.
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
6. dataset eval: the eval entry point ``rald_torch.cli.main_generation.run``
   at full width over a synthetic ColoRadar tree (product raw shapes: radar
   (128, 8, 2), 16000 LiDAR and 512 raw CFAR points a frame, two test
   sequences of 3 frames, one split file per scene; the voxel caches
   written by the port's ``dump_voxel``, as in phases 7 and 8), with the engine's
   seeded random weights (decoder sharpened as in phase 4) saved as
   reference ``.pth`` files and read back through ``eval.ckpt`` /
   ``lidar_ae.ckpt`` / ``radar_enc.ckpt``: the eval YAML as shipped (the
   modular path: PLY dumps, host grid, helper densify, threshold and
   refine) over both scenes, the same YAML with ``store_pc: false`` (the
   fused path), and ``ge_indoor_frozen_enc_ints_only.yml`` in eval mode
   (the frozen radar encoder) on one scene; each with a StageTimer, exact
   launches of rows 1 and 2 per batch, one PLY per frame in JAX's layout,
   peak memory. Then the modular evaluate at depth 2 in f32 on the card
   and on the CPU (plain versions), same weights and numpy prior: loss /
   IoU / accuracy and the PLY point count must agree.
7. training: the train entry point ``main_generation.run`` (and
   ``main_cache.run``) over a synthetic ColoRadar tree at the product raw
   shapes (3 train sequences of 8 frames, 16000 LiDAR points a frame, and
   one 2-frame test scene), with phase 6's VAE and radar-encoder ``.pth``
   files as the frozen weights. (a) ``ge_indoor_unfreeze_enc_ints_only.yml``
   as shipped (bf16, batch 8, full width, JAX-init DiT weights), cut to 2
   epochs of 3 steps, ``save_ckpt_freq: 1``, ``eval_freq: 2`` on the test
   scene: finite losses and norms, step 6, the EMA moved away from its
   start and from the params, ``checkpoint-0/1.pth`` written and read back
   bitwise, no kernel launch over the 6 train steps and exactly 864 of row 1
   and 1 of row 2 per eval batch; a resumed run from ``checkpoint-0.pth``
   trains epoch 1 only, its loss within ``RESUME_LOSS_REL`` of the
   uninterrupted run's; the eval CLI's loader with ``use_ema`` puts the
   EMA weights into the eval model. (d) Its timing: median step ms of 6
   warm steps, frames/s, the synchronised split (``vae_encode``,
   ``upsample``, ``forward_backward``, ``optimizer``), peak memory, and the
   device idle share of 3 steps under ``torch.profiler``. (b) The same path
   at depth 2 (DiT and VAE), float32 with ``matmul_precision: highest``,
   batch 2: 3 steps on the card and on the CPU from the same weights, batch
   and injected draws: loss and ``grad_norm`` within 1e-4 relative, step
   1's gradients within 1e-4 of each tensor's max |g| (floored at 1e-2 of
   the largest: exactly-zero gradients are rounding noise), params and EMA
   after 3 steps within 3 * lr. (c) ``ge_indoor_frozen_enc_ints_only.yml``
   for one epoch, ``main_cache`` over the train split, and one epoch from
   the cache. Checkpoints are deleted at the end of each run.
8. stage-1 VAE training: the entry point ``rald_torch.cli.main_ae`` over a
   synthetic ColoRadar tree at the product raw shapes (16000 LiDAR points a
   frame; 3 train sequences of 4 frames, a 2-frame val sequence). (a)
   ``configs/ae/ae_indoor_aniso_mix_view_cone.yml`` as shipped
   (``kl_d512_m512_l32_mix`` at full width: dim 512, 24 blocks, 512 x 32
   latents, 8 heads; N = 10000 points, batch 4, bf16, lr from ``blr``,
   JAX-init weights), cut to 2 epochs of 3 steps, ``save_ckpt_freq: 1``,
   ``eval_freq: 2``: finite losses, step 6, the
   EMA moved, ``checkpoint-0/1.pth`` read back bitwise, no kernel launch
   over the 6 train steps and exactly 48 of row 1 and 1 of row 2 per
   evaluated batch (two full forwards, 5e5 grid queries); a run resumed
   from ``checkpoint-0.pth`` trains epoch 1 only, its loss within
   ``RESUME_LOSS_REL`` of the uninterrupted run's. (c) Its timing: median
   step ms of 6 warm steps, frames/s, the synchronised split
   (``forward_backward``, ``optimizer``), peak memory, the device idle
   share of 3 steps under ``torch.profiler``, and one evaluated batch's
   ms. (b) ``ae_indoor_aniso_mix_view_cone_eval.yml`` in eval mode through
   ``main_ae.main``: its five-scene sweep, each scene's split naming the
   val sequence, ``eval.ckpt`` (a)'s ``checkpoint-1.pth``, exact launches
   over the sweep. (d) The same path at depth 2, float32 with
   ``matmul_precision: highest``, batch 2: 3 steps on the card and on the
   CPU from the same weights, batch and injected draws (posterior noise
   and drop-path masks), to (b) of phase 7's bars.
9. data preparation: (a) a raw ColoRadar-layout tree from a seed: two
   sequences (train and test in a split file) of 8 raw frames, 6 aligned
   through the index files; int16 ADC at the product chirp,
   (3, 4, 128, 128, 2) a frame (point targets of a room scene plus noise);
   65536 x 4 LiDAR returns a scan (one OS1-64 sweep: the room, returns
   behind the sensor and zero returns). (b) The five preprocessing CLIs
   through their ``main`` on the card, with ``configs/preprocess/
   coloradar.yml`` and ``coloradar_test_set.yml`` as shipped (only the
   root, output, voxel and split paths replaced): ``relink``,
   ``preprocess_lidar``, ``preprocess_radar`` ((128, 8, 2, 3) train cubes),
   ``preprocess_radar --test-set`` ((128, 32, 16, 3) cubes), ``cache_cfar``
   ((256, 256, 128), 8e5 points before the FOV filter) and ``dump_voxel
   --mode sc_cone``. (c) Checks: every output file with its shape;
   ``raeivv_map_batch`` on the card against the CPU on 8 frames of each
   chirp (dB within 1e-3, velocity and validity equal on >= 99 % of
   cells); ``cfar_points_from_cube`` on one high-res cube (equal budgets,
   >= 99.9 % shared cells); ``os_cfar``, ``nq_cfar_2d``, ``mask_real_2d``
   (masks equal, values within 1e-5 relative); ``rald_torch.native``
   built, its voxelizer bitwise the numpy one on a scan; each test frame's
   ``cache_voxel: true`` item bitwise its ``cache_voxel: false`` item.
   (d) The processed test sequence through ``main_generation`` (eval mode,
   the eval YAML as shipped with ``cache_voxel: true``; phase 6's ``.pth``
   weights, the occupancy bias centred on this tree's cubes): every frame
   evaluated, finite CD / F, one non-empty PLY a frame, rows 1 and 2
   launched per batch as in phase 6. (e) The ``[prep]`` line: wall s per
   frame of each CLI, CUDA-event ms of ``raeivv_map_batch`` per batch of 8
   (both chirps) and of ``cfar_points_from_cube`` per frame, the host share
   of a ``cache_cfar`` frame, peak device memory of the CLIs.
10. multi-process runs (``rald_torch.parallel``), each child a process of
   its own with the rendezvous in its environment, killed with the others
   when one fails or DIST_TIMEOUT runs out. (a) ``main_generation`` in
   train mode with ``WORLD_SIZE=1 RANK=0 LOCAL_RANK=0
   MASTER_ADDR=127.0.0.1``: the shipped ``ge_indoor_unfreeze_enc_ints_only.yml``
   at full width (bf16, batch 8) over phase 7's tree, one epoch of 3 steps
   and its EMA evaluation: a process group on NCCL on cuda:0, no kernel
   launch over the steps and exactly 864 of row 1 and 1 of row 2 per eval
   batch, and the checkpoint's params and EMA bitwise those of the same
   steps run with no process group (a mean over one rank is the identity;
   cuDNN deterministic in both). (b) Two ranks that share cuda:0 over gloo
   (NCCL refuses two ranks on one device): two stage-2 steps at depth 2 in
   float32 ``highest``, local batch 4 of one global batch of 8, the draws
   from the engine's generators: the ranks bitwise equal after each step,
   within DIST_REL (loss, grad norm) and ``k * 1e-6 + 2 * lr * k`` (params,
   EMA) of one process on the batch of 8; then ``infer`` over phase 4's
   nine cubes at batch 8, rank ``r`` taking files ``r::2``: the union of the
   two ranks' PLY files byte for byte the one-process run's, and 864
   launches of row 1 per rank. (c) NCCL at world size 2 on cuda:0 and
   cuda:1, the steps of (b), where the machine has two cards. (d)
   ``eval.inference.shard_queries`` over two gloo ranks on cuda:0, the
   product eval YAML with phase 6's weights, batch 2, a grid of 500001
   queries: ``sample_tokens`` + ``decode_queries``, then one
   ``fused_eval_step`` (the grid drawn on the card, 7e5 densified helpers,
   5e5 refine queries); both ranks' logits and step outputs bitwise the
   one-process run's, rank 0 launching row 1 for the sampler and both ranks
   for the VAE's decoder blocks. The ``[dist]`` lines: timings and peak
   memory per rank beside the card's name and power limit.
11. the rest of the port (``phase_rest()``, under ``build/chip_smoke/rest/``).
   (a) Stochastic churn (``s_churn 40, s_min 0.05, s_max 50, s_noise
   1.003``) on the product eval chain at full width, bf16 with
   ``use_fused_attn``, batch 1 and 8: non-empty clouds, finite CD / F, row
   1 at 864 and row 7 at 840 launches a batch (one AdaLN row per frame at
   every NFE); frames 0 and 5 sampled alone against the same seeds inside
   the batch of 8 (``CHURN_ALONE_BAR``); ``int8_ff: "static"`` + churn at
   batch 1: row 4 at 840, row 5 at 0 (churn takes no scale rows); a
   depth-2 f32 chain on the card against the CPU with injected prior and
   churn draws (``CHURN_F32_BAR``). (b) ``python -m
   rald_torch.cli.calibrate_int8`` with its defaults on phase 6's EDM
   ``.pth`` (the npz beside it) and ``int8_gate`` in all four modes over
   scene a of phase 6's tree: rows 4, 5 and 9 launched in their modes. (c)
   ``convert_ckpt`` of phase 6's EDM ``.pth`` -> ``train.resume`` for one
   epoch (3 steps) of ``main_generation`` train mode at full width; the
   frozen YAML's radar autoencoder ``encode`` -> ``decode`` at the product
   cube (128, 64, 32) on the card against the CPU in f32 (``RADAR_AE_BAR``);
   ``maybe_trace`` around one ``sample_tokens`` call, its Chrome trace
   naming the ``annotate`` region and row 1's GEMM kernels.
12. the convergence recipe cut to fit (``phase_curves()``, under
   ``build/chip_smoke/curves/``), at full width. (a) ``python -m
   rald_torch.cli.curves_configs``'s tree (300 frames of 16000 points,
   radar (128, 8, 2)) and YAMLs (60 + 120 epochs). (b) Stage 1: the first
   ``CURVES_AE_EPOCHS`` epochs of the 60-epoch schedule, the ``AEEngine``
   epoch loop driven from here (so the LR horizon stays the recipe's), the
   evals after epochs 3 and 7 beside JAX's log (``JAX_STAGE1_VAL_IOU``),
   then the checkpoint: finite values, a falling loss, val IoU at epoch 7
   at least ``CURVES_MIN_IOU_EPOCH7``, 48 launches of row 1 and 1 of row 2
   per evaluated batch. (c) ``main_cache`` from that file ("Loaded frozen
   VAE from …pth", 200 latents). (d) Stage 2: the first
   ``CURVES_GEN_EPOCHS`` epochs of the 120-epoch schedule from the cache,
   the EMA eval after epoch 3 with 864 / 1 launches of rows 1 / 2 per
   evaluated batch, then the checkpoint. (e) ``python -m
   rald_torch.cli.precision_gate`` on that checkpoint with 1 mask batch,
   from torch's process defaults, its three runs (``default``, ``highest``,
   ``medium``). One ``[curves]`` line: stage seconds, curve points, the
   gate's result and launches, peak GiB. The checkpoints stay for phase 13.
13. the product eval bench (``phase_product_bench()``): ``python -m
   rald_torch.cli.product_eval_bench``'s ``run`` (JAX's product recipe: 5e5
   grid, 7e5 helpers densified on the card, 5e5 refine queries, Chamfer / F,
   batch 8) on phase 12's stage-2 checkpoint and YAML (its params: after
   100 steps the EMA is still mostly its initial weights and predicts no
   point in most frames), over the recipe's 50 test frames: bf16, one
   warm-up and 3 timed passes, then int8 dynamic + ``vout``, one and one. Checks: identical metrics across the timed passes,
   ``n_pred`` > 0 in every frame, finite CD / F, 50 frames, exact launches
   per batch (phase 4's ``_want_launches``). One ``[product_bench]`` line:
   passes, median / min / max pc/s, launches, peak GiB, the card's name and
   power limit. The checkpoints are deleted after it.

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

import copy
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
PREP_CFG = REPO / "configs" / "preprocess" / "coloradar.yml"
PREP_TEST_CFG = REPO / "configs" / "preprocess" / "coloradar_test_set.yml"

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
                "fused_self_attention_block_int8_vout", "split_qk_norm", "moe_grouped_ffn",
                "head_rms_norm")
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


# split_qk_norm at Hunyuan3D's DiT attention in the eval_hy3d_live_b1 cell:
# B 2 guidance rows, 16 heads of 64; name: (stream token counts, MLP width
# after the qkv columns). The dual-stream blocks join 1370 condition and 3072
# latent tokens (q, k and v written); the single-stream blocks read the qkv
# slice of 4442 [qkv | 4096-wide MLP] rows in place (q and k written). Each
# dual-stream stream also alone, as one part (q and k written; bf16 only).
QK_B, QK_H = 2, 16
QK_CASES = {"dual": ((1370, 3072), 0), "single": ((4442,), 4096),
            "stream_1370": ((1370,), 0), "stream_3072": ((3072,), 0)}
# input sets a cold graph rotates through, each call's outputs kept in a
# buffer of their own: 0.9 / 1.3 GB a replay, far beyond the 50 MB L2
QK_COLD_SETS = 8


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """The largest distance in units in the last place between two
    same-dtype float tensors."""
    def ordered(x):
        bits = x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32).long()
        mag = bits & (0x7FFF if x.dtype == torch.bfloat16 else 0x7FFFFFFF)
        return torch.where(bits < 0, -mag, mag)
    return int((ordered(a) - ordered(b)).abs().max())


def _qk_parts(lens, mlp: int, dtype, gen: torch.Generator) -> list:
    """One ``(qkv, q scale, k scale)`` part a stream, qkv the first 3 * D
    columns of (B, L, 3 * D + mlp) rows."""
    d = QK_H * 64
    parts = []
    for n in lens:
        rows = (torch.randn(QK_B, n, 3 * d + mlp, generator=gen, device="cuda") * 3).to(dtype)
        scales = [(torch.rand(64, generator=gen, device="cuda") * 2).to(dtype) for _ in range(2)]
        parts.append((rows[..., :3 * d], *scales))
    return parts


def _graph_ms(calls: list, keep: bool, replays: int = 20) -> float:
    """Device ms a call of ``calls``, captured in order into one CUDA graph
    and replayed, so no host work runs between launches. ``keep``: every
    call's outputs stay alive, each in buffers of their own."""
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        calls[0]()
        torch.cuda.synchronize()
        outs = []
        with torch.cuda.graph(graph, stream=stream):
            for fn in calls:
                out = fn()
                if keep:
                    outs.append(out)
        del out
    torch.cuda.synchronize()
    ms = cuda_ms(graph.replay, replays) / len(calls)
    del graph, outs
    return ms


@torch.no_grad()
def _qk_norm_entry(gen: torch.Generator) -> dict:
    """split_qk_norm in each of ``QK_CASES`` against its plain version
    (bf16 and f32), then timed (see the docstring's phase 3)."""
    from rald_torch.ops import qk_norm as qn

    rows, f32 = {}, {}
    for case, (lens, mlp) in QK_CASES.items():
        for dtype in (torch.bfloat16, torch.float32)[:1 if case.startswith("stream") else 2]:
            sets = [_qk_parts(lens, mlp, dtype, gen)
                    for _ in range(QK_COLD_SETS if dtype == torch.bfloat16 else 1)]
            kern = lambda parts: qn.split_qk_norm(parts, QK_H)  # noqa: E731
            plain = lambda parts: qn.split_qk_norm_plain(parts, QK_H)  # noqa: E731
            before = qn.split_qk_norm.launches
            got, want = kern(sets[0]), plain(sets[0])
            torch.cuda.synchronize()
            label = f"split_qk_norm {case} {dtype}"
            check(qn.split_qk_norm.launches - before == len(lens), f"{label}: launches")
            n_tot = sum(lens)
            check(all(t.shape == (QK_B, QK_H, n_tot, 64) for t in got), f"{label}: shapes")
            tol = 1 if dtype == torch.bfloat16 else 16
            ulps = [_ulps(g, w) for g, w in zip(got[:2], want[:2])]
            check(max(ulps) <= tol, f"{label}: q / k {ulps} ulps > {tol}")
            check(torch.equal(got[2], want[2]), f"{label}: v not bitwise")
            # bytes: q and k read and written, v too where the kernel writes it
            moved = (6 if len(lens) > 1 else 4) * QK_B * n_tot * QK_H * 64 * got[0].element_size()
            line = {"shape": [QK_B, QK_H, list(lens), 64], "case": case, "dtype": str(dtype),
                    "mlp": mlp, "ulps_q": ulps[0], "ulps_k": ulps[1],
                    "max_abs_err": max((g.float() - w.float()).abs().max().item()
                                       for g, w in zip(got, want)),
                    "ms": _graph_ms([lambda: kern(sets[0])] * 20, keep=False),
                    "plain_ms": _graph_ms([lambda: plain(sets[0])] * 20, keep=False)}
            line["bound_ms"], line["bound_by"] = bound_t(moved, 0.0)
            if dtype == torch.bfloat16:
                line["ms_cold"] = _graph_ms([lambda p=p: kern(p) for p in sets], keep=True)
                line["plain_ms_cold"] = _graph_ms([lambda p=p: plain(p) for p in sets], keep=True)
                line["bound_share_cold"] = line["bound_ms"] / line["ms_cold"]
                rows[case] = line
            else:
                f32[case] = line
            print("[kernels] split_qk_norm " + json.dumps(line))
            del sets, got, want
    d, s1 = rows["dual"], rows["single"]
    return {
        "name": "split_qk_norm", "route": "cuda", "source": "rald_torch/csrc/qk_norm.cu",
        "replaces": "no TPU kernel: Hunyuan3D DiT's view / permute / F.rms_norm / torch.cat",
        "shape": d["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": d["ms"], "plain_ms": d["plain_ms"], "library_ms": d["plain_ms"],
        "bound_ms": d["bound_ms"], "bound_by": d["bound_by"], "ms_cold": d["ms_cold"],
        "library_ms_cold": d["plain_ms_cold"], "single": s1,
        "streams": {c: rows[c] for c in rows if c.startswith("stream")},
        "f32": {c: {k: r[k] for k in ("ulps_q", "ulps_k", "ms", "plain_ms", "bound_ms")}
                for c, r in f32.items()},
    }


# moe_grouped_ffn at Hunyuan3D-2.1's mixtures in the eval_hy3d21_live_b1
# cell: B 2 guidance rows of 4097 tokens, top 2 of 8 experts, so 16388
# routed rows of width 2048 through 2048 -> 8192 -> 2048 experts. The
# routing is the model's own (MoEFFN.route on seeded normed rows); two
# extreme ones besides: every row to one expert, and one expert empty.
MOE_T, MOE_D, MOE_INNER, MOE_E, MOE_K = 2 * 4097, 2048, 8192, 8, 2
MOE_COLD_SETS = 4  # input sets a cold graph rotates through (67 MB of rows each)
# the kernel against its plain version, ||got - want|| / ||want||: both round
# at the same four points in bf16 and sum in f32 in different orders, so a
# hidden activation may land one bf16 ulp (2^-8 relative) apart
MOE_TOL = 4e-3


def _moe_rows(mix, gen: torch.Generator, counts=None):
    """Seeded normed rows routed by ``mix`` (or forced to ``counts`` per
    expert): the expert-sorted rows, gate weights and int32 offsets."""
    if counts is None:
        h = torch.nn.functional.layer_norm(
            torch.randn(MOE_T, MOE_D, generator=gen, device="cuda"), (MOE_D,)).bfloat16()
        rows, gate, off, _, _ = mix.route(h)
        return rows.contiguous(), gate.contiguous(), off
    n = sum(counts)
    rows = torch.randn(n, MOE_D, generator=gen, device="cuda").bfloat16()
    gate = torch.rand(n, generator=gen, device="cuda")
    off = torch.tensor([0, *np.cumsum(counts).tolist()], dtype=torch.int32, device="cuda")
    return rows, gate, off


@torch.no_grad()
def _moe_ffn_entry(gen: torch.Generator) -> dict:
    """moe_grouped_ffn against its plain version (the per-expert loop of
    cuBLAS calls) at the cell's shapes and two extreme routings, then timed
    as a replayed graph: warm (one input set) and from HBM (rotating input
    sets; the 537 MB of expert weights never fit the 50 MB L2), beside the
    plain version and the library's grouped GEMMs (``torch._grouped_mm``,
    the two products alone, without bias, GELU or gate)."""
    from rald_torch.models.moe import MoEFFN
    from rald_torch.ops import moe_ffn as mf
    from rald_torch.train.gen_engine import init_random_weights

    mix = MoEFFN(MOE_D, MOE_INNER, MOE_E, MOE_K)
    init_random_weights(mix, torch.Generator().manual_seed(0))
    mix = mix.to(device="cuda", dtype=torch.bfloat16).eval()
    w = (mix.w1, mix.b1, mix.w2, mix.b2)
    routings = {"model": None, "one_expert": [0, 0, 0, MOE_K * MOE_T, 0, 0, 0, 0],
                "one_empty": [3000, 0, 2000, 2500, 2888, 1000, 2500, 2500]}
    errs = {}
    for name, counts in routings.items():
        rows, gate, off = _moe_rows(mix, gen, counts)
        before = mf.moe_grouped_ffn.launches
        got = mf.moe_grouped_ffn(rows, off, *w, gate)
        want = mf.moe_grouped_ffn_plain(rows, off, *w, gate)
        torch.cuda.synchronize()
        check(mf.moe_grouped_ffn.launches - before == 2, f"moe_grouped_ffn {name}: launches")
        diff = (got.float() - want.float())
        rel = float(diff.norm() / want.float().norm())
        check(bool(torch.isfinite(got).all()), f"moe_grouped_ffn {name}: non-finite rows")
        check(rel <= MOE_TOL, f"moe_grouped_ffn {name}: relative error {rel} > {MOE_TOL}")
        errs[name] = {"rel": rel, "max_abs_err": float(diff.abs().max()),
                      "max_ulps": _ulps(got, want), "offsets": off.tolist()}
        print(f"[kernels] moe_grouped_ffn {name} " + json.dumps(errs[name]))
    sets = [_moe_rows(mix, gen) for _ in range(MOE_COLD_SETS)]
    rows, gate, off = sets[0]
    n = rows.shape[0]
    flops = 2 * 2 * n * MOE_D * MOE_INNER
    moved = MOE_E * (2 * MOE_D * MOE_INNER + MOE_INNER + MOE_D) * 2 + n * ((2 * MOE_D + 2 * MOE_INNER) * 2 + 4)
    kern = lambda s: mf.moe_grouped_ffn(s[0], s[2], *w, s[1])  # noqa: E731
    line = {"shape": [n, MOE_D, MOE_INNER, MOE_E], "offsets": off.tolist(),
            "ms": _graph_ms([lambda: kern(sets[0])] * 10, keep=False),
            "ms_cold": _graph_ms([lambda s=s: kern(s) for s in sets] * 2, keep=True),
            "plain_ms": cuda_ms(lambda: mf.moe_grouped_ffn_plain(rows, off, *w, gate), 5)}
    line["bound_ms"], line["bound_by"] = bound(moved, flops, PEAK_BF16)
    line["tflops"] = flops / line["ms"] * 1e-9
    line["bound_share"], line["bound_share_cold"] = (line["bound_ms"] / line["ms"],
                                                     line["bound_ms"] / line["ms_cold"])
    try:
        ends = off[1:].contiguous()
        w1t, w2t = mix.w1.transpose(1, 2), mix.w2.transpose(1, 2)
        lib = lambda: torch._grouped_mm(torch._grouped_mm(rows, w1t, offs=ends), w2t, offs=ends)  # noqa: E731
        lib()
        line["library_ms"] = _graph_ms([lib] * 10, keep=False)
    except Exception as e:  # the library's grouped GEMM is private and may be missing
        line["library_ms"] = None
        line["library_error"] = f"{type(e).__name__}: {e}"[:300]
    print("[kernels] moe_grouped_ffn " + json.dumps(line))
    return {
        "name": "moe_grouped_ffn", "route": "cuda", "source": "rald_torch/csrc/moe_ffn.cu",
        "replaces": "no TPU kernel: the public MoEBlock's per-expert loop with host indexing",
        "shape": line["shape"], "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
        "errors": errs, "ms": line["ms"], "ms_cold": line["ms_cold"],
        "plain_ms": line["plain_ms"], "library_ms": line["library_ms"],
        "bound_ms": line["bound_ms"], "bound_by": line["bound_by"], "tflops": line["tflops"],
        "bound_share": line["bound_share"], "bound_share_cold": line["bound_share_cold"],
        "f32": "bf16 only",
    }


# head_rms_norm at Hunyuan3D-2.1's attentions in the eval_hy3d21_live_b1
# cell: B 2 guidance rows, 16 heads of 128, q over the 4097 tokens and k over
# them (self) or over the 1370 condition tokens (cross), the unconditional
# row's condition tokens zero
HN_B, HN_H = 2, 16
HN_CASES = {"self": (4097, 4097), "cross": (4097, 1370)}
HN_COLD_SETS = 8  # input sets a cold graph rotates through: 537 / 358 MB a replay


def _hn_rows(lq: int, lk: int, gen: torch.Generator, ones: bool = False) -> list:
    """q rows, k rows (the last 300 tokens of k's second row zero), and two
    128-value weights (ones: a norm that repeats itself, for timing in
    place)."""
    d = HN_H * 128
    q = (torch.randn(HN_B, lq, d, generator=gen, device="cuda") * 3).bfloat16()
    k = (torch.randn(HN_B, lk, d, generator=gen, device="cuda") * 3).bfloat16()
    k[-1, -300:] = 0
    ws = [torch.ones(128, device="cuda", dtype=torch.bfloat16) if ones else
          (torch.rand(128, generator=gen, device="cuda") * 2).bfloat16() for _ in range(2)]
    return [q, k, *ws]


@torch.no_grad()
def _head_norm_entry(gen: torch.Generator) -> dict:
    """head_rms_norm at ``HN_CASES``, in place in the rows as the DiT calls
    it, against its plain version: q and k within 1 unit in the last place
    of bf16, zero tokens zero, one launch a call; timed as CUDA graphs of
    its calls, warm (one input set) and from HBM (rotating through
    ``HN_COLD_SETS``), beside the plain version (view, transpose,
    ``F.rms_norm``: its copies and norm kernel, so also its ``library_ms``)
    and the bytes bound (q and k read and written once)."""
    from rald_torch.ops import head_norm as hn

    rows = {}
    for case, (lq, lk) in HN_CASES.items():
        q, k, wq, wk = _hn_rows(lq, lk, gen)
        want = [hn.head_rms_norm_plain(t, w, HN_H) for t, w in ((q, wq), (k, wk))]
        line = {"shape": [HN_B, HN_H, [lq, lk], 128], "case": case}
        before = hn.head_rms_norm.launches
        got = hn.head_rms_norm(q, k, wq, wk, HN_H)
        torch.cuda.synchronize()
        label = f"head_rms_norm {case}"
        check(hn.head_rms_norm.launches - before == 1, f"{label}: launches")
        line["ulps"] = [_ulps(g, w) for g, w in zip(got, want)]
        check(max(line["ulps"]) <= 1, f"{label}: q / k {line['ulps']} ulps > 1")
        check(not got[1][-1, :, -300:].any(), f"{label}: zero tokens not zero")
        line["max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                                  for g, w in zip(got, want))
        del q, k, got, want
        moved = 4 * HN_B * (lq + lk) * HN_H * 128  # bf16 q and k, read and written
        line["bound_ms"], line["bound_by"] = bound_t(moved, 0.0)
        sets = [_hn_rows(lq, lk, gen, ones=True) for _ in range(HN_COLD_SETS)]
        kern = lambda s: hn.head_rms_norm(*s, HN_H)  # noqa: E731
        plain = lambda s: (hn.head_rms_norm_plain(s[0], s[2], HN_H),  # noqa: E731
                           hn.head_rms_norm_plain(s[1], s[3], HN_H))
        line["ms"] = _graph_ms([lambda: kern(sets[0])] * 20, keep=False)
        line["ms_cold"] = _graph_ms([lambda s=s: kern(s) for s in sets], keep=False)
        line["plain_ms"] = _graph_ms([lambda: plain(sets[0])] * 20, keep=False)
        line["plain_ms_cold"] = _graph_ms([lambda s=s: plain(s) for s in sets], keep=True)
        line["bound_share"] = line["bound_ms"] / line["ms"]
        line["bound_share_cold"] = line["bound_ms"] / line["ms_cold"]
        rows[case] = line
        print("[kernels] head_rms_norm " + json.dumps(line))
        del sets
    s, c = rows["self"], rows["cross"]
    return {
        "name": "head_rms_norm", "route": "cuda", "source": "rald_torch/csrc/head_norm.cu",
        "replaces": "no TPU kernel: Hunyuan3D-2.1 DiT's head view / F.rms_norm of q and k",
        "shape": s["shape"], "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": s["ms"], "plain_ms": s["plain_ms"], "library_ms": s["plain_ms"],
        "bound_ms": s["bound_ms"], "bound_by": s["bound_by"], "ms_cold": s["ms_cold"],
        "library_ms_cold": s["plain_ms_cold"], "cross": c,
    }


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
    entries.append(_qk_norm_entry(gen))
    entries.append(_moe_ffn_entry(gen))
    entries.append(_head_norm_entry(gen))
    for e in entries:
        e["max_err"] = e["max_abs_err"]
        # the nearest-neighbour kernels take f32 points only: their entries
        # above are f32
        e.setdefault("f32", f32.get(e["name"], "f32 only: the entries above"))
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


def _device_busy_us(prof) -> tuple:
    """(union of the device kernels' intervals in microseconds, their count,
    the 8 kernels with the most device time as {name: ms}). User
    annotations on the device timeline (``Optimizer.step#AdamW.step``
    spans the optimizer's kernels and the gaps between them) are no
    kernels and are left out."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return busy, len(spans), {k[:80]: v / 1e3 for k, v in top}


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
        busy, n_kernels, top = _device_busy_us(prof)
        line = {"mode": mode, "batch": bsz,
                "wall_ms": wall, "traced_wall_ms": traced, "device_busy_ms": busy / 1e3,
                "device_idle_share": 1.0 - busy / 1e3 / wall, "kernels": n_kernels,
                "top_kernels_ms": top,
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


def _center_occupancy(eng, batches, sharpen: bool = True) -> float:
    """Make random weights give a real cloud on every frame. Random weights
    attend almost uniformly, so each query gets about its frame's mean
    logit and frames differ by more than queries do: the decoder's query
    projection is sharpened 10x (unless ``sharpen`` is False: weights that
    were sharpened before) and the occupancy bias set so that at least a
    fifth of each frame's probe queries score positive (the centring
    scripts/full_parity.py does, per frame)."""
    probe = np.random.default_rng(1).uniform(-1, 1, size=(1, 65536, 3)).astype(np.float32)
    if sharpen:
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


# --------------------------------------------------------------- phase 6
FROZEN_CFG = REPO / "configs" / "generation" / "ge_indoor_frozen_enc_ints_only.yml"
EVAL_ROOT = SCRATCH / "coloradar"  # the synthetic ColoRadar tree of the dataset-eval phase
EVAL_FRAMES = 3  # frames per test sequence; two sequences, one scene each
EVAL_SCENES = ("scene_a", "scene_b")


def _dump_voxels(tree: Path) -> int:
    """The voxel caches of a synthetic tree, written by the port's
    ``dump_voxel`` (``--mode sc_cone``, ``configs/preprocess/coloradar.yml``'s
    voxel settings) into ``<tree>_voxel`` and linked into each sequence, as
    the shipped YAMLs' ``cache_voxel: true`` reads them."""
    from rald_torch.cli import dump_voxel
    from rald_torch.config import load_config

    cfg = load_config(PREP_CFG)
    cfg.output_dir = str(tree)
    cfg.voxel_output_dir = str(tree.parent / f"{tree.name}_voxel")
    return dump_voxel.run(cfg, mode="sc_cone")


def _eval_tree() -> dict:
    """A synthetic ColoRadar tree at the product YAML's raw shapes (radar
    (128, 8, 2), 16000 LiDAR points and 512 raw CFAR points a frame), two
    test sequences of EVAL_FRAMES frames, their voxel caches, and one split
    file per scene. Returns {scene: test sequence}."""
    import shutil

    from rald_torch.data.synthetic import make_synthetic_coloradar

    shutil.rmtree(EVAL_ROOT, ignore_errors=True)
    make_synthetic_coloradar(EVAL_ROOT, num_train_seqs=0, num_eval_seqs=2,
                             frames_per_seq=EVAL_FRAMES, points_per_frame=16000,
                             radar_shape=(128, 8, 2), helper_points=512, seed=21)
    _dump_voxels(EVAL_ROOT)
    test = json.loads((EVAL_ROOT / "split_synth.json").read_text())["test"]
    for scene, seq in zip(EVAL_SCENES, test):
        (EVAL_ROOT / f"split_{scene}.json").write_text(
            json.dumps({"train": [], "val": [], "test": [seq]}))
    return dict(zip(EVAL_SCENES, test))


def _eval_cfg(path: Path, label: str, **system):
    """A shipped YAML pointed at the synthetic tree, its outputs under
    build/: split files per scene, ``system`` keys replaced."""
    from rald_torch.config import load_config

    cfg = load_config(path)
    out = SCRATCH / "eval" / label
    cfg.dataset.root_dir = str(EVAL_ROOT)
    cfg.dataset.split_file = {s: f"split_{s}.json" for s in EVAL_SCENES}
    cfg.system.update(output_dir=str(out / "result"), log_dir=str(out / "log"), **system)
    cfg.eval.store_base_dir = str(out / "dumps")
    return cfg


def _eval_cubes(cfg, scene: str, frames: int = 2) -> list:
    """The dataset's first test cubes of a scene, as engine inputs."""
    from rald_torch.config import Config
    from rald_torch.data.coloradar import ColoRadarDataset

    sub = json.loads(json.dumps(cfg.dataset.to_dict()))
    split = cfg.dataset.split_file
    sub["split_file"] = split[scene] if isinstance(split, dict) else split
    ds = ColoRadarDataset(cfg.dataset.root_dir, Config(sub), loader_type="test")
    return [{"radar_cube": ds[i]["radar_cube"][None], "seeds_or_prior": [i]} for i in range(frames)]


def _save_weights(eng, label: str) -> dict:
    """The engine's weights as reference-layout ``.pth`` files (float32):
    ``eval.ckpt``, ``lidar_ae.ckpt`` and, with the frozen encoder, a radar
    autoencoder's encoder (``radar_enc.ckpt``)."""
    from rald_torch.train.checkpoint import save_torch_checkpoint

    def f32(m):
        return {k: v.float() for k, v in m.state_dict().items()}

    d = SCRATCH / "eval" / "ckpt"
    paths = {"eval.ckpt": save_torch_checkpoint(d / f"{label}_edm.pth", f32(eng.model)),
             "lidar_ae.ckpt": save_torch_checkpoint(d / f"{label}_vae.pth", f32(eng.vae))}
    if eng.radar_enc is not None:
        paths["radar_enc.ckpt"] = save_torch_checkpoint(d / f"{label}_radar_ae.pth", f32(eng.radar_enc))
    return {k: str(v) for k, v in paths.items()}


def _set_ckpts(cfg, paths: dict):
    for key, path in paths.items():
        section, name = key.split(".")
        cfg[section][name] = path
    return cfg


def _eval_run(cfg, label: str, scene: str, seq: str, engine=None, n_frames=EVAL_FRAMES) -> dict:
    """One scene through ``rald_torch.cli.main_generation.run`` (the engine
    built and its ``.pth`` weights loaded unless ``engine`` is given), with a
    StageTimer, the launch counters zeroed just before and read just after.
    Checks: every frame evaluated once, finite loss / IoU / CD / F (a frame
    with no prediction would make CD inf), exact launches of rows 1 and 2
    per batch and none of the others, one PLY per frame in JAX's layout."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.config import expand_experiment_sweep, finalize_dirs
    from rald_torch.eval.ply import read_ply
    from rald_torch.ops import launch_counts, nn_min_sq_both, reset_launch_counts
    from rald_torch.train.profiler import StageTimer

    sub = dict(expand_experiment_sweep(finalize_dirs(copy.deepcopy(cfg))))[scene]
    st, lines = StageTimer(), []
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = mg.run(sub, engine=engine, print_fn=lines.append, stage_timer=st)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ev = sub.eval
    modular = bool(ev.get("store_pc", False))
    step = "sample_decode" if modular else "fused_eval_step"
    frames = st.counts.get(step, 0)
    check(frames == n_frames, f"eval {label} {scene}: {frames} frames evaluated, "
                              f"want {n_frames} ({st.counts})")
    for k in ("loss", "iou", "accuracy", "cd", "fscore"):
        check(math.isfinite(stats[k]), f"eval {label} {scene}: {k} = {stats[k]}")
    per_batch = _per_nfe_cfg(sub) + int((sub.lidar_ae.get("overrides") or {}).get("depth", 24))
    want = {name: 0 for name in KERNEL_NAMES}
    want["fused_ln_geglu_residual"] = frames * per_batch
    want["nn_min_sq_both"] = frames
    _check_counts(counts, want, f"eval {label} {scene}")
    points = []
    if modular:
        d = Path(ev.store_base_dir) / ev.exp_name / seq / ev.save_pc_dir_name
        got = sorted(p.name for p in d.glob("*.ply"))
        check(got == [f"{i:04d}.ply" for i in range(n_frames)], f"eval {label}: PLY files {got}")
        points = [len(read_ply(d / f)) for f in got]
        check(all(n > 0 for n in points), f"eval {label} {scene}: empty clouds {points}")
    eval_s = sum(st.seconds.values())
    line = {"mode": label, "scene": scene, "frames": frames, "wall_s": wall,
            "build_load_s": wall - eval_s, "eval_s": eval_s, "s_per_frame": eval_s / frames,
            "stage_ms": {k: round(v * 1e3, 3) for k, v in st.report().items()},
            "stage_calls": st.counts, "stats": stats, "ply_points": points,
            "launches_per_batch": {k: v // frames for k, v in counts.items() if v},
            "nn_split": getattr(nn_min_sq_both, "split", None),
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "loaded": [l for l in lines if l.startswith(("Loaded", "WARNING"))],
            "device": smi_line()}
    print("[eval] " + json.dumps(line))
    return line


def _per_nfe_cfg(cfg) -> int:
    inf = cfg.eval.get("inference", {})
    depth = int((cfg.ar_model.get("overrides") or {}).get("depth", 24))
    return (2 * int(inf.get("num_steps", 18)) - 1) * depth


def _numpy_prior(seeds, n_latents, channels, device):
    """The reference's injected prior: one numpy stream per seed."""
    return torch.from_numpy(np.stack([
        np.random.default_rng(int(s)).standard_normal((n_latents, channels)).astype(np.float32)
        for s in seeds])).to(device)


def _eval_reference(scenes: dict) -> dict:
    """The modular evaluate at depth 2 / 4 steps in float32 (``matmul_precision:
    highest``), on frame 0 of scene a, once on the card through the kernels
    and once on the CPU through their plain versions, with the same weights
    and the same injected numpy prior. Loss and accuracy / IoU on the eval
    queries agree within 1e-3 (a query whose logit sits within rounding of
    0 may flip: 1/16000 each); the refined clouds, drawn from the host
    stream after the threshold, within 2 % in point count."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.eval.ply import read_ply
    from rald_torch.train.gen_engine import GenerationEngine

    out = {}
    for device in ("cuda", "cpu"):
        cfg = _eval_cfg(PRODUCT_CFG, f"reference_{device}", compute_dtype="float32",
                        matmul_precision="highest")
        cfg.dataset.split_file = "split_scene_a.json"
        cfg.dataset.query_aug_num = 65536
        cfg.ar_model.overrides = {**(cfg.ar_model.get("overrides") or {}), "depth": 2}
        cfg.lidar_ae.overrides = {**(cfg.lidar_ae.get("overrides") or {}), "depth": 2}
        cfg.eval.freq = EVAL_FRAMES  # frame 0 only
        cfg.eval.inference.update(num_steps=4, num_query_points=65536, refine_query_aug_num=65536)
        eng = GenerationEngine(cfg, device=device)
        eng.draw_prior = _numpy_prior
        if device == "cuda":
            _center_occupancy(eng, _eval_cubes(cfg, "scene_a")[:1])
            weights = [{k: v.cpu() for k, v in m.state_dict().items()} for m in (eng.model, eng.vae)]
        else:
            eng.load_state_dicts(*weights)
        t0 = time.perf_counter()
        stats = mg.run(cfg, engine=eng, print_fn=lambda *_: None)
        ply = Path(cfg.eval.store_base_dir) / cfg.eval.exp_name / scenes["scene_a"] / \
            cfg.eval.save_pc_dir_name / "0000.ply"
        out[device] = {"stats": stats, "points": len(read_ply(ply)),
                       "seconds": time.perf_counter() - t0}
        del eng
    card, cpu = out["cuda"], out["cpu"]
    line = {"mode": "reference depth 2 f32", "card": card, "cpu": cpu}
    print("[eval] " + json.dumps(line))
    for k in ("loss", "iou", "accuracy"):
        a, b = card["stats"][k], cpu["stats"][k]
        check(abs(a - b) <= 1e-3 * max(1.0, abs(b)), f"eval reference: {k} card {a} vs CPU {b}")
    check(card["points"] > 0 and abs(card["points"] - cpu["points"]) <= 0.02 * cpu["points"],
          f"eval reference: PLY points card {card['points']} vs CPU {cpu['points']}")
    return line


def phase_eval() -> dict:
    """The dataset eval entry point at full width (``main_generation.run``
    over the synthetic tree, ``.pth`` weights): (a) the eval YAML as shipped
    (modular path, PLY dumps) over both scenes, (b) with ``store_pc: false``
    (fused path), (c) the frozen-encoder YAML in eval mode on one scene; then
    the depth-2 card-versus-CPU reference. Returns the runs by label."""
    from rald_torch.train.gen_engine import GenerationEngine

    torch.backends.cudnn.allow_tf32 = True  # torch's defaults (phase 5 set "highest")
    torch.set_float32_matmul_precision("highest")
    scenes = _eval_tree()
    runs = {}

    # (b) first: its engine makes the weights, then evaluates with them
    cfg_b = _eval_cfg(PRODUCT_CFG, "fused")
    cfg_b.eval.store_pc = False
    eng = GenerationEngine(cfg_b)
    shift = _center_occupancy(eng, _eval_cubes(cfg_b, "scene_a"))
    paths = _save_weights(eng, "unfrozen")
    print(f"[eval] weights saved (occupancy bias shift {shift:+.6f}): {json.dumps(paths)}")
    _set_ckpts(cfg_b, paths)
    runs["fused"] = [_eval_run(cfg_b, "store_pc=false", s, q, engine=eng) for s, q in scenes.items()]
    del eng
    torch.cuda.empty_cache()

    # (a) the eval YAML as shipped: both scenes, engine built and loaded each time
    cfg_a = _set_ckpts(_eval_cfg(PRODUCT_CFG, "shipped"), paths)
    runs["shipped"] = [_eval_run(cfg_a, "shipped", s, q) for s, q in scenes.items()]
    torch.cuda.empty_cache()

    # (c) the frozen external radar encoder, eval mode, one scene
    cfg_c = _eval_cfg(FROZEN_CFG, "frozen_enc", mode="eval")
    src = GenerationEngine(cfg_c)
    batches = [{**b, "radar_cube": src.encode_radar(b["radar_cube"])}
               for b in _eval_cubes(cfg_c, "scene_a")]
    shift = _center_occupancy(src, batches)
    _set_ckpts(cfg_c, _save_weights(src, "frozen"))
    print(f"[eval] frozen-encoder weights saved (occupancy bias shift {shift:+.6f})")
    del src
    torch.cuda.empty_cache()
    runs["frozen_enc"] = [_eval_run(cfg_c, "frozen_enc", "scene_a", scenes["scene_a"])]
    check(any(l.startswith("Loaded frozen radar encoder") for l in runs["frozen_enc"][0]["loaded"]),
          f"eval frozen_enc: {runs['frozen_enc'][0]['loaded']}")
    torch.cuda.empty_cache()
    runs["reference"] = _eval_reference(scenes)
    return runs


# --------------------------------------------------------------- phase 7
TRAIN_CFG = REPO / "configs" / "generation" / "ge_indoor_unfreeze_enc_ints_only.yml"
TRAIN_DIR = SCRATCH / "train"  # tree, outputs and checkpoints of the training phase
TRAIN_TREE = TRAIN_DIR / "coloradar"
TRAIN_SEQS, TRAIN_FRAMES, TEST_FRAMES = 3, 8, 2
# resume: the epoch-1 loss of the resumed run against the uninterrupted run's
# (the draws and the batch order depend on (seed, epoch, step) only, and the
# restored state is bitwise; only nondeterministic cuDNN / atomics
# reductions in the backward can move it), stated before the first run
RESUME_LOSS_REL = 1e-3


def _train_tree() -> None:
    """A synthetic ColoRadar tree at the product's raw shapes (radar (128, 8,
    2), 16000 LiDAR and 512 raw CFAR points a frame): 3 train sequences of 8
    frames and one test sequence of 2 (written apart and moved in), with
    ``split_train.json`` naming it as val and test."""
    import shutil

    from rald_torch.data.synthetic import make_synthetic_coloradar

    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    make_synthetic_coloradar(TRAIN_TREE, num_train_seqs=TRAIN_SEQS, num_eval_seqs=0,
                             frames_per_seq=TRAIN_FRAMES, points_per_frame=16000,
                             radar_shape=(128, 8, 2), helper_points=512, seed=31)
    make_synthetic_coloradar(TRAIN_DIR / "test_tree", num_train_seqs=0, num_eval_seqs=1,
                             frames_per_seq=TEST_FRAMES, points_per_frame=16000,
                             radar_shape=(128, 8, 2), helper_points=512, seed=32)
    test = json.loads((TRAIN_DIR / "test_tree" / "split_synth.json").read_text())["test"][0]
    shutil.move(str(TRAIN_DIR / "test_tree" / test), str(TRAIN_TREE / "synth_test"))
    train = json.loads((TRAIN_TREE / "split_synth.json").read_text())["train"]
    (TRAIN_TREE / "split_train.json").write_text(
        json.dumps({"train": train, "val": ["synth_test"], "test": ["synth_test"]}))
    _dump_voxels(TRAIN_TREE)


def _train_cfg(path: Path, label: str, **train):
    """A shipped training YAML pointed at the synthetic tree, outputs under
    build/: ``train`` keys replaced, the frozen VAE and radar encoder from
    phase 6's ``.pth`` files."""
    from rald_torch.config import load_config

    cfg = load_config(path)
    out = TRAIN_DIR / label
    cfg.dataset.root_dir = str(TRAIN_TREE)
    cfg.dataset.split_file = "split_train.json"
    cfg.system.update(output_dir=str(out / "result"), log_dir=str(out / "log"))
    cfg.train.update({"epochs": 2, "save_ckpt_freq": 1, "eval_freq": 2, **train})
    cfg.lidar_ae.cache_path = str(TRAIN_DIR / "latent_cache")
    ckpt = SCRATCH / "eval" / "ckpt"
    cfg.lidar_ae.ckpt = str(ckpt / ("frozen_vae.pth" if path == FROZEN_CFG else "unfrozen_vae.pth"))
    cfg.radar_enc.ckpt = str(ckpt / "frozen_radar_ae.pth")
    return cfg


def _phase6_weights() -> None:
    """Phase 6's ``.pth`` files, written here when phase 7 runs alone."""
    from rald_torch.train.gen_engine import GenerationEngine

    d = SCRATCH / "eval" / "ckpt"
    for label, path in (("unfrozen", PRODUCT_CFG), ("frozen", FROZEN_CFG)):
        if not (d / f"{label}_vae.pth").exists():
            eng = GenerationEngine(_eval_cfg(path, label))
            _save_weights(eng, label)
            del eng


def _records(cfg) -> list:
    return [json.loads(l) for l in (Path(cfg.system.output_dir) / "log.txt").read_text().splitlines()]


def _counted(eng, name: str, deltas: list):
    """Wrap ``eng.<name>`` so each call appends the launch counts it moved."""
    from rald_torch.ops import launch_counts

    fn = getattr(eng, name)

    def wrapped(*a, **k):
        before = launch_counts()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        deltas.append({n: c - before[n] for n, c in launch_counts().items()})
        return out

    setattr(eng, name, wrapped)


def _train_product() -> dict:
    """(a) the shipped training YAML at full width through
    ``main_generation.run``: 2 epochs of 3 steps, a checkpoint an epoch,
    EMA evaluation after epoch 2 on the 2-frame test scene; then the
    resume from ``checkpoint-0.pth`` and the eval CLI's EMA load."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.ops import reset_launch_counts
    from rald_torch.train.checkpoint import CheckpointManager
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _train_cfg(TRAIN_CFG, "product")
    cfg.eval.use_test_set = True
    eng = GenerationEngine(cfg)
    captured, train_d, eval_d = {}, [], []
    init = eng.init_state

    def init_state(*a):
        st = captured["state"] = init(*a)
        captured["start"] = {k: v.detach().clone() for k, v in st.params.items()}
        return st

    eng.init_state = init_state
    _counted(eng, "train_one_epoch", train_d)
    _counted(eng, "evaluate", eval_d)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    mg.run(cfg, engine=eng, print_fn=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, records = captured["state"], _records(cfg)
    out = Path(cfg.system.output_dir)
    for r in records:
        check(math.isfinite(r["train_loss"]) and math.isfinite(r["train_grad_norm"]),
              f"train: non-finite record {r}")
    check([r["epoch"] for r in records] == [0, 1], f"train: epochs {records}")
    check("val_loss" in records[1] and math.isfinite(records[1]["val_loss"]),
          f"train: eval record {records[1]}")
    check(st.step == 2 * 3 and st.count == 6, f"train: step {st.step}, count {st.count}")
    for k in ("model.proj_out.weight", "model.transformer_blocks.0.ff.net.0.proj.weight"):
        ema, p, p0 = st.ema_params[k], st.params[k], captured["start"][k]
        check(not torch.equal(ema, p0) and not torch.equal(ema, p), f"train: EMA of {k} did not move")
    check(all((out / f"checkpoint-{e}.pth").exists() for e in (0, 1)), "train: checkpoints missing")
    check(all(all(v == 0 for v in d.values()) for d in train_d),
          f"train: kernels launched over the train steps {train_d}")
    n_eval = TEST_FRAMES  # eval_batch_size 1
    want = {n: 0 for n in KERNEL_NAMES}
    want.update(fused_ln_geglu_residual=864 * n_eval, nn_min_sq_both=n_eval)
    check(len(eval_d) == 1, f"train: {len(eval_d)} evaluations")
    _check_counts(eval_d[0], want, "train-mode eval")

    # save -> restore round trip, bitwise
    fresh = eng.init_state(3, 8)
    CheckpointManager(out).restore(fresh, out / "checkpoint-1.pth")
    a, b = st.opt_state(), fresh.opt_state()
    for k in st.params:
        for x, y in ((st.params[k], fresh.params[k]), (st.ema_params[k], fresh.ema_params[k]),
                     (a["mu"][k], b["mu"][k]), (a["nu"][k], b["nu"][k])):
            check(torch.equal(x, y), f"train: checkpoint round trip differs at {k}")
    check(fresh.step == st.step and fresh.count == st.count, "train: round trip counters")
    # the eval CLI's loader with use_ema: the EMA weights, in the eval dtype
    eval_cfg = _train_cfg(TRAIN_CFG, "product")
    eval_cfg.system.mode, eval_cfg.eval.ckpt = "eval", str(out / "checkpoint-1.pth")
    mg.load_eval_checkpoint(eval_cfg, eng, print_fn=lambda *_: None)
    got = eng.model.state_dict()
    check(all(torch.equal(got[k], v.to(got[k])) for k, v in st.ema_params.items()),
          "train: eval.ckpt with use_ema did not load the EMA weights")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del fresh
    captured.clear()
    torch.cuda.empty_cache()

    # resume from checkpoint-0: epoch 1 only, its loss as the uninterrupted run's
    rcfg = _train_cfg(TRAIN_CFG, "resumed", resume=str(out / "checkpoint-0.pth"))
    rcfg.eval.use_test_set = True
    lines = []
    t0 = time.perf_counter()
    mg.run(rcfg, engine=eng, print_fn=lines.append)
    resume_s = time.perf_counter() - t0
    rrec = _records(rcfg)
    check([r["epoch"] for r in rrec] == [1] and "resumed from epoch 0" in lines,
          f"train resume: records {rrec}")
    la, lb = records[1]["train_loss"], rrec[0]["train_loss"]
    check(abs(la - lb) <= RESUME_LOSS_REL * abs(la), f"train resume: loss {lb} vs {la}")
    line = {"mode": "product train", "wall_s": wall, "steps": st.step,
            "records": records, "resumed_record": rrec[0], "resume_wall_s": resume_s,
            "resume_loss_rel_diff": abs(la - lb) / abs(la), "peak_gib": peak,
            "train_step_launches": {k: sum(d[k] for d in train_d) for k in KERNEL_NAMES},
            "eval_launches_per_batch": {k: v // n_eval for k, v in eval_d[0].items() if v},
            "device": smi_line()}
    print("[train] " + json.dumps(line))
    for label in ("product", "resumed"):
        for f in (TRAIN_DIR / label / "result").glob("checkpoint-*.pth"):
            f.unlink()
    # the resumed run's state, which the engine's training model belongs to
    return {"line": line, "engine": eng, "state": captured["state"], "cfg": cfg}


def _train_card_vs_cpu() -> dict:
    """(b) the training path at depth 2 (DiT and VAE), width unchanged, in
    float32 with ``matmul_precision: highest``, batch 2: 3 steps on the card
    and on the CPU from the same JAX-init weights, the same batch and the
    same injected draws (posterior noise, sigma, noise)."""
    from rald_torch import apply_matmul_precision
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.gen_engine import GenerationEngine
    from rald_torch.train.state import global_norm

    apply_matmul_precision("highest")
    bsz, steps = 2, 3
    runs = {}
    batch = None
    for device in ("cuda", "cpu"):
        cfg = _train_cfg(TRAIN_CFG, f"f32_{device}")
        cfg.system.compute_dtype = "float32"
        cfg.dataset.batch_size = bsz
        for sec in (cfg.ar_model, cfg.lidar_ae):
            sec.overrides = {**(sec.get("overrides") or {}), "depth": 2}
        eng = GenerationEngine(cfg, device=device)
        state = eng.init_state(steps, bsz)
        if batch is None:
            batch = next(iter(mg.build_train_loader(cfg, print_fn=lambda *_: None)))
        rng = np.random.default_rng(41)
        t0 = time.perf_counter()
        out = {"loss": [], "grad_norm": []}
        shape = (bsz, eng.vae.num_latents, eng.vae.latent_dim)
        for k in range(steps):
            eps = rng.standard_normal(shape).astype(np.float32)
            rnd = torch.from_numpy(rng.standard_normal((bsz, 1, 1)).astype(np.float32)).to(device)
            noise = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(device)
            latents, cube = eng.prepare_inputs(batch, eps=eps)
            if k == 0:
                loss, grads = eng.loss_and_grads(latents, cube, rnd=rnd, noise=noise)
                out["grads"] = {n: g.cpu() for n, g in grads.items()}
                metrics = {"loss": loss, "grad_norm": global_norm(grads.values())}
                state.apply_gradients(grads)
            else:
                state, metrics = eng.train_step(state, latents, cube, rnd=rnd, noise=noise)
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
        out["seconds"] = time.perf_counter() - t0
        out["params"] = {n: v.cpu() for n, v in state.params.items()}
        out["ema"] = {n: v.cpu() for n, v in state.ema_params.items()}
        out["lr"] = eng.lr_schedule
        runs[device] = out
        del eng, state
        torch.cuda.empty_cache()
    card, cpu = runs["cuda"], runs["cpu"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss_rel = max(rel(a, b) for a, b in zip(card["loss"], cpu["loss"]))
    norm_rel = max(rel(a, b) for a, b in zip(card["grad_norm"], cpu["grad_norm"]))
    gmax = max(float(g.abs().max()) for g in cpu["grads"].values())
    grad_rel = max(float((card["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-2 * gmax)
                   for n, g in cpu["grads"].items())
    lr = max(cpu["lr"](c) for c in range(steps + 1))
    p_abs = max(float((card["params"][n] - v).abs().max()) for n, v in cpu["params"].items())
    e_abs = max(float((card["ema"][n] - v).abs().max()) for n, v in cpu["ema"].items())
    line = {"mode": "train card vs CPU, depth 2, f32 highest", "batch": bsz, "steps": steps,
            "loss_card": card["loss"], "loss_cpu": cpu["loss"], "grad_norm_card": card["grad_norm"],
            "grad_norm_cpu": cpu["grad_norm"], "max_loss_rel": loss_rel,
            "max_grad_norm_rel": norm_rel, "max_grad_rel_of_tensor_max": grad_rel,
            "lr": lr, "max_param_abs": p_abs, "max_ema_abs": e_abs,
            "seconds_card": card["seconds"], "seconds_cpu": cpu["seconds"]}
    print("[train] " + json.dumps(line))
    check(loss_rel <= 1e-4 and norm_rel <= 1e-4, f"train card vs CPU: loss / norm {line}")
    check(grad_rel <= 1e-4, f"train card vs CPU: gradients {grad_rel}")
    check(p_abs <= 3 * lr and e_abs <= 3 * lr, f"train card vs CPU: params {p_abs}, EMA {e_abs}, lr {lr}")
    torch.backends.cudnn.allow_tf32 = True  # torch's defaults again
    torch.set_float32_matmul_precision("highest")
    return line


def _train_frozen_and_cache() -> dict:
    """(c) the frozen-encoder YAML in train mode for one epoch; then
    ``main_cache`` over the train split and one epoch from the cache."""
    from rald_torch.cli import main_cache
    from rald_torch.cli import main_generation as mg

    out = {}
    for label, path, extra in (("frozen_enc", FROZEN_CFG, {}),
                               ("cache", TRAIN_CFG, {"use_cache_latent": True})):
        if label == "cache":
            t0 = time.perf_counter()
            cache = main_cache.run(_train_cfg(TRAIN_CFG, "cache_write"), print_fn=lambda *_: None)
            files = sorted(cache.glob("*/*.npz"))
            check(len(files) == TRAIN_SEQS * TRAIN_FRAMES, f"main_cache: {len(files)} files")
            out["cache_s"] = time.perf_counter() - t0
            out["cache_files"] = len(files)
        cfg = _train_cfg(path, label, epochs=1, eval_freq=0, **extra)
        lines = []
        t0 = time.perf_counter()
        mg.run(cfg, print_fn=lines.append)
        rec = _records(cfg)
        check(len(rec) == 1 and math.isfinite(rec[0]["train_loss"]), f"train {label}: {rec}")
        if label == "frozen_enc":
            check(any(l.startswith("Loaded frozen radar encoder") for l in lines),
                  f"train {label}: {[l for l in lines if 'radar' in l]}")
        out[label] = {"wall_s": time.perf_counter() - t0, "record": rec[0]}
        for f in Path(cfg.system.output_dir).glob("checkpoint-*.pth"):
            f.unlink()
        torch.cuda.empty_cache()
    print("[train] " + json.dumps({"mode": "frozen encoder, cache", **out}))
    return out


def _train_timing(prod: dict) -> dict:
    """(d) step time at (a)'s configuration, on (a)'s engine and state: the
    median of 6 warm steps (each ended by a synchronise) and frames/s; the
    synchronised split of 5 more; peak memory; and the device idle share of
    3 steps traced by ``torch.profiler``."""
    from torch.profiler import ProfilerActivity, profile

    from rald_torch.cli import main_generation as mg

    eng, st, cfg = prod["engine"], prod["state"], prod["cfg"]
    batch = next(iter(mg.build_train_loader(cfg, print_fn=lambda *_: None)))
    bsz = len(batch["lidar_points"])

    def step(it, timings=None):
        latents, cube = eng.prepare_inputs(batch, eng.step_generator(9, it, 99), timings=timings)
        eng.train_step(st, latents, cube, eng.step_generator(9, it), timings=timings)
        torch.cuda.synchronize()

    for it in range(2):
        step(it)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for it in range(6):
        t0 = time.perf_counter()
        step(it)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    splits = []
    for it in range(5):
        t = {}
        step(it, t)
        splits.append(t)
    split = {k: float(np.median([t[k] for t in splits])) for k in splits[0]}
    t0 = time.perf_counter()
    for it in range(3):
        step(it)
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in range(3):
            step(it)
    busy, kernels, top = _device_busy_us(prof)
    med = float(np.median(ms))
    line = {"mode": "product train timing", "batch": bsz, "step_ms": ms, "median_step_ms": med,
            "frames_per_s": bsz / med * 1e3, "split_ms": split, "peak_gib": peak,
            "device_busy_ms_3_steps": busy / 1e3, "wall_ms_3_steps": wall,
            "device_idle_share": 1.0 - busy / 1e3 / wall, "kernels_3_steps": kernels,
            "top_kernels_ms_3_steps": top, "device": smi_line()}
    print("[train] " + json.dumps(line))
    return line


def phase_train() -> dict:
    """Training (phase 7): (a) product training, (d) its timing, (b) card
    against CPU, (c) the frozen encoder and the latent cache."""
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    _phase6_weights()
    _train_tree()
    prod = _train_product()
    timing = _train_timing(prod)
    del prod["engine"], prod["state"]
    torch.cuda.empty_cache()
    ref = _train_card_vs_cpu()
    cache = _train_frozen_and_cache()
    return {"product": prod["line"], "timing": timing, "reference": ref, "frozen_cache": cache}


# --------------------------------------------------------------- phase 8
AE_CFG = REPO / "configs" / "ae" / "ae_indoor_aniso_mix_view_cone.yml"
AE_EVAL_CFG = REPO / "configs" / "ae" / "ae_indoor_aniso_mix_view_cone_eval.yml"
AE_DIR = SCRATCH / "ae"  # tree, outputs and checkpoints of the stage-1 phase
AE_TREE = AE_DIR / "coloradar"
AE_TRAIN_SEQS, AE_TRAIN_FRAMES, AE_VAL_FRAMES = 3, 4, 2
AE_FF_PER_FORWARD = 24  # row 1 in each decoder block of one VAE forward


def _ae_tree() -> list:
    """A synthetic ColoRadar tree at the product's raw shapes (16000 LiDAR
    points a frame): 3 train sequences of 4 frames and one val sequence of
    2 (written apart and moved in), ``split_ae.json`` naming it as val and
    one split file per scene of the eval YAML's sweep, each naming it too.
    Returns the sweep's scenes."""
    import shutil

    from rald_torch.config import load_config
    from rald_torch.data.synthetic import make_synthetic_coloradar

    shutil.rmtree(AE_DIR, ignore_errors=True)
    make_synthetic_coloradar(AE_TREE, num_train_seqs=AE_TRAIN_SEQS, num_eval_seqs=0,
                             frames_per_seq=AE_TRAIN_FRAMES, points_per_frame=16000,
                             radar_shape=(128, 8, 2), seed=51)
    make_synthetic_coloradar(AE_DIR / "val_tree", num_train_seqs=0, num_eval_seqs=1,
                             frames_per_seq=AE_VAL_FRAMES, points_per_frame=16000,
                             radar_shape=(128, 8, 2), seed=52)
    val = json.loads((AE_DIR / "val_tree" / "split_synth.json").read_text())["val"][0]
    shutil.move(str(AE_DIR / "val_tree" / val), str(AE_TREE / "synth_val"))
    split = {"train": json.loads((AE_TREE / "split_synth.json").read_text())["train"],
             "val": ["synth_val"], "test": ["synth_val"]}
    (AE_TREE / "split_ae.json").write_text(json.dumps(split))
    _dump_voxels(AE_TREE)
    scenes = list(load_config(AE_EVAL_CFG).dataset.split_file)
    for scene in scenes:
        (AE_TREE / f"split_{scene}.json").write_text(json.dumps(split))
    return scenes


def _ae_cfg(path: Path, label: str, **train):
    """A shipped stage-1 YAML pointed at the synthetic tree, outputs under
    build/: ``train`` keys replaced."""
    from rald_torch.config import load_config

    cfg = load_config(path)
    out = AE_DIR / label
    cfg.dataset.root_dir = str(AE_TREE)
    cfg.dataset.split_file = "split_ae.json"
    cfg.system.update(output_dir=str(out / "result"), log_dir=str(out / "log"))
    cfg.train.update({"epochs": 2, "save_ckpt_freq": 1, "eval_freq": 2, **train})
    return cfg


def _ae_product() -> dict:
    """(a) the shipped stage-1 YAML at full width through ``main_ae.run``: 2
    epochs of 3 steps, a checkpoint an epoch, evaluation after epoch 2 on
    the 2-frame val split; then the checkpoint round trip and the resume
    from ``checkpoint-0.pth``."""
    from rald_torch.cli import main_ae
    from rald_torch.ops import reset_launch_counts
    from rald_torch.train.ae_engine import AEEngine
    from rald_torch.train.checkpoint import CheckpointManager

    cfg = _ae_cfg(AE_CFG, "product")
    eng = AEEngine(cfg)
    check(eng.model_eval.use_fused_ff and eng.model_eval.fold_decode_tail,
          "ae: the eval model lacks the fused FF / folded decode")
    captured, train_d, eval_d = {}, [], []
    init = eng.init_state

    def init_state(*a):
        st = captured["state"] = init(*a)
        captured["start"] = {k: v.detach().clone() for k, v in st.params.items()}
        return st

    eng.init_state = init_state
    _counted(eng, "train_one_epoch", train_d)
    _counted(eng, "evaluate", eval_d)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    main_ae.run(cfg, engine=eng, print_fn=lambda *_: None)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    st, records = captured["state"], _records(cfg)
    out = Path(cfg.system.output_dir)
    for r in records:
        check(all(math.isfinite(r[f"train_{k}"]) for k in
                  ("loss", "loss_vol", "loss_near", "loss_kl", "grad_norm")),
              f"ae: non-finite record {r}")
    check([r["epoch"] for r in records] == [0, 1], f"ae: epochs {records}")
    check(all(math.isfinite(records[1][f"val_{k}"]) for k in ("loss", "iou", "accuracy")),
          f"ae: eval record {records[1]}")
    check(st.step == 2 * 3 and st.count == 6, f"ae: step {st.step}, count {st.count}")
    for k in ("to_outputs.weight", "layers.0.1.fn.net.0.weight", "s_latents.weight"):
        ema, p, p0 = st.ema_params[k], st.params[k], captured["start"][k]
        check(not torch.equal(ema, p0) and not torch.equal(ema, p), f"ae: EMA of {k} did not move")
    check(all((out / f"checkpoint-{e}.pth").exists() for e in (0, 1)), "ae: checkpoints missing")
    check(all(all(v == 0 for v in d.values()) for d in train_d),
          f"ae: kernels launched over the train steps {train_d}")
    n_eval = AE_VAL_FRAMES  # eval_batch_size 1
    want = {n: 0 for n in KERNEL_NAMES}
    want.update(fused_ln_geglu_residual=2 * AE_FF_PER_FORWARD * n_eval, nn_min_sq_both=n_eval)
    check(len(eval_d) == 1, f"ae: {len(eval_d)} evaluations")
    _check_counts(eval_d[0], want, "ae eval")

    # save -> restore round trip, bitwise
    fresh = eng.init_state(3, 4)
    CheckpointManager(out).restore(fresh, out / "checkpoint-1.pth")
    a, b = st.opt_state(), fresh.opt_state()
    for k in st.params:
        for x, y in ((st.params[k], fresh.params[k]), (st.ema_params[k], fresh.ema_params[k]),
                     (a["mu"][k], b["mu"][k]), (a["nu"][k], b["nu"][k])):
            check(torch.equal(x, y), f"ae: checkpoint round trip differs at {k}")
    check(fresh.step == st.step and fresh.count == st.count, "ae: round trip counters")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del fresh
    torch.cuda.empty_cache()

    # resume from checkpoint-0: epoch 1 only, its loss as the uninterrupted run's
    rcfg = _ae_cfg(AE_CFG, "resumed", resume=str(out / "checkpoint-0.pth"))
    lines = []
    t0 = time.perf_counter()
    main_ae.run(rcfg, engine=eng, print_fn=lines.append)
    resume_s = time.perf_counter() - t0
    rrec = _records(rcfg)
    check([r["epoch"] for r in rrec] == [1] and "resumed from epoch 0" in lines,
          f"ae resume: records {rrec}")
    la, lb = records[1]["train_loss"], rrec[0]["train_loss"]
    check(abs(la - lb) <= RESUME_LOSS_REL * abs(la), f"ae resume: loss {lb} vs {la}")
    for f in (AE_DIR / "resumed" / "result").glob("checkpoint-*.pth"):
        f.unlink()
    line = {"mode": "ae product train", "wall_s": wall, "steps": st.step,
            "params_m": eng.param_count(st) / 1e6, "records": records,
            "resumed_record": rrec[0], "resume_wall_s": resume_s,
            "resume_loss_rel_diff": abs(la - lb) / abs(la), "peak_gib": peak,
            "train_step_launches": {k: sum(d[k] for d in train_d) for k in KERNEL_NAMES},
            "eval_launches_per_batch": {k: v // n_eval for k, v in eval_d[0].items() if v},
            "device": smi_line()}
    print("[ae] " + json.dumps(line))
    # the resumed run's state, which the engine's training model belongs to
    return {"line": line, "engine": eng, "state": captured["state"], "cfg": cfg,
            "ckpt": out / "checkpoint-1.pth"}


def _ae_eval_sweep(ckpt: Path, scenes: list) -> dict:
    """(b) the shipped eval YAML in eval mode through ``main_ae.main``: its
    per-scene sweep, each scene's split naming the 2-frame val sequence,
    ``eval.ckpt`` (a)'s ``checkpoint-1.pth``; launches over the whole sweep."""
    import yaml

    from rald_torch.cli import main_ae
    from rald_torch.config import load_config
    from rald_torch.ops import launch_counts, reset_launch_counts

    cfg = load_config(AE_EVAL_CFG)
    out = AE_DIR / "eval"
    cfg.dataset.root_dir = str(AE_TREE)
    cfg.dataset.split_file = {s: f"split_{s}.json" for s in scenes}
    cfg.system.update(output_dir=str(out / "result"), log_dir=str(out / "log"))
    cfg.eval.ckpt = str(ckpt)
    path = AE_DIR / "eval.yml"
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    reset_launch_counts()
    t0 = time.perf_counter()
    results = main_ae.main(["--config", str(path)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts()
    n_eval = AE_VAL_FRAMES * len(scenes)
    want = {n: 0 for n in KERNEL_NAMES}
    want.update(fused_ln_geglu_residual=2 * AE_FF_PER_FORWARD * n_eval, nn_min_sq_both=n_eval)
    _check_counts(counts, want, "ae eval sweep")
    check(sorted(results) == sorted(scenes), f"ae eval sweep: scenes {sorted(results)}")
    exp = cfg.system.expname
    for scene, stats in results.items():
        check(all(math.isfinite(stats[k]) for k in ("loss", "iou", "accuracy"))
              and "cd" in stats and "fscore" in stats, f"ae eval sweep {scene}: {stats}")
        check((out / "result" / exp / scene / "config.yml").exists(), f"ae eval sweep: {scene} config")
    first = results[scenes[0]]
    check(all(r[k] == v or abs(r[k] - v) <= 1e-5 * abs(v)
              for r in results.values() for k, v in first.items()),
          "ae eval sweep: the same split and weights gave other stats")
    line = {"mode": "ae eval sweep", "scenes": len(scenes), "wall_s": wall,
            "s_per_scene": wall / len(scenes), "stats": first,
            "launches_per_batch": {k: v // n_eval for k, v in counts.items() if v},
            "device": smi_line()}
    print("[ae] " + json.dumps(line))
    return line


def _ae_timing(prod: dict) -> dict:
    """(c) step time at (a)'s configuration, on (a)'s engine and state: the
    median of 6 warm steps (each ended by a synchronise) and frames/s; the
    synchronised split of 5 more; peak memory; the device idle share of 3
    steps traced by ``torch.profiler``; and the ms of one evaluated batch
    (two full forwards, 5e5 grid queries, threshold, Chamfer), the median
    of 3 after one warm-up."""
    from torch.profiler import ProfilerActivity, profile

    from rald_torch.cli import main_ae

    eng, st, cfg = prod["engine"], prod["state"], prod["cfg"]
    train_loader, val_loader, _ = main_ae.build_loaders(cfg)
    batch, val_batch = next(iter(train_loader)), next(iter(val_loader))
    bsz = len(batch["lidar_points"])

    def step(it, timings=None):
        eng.train_step(st, batch, eng.step_generator(9, it), timings=timings)
        torch.cuda.synchronize()

    for it in range(2):
        step(it)
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for it in range(6):
        t0 = time.perf_counter()
        step(it)
        ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    splits = []
    for it in range(5):
        t = {}
        step(it, t)
        splits.append(t)
    split = {k: float(np.median([t[k] for t in splits])) for k in splits[0]}
    t0 = time.perf_counter()
    for it in range(3):
        step(it)
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for it in range(3):
            step(it)
    busy, kernels, top = _device_busy_us(prof)
    eval_ms = []
    for _ in range(4):
        t0 = time.perf_counter()
        eng.evaluate(st, [val_batch], print_fn=lambda *_: None)
        torch.cuda.synchronize()
        eval_ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    line = {"mode": "ae train timing", "batch": bsz, "step_ms": ms, "median_step_ms": med,
            "frames_per_s": bsz / med * 1e3, "split_ms": split, "peak_gib": peak,
            "device_busy_ms_3_steps": busy / 1e3, "wall_ms_3_steps": wall,
            "device_idle_share": 1.0 - busy / 1e3 / wall, "kernels_3_steps": kernels,
            "top_kernels_ms_3_steps": top, "eval_batch_ms": eval_ms[1:],
            "median_eval_batch_ms": float(np.median(eval_ms[1:])), "device": smi_line()}
    print("[ae] " + json.dumps(line))
    return line


def _ae_card_vs_cpu() -> dict:
    """(d) the training path at depth 2, width unchanged, in float32 with
    ``matmul_precision: highest``, batch 2: 3 steps on the card and on the
    CPU from the same JAX-init weights, the same batch and the same injected
    draws (posterior noise and drop-path masks, from numpy)."""
    from rald_torch import apply_matmul_precision
    from rald_torch.cli import main_ae
    from rald_torch.train.ae_engine import AEEngine
    from rald_torch.train.state import global_norm

    apply_matmul_precision("highest")
    bsz, steps = 2, 3
    runs = {}
    batch = None
    for device in ("cuda", "cpu"):
        cfg = _ae_cfg(AE_CFG, f"f32_{device}")
        cfg.system.compute_dtype = "float32"
        cfg.dataset.batch_size = bsz
        cfg.lidar_ae.overrides = {**(cfg.lidar_ae.get("overrides") or {}), "depth": 2}
        eng = AEEngine(cfg, device=device)
        state = eng.init_state(steps, bsz)
        if batch is None:
            batch = next(iter(main_ae.build_loaders(cfg)[0]))
        sites = sorted(eng.train_model.drop_paths())
        rng = np.random.default_rng(41)
        t0 = time.perf_counter()
        out = {"loss": [], "grad_norm": []}
        for k in range(steps):
            eps = rng.standard_normal((bsz, eng.train_model.num_latents,
                                       eng.train_model.latent_dim)).astype(np.float32)
            masks = {s: torch.from_numpy(rng.random(bsz) >= 0.1) for s in sites}
            masks[sites[k]] = torch.tensor([True, False])  # a drop in every step
            if k == 0:
                metrics, grads = eng.loss_and_grads(batch, eps=eps, drop_masks=masks)
                out["grads"] = {n: g.detach().cpu().clone() for n, g in grads.items()}
                metrics["grad_norm"] = global_norm(grads.values())
                state.apply_gradients(grads)
            else:
                state, metrics = eng.train_step(state, batch, eps=eps, drop_masks=masks)
            out["loss"].append(float(metrics["loss"]))
            out["grad_norm"].append(float(metrics["grad_norm"]))
        out["seconds"] = time.perf_counter() - t0
        out["params"] = {n: v.cpu() for n, v in state.params.items()}
        out["ema"] = {n: v.cpu() for n, v in state.ema_params.items()}
        out["lr"] = eng.lr_schedule
        runs[device] = out
        del eng, state
        torch.cuda.empty_cache()
    card, cpu = runs["cuda"], runs["cpu"]
    rel = lambda a, b: abs(a - b) / max(abs(b), 1e-30)
    loss_rel = max(rel(a, b) for a, b in zip(card["loss"], cpu["loss"]))
    norm_rel = max(rel(a, b) for a, b in zip(card["grad_norm"], cpu["grad_norm"]))
    gmax = max(float(g.abs().max()) for g in cpu["grads"].values())
    grad_rel = max(float((card["grads"][n] - g).abs().max()) / max(float(g.abs().max()), 1e-2 * gmax)
                   for n, g in cpu["grads"].items())
    lr = max(cpu["lr"](c) for c in range(steps + 1))
    p_abs = max(float((card["params"][n] - v).abs().max()) for n, v in cpu["params"].items())
    e_abs = max(float((card["ema"][n] - v).abs().max()) for n, v in cpu["ema"].items())
    line = {"mode": "ae train card vs CPU, depth 2, f32 highest", "batch": bsz, "steps": steps,
            "loss_card": card["loss"], "loss_cpu": cpu["loss"], "grad_norm_card": card["grad_norm"],
            "grad_norm_cpu": cpu["grad_norm"], "max_loss_rel": loss_rel,
            "max_grad_norm_rel": norm_rel, "max_grad_rel_of_tensor_max": grad_rel,
            "lr": lr, "max_param_abs": p_abs, "max_ema_abs": e_abs,
            "seconds_card": card["seconds"], "seconds_cpu": cpu["seconds"]}
    print("[ae] " + json.dumps(line))
    check(loss_rel <= 1e-4 and norm_rel <= 1e-4, f"ae card vs CPU: loss / norm {line}")
    check(grad_rel <= 1e-4, f"ae card vs CPU: gradients {grad_rel}")
    check(p_abs <= 3 * lr and e_abs <= 3 * lr, f"ae card vs CPU: params {p_abs}, EMA {e_abs}, lr {lr}")
    torch.backends.cudnn.allow_tf32 = True  # torch's defaults again
    torch.set_float32_matmul_precision("highest")
    return line


def phase_ae() -> dict:
    """Stage-1 VAE training (phase 8): (a) product training, (c) its timing,
    (b) the eval YAML's sweep on (a)'s checkpoint, (d) card against CPU."""
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    scenes = _ae_tree()
    prod = _ae_product()
    timing = _ae_timing(prod)
    del prod["engine"], prod["state"]
    torch.cuda.empty_cache()
    sweep = _ae_eval_sweep(prod["ckpt"], scenes)
    for f in (AE_DIR / "product" / "result").glob("checkpoint-*.pth"):
        f.unlink()
    ref = _ae_card_vs_cpu()
    return {"product": prod["line"], "timing": timing, "sweep": sweep, "reference": ref}


# --------------------------------------------------------------- phase 9
PREP_DIR = SCRATCH / "prep"  # raw and processed trees, voxel caches and YAMLs of phase 9
PREP_SEQS = ("prep_train", "prep_test")  # train and test sequence of the split file
PREP_SPLIT = "split_prep.json"
PREP_RAW_FRAMES, PREP_INDEX = 8, (0, 1, 3, 4, 6, 7)  # raw frames a sequence, the aligned ones
LIDAR_SWEEP = 65536  # returns of one Ouster OS1-64 sweep (64 beams x 1024 columns)
CONE_DIR = "cone_sc_0.05_0.25_0.5"  # dump_voxel --mode sc_cone at the shipped voxel size
# card against CPU, stated before the first run: the CPU tests' bars against
# JAX (raeivv_map: dB within 1e-3 abs, velocity and validity equal on >= 99 %
# of cells; cfar_points_from_cube: equal budgets, >= 99.9 % shared cells;
# the CFAR detectors: masks equal, values within 1e-5 relative)
RAE_DB_ABS, RAE_AGREE, CFAR_SHARED, CFAR_REL = 1e-3, 0.99, 0.999, 1e-5


def _dev_ms(fn, dev, iters: int = 5) -> float:
    """Device ms per call (CUDA events); host ms where ``dev`` is the CPU."""
    if torch.device(dev).type == "cuda":
        return cuda_ms(fn, iters, warmup=1)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) * 1e3 / iters


def _adc_frame(rng, params, txl, rxl, targets: np.ndarray) -> np.ndarray:
    """One int16 ADC frame (ntx, nrx, nc, ns, 2): each target (range m,
    azimuth rad, elevation rad, velocity m/s, amplitude) a beat tone at its
    range, a doppler phase ramp over each TX's chirps and a steering phase
    over the virtual array, plus complex noise."""
    ntx, nrx, nc, ns = params.num_tx, params.num_rx, params.num_chirps, params.num_adc_samples
    taz, tel, raz, rel = np.zeros(ntx), np.zeros(ntx), np.zeros(nrx), np.zeros(nrx)
    taz[txl[:, 0]], tel[txl[:, 0]] = txl[:, 1], txl[:, 2]
    raz[rxl[:, 0]], rel[rxl[:, 0]] = rxl[:, 1], rxl[:, 2]
    r, az, el, v, amp = targets.T
    vmax = (3e8 / params.start_frequency) / (4 * params.chirp_time * ntx)
    tone = np.exp(2j * np.pi * (r / params.max_range)[:, None] * np.arange(ns))
    chirp = np.arange(nc)[None, :] + np.arange(ntx)[:, None] / ntx  # (ntx, nc) in chirp periods
    dopp = np.exp(1j * np.pi * (v / vmax)[:, None, None] * chirp)
    pos_az = taz[:, None] + raz[None, :]
    pos_el = tel[:, None] + rel[None, :]
    steer = np.exp(1j * np.pi * ((np.sin(az) * np.cos(el))[:, None, None] * pos_az
                                 + np.sin(el)[:, None, None] * pos_el))
    sig = np.einsum("k,kab,kac,kd->abcd", amp, steer, dopp, tone, optimize=True)
    sig = sig + rng.normal(scale=8.0, size=sig.shape) + 1j * rng.normal(scale=8.0, size=sig.shape)
    iq = np.stack([sig.real, sig.imag], axis=-1)
    return np.clip(np.round(iq), -32768, 32767).astype(np.int16)


def _lidar_scan(rng, room: np.ndarray, to_lidar: np.ndarray) -> np.ndarray:
    """One LIDAR_SWEEP x 4 float32 scan in the LiDAR frame: the room's
    returns, returns behind the sensor (outside the radar's FOV) and zero
    returns, in random order, with an intensity column."""
    from rald_torch import geometry as geo

    n_zero, n_back = LIDAR_SWEEP // 20, LIDAR_SWEEP // 5
    n_room = LIDAR_SWEEP - n_zero - n_back
    back = room[rng.choice(len(room), n_back)] * np.float32(-1.0)
    pts = np.concatenate([room[:n_room], back])
    scan = np.zeros((LIDAR_SWEEP, 4), np.float32)
    scan[:n_room + n_back, :3] = geo.transform_points(pts, to_lidar)
    scan[:n_room + n_back, 3] = rng.uniform(0, 1, n_room + n_back)
    return scan[rng.permutation(LIDAR_SWEEP)]


def _prep_raw_tree() -> None:
    """(a) the raw ColoRadar-layout tree from seed 91."""
    import shutil

    from rald_torch import geometry as geo
    from rald_torch.constants import T_RADAR_TO_LIDAR
    from rald_torch.data.synthetic import _room_points
    from rald_torch.dsp import RadarParams, parse_antenna_array

    shutil.rmtree(PREP_DIR, ignore_errors=True)
    raw = PREP_DIR / "raw"
    params = RadarParams.from_yaml(REPO / "configs" / "preprocess" / "1843_coloradar.yml")
    txl, rxl = parse_antenna_array(REPO / "configs" / "preprocess" / "antenna_array.txt")
    to_lidar = geo.get_inverse_tf(T_RADAR_TO_LIDAR)
    rng = np.random.default_rng(91)
    for seq in PREP_SEQS:
        for d in ("cascade", "groundtruth", "imu"):
            (raw / seq / d).mkdir(parents=True)
        adc_dir = raw / seq / "single_chip" / "adc_samples" / "data"
        lidar_dir = raw / seq / "lidar" / "pointclouds"
        adc_dir.mkdir(parents=True)
        lidar_dir.mkdir(parents=True)
        for i in range(PREP_RAW_FRAMES):
            room = _room_points(rng, LIDAR_SWEEP)
            while len(room) < LIDAR_SWEEP:
                room = np.concatenate([room, _room_points(rng, LIDAR_SWEEP)])
            _lidar_scan(rng, room, to_lidar).tofile(lidar_dir / f"lidar_pointcloud_{i}.bin")
            polar = geo.cartesian2polar(room[rng.choice(len(room), 24)].astype(np.float64))
            targets = np.column_stack([polar[:, 0], np.radians(polar[:, 1]), np.radians(polar[:, 2]),
                                       rng.normal(scale=0.5, size=24), rng.uniform(20, 80, 24)])
            _adc_frame(rng, params, txl, rxl, targets).tofile(adc_dir / f"frame_{i}.bin")
        for d in (adc_dir.parent, lidar_dir.parent):
            name = "radar_index_sequence.txt" if d == adc_dir.parent else "lidar_index_sequence.txt"
            (d / name).write_text("\n".join(map(str, PREP_INDEX)))
    (raw / "calib").mkdir()
    out = PREP_DIR / "processed"
    out.mkdir()
    (out / PREP_SPLIT).write_text(json.dumps({"train": [PREP_SEQS[0]], "val": [], "test": [PREP_SEQS[1]]}))


def _prep_yaml(src: Path) -> Path:
    """A shipped preprocessing YAML with only its paths replaced."""
    from rald_torch.config import dump_config, load_config

    cfg = load_config(src)
    cfg.root_dir = str(PREP_DIR / "linked")
    cfg.output_dir = str(PREP_DIR / "processed")
    cfg.voxel_output_dir = str(PREP_DIR / "voxel")
    cfg.split_file = PREP_SPLIT
    path = PREP_DIR / src.name
    dump_config(cfg, path)
    return path


def _prep_clis(device=None) -> dict:
    """(b) the five CLIs through their ``main``, in order; wall s per item
    (frame, or sequence for relink) and the peak device memory."""
    from rald_torch.cli import cache_cfar, dump_voxel, preprocess_lidar, preprocess_radar, relink

    cfg, test = str(_prep_yaml(PREP_CFG)), str(_prep_yaml(PREP_TEST_CFG))
    dev = ["--device", device] if device else []
    n, n_test = len(PREP_SEQS) * len(PREP_INDEX), len(PREP_INDEX)
    steps = (("relink", relink.main, ["--src", str(PREP_DIR / "raw"), "--dst", str(PREP_DIR / "linked")],
              len(PREP_SEQS)),
             ("preprocess_lidar", preprocess_lidar.main, ["--config", cfg], n),
             ("preprocess_radar", preprocess_radar.main, ["--config", cfg], n),
             ("preprocess_radar --test-set", preprocess_radar.main, ["--config", test, "--test-set"], n_test),
             ("cache_cfar", cache_cfar.main, ["--config", test], n_test),
             ("dump_voxel --mode sc_cone", dump_voxel.main, ["--config", cfg, "--mode", "sc_cone"], n))
    cuda = torch.cuda.is_available() and device is None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    out = {}
    for name, fn, argv, want in steps:
        t0 = time.perf_counter()
        got = fn(argv + dev)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(got == want, f"prep {name}: {got} items, want {want}")
        out[name] = {"items": got, "wall_s": wall, "s_per_item": wall / got}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30 if cuda else None
    return out


def _prep_check_files() -> dict:
    """(c) every output file, with its shape: LiDAR inside the FOV, finite
    cubes, helper points inside the FOV, voxel dicts, links."""
    from rald_torch import geometry as geo
    from rald_torch.cli.preprocess_lidar import fov_limits
    from rald_torch.config import load_config

    base = PREP_DIR / "processed"
    lo, hi = np.array(fov_limits(load_config(PREP_CFG).single_chip_mode.lidar.FOV)).T
    names = [f"{i:04d}" for i in range(len(PREP_INDEX))]

    def listing(d: Path, suffix: str) -> list:
        got = sorted(d.glob(f"*{suffix}"))
        check([p.stem for p in got] == names, f"prep: {d} holds {[p.name for p in got]}")
        return got

    def in_fov(polar, what):
        check(len(polar) > 0 and bool(((polar >= lo - 1e-3) & (polar <= hi + 1e-3)).all()),
              f"prep: {what} outside the FOV or empty")

    counts = {"lidar_points": [], "cfar_points": [], "voxels": []}
    for seq in PREP_SEQS:
        for f in listing(base / seq / "lidar_sc", ".bin"):
            pts = np.fromfile(f, np.float32)
            check(pts.size % 3 == 0, f"prep: {f} size {pts.size}")
            in_fov(geo.cartesian2polar(pts.reshape(-1, 3)), f)
            counts["lidar_points"].append(pts.size // 3)
        for f in listing(base / seq / "single_chip" / "radarcube_raw", ".bin"):
            cube = np.fromfile(f, np.float32)
            check(cube.size == 128 * 8 * 2 * 3 and np.isfinite(cube).all(), f"prep: {f} size {cube.size}")
        link = base / seq / CONE_DIR
        check(link.is_symlink() and link.resolve() == (PREP_DIR / "voxel" / seq / CONE_DIR).resolve(),
              f"prep: {link} is not the voxel cache's link")
        for f in listing(link, ".npy"):
            d = np.load(f, allow_pickle=True).item()
            check(list(d) == ["voxels", "voxel_coords", "voxel_num_points"]
                  and d["voxel_coords"].dtype == np.int32 and d["voxels"].shape[1:] == (10, 3)
                  and len(d["voxel_coords"]) == len(d["voxels"]) == len(d["voxel_num_points"]) > 0,
                  f"prep: {f} holds {[(k, v.dtype, v.shape) for k, v in d.items()]}")
            counts["voxels"].append(len(d["voxel_coords"]))
    test = base / PREP_SEQS[1] / "single_chip"
    for f in listing(test / "radarcube_high_res", ".bin"):
        cube = np.fromfile(f, np.float32)
        check(cube.size == 128 * 32 * 16 * 3 and np.isfinite(cube).all(), f"prep: {f} size {cube.size}")
    for f in listing(test / "radar_cfar_low_thrd", ".bin"):
        pts = np.fromfile(f, np.float32)
        check(pts.size % 3 == 0 and pts.size // 3 <= 800_000, f"prep: {f} size {pts.size}")
        in_fov(pts.reshape(-1, 3), f)
        counts["cfar_points"].append(pts.size // 3)
    for seq in PREP_SEQS:
        check(sorted(p.name for p in (PREP_DIR / "linked" / seq).iterdir())
              == ["cascade", "groundtruth", "imu", "lidar", "single_chip"], f"prep: relinked {seq}")
    return counts


def _prep_dsp(dev="cuda") -> dict:
    """(c) the DSP on ``dev`` against the CPU, and its times: raeivv_map_batch
    on 8 raw frames of each chirp, cfar_points_from_cube on one high-res
    cube, the three CFAR detectors once."""
    from rald_torch.dsp import (RadarParams, cfar_points_from_cube, mask_real_2d, nq_cfar_2d,
                                os_cfar, parse_antenna_array, rae_interpo, weighted_allocation)
    from rald_torch.dsp.rae import load_adc_frame, raeivv_map_batch

    pre = REPO / "configs" / "preprocess"
    txl, rxl = parse_antenna_array(pre / "antenna_array.txt")
    adc_dir = PREP_DIR / "raw" / PREP_SEQS[0] / "single_chip" / "adc_samples" / "data"
    out = {}
    for label, name in (("train", "1843_coloradar.yml"), ("test_set", "1843_coloradar_test_set.yml")):
        params = RadarParams.from_yaml(pre / name)
        frames = torch.from_numpy(np.stack([load_adc_frame(adc_dir / f"frame_{i}.bin", params)
                                            for i in range(8)]))
        t0 = time.perf_counter()
        cpu = raeivv_map_batch(frames, params, txl, rxl).numpy()
        cpu_s = time.perf_counter() - t0
        fd = frames.to(dev)
        got = raeivv_map_batch(fd, params, txl, rxl).cpu().numpy()
        err = float(np.abs(got[..., 0] - cpu[..., 0]).max())
        vel, val = float((got[..., 1] == cpu[..., 1]).mean()), float((got[..., 2] == cpu[..., 2]).mean())
        check(got.shape == cpu.shape == (8, 128, params.azimuth_fftsize, params.elevation_fftsize, 3)
              and err <= RAE_DB_ABS and vel >= RAE_AGREE and val >= RAE_AGREE,
              f"prep raeivv_map_batch {label}: dB {err}, velocity {vel}, validity {val}")
        out[f"raeivv_{label}"] = {"db_max_abs": err, "velocity_agree": vel, "validity_agree": val,
                                  "ms_per_batch8": _dev_ms(lambda: raeivv_map_batch(fd, params, txl, rxl),
                                                           dev),
                                  "cpu_s_per_batch8": cpu_s}

    cube = np.fromfile(PREP_DIR / "processed" / PREP_SEQS[1] / "single_chip" / "radarcube_high_res"
                       / "0000.bin", np.float32).reshape(128, 32, 16, 3)[..., 0].copy()
    tgt, total, max_range = (256, 256, 128), 800_000, RadarParams.from_yaml(pre / "1843_coloradar.yml").max_range

    def budgets(x):
        up = rae_interpo(x, *tgt)
        return weighted_allocation(up.sum(dim=(1, 2)) / up.sum(), total).cpu().numpy()

    x = torch.from_numpy(cube)
    t0 = time.perf_counter()
    want, _ = cfar_points_from_cube(x, *tgt, total, max_range)
    cpu_s = time.perf_counter() - t0
    xd = x.to(dev)
    got, _ = cfar_points_from_cube(xd, *tgt, total, max_range)
    shared = float((got.cpu() == want).all(dim=1).float().mean())
    same = bool(np.array_equal(budgets(xd), budgets(x)))
    check(same and shared >= CFAR_SHARED, f"prep cfar_points_from_cube: budgets equal {same}, shared {shared}")
    out["cfar_points"] = {"budgets_equal": same, "shared_cells": shared, "cpu_s_per_frame": cpu_s,
                          "ms_per_frame": _dev_ms(lambda: cfar_points_from_cube(xd, *tgt, total, max_range),
                                                  dev)}

    rng = np.random.default_rng(92)
    prof = rng.exponential(size=128).astype(np.float32)
    prof[[20, 70]] = (100.0, 80.0)
    plane = rng.exponential(size=(128, 128)).astype(np.float32)
    plane[[5, 60, 99], [5, 64, 120]] = (500.0, 300.0, 200.0)
    power = rng.exponential(size=(2, 8, 128, 128)).astype(np.float32)
    power[0, 3, 40, 50] = power[1, 6, 90, 17] = 400.0
    p = RadarParams.from_yaml(pre / "1843_coloradar.yml")
    runs = {"os_cfar": lambda a: (os_cfar(a, ws=16, ngc=2, tos=6),),
            "nq_cfar_2d": lambda a: nq_cfar_2d(a, ws=4, ngc=2, quantile=0.75, tos=8),
            "mask_real_2d": lambda a: mask_real_2d(a, p, ws=4, ngc=2, quantile=0.75, tos=2)}
    for (name, fn), arr in zip(runs.items(), (prof, plane, power)):
        a = torch.from_numpy(arr)
        cpu_out, dev_out = fn(a), [t.cpu() for t in fn(a.to(dev))]
        fires = int(cpu_out[0].sum())
        check(fires > 0 and torch.equal(dev_out[0], cpu_out[0]), f"prep {name}: masks differ ({fires} fire)")
        for g, w in zip(dev_out[1:], cpu_out[1:]):
            check(bool(((g - w).abs() <= CFAR_REL * w.abs()).all()), f"prep {name}: values differ")
        out[name] = {"fires": fires}
    return out


def _prep_native_and_items(eval_cfg) -> dict:
    """(c) ``rald_torch.native`` built, its voxelizer bitwise the numpy one
    on a scan; each test frame's ``cache_voxel: true`` item bitwise its
    ``cache_voxel: false`` item (the eval YAML's dataset section)."""
    from rald_torch import geometry as geo
    from rald_torch import native
    from rald_torch.config import Config, load_config
    from rald_torch.data.coloradar import ColoRadarDataset
    from rald_torch.data.voxelizer import voxelize

    check(native.available(), "prep: rald_torch.native did not build")
    lidar = load_config(PREP_CFG).single_chip_mode.lidar
    pts = np.fromfile(PREP_DIR / "processed" / PREP_SEQS[0] / "lidar_sc" / "0000.bin", np.float32)
    pts = geo.cartesian2polar(pts.reshape(-1, 3)).astype(np.float32)
    args = (lidar.voxel_size, lidar.pc_range, lidar.voxel_max_num_points, lidar.max_voxels)
    a, b = native.voxelize(pts, *args), voxelize(pts, *args)
    for k in ("voxels", "coords", "num_points", "grid_size"):
        check(getattr(a, k).dtype == getattr(b, k).dtype and np.array_equal(getattr(a, k), getattr(b, k)),
              f"prep: native voxelize {k} differs from numpy")
    sub = json.loads(json.dumps(eval_cfg.dataset.to_dict()))
    sub["split_file"] = PREP_SPLIT
    cached = ColoRadarDataset(eval_cfg.dataset.root_dir, Config(sub), loader_type="test")
    sub["lidar"]["cache_voxel"] = False
    live = ColoRadarDataset(eval_cfg.dataset.root_dir, Config(sub), loader_type="test")
    check(cached.cache_voxel and not live.cache_voxel and len(cached) == len(PREP_INDEX),
          f"prep: {len(cached)} test items")
    for i in range(len(cached)):
        x, y = cached[i], live[i]
        check(sorted(x) == sorted(y), f"prep item {i}: keys {sorted(x)} vs {sorted(y)}")
        for k, v in x.items():
            same = (v.dtype == y[k].dtype and np.array_equal(v, y[k])) if isinstance(v, np.ndarray) \
                else v == y[k]
            check(same, f"prep item {i}: {k} differs between cache_voxel true and false")
    return {"native_voxels": len(a.coords), "items_compared": len(cached)}


def _prep_eval_cfg():
    """The eval YAML as shipped (``cache_voxel: true``), pointed at the
    processed tree with its split as one scene, outputs under build/, and
    phase 6's ``.pth`` weights."""
    from rald_torch.config import load_config

    cfg = load_config(PRODUCT_CFG)
    out = SCRATCH / "eval" / "prep"
    cfg.dataset.root_dir = str(PREP_DIR / "processed")
    cfg.dataset.split_file = {"prep": PREP_SPLIT}
    cfg.system.update(output_dir=str(out / "result"), log_dir=str(out / "log"))
    cfg.eval.store_base_dir = str(out / "dumps")
    ckpt = SCRATCH / "eval" / "ckpt"
    return _set_ckpts(cfg, {"eval.ckpt": str(ckpt / "unfrozen_edm.pth"),
                            "lidar_ae.ckpt": str(ckpt / "unfrozen_vae.pth")})


def _prep_eval(cfg) -> dict:
    """(d) the processed test sequence through ``main_generation.run``: an
    engine loaded from phase 6's ``.pth`` files, its occupancy bias centred
    on this tree's cubes (the query projection stays as phase 6 sharpened
    it), then ``_eval_run``'s checks."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.gen_engine import GenerationEngine

    _phase6_weights()
    eng = GenerationEngine(cfg)
    lines = []
    mg.load_eval_checkpoint(cfg, eng, lines.append)
    mg.load_frozen_modules(cfg, eng, lines.append)
    check(not any(l.startswith("WARNING") for l in lines), f"prep eval: {lines}")
    shift = _center_occupancy(eng, _eval_cubes(cfg, "prep", len(PREP_INDEX)), sharpen=False)
    print(f"[prep] eval weights from phase 6 (occupancy bias shift {shift:+.6f})")
    line = _eval_run(cfg, "prep", "prep", PREP_SEQS[1], engine=eng, n_frames=len(PREP_INDEX))
    del eng
    torch.cuda.empty_cache()
    return line


def _prep_cfar_host_share(dev="cuda") -> dict:
    """(e) cache_cfar's frame split: reading the cube and moving its
    intensity to the device, the device call (its result back on the host),
    and the FOV filter and write, over the test frames."""
    from rald_torch import geometry as geo
    from rald_torch.cli.preprocess_lidar import fov_limits
    from rald_torch.config import load_config
    from rald_torch.dsp import RadarParams, cfar_points_from_cube

    cfg = load_config(PREP_TEST_CFG)
    limits = fov_limits(cfg.single_chip_mode.lidar.FOV)
    max_range = RadarParams.from_yaml(cfg.single_chip_mode.radar.config).max_range
    cubes = PREP_DIR / "processed" / PREP_SEQS[1] / "single_chip" / "radarcube_high_res"
    t = {"read": 0.0, "device": 0.0, "filter_write": 0.0}
    for f in sorted(cubes.glob("*.bin")):
        t0 = time.perf_counter()
        cube = np.fromfile(f, np.float32).reshape(128, 32, 16, 3)
        x = torch.from_numpy(np.ascontiguousarray(cube[..., 0])).to(dev)
        t1 = time.perf_counter()
        coords = cfar_points_from_cube(x, 256, 256, 128, 800_000, max_range)[0].cpu().numpy()
        t2 = time.perf_counter()
        geo.filter_points_polar(coords, limits).astype(np.float32).tofile(PREP_DIR / "cfar_probe.bin")
        t3 = time.perf_counter()
        for k, dt in zip(t, (t1 - t0, t2 - t1, t3 - t2)):
            t[k] += dt * 1e3 / len(PREP_INDEX)
    return {"ms_per_frame": t, "host_share": (t["read"] + t["filter_write"]) / sum(t.values())}


def phase_prep() -> dict:
    """Data preparation (phase 9): (a) the raw tree, (b) the five CLIs on the
    card, (c) the checks, (d) the end-to-end eval, (e) the ``[prep]`` line."""
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    t0 = time.perf_counter()
    _prep_raw_tree()
    raw_s = time.perf_counter() - t0
    clis = _prep_clis()
    files = _prep_check_files()
    dsp = _prep_dsp()
    cfg = _prep_eval_cfg()
    items = _prep_native_and_items(cfg)
    split = _prep_cfar_host_share()
    ev = _prep_eval(cfg)
    line = {"raw_tree_s": raw_s, "clis": clis, "files": files, "dsp": dsp, "cfar_frame": split,
            **items, "eval": {k: ev[k] for k in ("frames", "s_per_frame", "stats", "ply_points",
                                                 "launches_per_batch")},
            "device": smi_line()}
    print("[prep] " + json.dumps(line))
    return {"line": line, "eval": ev}


# --------------------------------------------------------------- phase 10
DIST_DIR = SCRATCH / "dist"  # outputs, payloads and child logs of the multi-process phase
DIST_STEPS = 2
DIST_TIMEOUT = 300  # s for one launch of child processes, then every child is killed
# (b) two gloo ranks (local batch 4) against one process (batch 8), the
# stage-2 path at depth 2 in float32 with matmul_precision "highest": loss
# and grad norm within 1e-4 relative, params and EMA within k * 1e-6 + 2 *
# lr * k absolute after k steps (the bars of tests/test_torch_parallel.py on
# the CPU), stated before the first run
DIST_REL = 1e-4


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _dist_launch(jobs: list, env_of) -> list:
    """One child process per job (``_dist_child(<job file>)``), ``env_of(i)``
    the rendezvous variables of child ``i``; their output goes to a log
    file each."""
    import os

    procs = []
    for i, job in enumerate(jobs):
        path = DIST_DIR / f"{job['label']}.json"
        path.write_text(json.dumps(job))
        env = {k: v for k, v in os.environ.items()
               if k not in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
                            "JAX_COORDINATOR_ADDRESS", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID")}
        env.update(env_of(i))
        log = open(DIST_DIR / f"{job['label']}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-c", "import sys, chip_smoke as c; sys.exit(c._dist_child(sys.argv[1]))",
             str(path)], cwd=REPO, env=env, stdout=log, stderr=subprocess.STDOUT), job))
        log.close()
    return procs


def _dist_wait(procs: list) -> list:
    """Each child's result (its job's ``result`` file); every child is
    killed when one fails or DIST_TIMEOUT runs out, and the phase fails."""
    t0 = time.perf_counter()
    while any(p.poll() is None for p, _ in procs):
        failed = [j["label"] for p, j in procs if p.poll() not in (None, 0)]
        if failed or time.perf_counter() - t0 > DIST_TIMEOUT:
            for p, _ in procs:
                p.kill()
            for p, _ in procs:
                p.wait()
            logs = "\n".join((DIST_DIR / f"{j['label']}.log").read_text()[-4000:] for _, j in procs)
            check(False, f"dist: {failed or 'timed out'}:\n{logs}")
        time.sleep(0.2)
    for p, j in procs:
        check(p.returncode == 0, f"dist {j['label']}: exit {p.returncode}:\n"
              + (DIST_DIR / f"{j['label']}.log").read_text()[-4000:])
    return [torch.load(j["result"], weights_only=False) for _, j in procs]


def _dist_train_cfg(label: str):
    """(a) the shipped training YAML (bf16, batch 8, full width) over phase
    7's tree: one epoch of 3 steps, a checkpoint, the EMA evaluation on the
    2-frame test scene."""
    cfg = _train_cfg(TRAIN_CFG, label, epochs=1, eval_freq=1, save_ckpt_freq=1)
    cfg.eval.use_test_set = True
    return cfg


def _dist_f32_cfg(label: str, bsz: int):
    """(b) the same YAML at depth 2 (DiT and VAE), float32 with
    ``matmul_precision: highest``, ``bsz`` frames a rank."""
    cfg = _train_cfg(TRAIN_CFG, label)
    cfg.system.update(compute_dtype="float32", matmul_precision="highest")
    cfg.dataset.batch_size = bsz
    for sec in (cfg.ar_model, cfg.lidar_ae):
        sec.overrides = {**(sec.get("overrides") or {}), "depth": 2}
    return cfg


def _dist_infer_cfg():
    """(b) the product eval YAML with phase 6's ``.pth`` weights."""
    d = SCRATCH / "eval" / "ckpt"
    cfg = _eval_cfg(PRODUCT_CFG, "dist_infer")
    return _set_ckpts(cfg, {"eval.ckpt": str(d / "unfrozen_edm.pth"),
                            "lidar_ae.ckpt": str(d / "unfrozen_vae.pth")})


def _digest(tree: dict) -> str:
    import hashlib

    h = hashlib.sha256()
    for k in sorted(tree):
        h.update(k.encode())
        h.update(tree[k].detach().cpu().contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _dist_steps(batch: dict, rows: slice, label: str, keep: bool) -> dict:
    """DIST_STEPS stage-2 steps of ``_dist_f32_cfg`` on ``rows`` of the
    global batch, the draws from the engine's generators (under a process
    group each rank's rows of the global draws): per step the loss, grad
    norm, ms and the digests of params and EMA (and, with ``keep``, their
    values on the host); the peak memory."""
    from rald_torch import apply_matmul_precision
    from rald_torch.train.gen_engine import GenerationEngine

    local = {k: v[rows] for k, v in batch.items()}
    bsz = len(local["lidar_points"])
    apply_matmul_precision("highest")
    eng = GenerationEngine(_dist_f32_cfg(label, bsz))
    state = eng.init_state(3, len(batch["lidar_points"]))
    torch.cuda.reset_peak_memory_stats()
    recs = []
    for k in range(DIST_STEPS):
        torch.cuda.synchronize()
        t0, split = time.perf_counter(), {}
        latents, cube = eng.prepare_inputs(local, eng.step_generator(0, k, 99), timings=split)
        state, m = eng.train_step(state, latents, cube, eng.step_generator(0, k), timings=split)
        torch.cuda.synchronize()
        rec = {"ms": (time.perf_counter() - t0) * 1e3, "split_ms": split, "loss": float(m["loss"]),
               "grad_norm": float(m["grad_norm"]), "params_sha": _digest(state.params),
               "ema_sha": _digest(state.ema_params), "lr": eng.lr_schedule(k)}
        if keep:
            rec["params"] = {n: v.cpu().clone() for n, v in state.params.items()}
            rec["ema"] = {n: v.cpu().clone() for n, v in state.ema_params.items()}
        recs.append(rec)
    out = {"steps": recs, "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    del eng, state
    torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = True  # torch's defaults again
    torch.set_float32_matmul_precision("highest")
    return out


def _dist_infer(out_dir: Path, thr: float) -> dict:
    """``infer.run`` over phase 4's nine cubes at batch 8 (under a process
    group: this rank's files), the launch counters zeroed just before and
    read just after."""
    from rald_torch.cli import infer
    from rald_torch.ops import launch_counts, reset_launch_counts

    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    reset_launch_counts()
    t0 = time.perf_counter()
    stats = infer.run(_dist_infer_cfg(), str(SCRATCH / "cli_cubes"), str(out_dir), batch=8,
                      threshold=thr, print_fn=lambda *_: None)
    torch.cuda.synchronize()
    return {"wall_s": time.perf_counter() - t0, "files": stats["files"],
            "points": stats["points"], "launches": launch_counts()}


def _dist_child(job_path: str) -> int:
    """A child of phase 10: joins the group its environment describes and
    runs its job, writing the job's ``result`` (``torch.save``)."""
    from rald_torch.parallel import backend, destroy, init_distributed

    sys.path.insert(0, str(REPO))
    job = json.loads(Path(job_path).read_text())
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t_start = time.perf_counter()
    if job["kind"] == "train_cli":
        out = _dist_train_child(job)
    elif job["kind"] == "shard":
        info = init_distributed(job["device"], backend=job["backend"])
        out = {"info": info, "backend": backend(), "shard": _dist_shard_run()}
    else:
        info = init_distributed(job["device"], backend=job["backend"])
        rank = info["rank"]
        batch = torch.load(job["batch"], weights_only=False)
        n = len(batch["lidar_points"]) // info["world_size"]
        out = {"info": info, "backend": backend(), "device": job["device"],
               "steps": _dist_steps(batch, slice(rank * n, (rank + 1) * n), job["label"],
                                    keep=rank == 0)}
        if job.get("infer_out"):
            out["infer"] = _dist_infer(Path(job["infer_out"]), job["threshold"])
    out["wall_s"] = time.perf_counter() - t_start
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    destroy()
    torch.save(out, job["result"])
    return 0


def _dist_train_child(job: dict) -> dict:
    """(a) in the child: ``main_generation.run`` on ``_dist_train_cfg``, which
    joins the group of one its environment describes."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.ops import reset_launch_counts
    from rald_torch.parallel import backend, process_info
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _dist_train_cfg(job["label"])
    eng = GenerationEngine(cfg)
    captured, init = {}, eng.init_state
    eng.init_state = lambda *a: captured.setdefault("state", init(*a))
    train_d, eval_d, lines = [], [], []
    _counted(eng, "train_one_epoch", train_d)
    _counted(eng, "evaluate", eval_d)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    mg.run(cfg, engine=eng, print_fn=lines.append)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    # the synchronised split of 4 more steps (the first a warm-up), after the run
    batch = next(iter(mg.build_train_loader(cfg, print_fn=lambda *_: None)))
    splits = []
    for it in range(4):
        t = {}
        latents, cube = eng.prepare_inputs(batch, eng.step_generator(9, it, 99), timings=t)
        eng.train_step(captured["state"], latents, cube, eng.step_generator(9, it), timings=t)
        splits.append(t)
    return {"run_s": run_s, "backend": backend(), "info": process_info(),
            "current_device": torch.cuda.current_device(),
            "dist_lines": [l for l in lines if l.startswith("distributed:")],
            "train_launches": train_d, "eval_launches": eval_d, "records": _records(cfg),
            "split_ms": {k: float(np.median([t[k] for t in splits[1:]])) for k in splits[0]}}


# (d) shard_queries: a grid that is no multiple of 2 (and of no block count)
SHARD_GRID = 500_001
SHARD_BATCH = 2


def _dist_shard_cfg():
    """(d) the product eval YAML with phase 6's ``.pth`` weights and
    ``eval.inference.shard_queries``, a SHARD_GRID-query grid."""
    cfg = _dist_infer_cfg()
    cfg.eval.inference.shard_queries = True
    cfg.eval.inference.num_query_points = SHARD_GRID
    return cfg


def _dist_shard_run() -> dict:
    """(d) in one process or one rank: ``sample_tokens`` + ``decode_queries``
    on a SHARD_GRID grid, then one ``fused_eval_step`` (that grid drawn on
    the card, 7e5 densified helpers, 5e5 refine queries: 1200001 and 5e5
    queries split over the ranks), on phase 10's saved batch; the digests of
    the logits and of the step's outputs, the launches and the ms."""
    from rald_torch.cli.main_generation import load_eval_checkpoint, load_frozen_modules
    from rald_torch.ops import launch_counts, reset_launch_counts
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _dist_shard_cfg()
    eng = GenerationEngine(cfg)
    load_eval_checkpoint(cfg, eng, print_fn=lambda *_: None)
    load_frozen_modules(cfg, eng, print_fn=lambda *_: None)
    batch = torch.load(DIST_DIR / "shard_batch.pt", weights_only=False)
    inputs, grid = batch["inputs"], batch["grid"].cuda()
    # a cloud in every frame (the weights were sharpened when phase 6 saved them)
    shift = _center_occupancy(eng, [inputs], sharpen=False)
    kw = dict(compute_cd=True, refine=True, helper_aug=True, use_device_grid=True)
    _run_step(eng, inputs, seed=3, **kw)  # warm-up: cuBLAS / cuDNN plans
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    logits = eng.decode_queries(eng.sample_tokens(inputs["radar_cube"], inputs["seeds_or_prior"]),
                                grid)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    step = _run_step(eng, inputs, seed=3, **kw)
    t2 = time.perf_counter()
    out = {"query_shards": eng.query_shards(), "bias_shift": shift,
           "logits_shape": list(logits.shape),
           "logits_sha": _digest({"logits": logits}),
           "step_sha": _digest({str(i): t.reshape(-1) for i, t in enumerate(step)}),
           "step": [t.float().cpu().tolist() for t in step], "launches": launch_counts(),
           "decode_ms": (t1 - t0) * 1e3, "step_ms": (t2 - t1) * 1e3}
    del eng
    torch.cuda.empty_cache()
    return out


def _dist_shard() -> dict:
    """(d) ``eval.inference.shard_queries`` over two gloo ranks sharing
    cuda:0: rank 0 samples and broadcasts the tokens, each rank decodes its
    run of whole query blocks, the runs are gathered and trimmed. The
    logits of ``decode_queries`` and the outputs of ``fused_eval_step``
    bitwise the one-process run's (the flag is a no-op there); rank 0
    launches row 1 for the sampler and its share of nothing else, rank 1
    row 1 only in the VAE's decoder blocks, both row 2 once."""
    cfg = _dist_shard_cfg()
    rng = np.random.default_rng(16)
    inputs = _inputs(cfg, SHARD_BATCH, rng)
    grid = np.broadcast_to(rng.uniform(-1, 1, (1, SHARD_GRID, 3)).astype(np.float32),
                           (SHARD_BATCH, SHARD_GRID, 3)).copy()
    torch.save({"inputs": inputs, "grid": torch.from_numpy(grid)}, DIST_DIR / "shard_batch.pt")
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True  # as in the children
    t0 = time.perf_counter()
    one = _dist_shard_run()
    one_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = det
    check(one["query_shards"] == (1, 0), f"dist (d): one process shards {one['query_shards']}")
    port = _free_port()
    jobs = [{"kind": "shard", "label": f"shard_rank{r}", "device": "cuda:0", "backend": "gloo",
             "result": str(DIST_DIR / f"shard_rank{r}.out")} for r in range(2)]
    t0 = time.perf_counter()
    outs = _dist_wait(_dist_launch(jobs, lambda i: {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(i),
        "LOCAL_RANK": "0"}))
    wall = time.perf_counter() - t0
    per_nfe, vdepth = _per_nfe_cfg(cfg), 24
    for r, o in enumerate(outs):
        sh = o["shard"]
        check(o["backend"] == "gloo" and sh["query_shards"] == (2, r),
              f"dist (d): rank {r} on {o['backend']} shards {sh['query_shards']}")
        check(sh["logits_shape"] == [SHARD_BATCH, SHARD_GRID]
              and sh["logits_sha"] == one["logits_sha"],
              f"dist (d): rank {r} decode_queries logits differ from one process")
        check(sh["step_sha"] == one["step_sha"],
              f"dist (d): rank {r} fused_eval_step {sh['step']} != one process {one['step']}")
        want = {n: 0 for n in KERNEL_NAMES}
        want.update(fused_ln_geglu_residual=(2 * per_nfe if r == 0 else 0) + 2 * vdepth,
                    nn_min_sq_both=1)
        _check_counts(sh["launches"], want, f"dist (d) rank {r}")
    want = {n: 0 for n in KERNEL_NAMES}
    want.update(fused_ln_geglu_residual=2 * per_nfe + 2 * vdepth, nn_min_sq_both=1)
    _check_counts(one["launches"], want, "dist (d) one process")
    check(min(one["step"][5]) > 0, f"dist (d): empty prediction n_pred={one['step'][5]}")
    line = {"mode": "(d) shard_queries, gloo world 2 on cuda:0", "grid": SHARD_GRID,
            "batch": SHARD_BATCH, "bitwise_one_process": True, "wall_s": wall,
            "world1_s": one_s, "rank_decode_ms": [o["shard"]["decode_ms"] for o in outs],
            "rank_step_ms": [o["shard"]["step_ms"] for o in outs],
            "world1_decode_ms": one["decode_ms"], "world1_step_ms": one["step_ms"],
            "rank_launches": [{k: v for k, v in o["shard"]["launches"].items() if v}
                              for o in outs],
            "rank_peak_gib": [o["peak_gib"] for o in outs], "n_pred": one["step"][5],
            "device": smi_line()}
    print("[dist] " + json.dumps(line))
    return line


def _dist_nccl_world1() -> dict:
    """(a) ``main_generation`` in train mode in a child with ``WORLD_SIZE=1
    RANK=0 LOCAL_RANK=0 MASTER_ADDR=127.0.0.1``: NCCL on cuda:0, exact
    launches (none over the steps; rows 1 and 2 per eval batch), and its
    checkpoint's params and EMA bitwise those of the same steps run here
    with no process group."""
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.gen_engine import GenerationEngine

    port = _free_port()
    job = {"kind": "train_cli", "label": "nccl_world1", "result": str(DIST_DIR / "nccl_world1.out")}
    t0 = time.perf_counter()
    (child,) = _dist_wait(_dist_launch([job], lambda i: {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "1", "RANK": "0",
        "LOCAL_RANK": "0"}))
    child_s = time.perf_counter() - t0
    check(child["backend"] == "nccl" and child["current_device"] == 0,
          f"dist (a): backend {child['backend']} on cuda:{child['current_device']}")
    check(child["dist_lines"] == ["distributed: rank 0/1 backend nccl device cuda:0"],
          f"dist (a): {child['dist_lines']}")
    check([r["epoch"] for r in child["records"]] == [0] and "val_loss" in child["records"][0],
          f"dist (a): records {child['records']}")
    check(all(all(v == 0 for v in d.values()) for d in child["train_launches"]),
          f"dist (a): kernels launched over the train steps {child['train_launches']}")
    want = {n: 0 for n in KERNEL_NAMES}
    want.update(fused_ln_geglu_residual=864 * TEST_FRAMES, nn_min_sq_both=TEST_FRAMES)
    check(len(child["eval_launches"]) == 1, f"dist (a): {len(child['eval_launches'])} evaluations")
    _check_counts(child["eval_launches"][0], want, "dist (a) eval")

    # the same steps here, with no process group
    cfg = _dist_train_cfg("nccl_world1_ref")
    cfg.train.eval_freq = 0
    eng = GenerationEngine(cfg)
    captured, init = {}, eng.init_state
    eng.init_state = lambda *a: captured.setdefault("state", init(*a))
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    t0 = time.perf_counter()
    mg.run(cfg, engine=eng, print_fn=lambda *_: None)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t0
    torch.backends.cudnn.deterministic = det
    st = captured["state"]
    ckpt = Path(_dist_train_cfg("nccl_world1").system.output_dir) / "checkpoint-0.pth"
    ck = torch.load(ckpt, map_location="cpu", weights_only=True)
    check(ck["step"] == st.step == 3, f"dist (a): steps {ck['step']} / {st.step}")
    for key, tree in (("model", st.params), ("model_ema", st.ema_params)):
        bad = [n for n, v in tree.items() if not torch.equal(ck[key][n], v.cpu())]
        check(not bad, f"dist (a): NCCL world-1 {key} differs from no group at {bad[:4]}")
    del eng, st, ck, captured
    for label in ("nccl_world1", "nccl_world1_ref"):
        for f in (TRAIN_DIR / label / "result").glob("checkpoint-*.pth"):
            f.unlink()
    torch.cuda.empty_cache()
    line = {"mode": "(a) NCCL world 1, main_generation train", "backend": child["backend"],
            "child_wall_s": child_s, "child_run_s": child["run_s"],
            "child_peak_gib": child["peak_gib"], "no_group_run_s": ref_s,
            "split_ms": child["split_ms"],
            "records": child["records"], "params_ema_bitwise_no_group": True,
            "eval_launches_per_batch": {k: v // TEST_FRAMES
                                        for k, v in child["eval_launches"][0].items() if v},
            "device": smi_line()}
    print("[dist] " + json.dumps(line))
    return line


def _dist_pair(backend: str, devices: tuple, batch_path: Path, ref: dict, infer_thr=None,
               infer_ref: Path = None) -> dict:
    """Two ranks (``backend`` on ``devices``): DIST_STEPS steps of local
    batch 4, the ranks bitwise equal after each, within DIST_REL and the
    params bar of the one-process batch-8 run ``ref``; with ``infer_thr``
    also ``infer.run``, whose union of PLY files must be ``infer_ref``'s,
    byte for byte, with exact launches per rank."""
    import shutil

    port = _free_port()
    infer_out = DIST_DIR / f"infer_{backend}"
    shutil.rmtree(infer_out, ignore_errors=True)
    jobs = [{"kind": "steps", "label": f"{backend}_world2_rank{r}", "device": devices[r],
             "backend": backend, "batch": str(batch_path),
             "result": str(DIST_DIR / f"{backend}_world2_rank{r}.out"),
             **({"infer_out": str(infer_out), "threshold": infer_thr} if infer_thr is not None
                else {})} for r in range(2)]
    t0 = time.perf_counter()
    outs = _dist_wait(_dist_launch(jobs, lambda i: {
        "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port), "WORLD_SIZE": "2", "RANK": str(i),
        "LOCAL_RANK": devices[i].split(":")[1]}))
    wall = time.perf_counter() - t0
    for r, o in enumerate(outs):
        check(o["backend"] == backend and o["info"]["rank"] == r and o["info"]["world_size"] == 2,
              f"dist {backend}: rank {r} joined {o['info']} on {o['backend']}")
    r0, r1 = (o["steps"]["steps"] for o in outs)
    worst = {"loss_rel": 0.0, "grad_norm_rel": 0.0, "params_abs": 0.0, "ema_abs": 0.0}
    lr_sum = 0.0
    for k, (a, b, w) in enumerate(zip(r0, r1, ref["steps"]), start=1):
        check(a["params_sha"] == b["params_sha"] and a["ema_sha"] == b["ema_sha"]
              and a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"],
              f"dist {backend}: the ranks differ after step {k}")
        lr_sum += w["lr"]
        worst["loss_rel"] = max(worst["loss_rel"], abs(a["loss"] - w["loss"]) / abs(w["loss"]))
        worst["grad_norm_rel"] = max(worst["grad_norm_rel"],
                                     abs(a["grad_norm"] - w["grad_norm"]) / abs(w["grad_norm"]))
        bar = k * 1e-6 + 2 * lr_sum
        for tree, key in (("params", "params_abs"), ("ema", "ema_abs")):
            worst[key] = max(worst[key], max(float((a[tree][n] - v).abs().max())
                                             for n, v in w[tree].items()))
        check(worst["loss_rel"] <= DIST_REL and worst["grad_norm_rel"] <= DIST_REL
              and worst["params_abs"] <= bar and worst["ema_abs"] <= bar,
              f"dist {backend}: step {k}: {worst} against world 1 (params bar {bar})")
        worst["params_bar"] = bar
    line = {"mode": f"(b/c) {backend} world 2 on {list(devices)}", "wall_s": wall,
            "rank_wall_s": [o["wall_s"] for o in outs], "rank_peak_gib": [o["peak_gib"] for o in outs],
            "rank_step_ms": [[s["ms"] for s in o["steps"]["steps"]] for o in outs],
            "world1_step_ms": [s["ms"] for s in ref["steps"]], "world1_peak_gib": ref["peak_gib"],
            "rank_all_reduce_ms": [[s["split_ms"]["all_reduce"] for s in o["steps"]["steps"]]
                                   for o in outs],
            # one process has no all-reduce stage (its steps may replay as graphs)
            "world1_all_reduce_ms": [s["split_ms"].get("all_reduce", 0.0) for s in ref["steps"]],
            "loss": [s["loss"] for s in r0], "world1_loss": [s["loss"] for s in ref["steps"]],
            "grad_norm": [s["grad_norm"] for s in r0],
            "world1_grad_norm": [s["grad_norm"] for s in ref["steps"]], **worst,
            "ranks_bitwise_equal": True, "device": smi_line()}
    if infer_thr is not None:
        got = {str(p.relative_to(infer_out)): p.read_bytes() for p in sorted(infer_out.rglob("*.ply"))}
        want = {str(p.relative_to(infer_ref)): p.read_bytes() for p in sorted(infer_ref.rglob("*.ply"))}
        check(sorted(got) == sorted(want) and len(want) == sum(CLI_FRAMES),
              f"dist {backend} infer: PLY files {sorted(got)} vs {sorted(want)}")
        diff = [k for k in want if got[k] != want[k]]
        check(not diff, f"dist {backend} infer: PLY files differ from world 1: {diff}")
        per_nfe = (2 * 18 - 1) * 24
        for r, o in enumerate(outs):
            inf = o["infer"]
            check(inf["files"] == len(range(r, sum(CLI_FRAMES), 2)), f"dist infer rank {r}: {inf}")
            want_l = {n: 0 for n in KERNEL_NAMES}
            want_l["fused_ln_geglu_residual"] = -(-inf["files"] // 8) * (per_nfe + 24)
            _check_counts(inf["launches"], want_l, f"dist {backend} infer rank {r}")
        points = [n for o in outs for n in o["infer"]["points"]]
        check(sum(n > 0 for n in points) >= 8, f"dist {backend} infer: empty clouds {points}")
        line["infer"] = {"rank_files": [o["infer"]["files"] for o in outs],
                         "rank_wall_s": [o["infer"]["wall_s"] for o in outs],
                         "rank_launches": [{k: v for k, v in o["infer"]["launches"].items() if v}
                                           for o in outs],
                         "ply_union_bytewise_world1": True,
                         "points": [o["infer"]["points"] for o in outs]}
    print("[dist] " + json.dumps(line))
    return line


def phase_dist() -> dict:
    """Multi-process runs (phase 10): (a) NCCL at world size 1 through
    ``main_generation``; (b) two ranks sharing cuda:0 over gloo (NCCL
    refuses two ranks on one device): stage-2 steps and ``infer``; (c) NCCL
    at world size 2 where the machine has two cards; (d) ``shard_queries``
    over two gloo ranks on cuda:0, bitwise one process."""
    import shutil

    from rald_torch.cli import main_generation as mg

    shutil.rmtree(DIST_DIR, ignore_errors=True)
    DIST_DIR.mkdir(parents=True)
    _phase6_weights()
    if not (TRAIN_TREE / "split_train.json").exists():
        _train_tree()
    if not (SCRATCH / "cli_cubes").exists():
        _cli_cubes(_product_cfg())
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    a = _dist_nccl_world1()
    a_s = time.perf_counter() - t0

    # (b): the global batch of 8 and the one-process references
    t0 = time.perf_counter()
    loader = mg.build_train_loader(_dist_f32_cfg("dist_batch", 8), print_fn=lambda *_: None)
    full = next(iter(loader))
    batch = {k: torch.from_numpy(np.asarray(full[k])) for k in ("lidar_points", "radar_cube")}
    batch_path = DIST_DIR / "batch.pt"
    torch.save(batch, batch_path)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    ref = _dist_steps(batch, slice(0, 8), "dist_world1", keep=True)
    thr = _dist_threshold()
    infer_ref = DIST_DIR / "infer_world1"
    ref_infer = _dist_infer(infer_ref, thr)
    torch.backends.cudnn.deterministic = det
    print("[dist] (b) two ranks share cuda:0 over gloo: NCCL refuses two ranks on one device "
          "(\"Duplicate GPU detected\")")
    b = _dist_pair("gloo", ("cuda:0", "cuda:0"), batch_path, ref, thr, infer_ref)
    b["world1_infer"] = {"wall_s": ref_infer["wall_s"],
                         "launches": {k: v for k, v in ref_infer["launches"].items() if v}}
    b_s = time.perf_counter() - t0
    n = torch.cuda.device_count()
    if n >= 2:
        print(f"[dist] (c) {n} cards: NCCL at world size 2 on cuda:0 and cuda:1")
        c = _dist_pair("nccl", ("cuda:0", "cuda:1"), batch_path, ref)
    else:
        print(f"[dist] (c) skipped: {n} card, NCCL at world size 2 needs two")
        c = None
    t0 = time.perf_counter()
    d = _dist_shard()
    d_s = time.perf_counter() - t0
    print(f"[dist] phase 10 split: (a) {a_s:.1f} s, (b) {b_s:.1f} s, (d) {d_s:.1f} s")
    return {"nccl_world1": a, "gloo_world2": b, "nccl_world2": c, "shard_queries": d}


def _dist_threshold() -> float:
    """The least of the first 8 cubes' 90th logit percentiles, from the
    engine ``infer`` builds from the same YAML: a threshold that leaves
    every one of them a cloud."""
    from rald_torch.cli import infer
    from rald_torch.cli.main_generation import load_eval_checkpoint, load_frozen_modules
    from rald_torch.train.gen_engine import GenerationEngine

    cfg = _dist_infer_cfg()
    eng = GenerationEngine(cfg)
    load_eval_checkpoint(cfg, eng, print_fn=lambda *_: None)
    load_frozen_modules(cfg, eng, print_fn=lambda *_: None)
    files = infer.collect_inputs(str(SCRATCH / "cli_cubes"))[:8]
    cubes = np.stack([infer.preprocess(infer.load_cube(f), cfg.dataset.radar) for f in files])
    grid = torch.from_numpy(infer.query_grid(cfg)).cuda()[None].expand(8, -1, -1)
    logits = eng.decode_queries(eng.sample_tokens(cubes, list(range(8))), grid)
    thr = float(torch.quantile(logits[:, ::16].float(), 0.9, dim=1).min())
    del eng
    torch.cuda.empty_cache()
    return thr


# -------------------------------------------------------------- phase 11
REST_DIR = SCRATCH / "rest"  # YAMLs, scales, artifacts, traces and checkpoints of phase 11
CHURN = {"s_churn": 40.0, "s_min": 0.05, "s_max": 50.0, "s_noise": 1.003}
# a frame sampled alone against the same seed inside the batch of 8: phase
# 5's bf16 bar (5 % of max(rms, 1) on the max token difference); card
# against CPU at depth 2 in f32: phase 5's f32 bar (1e-3 of max(rms, 1));
# the radar autoencoder card against CPU in f32: 1e-4 of max |pred|
CHURN_ALONE_BAR, CHURN_F32_BAR, RADAR_AE_BAR = 0.05, 1e-3, 1e-4


def _churn_cfg(**kw):
    cfg = _product_cfg(**kw)
    cfg.eval.inference.update(CHURN)
    return cfg


def _rest_churn() -> dict:
    """(a) churn on the product eval chain at full width: bf16 with
    ``use_fused_attn`` at batch 1 and 8 (rows 1 and 7 launched exactly, the
    AdaLN rows per frame at every NFE), a frame alone against the same seed
    in the batch of 8, ``int8_ff: "static"`` + churn at batch 1 (the dynamic
    row 4 runs, row 5 does not), then a depth-2 f32 chain on the card
    against the CPU with injected prior and churn draws."""
    from rald_torch import apply_matmul_precision
    from rald_torch.train.gen_engine import GenerationEngine

    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    cfg = _churn_cfg(fused_attn=True)
    rng = np.random.default_rng(cfg.system.seed)
    inputs = {b: _inputs(cfg, b, rng) for b in (1, 8)}
    runs = {}
    eng = _build(cfg, "churn use_fused_attn", inputs.values())
    for bsz in (1, 8):
        runs[("churn use_fused_attn", bsz)] = _main_run(eng, inputs[bsz], bsz, "churn use_fused_attn",
                                                        _want_launches(eng))
    cube = inputs[8]["radar_cube"]
    batch = eng.sample_tokens(cube, list(range(8)))
    alone = []
    for i in (0, 5):
        tok = eng.sample_tokens(cube[i:i + 1], [i])
        rms = float(batch[i].pow(2).mean().sqrt())
        alone.append({"frame": i, "max_abs_diff": float((tok[0] - batch[i]).abs().max()),
                      "rms": rms, "bar": CHURN_ALONE_BAR * max(rms, 1.0)})
        check(alone[-1]["max_abs_diff"] <= alone[-1]["bar"], f"churn alone vs batch: {alone[-1]}")
    print("[rest] " + json.dumps({"mode": "churn frame alone vs batch of 8", "frames": alone}))
    del eng
    torch.cuda.empty_cache()

    scales = REST_DIR / "int8_act_scales_unused.npz"  # churn takes no scale rows
    scales.parent.mkdir(parents=True, exist_ok=True)
    depth = 24
    np.savez(scales, ah=np.full((18, depth), 4.0, np.float32), ag=np.full((18, depth), 2.0, np.float32),
             num_steps=18)
    eng = _build(_churn_cfg(int8_ff="static", act_scales=scales), "churn int8_ff=static",
                 [inputs[1]])
    want = _want_launches(eng)
    want["fused_ln_geglu_residual_int8"] = want.pop("fused_ln_geglu_residual_int8_static")
    want["fused_ln_geglu_residual_int8_static"] = 0
    runs[("churn int8_ff=static", 1)] = _main_run(eng, inputs[1], 1, "churn int8_ff=static", want)
    del eng
    torch.cuda.empty_cache()

    # depth 2, f32 highest: the card against the CPU, same weights, injected draws
    apply_matmul_precision("highest")
    toks = {}
    sd = None
    for device in ("cuda", "cpu"):
        c = _churn_cfg(fused_attn=True, f32=True, depth=2)
        eng = GenerationEngine(c, device=device)
        if sd is None:
            sd = {k: v.cpu() for k, v in eng.model.state_dict().items()}
        else:
            eng.load_state_dicts(edm_state_dict=sd)
        m = eng.model
        eng.draw_prior = _numpy_prior
        eng.draw_churn = lambda seeds, step, n, ch, dev: torch.from_numpy(np.stack([
            np.random.default_rng([int(s), step, 7]).standard_normal((n, ch)).astype(np.float32)
            for s in seeds])).to(dev)
        toks[device] = eng.sample_tokens(inputs[1]["radar_cube"], [3]).cpu()
        del eng, m
    torch.cuda.empty_cache()
    rms = float(toks["cpu"].pow(2).mean().sqrt())
    err = float((toks["cuda"] - toks["cpu"]).abs().max())
    f32 = {"mode": "churn card vs CPU, depth 2, f32 highest, use_fused_attn",
           "tokens_max_abs_diff": err, "tokens_rms": rms, "bar": CHURN_F32_BAR * max(rms, 1.0)}
    print("[rest] " + json.dumps(f32))
    check(err <= f32["bar"], f"churn card vs CPU: {f32}")
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    return {"runs": runs, "alone": alone, "f32": f32}


def _rest_cfg_file(cfg, name: str) -> Path:
    import yaml

    path = REST_DIR / name
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(yaml.safe_dump(cfg.to_dict()))
    return path


def _rest_int8_drivers() -> dict:
    """(b) ``calibrate_int8`` with its defaults on phase 6's EDM ``.pth`` (the
    npz beside it), then ``int8_gate`` in all four modes over scene a of
    phase 6's tree, each mode's launches counted."""
    from rald_torch.cli import calibrate_int8, int8_gate
    from rald_torch.config import expand_experiment_sweep, finalize_dirs, load_config
    from rald_torch.train.gen_engine import act_scales_path

    _phase6_weights()
    if not (EVAL_ROOT / "split_scene_a.json").exists():
        _eval_tree()
    ckpt = SCRATCH / "eval" / "ckpt" / "unfrozen_edm.pth"
    cfg = _set_ckpts(_eval_cfg(PRODUCT_CFG, "rest_int8"),
                     {"lidar_ae.ckpt": str(SCRATCH / "eval" / "ckpt" / "unfrozen_vae.pth")})
    cfg.system.output_dir = str(REST_DIR / "int8")
    scene = dict(expand_experiment_sweep(finalize_dirs(copy.deepcopy(cfg))))["scene_a"]
    yml = _rest_cfg_file(scene, "int8_scene_a.yml")
    act_scales_path(ckpt).unlink(missing_ok=True)
    t0 = time.perf_counter()
    lines = []
    path = calibrate_int8.main(["--config", str(yml), "--ckpt", str(ckpt)])
    cal_s = time.perf_counter() - t0
    check(path == act_scales_path(ckpt) and path.exists(), f"calibrate_int8 wrote {path}")
    with np.load(path) as z:
        ah, ag = z["ah"], z["ag"]
    check(ah.shape == (18, 24) and bool((ah > 0).all()) and bool((ag > 0).all())
          and bool(np.isfinite(ah).all()), "calibrate_int8: bad tables")
    t0 = time.perf_counter()
    art = int8_gate.run(finalize_dirs(load_config(yml)), ckpt, print_fn=lines.append)
    gate_s = time.perf_counter() - t0
    modes = art["modes"]
    check(sorted(modes) == sorted(n for n, _ in int8_gate.MODES), f"int8_gate modes {sorted(modes)}")
    for name, row in modes.items():
        check(all(math.isfinite(row[k]) for k in ("iou", "cd_m", "fscore")), f"int8_gate {name}: {row}")
    want = {"int8_ff": ["fused_ln_geglu_residual_int8"],
            "int8_ff+attn_vout": ["fused_ln_geglu_residual_int8", "fused_self_attention_block_int8_vout"],
            "int8_ff_static+attn_vout": ["fused_ln_geglu_residual_int8_static",
                                         "fused_self_attention_block_int8_vout"]}
    for name, kernels in want.items():
        for k in kernels:
            check(modes[name]["launches"].get(k, 0) > 0, f"int8_gate {name}: no {k} launch")
    check("fused_ln_geglu_residual_int8_static" not in modes["int8_ff"]["launches"],
          "int8_gate int8_ff: a static launch")
    line = {"mode": "int8 drivers", "calibrate_s": cal_s, "gate_s": gate_s,
            "ah_range": [float(ah.min()), float(ah.max())], "ag_range": [float(ag.min()), float(ag.max())],
            "gate": art, "device": smi_line()}
    print("[rest] " + json.dumps(line))
    return line


def _rest_resume() -> dict:
    """(c) ``convert_ckpt`` of phase 6's EDM ``.pth`` into a trainer file, and
    ``train.resume`` from it: one epoch (3 steps) of ``main_generation``
    train mode at full width, bf16, batch 8, starting from the converted
    weights (params = EMA = the file's, fresh optimizer, step 0)."""
    from rald_torch.cli import convert_ckpt
    from rald_torch.cli import main_generation as mg
    from rald_torch.train.gen_engine import GenerationEngine

    _phase6_weights()
    if not (TRAIN_TREE / "split_train.json").exists():
        _train_tree()
    src = SCRATCH / "eval" / "ckpt" / "unfrozen_edm.pth"
    cfg = _train_cfg(TRAIN_CFG, "rest_resume")
    out = REST_DIR / "converted"
    t0 = time.perf_counter()
    path = convert_ckpt.main(["--config", str(_rest_cfg_file(cfg, "train.yml")), "--kind",
                              "generation", "--torch-ckpt", str(src), "--out", str(out)])
    conv_s = time.perf_counter() - t0
    raw = torch.load(path, map_location="cpu", weights_only=True)
    ref = torch.load(src, map_location="cpu", weights_only=True)["model"]
    check(raw["step"] == 0 and raw["epoch"] == 0 and raw["optimizer"]["count"] == 0,
          f"convert_ckpt: step {raw['step']} epoch {raw['epoch']}")
    check(all(torch.equal(raw["model"][k], v) and torch.equal(raw["model_ema"][k], v)
              for k, v in ref.items()) and sorted(raw["model"]) == sorted(ref),
          "convert_ckpt: params / EMA differ from the .pth")
    del raw, ref
    rcfg = _train_cfg(TRAIN_CFG, "rest_resume", resume=str(path), eval_freq=0, epochs=2)
    eng = GenerationEngine(rcfg)
    captured = {}
    init = eng.init_state

    def init_state(*a):
        captured["state"] = init(*a)
        return captured["state"]

    eng.init_state = init_state
    lines = []
    t0 = time.perf_counter()
    mg.run(rcfg, engine=eng, print_fn=lines.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rec = _records(rcfg)
    st = captured["state"]
    check("resumed from epoch 0" in lines and [r["epoch"] for r in rec] == [1]
          and math.isfinite(rec[0]["train_loss"]), f"resume from converted: {rec} {lines[-3:]}")
    check(st.step == 3 and st.count == 3, f"resume from converted: step {st.step}")
    line = {"mode": "convert_ckpt -> train.resume", "convert_s": conv_s, "train_wall_s": wall,
            "record": rec[0], "steps": st.step}
    print("[rest] " + json.dumps(line))
    for f in list(out.glob("checkpoint-*.pth")) + list(
            (TRAIN_DIR / "rest_resume" / "result").glob("checkpoint-*.pth")):
        f.unlink()
    del eng, st, captured
    torch.cuda.empty_cache()
    return line


def _rest_radar_ae() -> dict:
    """(c) the frozen YAML's radar autoencoder (encoder and decoder, random
    weights, f32, ``matmul_precision: highest``) at the product cube
    (128, 64, 32, 1): ``encode`` -> ``decode`` on the card against the CPU."""
    from rald_torch import apply_matmul_precision
    from rald_torch.config import load_config
    from rald_torch.models.registry import get_radar_encoder_model
    from rald_torch.train.gen_engine import init_random_weights

    apply_matmul_precision("highest")
    cfg = load_config(FROZEN_CFG)
    r = cfg.dataset.radar
    ae = get_radar_encoder_model(cfg.radar_enc.name, in_channels=1,
                                 overrides=cfg.radar_enc.get("overrides")).eval()
    init_random_weights(ae, torch.Generator().manual_seed(17))
    x = torch.from_numpy(np.random.default_rng(17).normal(
        size=(1, int(r.tgt_r_dim), int(r.tgt_a_dim), int(r.tgt_e_dim), 1)).astype(np.float32))
    with torch.no_grad():
        want = ae.decode(ae.encode(x))
        ae.cuda()
        t0 = time.perf_counter()
        z = ae.encode(x.cuda())
        got = ae.decode(z).cpu()
        card_s = time.perf_counter() - t0
    err, ref = float((got - want).abs().max()), float(want.abs().max())
    line = {"mode": "radar autoencoder encode -> decode, card vs CPU, f32 highest",
            "name": cfg.radar_enc.name, "input": list(x.shape), "latent": list(z.shape),
            "pred": list(got.shape), "max_abs_diff": err, "max_abs_pred": ref,
            "bar": RADAR_AE_BAR * ref, "card_s": card_s}
    print("[rest] " + json.dumps(line))
    check(tuple(got.shape) == tuple(x.shape) and math.isfinite(err) and err <= RADAR_AE_BAR * ref,
          f"radar autoencoder card vs CPU: {line}")
    torch.backends.cudnn.allow_tf32 = True
    torch.set_float32_matmul_precision("highest")
    del ae
    torch.cuda.empty_cache()
    return line


def _rest_trace() -> dict:
    """(c) ``maybe_trace`` around one ``sample_tokens`` call of the product
    engine at full width and depth 2 (bf16, batch 1, random weights; depth
    24 writes a 90 MB trace), an ``annotate`` region inside: the Chrome
    trace names the region and row 1's GEMM kernels."""
    import shutil

    from rald_torch.ops import launch_counts, reset_launch_counts
    from rald_torch.train.gen_engine import GenerationEngine
    from rald_torch.train.profiler import annotate, maybe_trace

    cfg = _product_cfg(depth=2)
    eng = GenerationEngine(cfg)
    cube = _inputs(cfg, 1, np.random.default_rng(5))["radar_cube"]
    eng.sample_tokens(cube, [0])  # warm-up
    d = REST_DIR / "trace"
    shutil.rmtree(d, ignore_errors=True)
    reset_launch_counts()
    with maybe_trace(profile_dir=str(d)):
        with annotate("rald_sample_tokens"):
            eng.sample_tokens(cube, [0])
        torch.cuda.synchronize()
    n_row1 = launch_counts()["fused_ln_geglu_residual"]
    files = list(d.glob("trace_*.json"))
    check(len(files) == 1, f"maybe_trace: {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    kernels = [e["name"] for e in events if e.get("cat") == "kernel"]
    row1 = [k for k in kernels if "gemm_kernel" in k]
    line = {"mode": "maybe_trace around sample_tokens", "row1_launches": n_row1,
            "kernel_events": len(kernels), "gemm_kernel_events": len(row1),
            "gemm_kernel_names": sorted(set(row1))[:4],
            "annotated": any(e.get("name") == "rald_sample_tokens" for e in events),
            "trace_mib": files[0].stat().st_size / 2 ** 20}
    print("[rest] " + json.dumps(line))
    check(n_row1 == _per_nfe(eng) and line["annotated"] and len(row1) >= n_row1,
          f"maybe_trace: {line}")
    del eng
    torch.cuda.empty_cache()
    return line


def phase_rest() -> dict:
    """Phase 11: churn, the int8 drivers, the converters' round trip, the
    radar decoder and the profiler hooks (``build/chip_smoke/rest/``)."""
    out, secs = {}, {}
    for name, part in (("churn", _rest_churn), ("int8", _rest_int8_drivers),
                       ("resume", _rest_resume), ("radar_ae", _rest_radar_ae),
                       ("trace", _rest_trace)):
        t = time.perf_counter()
        out[name] = part()
        secs[name] = round(time.perf_counter() - t, 1)
    print("[rest] part seconds " + json.dumps(secs))
    return out


CURVES_DIR = SCRATCH / "curves"  # the recipe's tree, YAMLs, outputs and gate artifact (phase 12)
CURVES_AE_EPOCHS = 8  # of the recipe's 60 (evals after epochs 3 and 7)
CURVES_GEN_EPOCHS = 4  # of the recipe's 120 (the eval after epoch 3)
JAX_STAGE1_VAL_IOU = {3: 0.5806, 7: 0.7548}  # docs/artifacts/curves_stage1_log.jsonl
CURVES_MIN_IOU_EPOCH7 = 0.5
# finite in every record (a val CD is inf while a frame predicts no point)
CURVES_FINITE = ("train_loss", "lr", "val_iou", "val_loss")


def _launches_per_batch(counts: dict, cfg, loader) -> dict:
    """Launches per evaluated batch (``evaluate`` takes every
    ``eval.freq``-th batch of ``loader``)."""
    batches = len(range(0, len(loader), int(cfg.eval.get("freq", 1) or 1)))
    return {k: v / batches for k, v in counts.items() if v}


def _curves_stage1(ae_cfg) -> dict:
    """(b) The first CURVES_AE_EPOCHS epochs of the recipe's stage 1, the
    ``AEEngine`` epoch loop driven here, so the LR horizon stays the
    recipe's 60 epochs; evals every ``eval_freq``; then the checkpoint."""
    from rald_torch.cli.main_ae import build_loaders
    from rald_torch.ops import launch_counts, reset_launch_counts
    from rald_torch.train.ae_engine import AEEngine
    from rald_torch.train.checkpoint import CheckpointManager

    eng = AEEngine(ae_cfg)
    train_loader, val_loader, batch = build_loaders(ae_cfg)
    state = eng.init_state(len(train_loader), batch)
    eval_freq = int(ae_cfg.train.eval_freq)
    lines, epochs, eval_counts = [], [], []
    for epoch in range(CURVES_AE_EPOCHS):
        train_loader.set_epoch(epoch)
        state, stats = eng.train_one_epoch(state, train_loader, epoch, print_fn=lines.append)
        rec = {"epoch": epoch, "train_loss": stats["loss"], "lr": stats["lr"]}
        if (epoch + 1) % eval_freq == 0:
            reset_launch_counts()
            val = eng.evaluate(state, val_loader, print_fn=lines.append)
            torch.cuda.synchronize()
            eval_counts.append(launch_counts())
            rec.update(val_iou=val["iou"], val_loss=val["loss"], val_cd=val["cd"],
                       jax_val_iou=JAX_STAGE1_VAL_IOU.get(epoch))
        epochs.append(rec)
    ckpt = CheckpointManager(ae_cfg.system.output_dir).save(state, CURVES_AE_EPOCHS - 1)
    losses = [r["train_loss"] for r in epochs]
    evals = [r for r in epochs if "val_iou" in r]
    check(all(math.isfinite(r[k]) for r in epochs for k in CURVES_FINITE if k in r),
          f"curves stage 1: {epochs}")
    check(losses[-1] < losses[0], f"curves stage 1: the loss did not fall: {losses}")
    check(evals[-1]["epoch"] == 7 and evals[-1]["val_iou"] >= CURVES_MIN_IOU_EPOCH7,
          f"curves stage 1: val IoU at epoch 7 {evals[-1]}")
    per_batch = _launches_per_batch(eval_counts[-1], ae_cfg, val_loader)
    check(per_batch.get("fused_ln_geglu_residual") == 2 * AE_FF_PER_FORWARD
          and per_batch.get("nn_min_sq_both") == 1, f"curves stage 1 eval launches {per_batch}")
    del eng, state
    return {"epochs": epochs, "ckpt": ckpt, "eval_launches_per_batch": per_batch}


def _curves_stage2(gen_cfg) -> dict:
    """(d) The first CURVES_GEN_EPOCHS epochs of the recipe's stage 2 (its
    120-epoch horizon), from the cache, the ``GenerationEngine`` epoch loop
    driven here, the EMA eval after epoch 3; then the checkpoint."""
    from rald_torch.cli.main_generation import (
        build_eval_loader,
        build_train_loader,
        load_frozen_modules,
    )
    from rald_torch.ops import launch_counts, reset_launch_counts
    from rald_torch.train.checkpoint import CheckpointManager
    from rald_torch.train.gen_engine import GenerationEngine

    lines = []
    eng = GenerationEngine(gen_cfg)
    train_loader = build_train_loader(gen_cfg, lines.append)
    eval_loader = build_eval_loader(gen_cfg, "train", lines.append)
    state = eng.init_state(len(train_loader), int(gen_cfg.dataset.batch_size))
    load_frozen_modules(gen_cfg, eng, lines.append)
    check(f"Loaded frozen VAE from {gen_cfg.lidar_ae.ckpt}" in lines, f"curves stage 2: {lines}")
    eval_freq = int(gen_cfg.train.eval_freq)
    epochs, counts = [], None
    for epoch in range(CURVES_GEN_EPOCHS):
        train_loader.set_epoch(epoch)
        state, stats = eng.train_one_epoch(state, train_loader, epoch, print_fn=lines.append)
        rec = {"epoch": epoch, "train_loss": stats["loss"], "lr": stats["lr"]}
        if (epoch + 1) % eval_freq == 0:
            reset_launch_counts()
            val = eng.evaluate(eval_loader, use_ema=True, state_or_params=state,
                               print_fn=lines.append)
            torch.cuda.synchronize()
            counts = launch_counts()
            rec.update(val_iou=val["iou"], val_cd=val["cd"], val_loss=val["loss"])
        epochs.append(rec)
    ckpt = CheckpointManager(gen_cfg.system.output_dir).save(state, CURVES_GEN_EPOCHS - 1)
    check(all(math.isfinite(r[k]) for r in epochs for k in CURVES_FINITE if k in r),
          f"curves stage 2: {epochs}")
    check(counts is not None and epochs[-1].get("val_iou") is not None, "curves stage 2: no eval")
    per_batch = _launches_per_batch(counts, gen_cfg, eval_loader)
    check(per_batch.get("fused_ln_geglu_residual") == _per_nfe_cfg(gen_cfg) + 24
          and per_batch.get("nn_min_sq_both") == 1, f"curves stage 2 eval launches {per_batch}")
    del eng, state
    torch.cuda.empty_cache()
    return {"epochs": epochs, "ckpt": ckpt, "eval_launches_per_batch": per_batch}


def phase_curves() -> dict:
    """Phase 12: the convergence recipe (``rald_torch.cli.curves_configs``) cut
    to fit, at full width, under ``build/chip_smoke/curves/``: (a) the tree
    and YAMLs; (b) stage 1's first epochs of 60; (c) ``main_cache`` from
    that checkpoint; (d) stage 2's first epochs of 120 from the cache, with
    one EMA eval; (e) ``precision_gate`` on that checkpoint, 1 mask batch,
    its three runs. The checkpoints stay for phase 13."""
    import shutil

    import yaml

    from rald_torch.cli import curves_configs, main_cache, precision_gate
    from rald_torch.config import finalize_dirs, load_config
    from rald_torch.ops import launch_counts, reset_launch_counts

    shutil.rmtree(CURVES_DIR, ignore_errors=True)
    torch.cuda.reset_peak_memory_stats()
    secs = {}
    t = time.perf_counter()
    ae_yml, gen_yml = curves_configs.main(CURVES_DIR, print_fn=lambda *a: None)
    secs["tree"] = time.perf_counter() - t
    ae_cfg = finalize_dirs(load_config(ae_yml))
    gen_cfg = finalize_dirs(load_config(gen_yml))
    check(int(ae_cfg.train.epochs) == 60 and int(gen_cfg.train.epochs) == 120
          and gen_cfg.lidar_ae.ckpt.endswith("out_ae/checkpoint-59.pth"), "curves: the recipe")

    t = time.perf_counter()
    s1 = _curves_stage1(ae_cfg)
    secs["stage1"] = time.perf_counter() - t
    torch.cuda.empty_cache()
    gen_cfg.lidar_ae.ckpt = str(s1["ckpt"])  # the cut stage 1's file

    t = time.perf_counter()
    lines = []
    main_cache.run(gen_cfg, print_fn=lines.append)
    secs["cache"] = time.perf_counter() - t
    check(f"Loaded frozen VAE from {s1['ckpt']}" in lines, f"curves main_cache: {lines[:3]}")
    n_cached = len(list((Path(gen_cfg.lidar_ae.cache_path)).rglob("*.npz")))
    check(n_cached == 200, f"curves main_cache wrote {n_cached} files")
    torch.cuda.empty_cache()

    t = time.perf_counter()
    s2 = _curves_stage2(gen_cfg)
    secs["stage2"] = time.perf_counter() - t

    # the gate's "default" is torch as a process starts (earlier phases set
    # other values); "highest" leaves cuDNN TF32 off, restored after
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = True
    gen_yml.write_text(yaml.safe_dump(gen_cfg.to_dict()))  # the gate reads ROOT/gen.yml
    t = time.perf_counter()
    reset_launch_counts()
    gate = precision_gate.run(CURVES_DIR, s2["ckpt"], 1, print_fn=lambda *a: None)
    torch.cuda.synchronize()
    gate_counts = {k: v for k, v in launch_counts().items() if v}
    secs["gate"] = time.perf_counter() - t
    torch.backends.cudnn.allow_tf32 = True
    for p in gate["precisions"].values():
        # a CD is inf while a frame predicts no point (early in stage 2)
        check(all(math.isfinite(p[k]) for k in ("iou", "fscore")) and p["cd_m"] > 0,
              f"curves gate {gate}")
    rc = precision_gate.recipe_cfg(CURVES_DIR, s2["ckpt"])
    want_q = int(rc.dataset.eval_batch_size) * (int(rc.eval.inference.num_query_points)
                                                 + int(rc.dataset.query_aug_num))
    check(gate["mask"]["queries_compared"] == want_q, f"curves gate mask {gate['mask']}")
    # the third run: apply_matmul_precision("default"), torch's "medium"
    medium = gate["precisions"]["medium"]["settings"]
    check(medium["float32_matmul_precision"] == "medium" and medium["cudnn_allow_tf32"]
          and gate["mask_medium_vs_highest"]["queries_compared"] == want_q,
          f"curves gate medium run {medium} {gate['mask_medium_vs_highest']}")
    check(gate_counts.get("fused_ln_geglu_residual", 0) > 0 and gate_counts.get("nn_min_sq_both", 0) > 0,
          f"curves gate launches {gate_counts}")
    # the two checkpoints stay: phase 13 benches them, then deletes them
    line = {"stage_s": {k: round(v, 1) for k, v in secs.items()},
            "stage1": [{k: v for k, v in r.items() if v is not None} for r in s1["epochs"]],
            "stage1_eval_launches_per_batch": s1["eval_launches_per_batch"],
            "stage2": s2["epochs"], "stage2_eval_launches_per_batch": s2["eval_launches_per_batch"],
            "gate": {"precisions": {k: {m: v[m] for m in ("iou", "cd_m", "fscore", "eval_wall_s")}
                                    for k, v in gate["precisions"].items()},
                     "mask": gate["mask"], "deltas": gate["deltas_default_minus_highest"],
                     "same_settings": gate["same_settings"],
                     "mask_medium_vs_highest": gate["mask_medium_vs_highest"],
                     "deltas_medium_minus_highest": gate["deltas_medium_minus_highest"],
                     "launches": gate_counts},
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30, "device": smi_line()}
    print("[curves] " + json.dumps(line))
    return {"stage1": s1, "stage2": s2, "gate_launches": gate_counts}


# phase 13: the product bench on phase 12's stage-2 checkpoint: bf16 with
# 1 warm-up + PB_REPEATS timed passes, then int8 dynamic + "vout" with 1 + 1
PB_REPEATS = 3
PB_INT8_REPEATS = 1


def _bench_mode(ckpt: Path, int8: str, repeats: int) -> tuple:
    """``product_eval_bench.run`` in one mode on the checkpoint's params (the
    recipe with ``train.use_ema: false``: after phase 12's 100 stage-2 steps
    the EMA, at rate 0.999, is still about 90 % its initial weights, and
    predicts no point in most frames); the engine it built and each
    ``fused_eval_step``'s ``n_pred``, caught on the way."""
    from rald_torch.cli import product_eval_bench
    from rald_torch.cli.precision_gate import recipe_cfg
    from rald_torch.train.gen_engine import GenerationEngine

    seen, step = {"n_pred": [], "lines": []}, GenerationEngine.fused_eval_step

    def caught(self, *a, **k):
        seen["engine"] = self
        out = step(self, *a, **k)
        seen["n_pred"] += out[5].tolist()
        return out

    GenerationEngine.fused_eval_step = caught
    try:
        torch.cuda.reset_peak_memory_stats()
        cfg = recipe_cfg(CURVES_DIR, ckpt, helper_aug_on_device=True)
        cfg.train.use_ema = False
        out = CURVES_DIR / f"product_eval_bench{'_' + int8 if int8 else ''}.json"
        art = product_eval_bench.run(CURVES_DIR, ckpt, repeats=repeats, int8=int8, profile=False,
                                     max_batches=0, host_helper=False, cfg=cfg, out=out,
                                     print_fn=seen["lines"].append)
        art["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    finally:
        GenerationEngine.fused_eval_step = step
    return art, seen


def phase_product_bench() -> dict:
    """Phase 13: ``python -m rald_torch.cli.product_eval_bench`` (JAX's
    product recipe: 5e5 grid + 7e5 helpers densified on the card + 5e5
    refine, Chamfer / F) on phase 12's stage-2 checkpoint (its params, see
    ``_bench_mode``) and YAML, over
    the recipe's 50 test frames at batch 8: bf16, one warm-up and
    PB_REPEATS timed passes, then int8 dynamic + "vout", one and
    PB_INT8_REPEATS. Checks: identical metrics across the timed passes,
    every frame's ``n_pred`` > 0, finite CD / F, the real frame count, and
    exact launches per batch (phase 4's ``_want_launches``). Runs phase 12
    first when its checkpoint is missing; deletes it at the end."""
    from rald_torch.cli.main_generation import build_eval_loader
    from rald_torch.cli.precision_gate import recipe_cfg

    ckpts = sorted((CURVES_DIR / "out_gen").glob("checkpoint-*.pth"))
    if not ckpts:
        phase_curves()
        ckpts = sorted((CURVES_DIR / "out_gen").glob("checkpoint-*.pth"))
    ckpt = ckpts[-1]
    frames = len(build_eval_loader(recipe_cfg(CURVES_DIR, ckpt), "eval",
                                   print_fn=lambda *_: None).dataset)
    torch.cuda.empty_cache()
    line, out, failed = {}, {}, []
    for label, int8, repeats in (("bf16", "", PB_REPEATS), ("int8_dynamic", "dynamic",
                                                             PB_INT8_REPEATS)):
        t = time.perf_counter()
        art, seen = _bench_mode(ckpt, int8, repeats)
        wall = time.perf_counter() - t
        s, timed, got = art["summary"], art["passes"]["timed"], art["kernel_launches"]["per_batch"]
        n_pred = np.array(seen["n_pred"])
        out[label] = art
        line[label] = {"passes": [{k: r[k] for k in ("wall_s", "pc_per_sec", "iou", "cd_m",
                                                     "fscore")} for r in timed],
                       "pc_per_sec": s["pc_per_sec"], "wall_s": s["wall_s"],
                       "warmup_s": art["passes"]["warmup"]["wall_s"], "mode_s": wall,
                       "launches_per_batch": got, "peak_gib": art["peak_gib"],
                       "n_pred_min": int(n_pred.min()), "n_pred_median": float(np.median(n_pred))}
        vae = [l for l in seen["lines"] if isinstance(l, str) and "frozen VAE" in l]
        want = {k: v for k, v in _want_launches(seen["engine"]).items() if v}
        failed += [f"product bench {label}: {msg}" for ok, msg in (
            (vae and vae[0].startswith("Loaded frozen VAE from"), f"VAE {vae}"),
            (s["metrics_identical"] and len(timed) == repeats,
             f"metrics differ across the timed passes {timed}"),
            (s["frames"] == frames == 50, f"{s['frames']} frames of {frames}"),
            (all(math.isfinite(r[k]) for r in timed for k in ("iou", "cd_m", "fscore")),
             f"non-finite metrics {timed}"),
            (len(n_pred) == (1 + repeats) * 56 and n_pred.min() > 0,
             f"empty prediction n_pred={n_pred.tolist()}"),
            (got == want, f"launches per batch {got}, want {want}")) if not ok]
        del seen
        torch.cuda.empty_cache()
    line.update(ckpt=str(ckpt.relative_to(REPO)), frames=frames, batch=8, device=smi_line())
    print("[product_bench] " + json.dumps(line))
    check(not failed, "; ".join(failed))
    for f in list(CURVES_DIR.rglob("checkpoint-*.pth")):
        f.unlink()
    return out


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
    t = time.perf_counter()
    eval_runs = phase_eval()
    print(f"[time] phase 6 (dataset eval) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    train = phase_train()
    print(f"[time] phase 7 (training) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    ae = phase_ae()
    print(f"[time] phase 8 (stage-1 VAE training) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    prep = phase_prep()
    print(f"[time] phase 9 (data preparation) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    dist = phase_dist()
    print(f"[time] phase 10 (multi-process) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    rest = phase_rest()
    print(f"[time] phase 11 (churn, int8 drivers, converters, radar decoder, trace) "
          f"{time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    curves = phase_curves()
    print(f"[time] phase 12 (convergence recipe, cut) {time.perf_counter() - t:.1f} s")
    t = time.perf_counter()
    bench = phase_product_bench()
    print(f"[time] phase 13 (product eval bench) {time.perf_counter() - t:.1f} s")
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
        if k["name"] not in mode_of:  # the Hunyuan3D kernels: no RaLD chain runs them
            continue
        mode = mode_of[k["name"]]
        k["launches_mode"] = mode
        k["launches"] = runs[(mode, 1)]["launches"][k["name"]]
        if (mode, 8) in runs:
            k["launches_b8"] = runs[(mode, 8)]["launches"][k["name"]]
        if k["name"] in f32_mode_of:
            mode = f32_mode_of[k["name"]]
            k["f32"].update(launches_mode=mode, launches=runs[(mode, 1)]["launches"][k["name"]])
            check(k["f32"]["launches"] > 0, f"{k['name']}: no f32 launch in {mode}")
    # rows 1 and 2 on the dataset eval entry point (phase 6): launches per
    # batch and, for row 2, the slice count S of the last launch, per run
    for k in kernels:
        if k["name"] in ("fused_ln_geglu_residual", "nn_min_sq_both"):
            k["eval_cli"] = [
                {"mode": r["mode"], "scene": r["scene"],
                 "launches_per_batch": r["launches_per_batch"][k["name"]],
                 **({"split": r["nn_split"]} if k["name"] == "nn_min_sq_both" else {})}
                for label in ("shipped", "fused", "frozen_enc") for r in eval_runs[label]]
    # the training path (phase 7): launches over the 6 train steps (none:
    # training runs the plain modules) and per batch of its EMA evaluation
    for k in kernels:
        k["train"] = {"train_steps": train["product"]["train_step_launches"][k["name"]],
                      "train_eval_per_batch":
                          train["product"]["eval_launches_per_batch"].get(k["name"], 0)}
    # stage-1 training (phase 8): launches over its 6 train steps (none) and
    # per batch of its evaluation
    for k in kernels:
        k["ae_train"] = {"train_steps": ae["product"]["train_step_launches"][k["name"]],
                         "eval_per_batch": ae["product"]["eval_launches_per_batch"].get(k["name"], 0)}
    # data preparation (phase 9): launches per batch of the processed raw
    # tree's eval (the DSP itself reaches no kernel of the table)
    for k in kernels:
        k["prep_eval_per_batch"] = prep["eval"]["launches_per_batch"].get(k["name"], 0)
    # multi-process runs (phase 10): rows 1 and 2 per eval batch of the NCCL
    # world-1 training run, and per rank of the two-rank gloo infer
    for k in kernels:
        if k["name"] in ("fused_ln_geglu_residual", "nn_min_sq_both"):
            k["dist"] = {
                "nccl_world1_eval_per_batch":
                    dist["nccl_world1"]["eval_launches_per_batch"].get(k["name"], 0),
                "gloo_world2_infer_per_rank": [l.get(k["name"], 0) for l in
                                               dist["gloo_world2"]["infer"]["rank_launches"]]}
    # phase 11: launches of the churn chain's runs, and per gate mode
    gate = rest["int8"]["gate"]["modes"]
    for k in kernels:
        k["rest"] = {"churn": {f"{mode} B={b}": r["launches"][k["name"]]
                               for (mode, b), r in rest["churn"]["runs"].items()},
                     "int8_gate": {m: row["launches"].get(k["name"], 0) for m, row in gate.items()}}
    # phase 12: launches per evaluated batch of the cut recipe's stage-1 and
    # stage-2 evals, and over the precision gate
    for k in kernels:
        k["curves"] = {
            "stage1_eval_per_batch": curves["stage1"]["eval_launches_per_batch"].get(k["name"], 0),
            "stage2_eval_per_batch": curves["stage2"]["eval_launches_per_batch"].get(k["name"], 0),
            "precision_gate": curves["gate_launches"].get(k["name"], 0)}
    # phase 13: launches per batch of the product bench's timed passes
    for k in kernels:
        k["product_bench_per_batch"] = {
            mode: art["kernel_launches"]["per_batch"].get(k["name"], 0)
            for mode, art in bench.items()}
    print(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
