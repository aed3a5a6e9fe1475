"""The matmul-precision gate on a trained stage-2 checkpoint: the port of
``scripts/precision_gate.py``, with its protocol.

    python -m rald_torch.cli.precision_gate [ROOT] [CKPT] [MASK_BATCHES] [--out <json>] [--device cpu]

``ROOT`` is the recipe's root (``build/curves``: its ``gen.yml``), ``CKPT``
a stage-2 ``.pth`` (default ``ROOT/out_gen/checkpoint-119.pth``; its EMA
weights with ``train.use_ema``, as ``gen.yml`` sets), ``MASK_BATCHES`` 2.
Three runs, ``default`` first and ``highest`` second (JAX's two, in JAX's
order, so that no setting leaks backwards), then ``medium``, each with a
fresh engine, on the test split in batches of ``eval_batch_size``:

1. the mask phase: :meth:`GenerationEngine._sample_and_decode` (the 35-NFE
   sampler, then the thresholded decode of a ``build_query_grid`` of 5e5
   queries followed by the batch's 7e5 densified helper points) on the
   first ``MASK_BATCHES`` batches, batch ``b`` with prior seeds
   ``b*B .. b*B+B-1``, the grids drawn from one ``default_rng(0)``
   stream: each run gets the same batches, seeds, grids and helpers;
2. ``evaluate`` with the full product recipe (5e5 grid + 7e5 helper + 5e5
   refine queries, Chamfer / F-score) over the whole split.

The artifact (default ``ROOT/precision_gate_<ckpt stem>.json``) has JAX's
keys: ``precisions`` (each run's IoU / CD / F and eval wall time),
``mask`` (the share of grid hits that agree, the positives' IoU) and
``deltas_default_minus_highest``; each run also records its torch settings
and the device, and ``same_settings`` says whether ``default`` and
``highest`` had the same ones. The third run adds ``mask_medium_vs_highest``
and ``deltas_medium_minus_highest``, held to the same bar as JAX's pair
(|ΔIoU| <= 0.005). The process's settings are restored at the end.

What ``default`` and ``highest`` mean here. JAX's ``default`` is the
platform default (``jax_default_matmul_precision`` None: on a TPU, f32
matmuls as bf16 passes). The port's counterpart is torch as a process
starts: no call to :func:`rald_torch.apply_matmul_precision`. On the card
that is ``torch.get_float32_matmul_precision() == "highest"`` (f32 matmuls
in full f32) with ``torch.backends.cudnn.allow_tf32`` True (f32
convolutions may use TF32). ``highest`` is
``apply_matmul_precision("highest")``: the same matmul precision and cuDNN
TF32 off. So the two runs differ in one switch, cuDNN's TF32, which moves
only f32 convolutions. The recipe computes in bf16 (``compute_dtype:
bfloat16``): the DiT's radar encoder, the one ``Conv3d`` stack on the path,
runs in bf16, where the switch does nothing, and the port's kernels compute
f32 products exactly under either setting. On the card both runs then
compute the same thing, up to any nondeterminism of the library kernels;
the artifact says so (``same_settings`` false, yet a mask agreement of 1.0
and zero deltas), and that agreement is the finding, not a vacuous pass.

``medium`` is ``apply_matmul_precision("default")``, the port's stand-in
for JAX's platform default: ``torch.set_float32_matmul_precision("medium")``
with cuDNN TF32 on, which lets PyTorch compute f32 matmuls with bf16
products where it can. That is the lowest f32 setting the port has, and
the one a YAML's ``system.matmul_precision: default`` selects.

The recipe (:func:`recipe_cfg`) is shared with
``rald_torch.cli.product_eval_bench``. This gate, as JAX's, leaves
``dataset.helper_aug_on_device`` as ``gen.yml`` has it (unset: the dataset
densifies the CFAR helpers to 7e5 on the host from its own stream); the
bench sets it true (the engine densifies them on the card) unless
``RALD_PE_HOST_HELPER=1``. The IoU reads only the eval queries, which no
helper draw touches; CD and F see the helpers.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch
import yaml

from rald_torch import apply_matmul_precision, precision_in_force
from rald_torch.cli import curves_configs
from rald_torch.cli.main_generation import build_eval_loader, join, load_frozen_modules
from rald_torch.config import Config
from rald_torch.eval.queries import build_query_grid
from rald_torch.train.checkpoint import load_torch_checkpoint
from rald_torch.train.gen_engine import GenerationEngine

# run name -> the apply_matmul_precision value (None: torch as the process starts)
PRECISIONS = {"default": None, "highest": "highest", "medium": "default"}


def recipe_cfg(root, ckpt, helper_aug_on_device=None) -> Config:
    """The reference's full inference recipe on ``ROOT/gen.yml`` in eval
    mode on ``ckpt``: JAX's ``_recipe_cfg`` (``scripts/precision_gate.py``)
    with ``helper_aug_on_device`` None, else JAX's product bench
    (``scripts/product_eval_bench.py:61-84``), which also sets
    ``dataset.helper_aug_on_device`` and two keys of its inference block
    that no engine reads (``query_helper_aug``, ``query_aug_num``)."""
    cfg = Config(yaml.safe_load((Path(root) / "gen.yml").read_text()))
    cfg.system.mode = "eval"
    cfg.eval.ckpt = str(ckpt)
    cfg.dataset.use_query_helper = True
    cfg.dataset.query_helper_aug = True
    cfg.dataset.query_aug_num = 7e5
    cfg.dataset.query_aug_scale = 2
    inference = {"num_query_points": 500000, "query_helper": True}
    if helper_aug_on_device is not None:
        cfg.dataset.helper_aug_on_device = bool(helper_aug_on_device)
        inference.update(query_helper_aug=True, query_aug_num=7e5)
    inference.update(refine_query=True, refine_query_aug_num=500000, refine_query_scale=10)
    cfg.eval.inference = Config(inference)
    cfg.eval.use_test_set = True
    cfg.eval.store_pc = False
    cfg.eval.freq = 1
    return cfg


def mask_hits(engine: GenerationEngine, cfg, loader, mask_batches: int) -> np.ndarray:
    """Phase 1: the grid-hit masks of the first ``mask_batches`` batches of
    ``loader``, (mask_batches * B, Q) bool, with JAX's seeds, grid stream
    and helpers."""
    rng_np = np.random.default_rng(0)
    masks = []
    batches = iter(loader)
    try:
        for b in range(mask_batches):
            batch = next(batches)
            radar_cube = batch["radar_cube"]
            if engine.frozen_radar_enc:
                radar_cube = engine.encode_radar(radar_cube)
            grid = build_query_grid(cfg.dataset.lidar, int(cfg.eval.inference.num_query_points),
                                    False, rng_np)
            bsz = np.asarray(batch["lidar_points"]).shape[0]
            helper = np.asarray(batch["helper_points"], np.float32)
            _, _, hits, _ = engine._sample_and_decode(
                radar_cube, list(range(b * bsz, (b + 1) * bsz)), batch["query_points"], grid,
                helper)
            masks.append(hits.cpu().numpy())
    finally:
        batches.close()
    return np.concatenate(masks)


def settings(device) -> dict:
    """The torch switches that decide f32 matmul and convolution precision,
    and the device."""
    dev = torch.device(device) if device else torch.device("cuda")
    return {**precision_in_force(),
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev)}


def run(root=curves_configs.DEFAULT_ROOT, ckpt=None, mask_batches: int = 2, out=None,
        device=None, cfg=None, print_fn=print) -> dict:
    """The three runs and the artifact (returned and written). ``cfg``
    replaces :func:`recipe_cfg` (a test's shrunk recipe)."""
    root = Path(root)
    ckpt = Path(ckpt) if ckpt else root / "out_gen" / "checkpoint-119.pth"
    if not ckpt.is_file():
        raise FileNotFoundError(f"no checkpoint at {ckpt}")
    info = join(device, print_fn)
    cfg = recipe_cfg(root, ckpt) if cfg is None else cfg
    loader = build_eval_loader(cfg, "eval", print_fn)
    use_ema = bool(cfg.train.get("use_ema", True))
    out_art = {"ckpt": str(ckpt), "backend": (torch.device(device) if device else
                                              torch.device("cuda")).type,
               "inference_mode": f"{cfg.system.get('compute_dtype', 'float32')} (product default)",
               "world_size": info["world_size"], "precisions": {}}
    hits_by_precision = {}
    before = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    for precision, value in PRECISIONS.items():
        if value is not None:
            apply_matmul_precision(value)
        engine = GenerationEngine(cfg, device=device)
        engine.load_state_dicts(edm_state_dict=load_torch_checkpoint(ckpt, ema=use_ema))
        load_frozen_modules(cfg, engine, print_fn)
        hits_by_precision[precision] = mask_hits(engine, cfg, loader, mask_batches)
        t0 = time.perf_counter()
        stats = engine.evaluate(loader, use_ema=use_ema, print_fn=print_fn)
        out_art["precisions"][precision] = {
            "iou": round(float(stats.get("iou", -1)), 5),
            "cd_m": round(float(stats.get("cd", -1)), 5),
            "fscore": round(float(stats.get("fscore", -1)), 5),
            "eval_wall_s": round(time.perf_counter() - t0, 1),
            "settings": settings(device),
        }
        print_fn(f"{precision} {out_art['precisions'][precision]}")
        del engine
    torch.set_float32_matmul_precision(before[0])
    torch.backends.cudnn.allow_tf32 = before[1]

    runs = out_art["precisions"]
    for name, mask_key in (("default", "mask"), ("medium", "mask_medium_vs_highest")):
        a, b = hits_by_precision[name], hits_by_precision["highest"]
        pos = np.logical_or(a, b).sum()
        out_art[mask_key] = {
            "batches": mask_batches,
            "queries_compared": int(a.size),
            "agreement": round(float(np.mean(a == b)), 6),
            "positive_iou": round(float(np.logical_and(a, b).sum() / max(pos, 1)), 6),
            f"positives_{name}": int(a.sum()),
            "positives_highest": int(b.sum()),
        }
        out_art[f"deltas_{name}_minus_highest"] = {
            k: round(runs[name][k] - runs["highest"][k], 5) for k in ("iou", "cd_m", "fscore")}
    out_art["same_settings"] = runs["default"]["settings"] == runs["highest"]["settings"]
    path = Path(out) if out else root / f"precision_gate_{ckpt.stem}.json"
    if info["is_main_process"]:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(out_art, indent=2) + "\n")
    print_fn(json.dumps(out_art, indent=2))
    print_fn(f"written: {path}")
    return out_art


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("rald_torch matmul-precision gate")
    parser.add_argument("root", nargs="?", default=str(curves_configs.DEFAULT_ROOT))
    parser.add_argument("ckpt", nargs="?", default=None,
                        help="stage-2 .pth (default ROOT/out_gen/checkpoint-119.pth)")
    parser.add_argument("mask_batches", nargs="?", type=int, default=2)
    parser.add_argument("--out", default=None,
                        help="artifact path (default ROOT/precision_gate_<ckpt stem>.json)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    return run(args.root, args.ckpt, args.mask_batches, args.out, args.device)


if __name__ == "__main__":
    main()
