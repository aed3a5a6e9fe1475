"""The product recipe's throughput on a trained checkpoint: the port of
``scripts/product_eval_bench.py``.

    python -m rald_torch.cli.product_eval_bench [ROOT] [CKPT] [--repeats 5] [--out <json>] \\
        [--device cpu]

``ROOT`` is a convergence recipe's root (``python -m
rald_torch.cli.rerun_to_convergence``; default ``build/curves``: its
``gen.yml`` and test split), ``CKPT`` a stage-2 ``.pth`` (default
``ROOT/out_gen/checkpoint-479.pth``; its EMA with ``train.use_ema``). It
drives the product eval path, :meth:`GenerationEngine.evaluate` as
``main_generation``'s eval mode calls it, with the reference's full
inference recipe (:func:`rald_torch.cli.precision_gate.recipe_cfg`, shared
with the precision gate):

  grid 5e5 + CFAR helpers densified to 7e5 on the card -> fused sample +
  decode (35-NFE EDM) -> threshold -> refine decode (5e5 jittered queries,
  scale 10) -> polar -> cartesian -> Chamfer + F-score,

in batches of ``eval_batch_size``: one warm-up pass over the test split,
then ``--repeats`` timed passes (JAX times one). A pass's clock stops after
the card is synchronised; the host work (loader, metrics) is part of it,
as it is of what ``main_generation`` sustains. Frames are the split's real
frames, not the ``pad_last`` duplicates of the last batch. IoU / CD / F
are recorded per pass and must be identical across the timed passes (the
fused path's draws are seeded per batch): the tool raises, after writing
the artifact, when they are not.

Environment (JAX's knobs):

  RALD_BENCH_INT8      '' (bf16), '1' or 'dynamic' (``int8_ff: true``,
                       ``int8_attn: "vout"``), 'static' (``int8_ff:
                       "static"``, ``"vout"``; the scales beside CKPT, from
                       ``python -m rald_torch.cli.calibrate_int8``); any
                       other value raises
  RALD_PE_PROFILE=1    attribute the timed passes to stages with a
                       ``StageTimer`` (it synchronises at stage ends: the
                       attribution run, not the throughput number)
  RALD_PE_BATCHES=N    cap each pass at N batches
  RALD_PE_HOST_HELPER=1  densify the helpers on the host (the dataset's
                       stream) instead of on the card
  RALD_BENCH_CPU=1     run on the CPU, as ``--device cpu`` does

Without one of the last two it runs on the card, or raises. The artifact
(``--out``; default ``docs/artifacts/h100/product_eval_bench.json``,
``product_eval_bench_int8_{dynamic,static}.json`` for the int8 modes,
``product_eval_attrib.json`` under profiling or a batch cap) keeps JAX's
keys (``recipe``, ``eval_batch_size``, ``ckpt``, ``backend``,
``inference_mode``, ``matmul_precision``, ``passes``, ``note``,
``stage_attribution_s`` when profiled); ``matmul_precision`` holds the
torch settings in force, ``compiled_programs`` becomes
``kernel_launches`` (:func:`rald_torch.ops.launch_counts` over the timed
passes, per batch), and ``summary`` (median / min / max of ``pc_per_sec``
and ``wall_s``) and ``device`` (``nvidia-smi``'s name and power limit)
are added.
"""
from __future__ import annotations

import argparse
import itertools
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

from rald_torch import precision_in_force, resolve_device
from rald_torch.cli import curves_configs
from rald_torch.cli.main_generation import build_eval_loader, join, load_frozen_modules
from rald_torch.cli.precision_gate import recipe_cfg
from rald_torch.cli.render_curves import device_line
from rald_torch.ops import launch_counts, reset_launch_counts
from rald_torch.train.checkpoint import load_torch_checkpoint
from rald_torch.train.gen_engine import GenerationEngine
from rald_torch.train.profiler import StageTimer

ARTIFACTS = Path(__file__).resolve().parents[2] / "docs" / "artifacts" / "h100"
RECIPE = "reference full eval: grid 500k + CFAR helper aug 7e5 + refine 5e5 scale 10"
# RALD_BENCH_INT8 -> (eval.inference flags, inference_mode)
INT8_MODES = {
    "": ({}, "bf16"),
    "1": ({"int8_ff": True, "int8_attn": "vout"}, "int8_dynamic+vout"),
    "dynamic": ({"int8_ff": True, "int8_attn": "vout"}, "int8_dynamic+vout"),
    "static": ({"int8_ff": "static", "int8_attn": "vout"}, "int8_static+vout"),
}


def int8_mode(value: str) -> tuple:
    """``(eval.inference flags, inference_mode)`` of a ``RALD_BENCH_INT8``
    value; any other value raises ``ValueError``."""
    if value not in INT8_MODES:
        raise ValueError(f"RALD_BENCH_INT8 must be ''/'1'/'dynamic'/'static', got {value!r}")
    return INT8_MODES[value]


def default_out(int8: str, attribution: bool) -> Path:
    """JAX's artifact names, under ``docs/artifacts/h100/``."""
    if attribution:
        return ARTIFACTS / "product_eval_attrib.json"
    if int8:
        return ARTIFACTS / f"product_eval_bench_int8_{'static' if int8 == 'static' else 'dynamic'}.json"
    return ARTIFACTS / "product_eval_bench.json"


def real_frames(loader, max_batches: int = 0) -> int:
    """The frames a pass evaluates, without the ``pad_last`` duplicates
    that fill the last batch (JAX :119-121)."""
    frames = sum(1 for _ in iter(loader.sampler))
    if max_batches:
        frames = min(frames, max_batches * loader.batch_size)
    return frames


class _Capped:
    """The first ``n`` batches of a loader, for each pass."""

    def __init__(self, loader, n: int):
        self.loader, self.n = loader, n

    def __iter__(self):
        return itertools.islice(iter(self.loader), self.n)


def _spread(values: list) -> dict:
    return {"median": float(np.median(values)), "min": float(min(values)),
            "max": float(max(values))}


def run(root=curves_configs.DEFAULT_ROOT, ckpt=None, repeats: int = 5, out=None, device=None,
        int8=None, profile=None, max_batches=None, host_helper=None, cfg=None,
        print_fn=print) -> dict:
    """The warm-up pass, ``repeats`` timed passes and the artifact (returned,
    and written on rank 0). ``int8`` / ``profile`` / ``max_batches`` /
    ``host_helper`` default to the environment's knobs; ``cfg`` replaces
    the recipe (a test's shrunk one; the int8 flags still apply)."""
    env = os.environ
    int8 = env.get("RALD_BENCH_INT8", "") if int8 is None else int8
    flags, mode = int8_mode(int8)
    profile = env.get("RALD_PE_PROFILE") == "1" if profile is None else bool(profile)
    max_batches = int(env.get("RALD_PE_BATCHES", "0") or 0) if max_batches is None else max_batches
    host_helper = env.get("RALD_PE_HOST_HELPER") == "1" if host_helper is None else host_helper
    if device is None and env.get("RALD_BENCH_CPU") == "1":
        device = "cpu"
    dev = resolve_device(device)
    if repeats < 1:
        raise ValueError(f"repeats must be at least 1, got {repeats}")
    root = Path(root)
    ckpt = Path(ckpt) if ckpt else root / "out_gen" / "checkpoint-479.pth"
    if not ckpt.is_file():
        raise FileNotFoundError(f"no checkpoint at {ckpt}: run python -m "
                                "rald_torch.cli.rerun_to_convergence first")
    info = join(device, print_fn)
    if cfg is None:
        cfg = recipe_cfg(root, ckpt, helper_aug_on_device=not host_helper)
    cfg.eval.inference.update(flags)
    loader = build_eval_loader(cfg, "eval", print_fn)
    use_ema = bool(cfg.train.get("use_ema", True))
    engine = GenerationEngine(cfg, device=dev)  # the weights as the precision gate loads them
    engine.load_state_dicts(edm_state_dict=load_torch_checkpoint(ckpt, ema=use_ema))
    load_frozen_modules(cfg, engine, print_fn)
    frames = real_frames(loader, max_batches)
    batches = min(len(loader), max_batches) if max_batches else len(loader)
    passes = _Capped(loader, max_batches) if max_batches else loader

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    results = {"warmup": None, "timed": []}
    timer = StageTimer(enabled=profile)
    walls = []
    for k in range(1 + repeats):
        if k == 1:  # the launch counts of the timed passes
            sync()
            reset_launch_counts()
        sync()
        t0 = time.perf_counter()
        stats = engine.evaluate(passes, use_ema=use_ema, print_fn=lambda *_: None,
                                stage_timer=timer if k else None)
        sync()
        wall = time.perf_counter() - t0
        row = {"wall_s": wall, "frames": frames, "pc_per_sec": frames / wall,
               "iou": float(stats.get("iou", -1)), "cd_m": float(stats.get("cd", -1)),
               "fscore": float(stats.get("fscore", -1))}
        print_fn(f"[{'timed' if k else 'warmup'}] {row}")
        if k:
            results["timed"].append(row)
            walls.append(wall)
        else:
            results["warmup"] = row
    counts = {n: c / (repeats * batches) for n, c in launch_counts().items() if c}
    timed = results["timed"]
    metrics = [(r["iou"], r["cd_m"], r["fscore"]) for r in timed]
    artifact = {
        "recipe": RECIPE,
        "eval_batch_size": int(cfg.dataset.get("eval_batch_size", 1)),
        "ckpt": str(ckpt),
        "backend": dev.type,
        "inference_mode": mode,
        "matmul_precision": precision_in_force(),
        "passes": results,
        "summary": {"timed_passes": repeats, "frames": frames, "batches_per_pass": batches,
                    "pc_per_sec": _spread([r["pc_per_sec"] for r in timed]),
                    "wall_s": _spread(walls),
                    "metrics_identical": len(set(metrics)) == 1},
        "note": "timed passes after one warm-up pass; each includes the host pipeline, "
                "helper / refine densification and Chamfer / F-score metrics, and ends "
                "with the card synchronised",
        "kernel_launches": {"per_batch": counts, "timed_passes": repeats,
                            "batches_per_pass": batches},
        "helper_aug_on_device": bool(cfg.dataset.get("helper_aug_on_device", False)),
        "world_size": info["world_size"],
        "device": device_line() if dev.type == "cuda" else str(dev),
    }
    if profile:
        report = {k: v / repeats for k, v in timer.report().items()}
        covered = sum(report.values())
        wall = float(np.mean(walls))
        report.update(_stages_total_s=covered, _wall_s=wall, _unattributed_s=wall - covered)
        artifact["stage_attribution_s"] = report
        artifact["note"] += ("; PROFILED run (stage attribution serializes overlap; seconds "
                             "are the mean of the timed passes)")
    path = Path(out) if out else default_out(int8, profile or bool(max_batches))
    if info["is_main_process"]:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(artifact, indent=2) + "\n")
    print_fn(json.dumps(artifact["summary"]))
    print_fn(f"written: {path}")
    if not artifact["summary"]["metrics_identical"]:
        raise RuntimeError(f"product_eval_bench: IoU / CD / F differ across the timed passes: "
                           f"{metrics}")
    return artifact


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("rald_torch product-recipe eval throughput")
    parser.add_argument("root", nargs="?", default=str(curves_configs.DEFAULT_ROOT))
    parser.add_argument("ckpt", nargs="?", default=None,
                        help="stage-2 .pth (default ROOT/out_gen/checkpoint-479.pth)")
    parser.add_argument("--repeats", type=int, default=5, help="timed passes (default 5)")
    parser.add_argument("--out", default=None,
                        help="artifact path (default docs/artifacts/h100/product_eval_bench*.json)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    return run(args.root, args.ckpt, args.repeats, args.out, args.device)


if __name__ == "__main__":
    main()
