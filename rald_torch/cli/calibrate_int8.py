"""Calibrate the static int8 FF activation scales of a stage-2 checkpoint:
the port of ``scripts/calibrate_int8.py``.

    python -m rald_torch.cli.calibrate_int8 --config <generation yml> --ckpt <stage-2 .pth> \
        [--num-batches 8] [--margin 1.10] [--out <npz>] [--device cpu]

``eval.inference.int8_ff: "static"`` replaces the int8 FF kernel's dynamic
per-token activation scales with calibrated per-(schedule step, block)
ones. This driver runs the engine's own Heun sampler in the dynamic int8
mode (``int8_ff: true``: its trajectory is closer to the static one than
the bf16 trajectory is) with ``capture_states`` over ``--num-batches``
batches of the test split, replays each state through the unfused
full-precision denoiser and takes max|h| / max|g| per (step, block)
(:meth:`GenerationEngine.calibrate_act_scales`), times ``--margin``. The
defaults are the JAX package's: a 2-batch / 1.05-margin calibration failed
its quality gate, so 8 batches and 1.10 headroom.

Weights: ``--ckpt`` (EMA where the file has it and ``train.use_ema`` is
unset or true), the frozen VAE and radar encoder of the YAML. Writes
``ah``, ``ag`` (num_steps, depth) and ``num_steps`` to ``--out``, by default
beside the checkpoint (``checkpoint-479.pth`` ->
``checkpoint-479.int8_act_scales.npz``), where the engine looks for them
when ``int8_ff: "static"`` is set with ``eval.ckpt`` alone. Runs on the
card unless ``--device cpu`` is given. Quality-gate the result with
``python -m rald_torch.cli.int8_gate``.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from rald_torch import apply_matmul_precision
from rald_torch.cli.main_generation import build_eval_loader, join, load_frozen_modules
from rald_torch.config import finalize_dirs, load_config
from rald_torch.train.checkpoint import load_torch_checkpoint
from rald_torch.train.gen_engine import GenerationEngine, act_scales_path


def run(cfg, ckpt, num_batches: int = 8, margin: float = 1.10, out=None, device=None,
        print_fn=print) -> Path:
    """Calibrate and write the npz; returns its path."""
    ckpt = Path(ckpt)
    if not ckpt.is_file():
        raise FileNotFoundError(f"no checkpoint at {ckpt}")
    cfg.system.mode = "eval"
    cfg.eval.ckpt = str(ckpt)
    cfg.eval.use_test_set = True
    cfg.eval.inference.int8_ff = True
    join(device, print_fn)
    if cfg.system.get("matmul_precision"):
        apply_matmul_precision(cfg.system.matmul_precision)
    loader = build_eval_loader(cfg, "eval", print_fn)
    engine = GenerationEngine(cfg, device=device)
    use_ema = bool(cfg.get("train", {}).get("use_ema", True))
    engine.load_state_dicts(edm_state_dict=load_torch_checkpoint(ckpt, ema=use_ema))
    load_frozen_modules(cfg, engine, print_fn)
    ah, ag = engine.calibrate_act_scales(loader, num_batches=num_batches, margin=margin,
                                         print_fn=print_fn)
    path = Path(out) if out else act_scales_path(ckpt)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, ah=ah, ag=ag, num_steps=int(engine.sampler_kwargs["num_steps"]))
    print_fn(f"h amax: per-step min {ah.min(1).round(2).tolist()}")
    print_fn(f"        per-step max {ah.max(1).round(2).tolist()}")
    print_fn(f"g amax: per-step min {ag.min(1).round(2).tolist()}")
    print_fn(f"        per-step max {ag.max(1).round(2).tolist()}")
    print_fn(f"written: {path}")
    return path


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser("rald_torch static int8 activation-scale calibration")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True, help="stage-2 .pth checkpoint")
    parser.add_argument("--num-batches", type=int, default=8)
    parser.add_argument("--margin", type=float, default=1.10)
    parser.add_argument("--out", default=None,
                        help="npz path (default: <ckpt stem>.int8_act_scales.npz beside --ckpt)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    return run(finalize_dirs(load_config(args.config)), args.ckpt, args.num_batches, args.margin,
               args.out, args.device)


if __name__ == "__main__":
    main()
