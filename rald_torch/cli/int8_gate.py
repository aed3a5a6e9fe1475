"""The int8 quality gate through the product path: the port of
``scripts/int8_gate.py``.

    python -m rald_torch.cli.int8_gate --config <generation yml> --ckpt <stage-2 .pth> \
        [--modes bf16,int8_ff,...] [--out <json>] [--device cpu]

Runs ``rald_torch.cli.main_generation.run`` in eval mode on the test split
(``eval.store_pc: false``) once per inference mode:

    bf16                      the default chain
    int8_ff                   DiT FF matmuls int8, dynamic per-token scales
    int8_ff+attn_vout         plus the v / out attention projections
    int8_ff_static+attn_vout  calibrated per-(step, block) scales; skipped,
                              with a printed line, when the npz is missing
                              (``python -m rald_torch.cli.calibrate_int8``)

and records each mode's ``iou``, ``cd_m``, ``fscore``, ``delta_iou_vs_bf16``
and its kernel launches. Each mode's outputs go under
``<system.output_dir>/int8_gate/<mode>``. ``--modes`` (comma-separated)
reruns some modes and keeps the other rows of an artifact written for the
same checkpoint. The artifact (default ``<system.output_dir>/int8_gate_<ckpt
stem>.json``) also records ``matmul_precision``, the torch settings in
force during the runs (:func:`rald_torch.precision_in_force`:
``system.matmul_precision``, applied by ``main_generation.run``, or
torch's defaults), ``system_matmul_precision`` (the YAML's key, or None)
and the torch device. Runs on the card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import copy
import json
from pathlib import Path

import torch

from rald_torch import precision_in_force
from rald_torch.cli import main_generation
from rald_torch.config import finalize_dirs, load_config
from rald_torch.ops import launch_counts, reset_launch_counts
from rald_torch.train.gen_engine import act_scales_path

MODES = (
    ("bf16", {"int8_ff": False, "int8_attn": False}),
    ("int8_ff", {"int8_ff": True, "int8_attn": False}),
    ("int8_ff+attn_vout", {"int8_ff": True, "int8_attn": "vout"}),
    ("int8_ff_static+attn_vout", {"int8_ff": "static", "int8_attn": "vout"}),
)


def run(cfg, ckpt, modes=None, out=None, device=None, print_fn=print) -> dict:
    """Gate ``ckpt`` in ``modes`` (default: all); returns the artifact."""
    ckpt = Path(ckpt)
    if not ckpt.is_file():
        raise FileNotFoundError(f"no checkpoint at {ckpt}")
    only = set(modes) if modes else None
    unknown = (only or set()) - {n for n, _ in MODES}
    if unknown:
        raise ValueError(f"unknown mode(s) {sorted(unknown)} (one of {[n for n, _ in MODES]})")
    root = Path(cfg.system.get("output_dir", "./result/generation"))
    path = Path(out) if out else root / f"int8_gate_{ckpt.stem}.json"
    results = {}
    if only and path.exists():  # a partial run keeps the settled rows
        prior = json.loads(path.read_text())
        if prior.get("ckpt") == str(ckpt):
            results = {k: v for k, v in prior["modes"].items() if k not in only}
    scales = cfg.eval.inference.get("int8_act_scales") or act_scales_path(ckpt)
    in_force = None
    for name, flags in MODES:
        if only and name not in only:
            continue
        if flags["int8_ff"] == "static" and not Path(str(scales)).exists():
            print_fn(f"=== mode {name} skipped: no {scales} "
                     "(run python -m rald_torch.cli.calibrate_int8) ===")
            continue
        sub = copy.deepcopy(cfg)
        sub.system.mode = "eval"
        sub.system.output_dir = str(root / "int8_gate" / name)
        sub.eval.ckpt = str(ckpt)
        sub.eval.use_test_set = True
        sub.eval.store_pc = False
        for k, v in flags.items():
            sub.eval.inference[k] = v
        print_fn(f"=== mode {name} ===")
        reset_launch_counts()
        stats = main_generation.run(sub, device=device, print_fn=print_fn)
        in_force = precision_in_force()  # as run applied it
        results[name] = {"iou": round(float(stats.get("iou", -1)), 4),
                         "cd_m": round(float(stats.get("cd", -1)), 4),
                         "fscore": round(float(stats.get("fscore", -1)), 4),
                         "launches": {k: v for k, v in launch_counts().items() if v}}
        print_fn(f"{name} {results[name]}")
    base = results.get("bf16")
    if base is None:
        print_fn("NOTE: no bf16 row (include 'bf16' in --modes): deltas vs bf16 omitted")
    for row in results.values():
        if base is not None:
            row["delta_iou_vs_bf16"] = round(row["iou"] - base["iou"], 4)
        else:
            row.pop("delta_iou_vs_bf16", None)
    dev = torch.device(device) if device else torch.device("cuda")
    artifact = {
        "ckpt": str(ckpt),
        "protocol": "rald_torch main_generation eval mode, test split",
        "matmul_precision": in_force or precision_in_force(),
        "system_matmul_precision": cfg.system.get("matmul_precision"),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
        "modes": results,
    }
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(artifact, indent=2) + "\n")
    print_fn(json.dumps(artifact, indent=2))
    print_fn(f"written: {path}")
    return artifact


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("rald_torch int8 quality gate")
    parser.add_argument("--config", required=True)
    parser.add_argument("--ckpt", required=True, help="stage-2 .pth checkpoint")
    parser.add_argument("--modes", default=None,
                        help=f"comma-separated subset of {','.join(n for n, _ in MODES)}")
    parser.add_argument("--out", default=None,
                        help="artifact path (default <system.output_dir>/int8_gate_<ckpt stem>.json)")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    modes = args.modes.split(",") if args.modes else None
    return run(finalize_dirs(load_config(args.config)), args.ckpt, modes, args.out, args.device)


if __name__ == "__main__":
    main()
