"""What a run is: the cell from ``BENCHMARK.json``, its configuration
(``configs/<config>.json``), its traffic mix (``traffic/<traffic>.json``),
the limits of its correctness check (``limits/<cell>.json``) and the
per-layer metrics it reports (``metrics/<name>.py``). Everything is found by
name; nothing here names a cell."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

import numpy as np

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(name: str, bench: dict | None = None, base: Path = BENCH_DIR) -> dict:
    """The cell ``name``: its ``BENCHMARK.json`` entry with the loaded
    ``config``, ``traffic`` and ``limits`` files and the names of its
    end-to-end and per-layer metrics."""
    bench = bench or benchmark()
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])

    def reports(m):
        return name in m.get("workloads", [name])

    return {
        "name": name,
        "chips": int(entry["chips"]),
        "config": load_json(base.parent / conf["file"]),
        "traffic": load_json(base / "traffic" / f"{entry['traffic']}.json"),
        "limits": load_json(base / "limits" / f"{name}.json"),
        "end_to_end": {m["name"]: m for m in bench["end_to_end"] if reports(m)},
        "per_layer": {m["name"]: m for m in bench["per_layer"] if reports(m)},
    }


def metric_reader(name: str):
    """The module ``metrics/<name>.py``: ``read(ctx)`` gives the metric's
    value or None; a roofline reader also names its ``OP`` and gives
    ``describe(args, kwargs, out)``, kept per call of the op."""
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"rald_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def engine_cfg(config: dict):
    """The system's configuration object from the ``config`` block."""
    from rald_torch.config import Config

    return Config(config["config"])


def seed_int(*key: int) -> int:
    """A 63-bit generator seed from the run's seed and a tag."""
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint64)[0] >> 1)


def eval_settings(cfg: dict, device) -> dict:
    """The eval chain's settings, read from the configuration block as the
    system reads them (``eval.inference``, ``dataset``, ``dataset.lidar``)."""
    inf, ds, lidar = cfg["eval"]["inference"], cfg["dataset"], cfg["dataset"]["lidar"]
    return {
        "device": device,
        "sampler": {k: float(inf.get(k, d)) if k != "num_steps" else int(inf.get(k, d))
                    for k, d in (("num_steps", 18), ("sigma_min", 0.002), ("sigma_max", 80.0),
                                 ("rho", 7.0))},
        "num_query": int(float(inf["num_query_points"])),
        "helper_num": int(float(ds["query_aug_num"])),
        "helper_scale": int(ds.get("query_aug_scale", 2)),
        "refine_num": int(float(inf["refine_query_aug_num"])),
        "refine_scale": int(inf["refine_query_scale"]),
        "pc_range": lidar["pc_range"],
        "voxel_size": lidar["voxel_size"],
        "fscore_tau": float(cfg["eval"].get("fscore_tau", 0.1)),
    }


def model_sizes(cfg: dict) -> dict:
    """The widths and depths the yardstick counts work at, from the names
    and blocks of the configuration (the registry's published variants:
    ``kl_d512_m512_l32_d24_edm``, ``kl_d512_m512_l32_mix``)."""
    import re

    dit = re.fullmatch(r"kl_d(\d+)_m(\d+)_l(\d+)(?:_d(\d+))?_edm", cfg["ar_model"]["name"])
    vae = re.fullmatch(r"kl_d(\d+)_m(\d+)_l(\d+)_mix", cfg["lidar_ae"]["name"])
    mc, radar = cfg["ar_model"]["configs"], cfg["dataset"]["radar"]
    return {
        "dim": int(dit.group(1)), "latents": int(dit.group(2)), "channels": int(dit.group(3)),
        "depth": int(cfg["ar_model"].get("overrides", {}).get("depth", dit.group(4) or 12)), "heads": 8, "dim_head": 64, "ff_mult": 4,
        "cond_tokens": int(mc["enc_radar_r_dim"]) * int(mc["enc_radar_a_dim"]) * int(mc["enc_radar_e_dim"]),
        "token_channel": int(mc["radar_token_channel"]),
        "enc_ch": int(mc["enc_hidden_ch"]), "enc_z": int(mc["enc_radar_ch"]),
        "enc_res": (int(radar["tgt_r_dim"]), int(radar["tgt_a_dim"]), int(radar["tgt_e_dim"])),
        "vae_dim": int(vae.group(1)), "vae_latents": int(vae.group(2)),
        "vae_depth": int(cfg["lidar_ae"].get("overrides", {}).get("depth", 24)),
        "lidar_points": int(cfg["dataset"]["lidar"]["num_samples"]),
    }
