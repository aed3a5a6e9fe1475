"""The convergence recipe's synthetic tree and YAMLs: the port of
``scripts/curves_configs.py``.

    python -m rald_torch.cli.curves_configs [ROOT]        # default build/curves

Writes under ``ROOT`` (unless ``ROOT/data/split_synth.json`` exists) the
scene-correlated synthetic ColoRadar tree of
:func:`rald_torch.data.synthetic.make_synthetic_coloradar` (4 train
sequences, one val and one test sequence, 50 frames each, 16000 LiDAR
points a frame, radar cubes (128, 8, 2), upsampled on the device to
(128, 64, 32)), then ``ae.yml`` (stage 1: the full-width
``kl_d512_m512_l32_mix`` VAE, 60 epochs) and ``gen.yml`` (stage 2: the
full-width ``kl_d512_m512_l32_d24_edm`` DiT on cached latents of the
frozen stage-1 VAE, 120 epochs, EMA): batch 8, bf16, seed 0, the JAX
recipe's keys and values. One key differs from the JAX package's
``gen.yml``: ``lidar_ae.ckpt`` names ``out_ae/checkpoint-59.pth``, the file
the port's ``main_ae`` writes after epoch 59 (JAX names the orbax directory
``out_ae/checkpoint-59``).

``python -m rald_torch.cli.rerun_to_convergence`` runs the chain on these
files. The sizes are keyword arguments of :func:`main` (defaults: the JAX
recipe's), so that a test can write a tiny recipe.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import yaml

from rald_torch.config import Config
from rald_torch.data.synthetic import make_synthetic_coloradar, synthetic_dataset_config

DEFAULT_ROOT = Path("build") / "curves"


def recipe_configs(root, ae_epochs: int = 60, gen_epochs: int = 120) -> tuple:
    """``(ae, gen)``: the recipe's two configs for a tree under ``root``."""
    root = Path(root)
    ds = synthetic_dataset_config(root / "data")
    ds.batch_size = 8
    ds.eval_batch_size = 8
    ds.num_workers = 2
    ds.radar.upsample_on_device = True
    ds.use_query_helper = True
    ds.query_aug_num = 2048
    ds.query_aug_scale = 2

    ae = Config({
        "system": {"seed": 0, "mode": "train", "output_dir": str(root / "out_ae"),
                   "log_dir": None, "compute_dtype": "bfloat16"},
        "dataset": ds,
        "train": {
            "epochs": ae_epochs, "warmup_epochs": 2, "lr": 5e-4, "blr": 1e-4,
            "min_lr": 1e-6, "clip_grad": 10, "accum_iter": 1,
            "vol_weight": 0.1, "near_weight": 1.0,
            "save_ckpt_freq": 20, "eval_freq": 4, "use_ema": False,
        },
        "lidar_ae": {"name": "kl_d512_m512_l32_mix"},
        "eval": {"inference": {"num_query_points": 4096}, "freq": 4},
    })

    gen = Config({
        "system": {"seed": 0, "mode": "train", "output_dir": str(root / "out_gen"),
                   "log_dir": None, "compute_dtype": "bfloat16"},
        "dataset": ds,
        "train": {
            "epochs": gen_epochs, "warmup_epochs": 4, "lr": 5e-4, "blr": 1e-4,
            "min_lr": 1e-6, "clip_grad": 10, "accum_iter": 1,
            "save_ckpt_freq": 40, "eval_freq": 4, "use_ema": True,
            "use_cache_latent": True,
        },
        "ar_model": {
            "name": "kl_d512_m512_l32_d24_edm",
            "configs": {
                "cond_type": "radar", "use_radar_cond": True,
                "use_radar_enc": True, "unfreeze_radar_enc": True,
                "radar_token_channel": 512,
                "enc_radar_r_dim": 8, "enc_radar_a_dim": 4, "enc_radar_e_dim": 2,
                "enc_radar_ch": 16, "enc_hidden_ch": 64,
            },
        },
        "lidar_ae": {
            "name": "kl_d512_m512_l32_mix",
            "ckpt": str(root / "out_ae" / f"checkpoint-{ae_epochs - 1}.pth"),
            "latent_std": 1,
            "cache_path": str(root / "latent_cache"),
            "cache_name": "curves",
        },
        "radar_enc": {"name": "ae_ch64_mult5_n2_d16", "ckpt": None},
        "eval": {
            "freq": 4, "use_test_set": False,
            "inference": {
                "num_query_points": 100000,
                "query_helper": True,
                "refine_query": False,
            },
            "store_pc": False,
        },
    })
    return ae, gen


def main(root=DEFAULT_ROOT, num_train_seqs: int = 4, num_eval_seqs: int = 1,
         frames_per_seq: int = 50, points_per_frame: int = 16000,
         radar_shape: tuple = (128, 8, 2), ae_epochs: int = 60, gen_epochs: int = 120,
         print_fn=print) -> tuple:
    """Write the tree (unless its split file exists) and the two YAMLs;
    returns their paths ``(ae.yml, gen.yml)``."""
    root = Path(root)
    data = root / "data"
    if not (data / "split_synth.json").exists():
        make_synthetic_coloradar(
            data, num_train_seqs=num_train_seqs, num_eval_seqs=num_eval_seqs,
            frames_per_seq=frames_per_seq, points_per_frame=points_per_frame,
            radar_shape=radar_shape,
        )
        print_fn(f"dataset written: {data}")
    paths = []
    for name, c in zip(("ae", "gen"), recipe_configs(root, ae_epochs, gen_epochs)):
        path = root / f"{name}.yml"
        path.write_text(yaml.safe_dump(c.to_dict()))
        paths.append(path)
    print_fn(f"configs written: {paths[0]} {paths[1]}")
    return tuple(paths)


if __name__ == "__main__":
    parser = argparse.ArgumentParser("rald_torch convergence recipe: synthetic tree + YAMLs")
    parser.add_argument("root", nargs="?", default=str(DEFAULT_ROOT))
    main(parser.parse_args().root)
