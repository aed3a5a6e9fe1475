"""The convergence recipe end to end: the port of
``scripts/rerun_to_convergence.sh``.

    python -m rald_torch.cli.rerun_to_convergence [ROOT] [--gen-epochs 480] [--device cpu]

In one process, on the card unless ``--device cpu`` is given:

1. :mod:`rald_torch.cli.curves_configs` writes the synthetic tree (if it is
   not there yet) and ``ae.yml`` / ``gen.yml`` under ``ROOT`` (default
   ``build/curves``);
2. ``main_ae.run`` trains stage 1 (60 epochs) into ``ROOT/out_ae``;
3. the stage-1 file that ``gen.yml``'s ``lidar_ae.ckpt`` names must be the
   file stage 1 wrote after its last epoch (``out_ae/checkpoint-59.pth``),
   else the chain raises :class:`FileNotFoundError` (a wrong name before
   stage 1 trains, a missing file after it). The package's CLIs only
   warn on a missing ``lidar_ae.ckpt`` and go on with a random frozen VAE,
   as the JAX package's do; a recipe that trained stage 2 on noise would
   show no error at all;
4. ``main_cache.run`` writes the latent cache of the train split;
5. ``main_generation.run`` trains stage 2 (120 epochs) into
   ``ROOT/out_gen`` from the cache.

Each stage logs one JSON line an epoch to its ``log.txt``
(``python -m rald_torch.cli.render_curves`` renders them). By default the
recipe runs as ``curves_configs`` writes it. ``--gen-epochs N`` does what
the shell script's YAML patch does, and nothing else: stage 2 trains N
epochs (which also stretches the cosine LR horizon), ``eval_freq`` 16,
``save_ckpt_freq`` 40.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import yaml

from rald_torch.cli import curves_configs, main_ae, main_cache, main_generation
from rald_torch.config import finalize_dirs, load_config


def patch_gen_epochs(gen_yml, epochs: int) -> None:
    """The shell script's patch of ``gen.yml``: ``epochs``, ``eval_freq``
    16, ``save_ckpt_freq`` 40."""
    gen_yml = Path(gen_yml)
    gen = yaml.safe_load(gen_yml.read_text())
    gen["train"]["epochs"] = int(epochs)
    gen["train"]["eval_freq"] = 16
    gen["train"]["save_ckpt_freq"] = 40
    gen_yml.write_text(yaml.safe_dump(gen))


def check_stage1_checkpoint(ae_cfg, gen_cfg, trained: bool = True) -> Path:
    """The path of ``gen_cfg.lidar_ae.ckpt``, which must be the file that
    stage 1 (``ae_cfg``) writes after its last epoch, and, with ``trained``,
    must exist; raises :class:`FileNotFoundError` otherwise."""
    wrote = Path(ae_cfg.system.output_dir) / f"checkpoint-{int(ae_cfg.train.epochs) - 1}.pth"
    named = Path(str(gen_cfg.lidar_ae.get("ckpt") or ""))
    if named.resolve() != wrote.resolve():
        raise FileNotFoundError(
            f"stage 2's lidar_ae.ckpt {named} is not the file stage 1 writes, {wrote}: stage 2 "
            "would train on a random frozen VAE")
    if trained and not wrote.is_file():
        raise FileNotFoundError(f"stage 1 wrote no {wrote}")
    return named


def chain(ae_yml, gen_yml, device=None, print_fn=print) -> dict:
    """Steps 2-5 of the module docstring on the two YAMLs; returns the stats
    of each stage's last evaluation (``ae``, ``gen``) and the cache
    directory (``cache``). The stage-1 file is checked before stage 1 (the
    name) and after it (the file)."""
    ae_cfg = finalize_dirs(load_config(ae_yml))
    gen_cfg = finalize_dirs(load_config(gen_yml))
    check_stage1_checkpoint(ae_cfg, gen_cfg, trained=False)
    out = {"ae": main_ae.run(ae_cfg, device=device, print_fn=print_fn)}
    check_stage1_checkpoint(ae_cfg, gen_cfg)
    out["cache"] = main_cache.run(finalize_dirs(load_config(gen_yml)), device=device,
                                  print_fn=print_fn)
    out["gen"] = main_generation.run(gen_cfg, device=device, print_fn=print_fn)
    return out


def run(root=curves_configs.DEFAULT_ROOT, gen_epochs: int | None = None, device=None,
        print_fn=print) -> dict:
    """The recipe's files (:func:`curves_configs.main`, then the
    ``--gen-epochs`` patch), then :func:`chain`."""
    ae_yml, gen_yml = curves_configs.main(root, print_fn=print_fn)
    if gen_epochs is not None:
        patch_gen_epochs(gen_yml, gen_epochs)
    return chain(ae_yml, gen_yml, device, print_fn)


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser("rald_torch convergence recipe: main_ae -> main_cache -> "
                                     "main_generation")
    parser.add_argument("root", nargs="?", default=str(curves_configs.DEFAULT_ROOT))
    parser.add_argument("--gen-epochs", type=int, default=None,
                        help="stage-2 epochs (with eval_freq 16, save_ckpt_freq 40), "
                             "as the shell script's 480-epoch patch")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs the plain versions)")
    args = parser.parse_args(argv)
    return run(args.root, args.gen_epochs, args.device)


if __name__ == "__main__":
    main()
