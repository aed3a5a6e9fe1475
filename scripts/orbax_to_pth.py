"""Carry a checkpoint of the JAX package (an orbax directory) into the
PyTorch port's ``.pth`` files. Run it where the JAX package runs (it needs
JAX, flax, optax and orbax; the port never imports them):

    python scripts/orbax_to_pth.py --config <yml> --kind {generation,ae,radar_enc} \
        --ckpt <orbax checkpoint-N dir> --out <dir> [--params-only]

A trainer checkpoint (``params``, ``ema_params``, ``opt_state``, ``step``,
``epoch``; ``rald_tpu/train/checkpoint.py``) is restored through
``rald_tpu``'s ``CheckpointManager`` into the structure of its engine's
``init_state`` (traced, not run; the optimizer state keeps its optax
structure), carried
into the port's train state by ``rald_torch.convert.flax_params.train_state_from_flax``
and written by the port's ``CheckpointManager`` as
``<out>/checkpoint-<epoch>.pth``: ``train.resume`` continues from it, and
``eval.ckpt`` / ``lidar_ae.ckpt`` read it. The port's state is built on the
CPU; the file loads on any device.

With ``--params-only``, or for a checkpoint that holds a bare ``params``
tree (a frozen module's, such as ``rald_tpu.cli.convert_ckpt --kind
radar_enc`` writes), it writes a reference-layout ``.pth`` (state_dict under
``model``) at the same path: the EMA weights where ``train.use_ema`` is set
and the checkpoint has them, else the params (as ``rald_tpu/cli/infer.py``
chooses). ``--kind radar_enc`` takes the whole autoencoder (encoder and
decoder), which ``radar_enc.ckpt`` reads.
"""
from __future__ import annotations

import argparse
import functools
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

KINDS = ("generation", "ae", "radar_enc")


def _jax_engine(cfg, kind: str):
    if kind == "generation":
        from rald_tpu.train.gen_engine import GenerationEngine as Engine
    else:
        from rald_tpu.train.ae_engine import AEEngine as Engine
    return Engine(cfg)


def _converter(jeng, kind: str):
    """The port's tree converter of a kind: flax params -> reference state_dict."""
    from rald_torch.convert import flax_params as fp

    if kind == "radar_enc":
        return fp.radar_autoencoder_state_dict_from_flax
    if kind == "generation":
        return functools.partial(fp.edm_state_dict_from_flax, depth=int(jeng.model.depth))
    return functools.partial(fp.vae_state_dict_from_flax, depth=int(jeng.model.depth),
                             query_type=jeng.model.query_type)


def run(cfg_path: str, kind: str, ckpt: str, out_dir: str, params_only: bool = False,
        print_fn=print) -> Path:
    """Convert ``ckpt``; returns the written ``.pth``."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} (one of {KINDS})")
    from rald_torch.config import load_config as port_load
    from rald_torch.convert.flax_params import train_state_from_flax
    from rald_torch.train.checkpoint import CheckpointManager as PortManager
    from rald_torch.train.checkpoint import save_torch_checkpoint
    from rald_tpu.config import load_config
    from rald_tpu.train.checkpoint import CheckpointManager

    ckpt = Path(ckpt).resolve()
    cfg = load_config(cfg_path)
    jeng = _jax_engine(cfg, kind) if kind != "radar_enc" else None
    convert = _converter(jeng, kind)
    meta = ocp.StandardCheckpointer().metadata(ckpt).item_metadata
    keys = set(meta.tree) if meta is not None else set(ocp.StandardCheckpointer().restore(ckpt))
    if jeng is not None and not params_only and {"ema_params", "opt_state", "step"} <= keys:
        # the template's structure and shapes, traced only: nothing is
        # initialised or compiled
        template = jax.eval_shape(lambda: jeng.init_state(1, 1))
        state, epoch = CheckpointManager(ckpt.parent).restore(template, ckpt)
        st = jax.device_get({"params": state.params, "ema": state.ema_params,
                             "opt": state.opt_state, "step": state.step})
        if kind == "generation":
            from rald_torch.train.gen_engine import GenerationEngine as PortEngine
        else:
            from rald_torch.train.ae_engine import AEEngine as PortEngine
        pstate = PortEngine(port_load(cfg_path), device="cpu").init_state(1, 1)
        train_state_from_flax(pstate, st["params"], st["ema"], st["opt"], st["step"],
                              convert=convert)
        path = PortManager(out_dir).save(pstate, epoch)
    else:
        raw = ocp.StandardCheckpointer().restore(ckpt)
        use_ema = bool(cfg.get("train", {}).get("use_ema", False))
        tree = raw["ema_params"] if use_ema and "ema_params" in raw else raw["params"]
        sd = convert(jax.tree_util.tree_map(np.asarray, tree))
        epoch = int(raw.get("epoch", 0))
        path = save_torch_checkpoint(Path(out_dir) / f"checkpoint-{epoch}.pth", sd)
    print_fn(f"converted {ckpt} -> {path}")
    return path


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser("orbax checkpoint of rald_tpu -> .pth of rald_torch")
    parser.add_argument("--config", required=True)
    parser.add_argument("--kind", required=True, choices=KINDS)
    parser.add_argument("--ckpt", required=True, help="orbax checkpoint-N directory")
    parser.add_argument("--out", required=True)
    parser.add_argument("--params-only", action="store_true",
                        help="write a reference-layout .pth of the weights only")
    args = parser.parse_args(argv)
    return run(args.config, args.kind, args.ckpt, args.out, args.params_only)


if __name__ == "__main__":
    main()
