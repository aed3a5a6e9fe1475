"""Turn a released reference ``.pth`` into a checkpoint the port's trainers
resume from: the port of ``rald_tpu/cli/convert_ckpt.py``.

    python -m rald_torch.cli.convert_ckpt --config configs/generation/ge_indoor_unfreeze_enc_ints_only.yml \
        --kind generation --torch-ckpt checkpoint-479.pth --out ./converted [--device cpu]

``--kind generation`` / ``ae`` builds the engine the YAML describes
(``GenerationEngine`` / ``AEEngine``) and its fresh train state
(``init_state(1, 1)``), loads the file's state_dict (under ``--state-key``,
default ``model``; else the file itself) strictly into both the params and
the EMA, cast to the state's dtypes (the reference merges EMA into the
weights it saves), keeps the fresh optimizer and step 0, and writes
``<out>/checkpoint-<epoch>.pth``, which ``train.resume``, ``eval.ckpt`` and
``lidar_ae.ckpt`` take. ``--kind radar_enc`` loads the whole radar
autoencoder (encoder and ``decoder.*``) strictly into the ``radar_enc``
model of the YAML and writes it as a reference-layout ``.pth`` at the same
path, which ``radar_enc.ckpt`` takes. A key missing from the file, or one
the model does not have, raises. The engine is built on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
from pathlib import Path

from rald_torch.config import finalize_dirs, load_config
from rald_torch.train.checkpoint import (
    CheckpointManager,
    load_torch_checkpoint,
    save_torch_checkpoint,
)

KINDS = ("ae", "generation", "radar_enc")


def assert_keys_match(target, converted, what: str = "param") -> None:
    """Raise, naming up to 8 of each, where the keys of the two differ
    (JAX ``_assert_structures_match``)."""
    missing, extra = sorted(set(target) - set(converted)), sorted(set(converted) - set(target))
    if missing or extra:
        raise ValueError(f"{what} structure mismatch:\n  missing from checkpoint: {missing[:8]}"
                         f"\n  unexpected in checkpoint: {extra[:8]}")


def run(cfg, kind: str, torch_ckpt: str, out_dir: str, epoch: int = 0, state_key: str = "model",
        device=None, print_fn=print) -> Path:
    """Convert ``torch_ckpt``; returns the written file."""
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} (one of {KINDS})")
    sd = load_torch_checkpoint(torch_ckpt, key=state_key)
    if kind == "radar_enc":
        from rald_torch.models.registry import get_radar_encoder_model

        in_ch = int(sd["encoder.conv_in.weight"].shape[1]) if "encoder.conv_in.weight" in sd else 1
        model = get_radar_encoder_model(cfg.radar_enc.name, in_channels=in_ch,
                                        overrides=cfg.radar_enc.get("overrides"))
        assert_keys_match(model.state_dict(), sd)
        model.load_state_dict(sd)
        path = save_torch_checkpoint(Path(out_dir) / f"checkpoint-{epoch}.pth", model.state_dict())
    else:
        if kind == "ae":
            from rald_torch.train.ae_engine import AEEngine as Engine
        else:
            from rald_torch.train.gen_engine import GenerationEngine as Engine
        state = Engine(cfg, device=device).init_state(steps_per_epoch=1, world_batch=1)
        assert_keys_match(state.params, sd)
        params = {k: sd[k].to(p.device, p.dtype).reshape(p.shape) for k, p in state.params.items()}
        state.load(params, params, state.opt_state(), 0)
        path = CheckpointManager(out_dir).save(state, epoch)
    print_fn(f"converted {torch_ckpt} -> {path}")
    return path


def main(argv=None) -> Path:
    parser = argparse.ArgumentParser("rald_torch reference checkpoint conversion")
    parser.add_argument("--config", required=True)
    parser.add_argument("--kind", required=True, choices=KINDS)
    parser.add_argument("--torch-ckpt", required=True)
    parser.add_argument("--out", required=True)
    parser.add_argument("--epoch", type=int, default=0)
    parser.add_argument("--state-key", default="model")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card; 'cpu' runs on the CPU)")
    args = parser.parse_args(argv)
    return run(finalize_dirs(load_config(args.config)), args.kind, args.torch_ckpt, args.out,
               args.epoch, args.state_key, args.device)


if __name__ == "__main__":
    main()
