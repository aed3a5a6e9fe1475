"""Checkpoints: the reference's ``.pth`` files and the trainer's own.

The released RaLD weights are PyTorch ``state_dict`` files of
``EDMPrecond``, ``KLAutoEncoder`` and ``RadarAutoencoder``; the port's
models keep that key layout, so a reference file loads as it is. This is
the port's counterpart of ``rald_tpu/convert/torch_ckpt.py:39-45``
(``load_torch_checkpoint``) and ``rald_tpu/cli/convert_ckpt.py:30-73``: the
state_dict sits under ``model`` (else the file is the state_dict itself),
and the reference merges EMA into it before saving, so there is one weight
set per file.

:class:`CheckpointManager` (``rald_tpu/train/checkpoint.py:24-114``) writes
and resumes the trainer's state as ``output_dir/checkpoint-{epoch}.pth``:
``model`` (the params, in the reference layout, so the files above and the
eval CLI read it as a reference file), ``model_ema``, ``optimizer``
(:meth:`TrainState.opt_state`), ``step`` and ``epoch``.
:func:`load_torch_checkpoint` with ``ema`` reads ``model_ema`` where a
file has it, as JAX's eval takes a restored state's ``ema_params``.

Orbax checkpoint directories (the JAX package's trainers write them) are
not read here: that needs orbax and tensorstore, which the port does not
use. ``scripts/orbax_to_pth.py``, run where the JAX package runs, turns
them into these ``.pth`` files.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from rald_torch.parallel.dist import barrier, is_main_process

STATE_KEY = "model"
EMA_KEY = "model_ema"


def load_torch_checkpoint(path, key: str | None = STATE_KEY, ema: bool = False) -> dict:
    """A ``.pth`` file -> its state_dict of CPU tensors (``key`` if the file
    holds it, else the whole dict; with ``ema``, ``model_ema`` where the
    file holds it). A directory raises ``NotImplementedError``: convert an
    orbax checkpoint with ``scripts/orbax_to_pth.py`` first."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"rald_torch: {path} is a directory (an orbax checkpoint of the JAX package); the "
            "port reads .pth files: convert it with scripts/orbax_to_pth.py, where the JAX "
            "package runs"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if ema and isinstance(ckpt, dict) and EMA_KEY in ckpt:
        key = EMA_KEY
    sd = ckpt[key] if key and isinstance(ckpt, dict) and key in ckpt else ckpt
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def save_torch_checkpoint(path, state_dict: dict, key: str = STATE_KEY) -> Path:
    """Write ``{key: state_dict}`` as the reference saves its checkpoints
    (tensors on the CPU, in their own dtypes)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({key: {k: v.detach().cpu() for k, v in state_dict.items()}}, path)
    return path


def split_radar_autoencoder(state_dict: dict) -> tuple[dict, dict]:
    """A reference ``RadarAutoencoder`` state_dict -> (its encoder half, its
    ``decoder.*`` entries). The frozen conditioning encoder
    (``RadarAutoencoder(decoder=False)``) loads the first strictly; any key
    outside ``decoder.*`` stays in it, so that load refuses a stray one. A
    whole ``RadarAutoencoder`` loads the file as it is."""
    keep = {k: v for k, v in state_dict.items() if not k.startswith("decoder.")}
    return keep, {k: v for k, v in state_dict.items() if k.startswith("decoder.")}


def _to_cpu(tree):
    if torch.is_tensor(tree):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    return tree


class CheckpointManager:
    """``checkpoint-{epoch}.pth`` files of a :class:`TrainState` under
    ``output_dir``."""

    def __init__(self, output_dir):
        self.output_dir = Path(output_dir).resolve()
        self.output_dir.mkdir(parents=True, exist_ok=True)

    def _path(self, epoch) -> Path:
        return self.output_dir / f"checkpoint-{epoch}.pth"

    def save(self, state, epoch: int) -> Path:
        """Write the state (on the CPU) and the epoch; the file appears whole
        or not at all (written aside, then renamed). Under a process group
        rank 0 writes (every rank holds the same state) and every rank waits
        for it at a barrier, so no rank can read a half-written file."""
        path = self._path(epoch)
        if is_main_process():
            payload = {STATE_KEY: _to_cpu(state.params), EMA_KEY: _to_cpu(state.ema_params),
                       "optimizer": _to_cpu(state.opt_state()), "step": int(state.step),
                       "epoch": int(epoch)}
            tmp = path.with_name(path.name + ".tmp")
            torch.save(payload, tmp)
            os.replace(tmp, path)
        barrier()
        return path

    def restore(self, state, path=None):
        """Load a checkpoint into ``state`` (in place); returns ``(state,
        epoch)``. ``path``: an epoch number, a file, or None (the latest
        under ``output_dir``). Every rank reads the file itself."""
        if path is None:
            path = self.latest_epoch()
            if path is None:
                raise FileNotFoundError(f"No checkpoints under {self.output_dir}")
        if isinstance(path, int):
            path = self._path(path)
        ckpt = torch.load(Path(path), map_location="cpu", weights_only=True)
        state.load(ckpt[STATE_KEY], ckpt[EMA_KEY], ckpt["optimizer"], ckpt["step"])
        return state, int(ckpt["epoch"])

    def latest_epoch(self) -> Optional[int]:
        epochs = [int(m.group(1)) for p in self.output_dir.glob("checkpoint-*.pth")
                  if (m := re.fullmatch(r"checkpoint-(\d+)\.pth", p.name))]
        return max(epochs) if epochs else None
