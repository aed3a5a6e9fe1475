"""Reference ``.pth`` checkpoints: read into the port's models, strictly.

The released RaLD weights are PyTorch ``state_dict`` files of
``EDMPrecond``, ``KLAutoEncoder`` and ``RadarAutoencoder``; the port's
models keep that key layout, so a reference file loads as it is. This is
the port's counterpart of ``rald_tpu/convert/torch_ckpt.py:39-45``
(``load_torch_checkpoint``) and ``rald_tpu/cli/convert_ckpt.py:30-73``: the
state_dict sits under ``model`` (else the file is the state_dict itself),
and the reference merges EMA into it before saving, so there is one weight
set per file.

Orbax checkpoint directories (the JAX package's trainers write them) are
not read: that needs orbax and tensorstore, which the port does not use.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

STATE_KEY = "model"


def load_torch_checkpoint(path, key: str | None = STATE_KEY) -> dict:
    """A ``.pth`` file -> its state_dict of CPU tensors (``key`` if the file
    holds it, else the whole dict). A directory raises
    ``NotImplementedError``: orbax checkpoints are not read by the port."""
    path = Path(path)
    if path.is_dir():
        raise NotImplementedError(
            f"rald_torch: {path} is a directory (an orbax checkpoint of the JAX package); the "
            "port reads reference-layout .pth files only — reading orbax is not ported "
            "(ROADMAP A3)"
        )
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = ckpt[key] if key and isinstance(ckpt, dict) and key in ckpt else ckpt
    return {k: v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v)) for k, v in sd.items()}


def save_torch_checkpoint(path, state_dict: dict, key: str = STATE_KEY) -> Path:
    """Write ``{key: state_dict}`` as the reference saves its checkpoints
    (tensors on the CPU, in their own dtypes)."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({key: {k: v.detach().cpu() for k, v in state_dict.items()}}, path)
    return path


def split_radar_autoencoder(state_dict: dict) -> tuple[dict, list]:
    """A reference ``RadarAutoencoder`` state_dict -> (the ``encoder.*``
    entries, the sorted ``decoder.*`` keys the port does not use: it has no
    ``RadarDecoder3D``). Any other key stays in the first dict, so a strict
    load refuses it."""
    keep = {k: v for k, v in state_dict.items() if not k.startswith("decoder.")}
    return keep, sorted(k for k in state_dict if k.startswith("decoder."))
