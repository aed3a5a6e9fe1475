"""Layer-wise learning-rate decay (``rald_tpu/train/lr_decay.py:19-62``).

Each parameter gets the scale ``decay ** (depth + 1 - layer_id)``, so that
layers near the input learn slower: the input side (``point_embed``,
``s_latents`` / ``d_latents``, the DiT's input projection and
``map_noise``) is layer 0, block ``i`` (the VAE's ``layers.{i}``, the
DiT's ``transformer_blocks.{i}``) is ``i + 1``, everything else (heads,
final norms, the encoder cross-attention, the learnable query table) is
``depth + 1``, at scale 1.
Keys are the port's parameter names, which carry the reference's torch
layout. JAX's mains do not use it, and neither do the port's.
"""
from __future__ import annotations

import re
from typing import Callable

_INPUT_SIDE = ("point_embed", "s_latents", "d_latents", "proj_in", "map_noise")


def layer_id_fn(depth: int) -> Callable[[str], int]:
    """A parameter name -> its layer id (0 = the input side).

    The VAE's names start at the model (``layers.3.0.fn.to_q.weight``); the
    DiT's at ``EDMPrecond`` (``model.transformer_blocks.3....``), whose inner
    ``model.`` prefix is skipped, so only the top module below it decides,
    as JAX's top-level flax module does (a block's own ``proj_in`` is not
    the input projection)."""

    def fn(name: str) -> int:
        parts = name.split(".")
        if parts[0] == "model" and len(parts) > 2:
            parts = parts[1:]
        if parts[0] in _INPUT_SIDE:
            return 0
        m = re.fullmatch(r"(?:layers|transformer_blocks)\.(\d+)", ".".join(parts[:2]))
        if m:
            return int(m.group(1)) + 1
        return depth + 1

    return fn


def lr_decay_scales(names, depth: int, decay: float = 0.75) -> dict:
    """Name -> scale ``decay ** (depth + 1 - layer_id)`` for each of
    ``names`` (parameter names, or a dict keyed by them)."""
    fn = layer_id_fn(depth)
    return {n: decay ** (depth + 1 - fn(n)) for n in names}


def scale_by_layer_decay(updates: dict, depth: int, decay: float = 0.75) -> dict:
    """Each update multiplied by its parameter's scale (JAX's transform,
    chained after the optimizer: the reference's ``lr * lr_scale``)."""
    scales = lr_decay_scales(updates, depth, decay)
    return {n: u * scales[n] for n, u in updates.items()}
