"""Rectified-flow Euler sampling with classifier-free guidance, as
Hunyuan3D-2.0's shape pipeline samples (arXiv:2501.12202).

From unit-normal latents ``x_0`` the sampler takes ``num_steps`` Euler
steps at ``t_i = i / num_steps``: one denoiser call on the batch ``[x ;
x]`` (the conditional rows, then the unconditional ones), ``v = v_u +
guidance * (v_c - v_u)``, ``x <- x + v / num_steps``. The state stays in
float32; each step is one ``flow_step`` span.
"""
from __future__ import annotations

from typing import Callable

import torch

from rald_torch.train.profiler import span


def flow_times(num_steps: int, device=None) -> torch.Tensor:
    """(num_steps,) float32 flow times ``i / num_steps``."""
    return torch.arange(num_steps, dtype=torch.float32, device=device) / num_steps


def flow_euler_cfg(velocity_indexed: Callable, latents: torch.Tensor, num_steps: int = 50,
                   guidance_scale: float = 5.0) -> torch.Tensor:
    """Euler steps from ``latents`` (B, N, C). ``velocity_indexed(x2, i)``
    gives the velocity of the (2B, N, C) batch ``[x ; x]`` at step ``i``,
    the first B rows conditioned and the last B not."""
    x = latents.float()
    for i in range(num_steps):
        with span("flow_step"):
            v_c, v_u = velocity_indexed(torch.cat([x, x]), i).float().chunk(2)
            x = x + (v_u + guidance_scale * (v_c - v_u)) / num_steps
    return x
