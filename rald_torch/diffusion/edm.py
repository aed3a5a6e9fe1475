"""EDM sigma schedule and churn-free Heun sampler (``rald_tpu/diffusion/edm.py``).

:func:`karras_sigmas` (:35), :func:`stack_mod_table` / :func:`unstack_mods`
(:62-82) and :func:`edm_sampler` (:85). The JAX ``lax.scan`` becomes a
Python loop: ``num_steps - 1`` Heun steps (2 NFEs each) and one final Euler
step, 35 NFEs at 18 steps. Stochastic churn (``s_churn > 0``) is not part
of the product config and is not ported yet: it raises.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch


def karras_sigmas(num_steps: int = 18, sigma_min: float = 0.002, sigma_max: float = 80.0,
                  rho: float = 7.0, device=None) -> torch.Tensor:
    """(num_steps + 1,) f32 noise levels: rho-spaced descending, terminal 0."""
    idx = torch.arange(num_steps, dtype=torch.float32, device=device)
    t = (sigma_max ** (1 / rho) + idx / (num_steps - 1)
         * (sigma_min ** (1 / rho) - sigma_max ** (1 / rho))) ** rho
    return torch.cat([t, torch.zeros((1,), dtype=torch.float32, device=device)])


def sample_prior_latents(seeds_or_prior, n_latents: int, channels: int, device) -> torch.Tensor:
    """(B, n_latents, channels) unit-normal prior draws.

    ``seeds_or_prior``: a sequence of integer seeds (one ``torch.Generator``
    per sample, so a frame's draw does not depend on its batch), or an
    injected (B, n_latents, channels) numpy array / tensor.
    """
    if isinstance(seeds_or_prior, (np.ndarray, torch.Tensor)):
        prior = seeds_or_prior
        if isinstance(prior, np.ndarray):
            prior = torch.from_numpy(np.array(prior, np.float32))
        prior = prior.to(device, torch.float32)
        if prior.shape[1:] != (n_latents, channels):
            raise ValueError(f"injected prior {tuple(prior.shape)} != (B, {n_latents}, {channels})")
        return prior
    seeds: Sequence[int] = [int(s) for s in seeds_or_prior]
    out = []
    for s in seeds:
        g = torch.Generator(device=device).manual_seed(s)
        out.append(torch.randn((n_latents, channels), generator=g, device=device))
    return torch.stack(out)


def stack_mod_table(table) -> torch.Tensor:
    """``compute_mod_table`` pairs -> one (S, depth, 3, 2, 1, C) tensor."""
    rows = [torch.stack([torch.stack(pair) for pair in block]) for block in table]
    return torch.stack(rows).movedim(3, 0).contiguous()


def unstack_mods(sl: torch.Tensor):
    """(depth, 3, 2, 1, C) schedule-step slice -> per-block (scale, shift) pairs."""
    return tuple(
        ((sl[i, 0, 0], sl[i, 0, 1]), (sl[i, 1, 0], sl[i, 1, 1]), (sl[i, 2, 0], sl[i, 2, 1]))
        for i in range(sl.shape[0])
    )


def edm_sampler(
    denoise_indexed: Callable,
    latents: torch.Tensor,
    num_steps: int = 18,
    sigma_min: float = 0.002,
    sigma_max: float = 80.0,
    rho: float = 7.0,
    s_churn: float = 0.0,
    s_min: float = 0.0,
    s_max: float = float("inf"),
    s_noise: float = 1.0,
) -> torch.Tensor:
    """Heun sampler from unit-normal ``latents`` (B, M, C).

    ``denoise_indexed(x, sigma, step_idx)`` also receives the schedule index
    of ``sigma``, so it can look up precomputed AdaLN modulations: the two
    evaluations of step ``i`` use rows ``i`` and ``i + 1``. ``s_min``,
    ``s_max`` and ``s_noise`` shape the churn only.
    """
    if s_churn > 0:
        raise NotImplementedError("edm_sampler: s_churn > 0 is not ported yet")
    t_steps = karras_sigmas(num_steps, sigma_min, sigma_max, rho, device=latents.device)
    x = latents.float() * t_steps[0]
    for i in range(num_steps - 1):
        t_cur, t_next = t_steps[i], t_steps[i + 1]
        d_cur = (x - denoise_indexed(x, t_cur, i)) / t_cur
        x_next = x + (t_next - t_cur) * d_cur
        d_prime = (x_next - denoise_indexed(x_next, t_next, i + 1)) / t_next
        x = x + (t_next - t_cur) * (0.5 * d_cur + 0.5 * d_prime)
    t_cur, t_next = t_steps[num_steps - 1], t_steps[num_steps]
    return x + (t_next - t_cur) * (x - denoise_indexed(x, t_cur, num_steps - 1)) / t_cur
