"""EDM sigma schedule, Heun sampler with stochastic churn, and training
loss (``rald_tpu/diffusion/edm.py``).

:func:`karras_sigmas` (:35), :func:`stack_mod_table` / :func:`unstack_mods`
(:62-82), :func:`edm_sampler` (:85) and :func:`edm_loss` (:180). The JAX ``lax.scan`` becomes a
Python loop: ``num_steps - 1`` Heun steps (2 NFEs each) and one final Euler
step, 35 NFEs at 18 steps. Stochastic churn (``s_churn > 0``, :132-143)
perturbs each step's state and sigma before its first evaluation, the
final Euler step included; its unit-normal draws come from
:func:`sample_churn_noise`, one stream per (sample seed, step), as JAX
keys them from ``fold_in(fold_in(PRNGKey(0), seed), step)``.
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from rald_torch.parallel.dist import draw_rows
from rald_torch.train.profiler import span


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


CHURN_STREAM = 0x636875  # the churn draws' key tag: distinct from the prior's stream


def sample_churn_noise(seeds_or_prior, step: int, n_latents: int, channels: int,
                       device) -> torch.Tensor:
    """(B, n_latents, channels) unit-normal churn draws of Heun step
    ``step``: one generator per sample, seeded from (seed, step,
    :data:`CHURN_STREAM`), so a frame's draws do not depend on its batch and
    differ from its prior's. An injected prior array has no seeds to key
    from: it raises (inject the churn draws as well)."""
    if isinstance(seeds_or_prior, (np.ndarray, torch.Tensor)):
        raise ValueError("s_churn > 0 with an injected prior draw: there are no seeds to key "
                         "the churn noise from; inject it too (GenerationEngine.draw_churn)")
    out = []
    for s in seeds_or_prior:
        key = np.random.SeedSequence([int(s), int(step), CHURN_STREAM]).generate_state(1)[0]
        g = torch.Generator(device=device).manual_seed(int(key))
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
    churn_noise: Optional[Callable] = None,
    capture_states: bool = False,
):
    """Heun sampler from unit-normal ``latents`` (B, M, C).

    ``denoise_indexed(x, sigma, step_idx)`` also receives the schedule index
    of ``sigma``, so it can look up precomputed AdaLN modulations: the two
    evaluations of step ``i`` use rows ``i`` and ``i + 1``.

    Churn (``s_churn > 0``): before its first evaluation, step ``i`` (the
    final Euler step too, ``i = num_steps - 1``) raises ``t_cur`` to
    ``t_hat = t_cur + gamma * t_cur``, with ``gamma = min(s_churn /
    num_steps, sqrt(2) - 1)`` where ``s_min <= t_cur <= s_max`` (in f32)
    and 0 elsewhere, and adds ``sqrt(max(t_hat^2 - t_cur^2, 0)) * s_noise *
    eps`` to the state; ``eps = churn_noise(i)`` (B, M, C). The denoiser is
    then evaluated at ``t_hat``, off the schedule, so its ``step_idx`` names
    the step, not the sigma.

    ``capture_states=True`` returns ``(x_final, (idxs, xs))`` instead:
    every (schedule index, state) pair the denoiser was evaluated at, in
    call order, the final Euler state included (``idxs`` (2*num_steps-1,)
    int64 on the CPU, ``xs`` (2*num_steps-1, B, M, C)) -- the replay inputs
    of the int8 activation-scale calibration (JAX ``capture_states``).
    """
    churn = s_churn > 0
    if churn and churn_noise is None:
        raise ValueError("edm_sampler: s_churn > 0 needs churn_noise")
    t_steps = karras_sigmas(num_steps, sigma_min, sigma_max, rho, device=latents.device)
    x = latents.float() * t_steps[0]
    gamma_cap = min(s_churn / num_steps, math.sqrt(2.0) - 1.0)

    def nfe(x_in, t, i):
        with span("nfe"):
            return denoise_indexed(x_in, t, i)

    def perturb(x_cur, t_cur, i):
        if not churn:
            return x_cur, t_cur
        gamma = torch.where((t_cur >= s_min) & (t_cur <= s_max), gamma_cap, 0.0)
        t_hat = t_cur + gamma * t_cur
        eps = churn_noise(i).to(x_cur.device, torch.float32)
        return x_cur + torch.sqrt(torch.clamp(t_hat ** 2 - t_cur ** 2, min=0.0)) * s_noise * eps, t_hat

    seen = []
    for i in range(num_steps - 1):
        t_next = t_steps[i + 1]
        x_hat, t_hat = perturb(x, t_steps[i], i)
        d_cur = (x_hat - nfe(x_hat, t_hat, i)) / t_hat
        x_next = x_hat + (t_next - t_hat) * d_cur
        d_prime = (x_next - nfe(x_next, t_next, i + 1)) / t_next
        if capture_states:
            seen += [(i, x_hat), (i + 1, x_next)]
        x = x_hat + (t_next - t_hat) * (0.5 * d_cur + 0.5 * d_prime)
    x_hat, t_hat = perturb(x, t_steps[num_steps - 1], num_steps - 1)
    denoised = nfe(x_hat, t_hat, num_steps - 1)
    x_final = x_hat + (t_steps[num_steps] - t_hat) * (x_hat - denoised) / t_hat
    if not capture_states:
        return x_final
    seen.append((num_steps - 1, x_hat))
    idxs = torch.tensor([i for i, _ in seen], dtype=torch.int64)
    return x_final, (idxs, torch.stack([s for _, s in seen]))


def edm_draws(y: torch.Tensor, generator: Optional[torch.Generator] = None,
              rnd: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None) -> tuple:
    """:func:`edm_loss`'s two unit-normal draws for ``y``: ``rnd`` of shape
    (B, 1, 1), then ``noise`` of ``y``'s shape, each from ``generator`` (on
    ``y``'s device) unless given; under a process group each is drawn at the
    global batch and this rank keeps its rows
    (:func:`rald_torch.parallel.draw_rows`), as JAX draws at the sharded
    batch's global shape."""
    dev = y.device
    if rnd is None:
        rnd = draw_rows(torch.randn, (y.shape[0], 1, 1), generator=generator, device=dev)
    if noise is None:
        noise = draw_rows(torch.randn, y.shape, generator=generator, device=dev)
    return rnd, noise


def edm_loss(
    denoise_fn: Callable,
    y: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    rnd: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    p_mean: float = -1.2,
    p_std: float = 1.2,
    sigma_data: float = 1.0,
) -> torch.Tensor:
    """EDM weighted denoising MSE (JAX ``edm_loss``): ``rnd ~ N(0, 1)`` of
    shape (B, 1, 1), ``sigma = exp(rnd * p_std + p_mean)``, noise ``N(0, 1)
    * sigma`` of ``y``'s shape, loss ``mean(weight * (D(y + n, sigma) -
    y)^2)`` in float32 with ``weight = (sigma^2 + sigma_data^2) / (sigma *
    sigma_data)^2``. The two unit-normal draws are :func:`edm_draws`'."""
    dev = y.device
    rnd, noise = edm_draws(y, generator, rnd, noise)
    sigma = torch.exp(rnd.to(dev, torch.float32) * p_std + p_mean)
    weight = (sigma ** 2 + sigma_data ** 2) / (sigma * sigma_data) ** 2
    n = noise.to(dev, torch.float32) * sigma
    d_yn = denoise_fn(y + n, sigma)
    return torch.mean(weight * (d_yn - y.float()) ** 2)
